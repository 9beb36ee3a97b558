"""``whole_seq_attention``'s share of its roofline, %: for each call the
larger of its FLOPs at 989 TFLOP/s (bfloat16) and its bytes (Q, K and V read
once, O written once) at 3.35 TB/s, summed, over the device time of the
kernel's events (``attn_wgmma_kernel``, ``attn_fma_kernel``), profiled
keyframes."""
from benchmark.harness import counts, peaks, trace


def read(obs):
    p = obs.profiled
    if p is None or not p.attention:
        return None
    seconds = sum(trace.kernel_seconds(p.events, k)[0] for k in ("attn_wgmma_kernel", "attn_fma_kernel"))
    if seconds <= 0:
        return None
    least = 0.0
    for B, T, heads, hd, elem in p.attention:
        flops, bytes_ = counts.attention_work(B, T, heads, hd, elem)
        peak = peaks.BF16_FLOPS if elem == 2 else peaks.FP32_FLOPS
        least += max(flops / peak, bytes_ / peaks.HBM_BYTES)
    return 100.0 * least / seconds
