"""The PST search kernel's share of its roofline, %: the least time its
float32 operations need at 67 TFLOP/s (``counts.pst_search_ops``, a lower
bound of its work, from each search's recorded inputs and iterations) over
the device time of the ``pst_search_kernel`` events, profiled keyframes."""
from benchmark.harness import counts, peaks, trace


def read(obs):
    p = obs.profiled
    if p is None or not p.searches:
        return None
    seconds, n = trace.kernel_seconds(p.events, "pst_search_kernel")
    if n == 0 or seconds <= 0:
        return None
    ops = 0
    for iterations, view_mask, n_particles, pvalid in p.searches:
        planes = (pvalid > 0.5).sum(-1).cpu().tolist()
        ops += counts.pst_search_ops(iterations.cpu().tolist(), view_mask.cpu().tolist(), n_particles, planes)
    if ops == 0:  # no search had an object to fuse
        return None
    return 100.0 * (ops / peaks.FP32_FLOPS) / seconds
