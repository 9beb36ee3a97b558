"""Where do the CLIP tower's milliseconds go?  One ViT-L block, attention variants.

Port of ``tools/profile_clip_attn.py``.  Times one ViT-L-scale residual block
at the label batch (B crops, 257 tokens, width 1024, 16 heads of 64,
bfloat16), ``LAYERS`` chained blocks per timed call, in variants:

  full     einsum scores, float32 softmax, einsum with v (the JAX tool's
           shipped block)
  kernel   ``whole_seq_attention``: the CUDA kernel on a card, its plain
           twin on the CPU
  nosmax   scores @ v without the softmax (what the softmax and its casts
           cost)
  mlponly  LN + MLP only, no attention at all
  flash    ``F.scaled_dot_product_attention`` restricted to SDPA's flash
           backend, unpadded (in place of the JAX tool's TPU Pallas flash
           op).  It needs a card: on the CPU it is reported and not timed.

The weights and the input come from ``np.random.RandomState(0)`` in the JAX
tool's order (``_params``, then the input), so both tools see the same
numbers.  The JAX tool enables XLA's compile cache first; eager PyTorch
compiles no program.  Prints ms per layer and per 24-layer tower at each B.

    python -m boxfusion_tpu_torch.tools.profile_clip_attn --batch 32 64 69 96 100 128 400
    python -m boxfusion_tpu_torch.tools.profile_clip_attn --device cpu --batch 2 --layers 1 --reps 1
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from boxfusion_tpu_torch.tools.common import timed_ms
from boxfusion_tpu_torch.utils.device import resolve_device

T, D, H = 257, 1024, 16
HD = D // H
LAYERS = 8  # chained blocks per timed call
TOWER_LAYERS = 24  # ViT-L/14
IMPLS = ("full", "kernel", "nosmax", "mlponly", "flash")
# the batches the engines give the tower (fused with buckets: 32 / 64 / 96 /
# 100; host: 69; batched, 4 lanes x 100: 400) and 128, the shape of record
ENGINE_BATCHES = (32, 64, 69, 96, 100, 128, 400)


def params(rng: np.random.RandomState) -> Dict[str, np.ndarray]:
    """The JAX tool's ``_params``: the same draws in the same order."""
    s = 0.02
    return dict(
        w_in=(rng.randn(3 * D, D) * s).astype(np.float32),
        b_in=np.zeros((3 * D,), np.float32),
        w_out=(rng.randn(D, D) * s).astype(np.float32),
        w_fc=(rng.randn(D, 4 * D) * s).astype(np.float32),
        w_proj=(rng.randn(4 * D, D) * s).astype(np.float32),
    )


def inputs(B: int, device, dtype=torch.bfloat16):
    """(x0 (B, T, D), weights) on ``device`` in ``dtype``, from
    ``RandomState(0)`` as the JAX tool draws them."""
    rng = np.random.RandomState(0)
    p = params(rng)
    x0 = rng.randn(B, T, D) * 0.02
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device).to(dtype)
    return as_t(x0), {k: as_t(v) for k, v in p.items()}


def layer_norm(x: torch.Tensor) -> torch.Tensor:
    """The JAX tool's ``_ln``: statistics in float32, no affine."""
    xf = x.float()
    m = xf.mean(-1, keepdim=True)
    v = xf.var(-1, unbiased=False, keepdim=True)
    return ((xf - m) * torch.rsqrt(v + 1e-5)).to(x.dtype)


def qkv(x: torch.Tensor, p: dict):
    """The block's q, k, v: (B, T, D) views of one projection."""
    h = layer_norm(x)
    return (h @ p["w_in"].T + p["b_in"]).chunk(3, dim=-1)


def attention(q, k, v, impl: str) -> torch.Tensor:
    B = q.shape[0]
    scale = HD ** -0.5
    if impl in ("full", "nosmax"):
        qh, kh, vh = (t.reshape(B, T, H, HD) for t in (q, k, v))
        a = torch.einsum("bqhc,bkhc->bhqk", qh * scale, kh)
        a = torch.softmax(a.float(), dim=-1).to(v.dtype) if impl == "full" else a * 1e-3
        return torch.einsum("bhqk,bkhc->bqhc", a, vh).reshape(B, T, D)
    if impl == "kernel":
        from boxfusion_tpu_torch.ops.attention_kernel import whole_seq_attention

        return whole_seq_attention(q, k, v, heads=H, sm_scale=scale)
    if impl == "mlponly":
        return v
    if impl == "flash":
        from torch.nn.attention import SDPBackend, sdpa_kernel

        qh, kh, vh = (t.reshape(B, T, H, HD).transpose(1, 2) for t in (q, k, v))
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            o = F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
        return o.transpose(1, 2).reshape(B, T, D)
    raise ValueError(f"unknown variant {impl!r}; one of {IMPLS}")


def block(x: torch.Tensor, p: dict, impl: str) -> torch.Tensor:
    """One residual block (the JAX tool's ``block``) with attention ``impl``."""
    q, k, v = qkv(x, p)
    x = x + attention(q, k, v, impl) @ p["w_out"]
    h = F.gelu(layer_norm(x) @ p["w_fc"], approximate="none")
    return x + h @ p["w_proj"]


def run(device=None, batches=ENGINE_BATCHES, layers=LAYERS, reps=4,
        verbose=True) -> Dict[int, Dict[str, Optional[float]]]:
    """ms per layer of each variant at each B (None: flash on the CPU)."""
    dev = resolve_device(device)
    out: Dict[int, Dict[str, Optional[float]]] = {}
    for B in batches:
        x0, p = inputs(B, dev)
        out[B] = {}
        if verbose:
            print(f"B = {B} (T {T}, D {D}, {H} heads, bfloat16, {layers} chained blocks a call)", flush=True)
        for impl in IMPLS:
            if impl == "flash" and dev.type != "cuda":
                out[B][impl] = None
                if verbose:
                    print(f"{impl:8s} needs a CUDA device (SDPA's flash backend); not timed on the CPU",
                          flush=True)
                continue
            x = [x0]

            def chained():
                y = x[0]
                for _ in range(layers):
                    y = block(y, p, impl)
                x[0] = y

            ms = timed_ms(chained, dev, reps) / layers
            if not torch.isfinite(x[0]).all():
                raise RuntimeError(f"{impl} at B = {B}: non-finite output")
            out[B][impl] = ms
            if verbose:
                print(f"{impl:8s} {ms:7.3f} ms/layer  (x{TOWER_LAYERS} = {ms * TOWER_LAYERS:6.1f} ms/tower)",
                      flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, nargs="+", default=list(ENGINE_BATCHES))
    ap.add_argument("--layers", type=int, default=LAYERS, help="chained blocks per timed call")
    ap.add_argument("--reps", type=int, default=4)
    a = ap.parse_args(argv)
    with torch.inference_mode():
        run(a.device, a.batch, a.layers, a.reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
