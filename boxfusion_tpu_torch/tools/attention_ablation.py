"""Attention ablation for the ViT global blocks: an exact two-sweep softmax
kernel in CUDA for Hopper, with its plain twin.

Port of ``tools/pallas_attention_ablation.py``.  ``tiled_attention`` replaces
the TPU kernel of that file (body ``_attn_kernel``): softmax attention over
(BH, N, D) slices, one per (batch x head), with no mask and no head packing.
Scores are accumulated in float32 and scaled by D^-0.5, the softmax runs in
float32 against the row's true maximum, the probabilities are cast to v's
type, the product with v is accumulated in float32 and the output is cast to
q's type.

The question the record answers.  The package's own attention kernel
(``ops/attention_kernel.py:whole_seq_attention``) walks the keys once with a
running maximum and rescales its partial output at every key tile.  The TPU
kernel this file ports avoided that by holding a slice's whole K and V in fast
memory; a thread block on this card cannot (1 MiB each at N = 4096 in
float32, against 227 KB of shared memory), so the same exact softmax takes
two sweeps over the keys: one for the row maximum, one for the probabilities,
their sum and the weighted sum of V.  It computes q k^T twice and rescales
nothing (``csrc/tiled_attention_kernel.cu``).  ``chip_smoke.py`` times both
kernels, ``F.scaled_dot_product_attention`` and the plain twin on the same
data at CuTR's global-block shapes (12 heads, D = 64, N = 1024 at 512 px and
N = 4096 at 1024 px) and prints the record; PERF.md keeps the readings, with
the card they were taken on.

MEASURED (``chip_smoke.py`` on an NVIDIA H100 80GB HBM3 at 700 W, 12 slices,
D = 64; milliseconds for two-sweep / online / SDPA / plain twin):

  * float32, N = 1024: 0.214 / 0.170 / 0.150 / 0.218;  N = 4096: 2.58 / 1.90 /
    1.60 / 2.69.  Both kernels are float32 FMA loops from shared memory; the
    second q k^T costs the two-sweep kernel 26-36%, more than the online
    kernel's rescaling of a 64 x 64 output tile per key tile costs it.
  * bfloat16, N = 1024: 0.212 / 0.058 / 0.053 / 0.254;  N = 4096: 2.57 / 0.328 /
    0.126 / 2.65.  The online kernel runs on the tensor cores; this one widens
    to float32 and stays on FMA, so it does not gain from the narrower type.

DECISION: the exact softmax buys nothing on this card.  Its two results agree
with the online kernel's to 5e-7 (float32) and 2e-3 (bfloat16), so the running
rescale costs no accuracy that would pay for a second product.  The record
stays, as in the JAX package, where the same kernel lost to the compiler's
fused attention; the package's models keep ``whole_seq_attention``.

On a CUDA tensor ``tiled_attention`` launches the kernel (built with nvcc at
first use, ops/build.py) and counts the launch in ``tiled_attention.launches``;
on a CPU tensor it runs ``reference_attention``.  There is no other path: a
CUDA tensor launches the kernel or raises.  Nothing in the package's models
calls this module: like its counterpart it is a record, kept runnable.
"""
from __future__ import annotations

import ctypes

import torch

from boxfusion_tpu_torch.ops import build

HEAD_DIMS = (16, 32, 64, 128)  # head widths the kernel is instantiated for
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin: einsum scores, float32 softmax, einsum with v."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqc,bkc->bqk", q, k).float() * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bqk,bkc->bqc", p, v).to(q.dtype)


def _check_args(q, k, v, block_q: int) -> None:
    if q.dim() != 3:
        raise ValueError(f"q must be (BH, N, D), got {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(f"{name} must have q's shape {tuple(q.shape)}, got {tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q, k, v must be float32 or bfloat16, got {q.dtype}")
    if q.shape[2] not in HEAD_DIMS:
        raise ValueError(f"head width {q.shape[2]} is not one of {HEAD_DIMS}")
    if block_q <= 0:
        raise ValueError(f"block_q must be positive, got {block_q}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, as the kernel's vector loads need."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launcher():
    fn = build.load("tiled_attention_kernel").tiled_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def tiled_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    block_q: int = 256) -> torch.Tensor:
    """Softmax attention with an exact (two-sweep) softmax, one launch.

    Args:
      q, k, v: (BH, N, D) -- batch*heads leading, D = head_dim, one of
        ``HEAD_DIMS``; all float32 or all bfloat16, on one device.  N is
        free: nothing is padded in device memory.
      block_q: the TPU kernel's query tile, kept for the signature.  The
        result does not depend on it; a thread block here owns 64 query rows.

    Returns:
      (BH, N, D) in q's dtype, contiguous.  On a CUDA device the launch is
      asynchronous on the current stream.
    """
    _check_args(q, k, v, block_q)
    if q.device.type == "cpu":
        return reference_attention(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"tiled_attention runs on cuda or cpu tensors, got {q.device}")
    BH, N, D = q.shape
    if BH > 65535:
        raise ValueError(f"at most 65535 slices per launch, got {BH}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty((BH, N, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = _launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            BH, N, D, float(D ** -0.5), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"tiled_attention kernel launch failed: cudaError_t {rc}")
    tiled_attention.launches += 1
    return out


tiled_attention.launches = 0
