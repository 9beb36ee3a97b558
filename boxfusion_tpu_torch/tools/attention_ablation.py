"""Attention ablation for the ViT global blocks: tiled softmax attention in
CUDA for Hopper, with its plain twin.

Port of ``tools/pallas_attention_ablation.py``.  ``tiled_attention`` replaces
the TPU kernel of that file (body ``_attn_kernel``): softmax attention over
(BH, N, D) slices, one per (batch x head), with no mask and no head packing.
Scores are accumulated in float32 and scaled by D^-0.5, the softmax runs in
float32, the probabilities are cast to v's type, the product with v is
accumulated in float32 and the output is cast to q's type.

The kernel (``csrc/tiled_attention_kernel.cu``) walks the keys once with a
running row maximum and sum (the online softmax).  bfloat16 runs both
products on the tensor cores (wgmma), fed by a producer warpgroup through a
ring of shared-memory slots; float32 runs FMA loops (never TF32) on K and V
tiles double-buffered by cp.async.  ``plan_tiled`` chooses the bfloat16
launch's consumer warpgroups and ring stages; the C entry lays out the rest.
``chip_smoke.py`` times it, ``whole_seq_attention`` on the same data,
``F.scaled_dot_product_attention`` and the plain twin at CuTR's global-block
shapes (12 heads, D = 64, N = 1024 at 512 px and N = 4096 at 1024 px);
PERF.md keeps the readings, with the card they were taken on.

History.  The port's first kernel here kept the Pallas body's exact
softmax, which holds K and V whole in fast memory; a block here cannot (1 MiB
each at N = 4096 in float32, against 227 KB of shared memory), so it took two
sweeps over the keys and computed q k^T twice, and it widened bfloat16 to
float32 FMA.  It measured (NVIDIA H100 80GB HBM3, 700 W; milliseconds for
two-sweep / online / SDPA / twin): float32 N = 1024 0.214 / 0.170 / 0.150 /
0.218, N = 4096 2.58 / 1.90 / 1.60 / 2.69; bfloat16 N = 1024 0.212 / 0.058 /
0.053 / 0.254, N = 4096 2.57 / 0.328 / 0.126 / 2.65.  Its results agreed
with the online form's to 5e-7 (float32) and 2e-3 (bfloat16): the exact form
bought no accuracy for its second product, so the kernel now computes the
same function in one online sweep.

On a CUDA tensor ``tiled_attention`` launches the kernel (built with nvcc at
first use, ops/build.py) and counts the launch in ``tiled_attention.launches``;
on a CPU tensor it runs ``reference_attention``.  There is no other path: a
CUDA tensor launches the kernel or raises.  Nothing in the package's models
calls this module: like its counterpart it is a record, kept runnable.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from boxfusion_tpu_torch.ops import build
from boxfusion_tpu_torch.utils.device import refuse_autograd

HEAD_DIMS = (16, 32, 64, 128)  # head widths the kernel is instantiated for
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# The kernel's tiles (csrc/tiled_attention_kernel.cu): 64 query rows (a
# consumer warpgroup's wgmma tile; the float32 block) and 64 keys (float32;
# bfloat16 with three consumers; 128 with two).  The card: an H100 SXM's SMs
# and the shared memory one block may use.
TILE = 64
NUM_SMS = 132
SMEM_LIMIT = 232_448
MAX_STAGES = 4  # ring slots of the bfloat16 kernel


@dataclasses.dataclass(frozen=True)
class TiledPlan:
    """The kernel's launch: grid (ceil(N / block_rows), BH) of blocks of
    ``warpgroups`` x 128 threads, ``stages`` K, V slots (float32: two
    buffers), ``smem_bytes`` of dynamic shared memory a block.  Only the
    bfloat16 plan's consumers (``warpgroups - 1``) and stages go to the C
    entry, which lays out the rest itself; ``kernel_info`` reads back what
    it laid out."""

    block_rows: int
    warpgroups: int
    stages: int
    smem_bytes: int


@functools.lru_cache(maxsize=None)
def plan_tiled(BH: int, N: int, HD: int, dtype: torch.dtype) -> TiledPlan:
    """The launch of ``tiled_attention`` on (BH, N, HD) tensors of ``dtype``.

    float32: one warpgroup a block owns 64 query rows; K and V tiles are
    double-buffered (2 stages).  bfloat16: a block is one producer warpgroup
    and two or three consumer warpgroups of 64 query rows each, one block per
    SM.  Three (key tiles of 64, 160 registers a consumer thread) where
    192-row blocks still give every SM of the card one and the head width is
    at most 64, else two (key tiles of 128, 232 registers): each K and V tile
    loaded then serves more query rows, and a third consumer's softmax runs
    under the others' products.  Timed on an H100, three consumers read
    faster than two at (12, 4096, 64), and two consumers in 96 blocks faster
    at (12, 1024, 64) than one consumer in 192 blocks: a full wave of blocks
    is not worth another load of K and V.  As many K, V slots as fit, up to
    ``MAX_STAGES``, no more than the key tiles (but at least 2).
    """
    if BH < 1 or N < 1 or HD not in HEAD_DIMS or dtype not in _DTYPE_CODE:
        raise ValueError(f"no plan for BH = {BH}, N = {N}, head width {HD}, {dtype}")
    if dtype == torch.float32:  # the kernel's one layout: Q, two (K, V) buffers, P; float rows padded by 4
        return TiledPlan(TILE, 1, 2, 4 * (5 * TILE * (HD + 4) + TILE * (TILE + 4)))
    consumers = 3 if HD <= 64 and -(-N // (3 * TILE)) * BH >= NUM_SMS else 2
    keys = 64 if consumers == 3 else 128

    def smem(stages):
        return (consumers * TILE + 2 * stages * keys) * HD * 2

    stages = max(2, min(MAX_STAGES, -(-N // keys)))
    while stages > 2 and smem(stages) > SMEM_LIMIT:
        stages -= 1
    return TiledPlan(consumers * TILE, consumers + 1, stages, smem(stages))


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


@functools.lru_cache(maxsize=None)
def _library():
    """The kernel library, built and its entry points typed once a process
    (typing them costs more host time than a launch at N = 1024)."""
    lib = build.load("tiled_attention_kernel")
    lib.tiled_attention_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.tiled_attention_launch.restype = ctypes.c_int
    lib.tiled_attention_info.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    lib.tiled_attention_info.restype = ctypes.c_int
    return lib


def _plan_args(BH: int, N: int, HD: int, dtype: torch.dtype) -> tuple:
    """(dtype code, consumers, stages) as the C entry takes them: float32
    takes no plan."""
    if dtype == torch.float32:
        return 0, 0, 0
    plan = plan_tiled(BH, N, HD, dtype)
    return _DTYPE_CODE[dtype], plan.warpgroups - 1, plan.stages


def kernel_info(BH: int, N: int, HD: int, dtype: torch.dtype) -> dict:
    """What the compiler, the occupancy calculator and the C entry's layout
    say of the kernel a launch at (BH, N, HD, dtype) runs: registers per
    thread at launch (the bfloat16 kernel's warpgroups then move them with
    setmaxnreg), local (spill + stack) bytes per thread, dynamic shared bytes
    per block, resident blocks per SM, query rows and warpgroups a block, K
    and V buffers, and the grid.  Needs a card (it loads the library)."""
    info = (ctypes.c_int * 7)()
    rc = _library().tiled_attention_info(HD, *_plan_args(BH, N, HD, dtype), info)
    if rc != 0:
        raise RuntimeError(f"tiled_attention_info failed: cudaError_t {rc}")
    return dict(registers=info[0], local_bytes=info[1], smem_bytes=info[2], blocks_per_sm=info[3],
                block_rows=info[4], warpgroups=info[5], stages=info[6], grid=-(-N // info[4]) * BH)


def tiled_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    block_q: int = 256) -> torch.Tensor:
    """Softmax attention in one launch (one online sweep over the keys).

    Args:
      q, k, v: (BH, N, D) -- batch*heads leading, D = head_dim, one of
        ``HEAD_DIMS``; all float32 or all bfloat16, on one device.  N is
        free: nothing is padded in device memory.
      block_q: the TPU kernel's query tile, kept for the signature.  The
        result does not depend on it; ``plan_tiled`` sets a block's rows.

    Returns:
      (BH, N, D) in q's dtype, contiguous.  On a CUDA device the launch is
      asynchronous on the current stream.  The kernel defines no gradient:
      on a CUDA device, under grad mode with an input that requires grad, it
      raises RuntimeError (``utils/device.py:refuse_autograd``).
    """
    _check_args(q, k, v, block_q)
    if q.device.type == "cpu":
        return reference_attention(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"tiled_attention runs on cuda or cpu tensors, got {q.device}")
    refuse_autograd("tiled_attention", q, k, v)
    BH, N, D = q.shape
    if BH > 65535:
        raise ValueError(f"at most 65535 slices per launch, got {BH}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):  # the current device: q's, and so is the current stream
        rc = _library().tiled_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, N, D, D ** -0.5,
            *_plan_args(BH, N, D, q.dtype), torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"tiled_attention kernel launch failed: cudaError_t {rc}")
    tiled_attention.launches += int(BH > 0 and N > 0)  # the C entry launches nothing for no work
    return out


tiled_attention.launches = 0
