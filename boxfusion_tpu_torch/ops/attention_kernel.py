"""Whole-sequence multi-head attention: CUDA for Hopper, with its plain twin.

``whole_seq_attention`` replaces the TPU kernel ``boxfusion_tpu/ops/
attention_kernel.py:whole_seq_attention`` (body ``_kernel``): full attention
without a mask over (B, T, D) tensors whose heads are packed along the channel
axis (head h = columns [h*hd, (h+1)*hd)).  Scores are accumulated in float32
and scaled, the softmax runs in float32, the probabilities are cast to v's
type, and the product with v is accumulated in float32.

On a CUDA tensor it launches ``csrc/attention_kernel.cu`` (built with nvcc at
first use, ops/build.py) and counts the launch in
``whole_seq_attention.launches``; on a CPU tensor it runs
``whole_seq_attention_reference``, the einsum + float32-softmax form of the
CLIP block.  There is no other path: a CUDA tensor launches the kernel or
raises.

Blocks.  float32 runs the FMA kernel, one block per 64 query rows of a
(sequence, head).  bfloat16 runs the wgmma kernel on the blocks that
``plan_bf16`` lays out: query tiles of at most 64 rows, two warpgroups a
block, K and V resident in shared memory or streaming through a ring.

Strides.  The kernel takes a batch stride and a row stride per tensor, so the
three ``chunk`` views of one (B, T, 3D) qkv tensor are read where they lie.
A tensor whose channel axis is not contiguous, or whose rows are not 16-byte
aligned, is made contiguous first.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from boxfusion_tpu_torch.ops import build
from boxfusion_tpu_torch.utils.device import refuse_autograd

HEAD_DIMS = (16, 32, 64, 72, 80, 128)  # head widths the kernel is instantiated for
# the C entry's type codes: float32 runs the FMA kernel (full float32, no
# TF32), bfloat16 the wgmma kernel (float32 accumulators)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# The bfloat16 kernel's tiles (csrc/attention_kernel.cu): 64 query rows (the
# wgmma's M) and 64 keys; warpgroups a block; the shared memory one block may
# use on Hopper; the most a block takes to keep a head's K and V resident, so
# that two blocks share an SM.
TILE = 64
WARPGROUPS = 2
SMEM_LIMIT = 232_448
RESIDENT_BYTES = SMEM_LIMIT // 2 - 1024
MAX_RESIDENT_TILES = 5  # key tiles a block holds at once (its wait on cp.async groups)
STAGES = 3              # K, V slots when they stream


def padded_width(hd: int) -> int:
    """Channels of one of the bfloat16 kernel's shared tiles: the head width
    rounded up to wgmma's 16-channel step (72 -> 80, whose last 8 are zeros
    in shared memory; every other head width is its own)."""
    return -(-hd // 16) * 16


@dataclasses.dataclass(frozen=True)
class Plan:
    """The bfloat16 kernel's launch: grid (n_groups, heads, B) of blocks of
    ``WARPGROUPS`` warpgroups; the kernel cuts the T query rows of a
    (sequence, head) into ``n_qtiles`` near-equal tiles and gives each block a
    near-equal run of them, which its warpgroups take in turn, one each a
    round; ``stages`` K, V slots; ``smem_bytes`` of shared memory a block."""

    n_qtiles: int
    n_groups: int
    stages: int
    smem_bytes: int


def plan_bf16(T: int, hd: int) -> Plan:
    """Blocks of the bfloat16 kernel for sequences of T tokens, head width hd.

    The T query rows of a (sequence, head) fall into ``ceil(T / 64)`` tiles
    (at T = 257: 51 or 52 rows), so no tile exists for a few tail rows.  If
    the head's K and V tiles (at most 5) fit beside two Q tiles per
    warpgroup in ``RESIDENT_BYTES`` (T = 257 at hd 64: 112 KiB; a tile is
    ``padded_width(hd)`` channels wide), one block
    walks all the query tiles and loads K and V once; otherwise each block
    takes two or three tiles (at least half of the rows its rounds could
    hold) and K and V stream through ``STAGES`` slots (fewer if they would
    not fit).
    """
    if T < 1 or hd not in HEAD_DIMS:
        raise ValueError(f"no plan for T = {T}, head width {hd}")
    n_kt = -(-T // TILE)

    def plan(stages, groups):
        return Plan(n_kt, groups, stages, (2 * WARPGROUPS + 2 * stages) * TILE * padded_width(hd) * 2)

    resident = plan(max(n_kt, 2), 1)
    if n_kt <= MAX_RESIDENT_TILES and resident.smem_bytes <= RESIDENT_BYTES:
        return resident
    groups = max(1, n_kt // WARPGROUPS)
    stages = max(2, min(STAGES, n_kt))
    while stages > 2 and plan(stages, groups).smem_bytes > RESIDENT_BYTES:
        stages -= 1
    return plan(stages, groups)


def whole_seq_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  heads: int, sm_scale: float) -> torch.Tensor:
    """Plain PyTorch twin: q pre-scaled in the compute type, scores in the
    compute type, softmax in float32, probabilities cast to v's type."""
    B, T, D = q.shape
    hd = D // heads
    qh = (q * sm_scale).reshape(B, T, heads, hd).transpose(1, 2)  # (B, h, T, c)
    kh = k.reshape(B, T, heads, hd).permute(0, 2, 3, 1)           # (B, h, c, T)
    vh = v.reshape(B, T, heads, hd).transpose(1, 2)
    a = torch.softmax((qh @ kh).float(), dim=-1).to(v.dtype)
    return (a @ vh).transpose(1, 2).reshape(B, T, D)


def _check_args(q, k, v, heads: int) -> int:
    if q.dim() != 3:
        raise ValueError(f"q must be (B, T, D), got {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(f"{name} must have q's shape {tuple(q.shape)}, got {tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q, k, v must be float32 or bfloat16, got {q.dtype}")
    D = q.shape[2]
    if heads <= 0 or D % heads != 0:
        raise ValueError(f"D = {D} is not a multiple of heads = {heads}")
    hd = D // heads
    if hd not in HEAD_DIMS:
        raise ValueError(f"head width {hd} is not one of {HEAD_DIMS}")
    return hd


def _strided(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself if the kernel can read it in place, else a contiguous copy."""
    per16 = 16 // t.element_size()
    ok = (t.stride(2) == 1 and t.stride(0) % per16 == 0 and t.stride(1) % per16 == 0
          and t.data_ptr() % 16 == 0)
    return t if ok else t.contiguous()


def _library():
    lib = build.load("attention_kernel")
    lib.whole_seq_attention_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
           ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    lib.whole_seq_attention_launch.restype = ctypes.c_int
    lib.whole_seq_attention_info.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.whole_seq_attention_info.restype = ctypes.c_int
    return lib


def kernel_info(T: int, hd: int, dtype: torch.dtype) -> dict:
    """What the compiler and the occupancy calculator say of the kernel a
    launch at (T, hd, dtype) runs: registers and local (spill + stack) bytes
    per thread, dynamic shared bytes per block, resident blocks per SM; for
    bfloat16 also the plan.  Needs a card (it loads the library)."""
    bf16 = dtype == torch.bfloat16
    plan = plan_bf16(T, hd) if bf16 else None
    info = (ctypes.c_int * 4)()
    rc = _library().whole_seq_attention_info(hd, _DTYPE_CODE[dtype], plan.smem_bytes if bf16 else 0, info)
    if rc != 0:
        raise RuntimeError(f"whole_seq_attention_info failed: cudaError_t {rc}")
    out = dict(registers=info[0], local_bytes=info[1], smem_bytes=info[2], blocks_per_sm=info[3])
    if bf16:
        out.update(n_qtiles=plan.n_qtiles, n_groups=plan.n_groups, stages=plan.stages)
    return out


def whole_seq_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        heads: int, sm_scale: float) -> torch.Tensor:
    """Full (non-causal) multi-head attention, one launch for all sequences.

    Args:
      q, k, v: (B, T, D) with D = heads * head_dim, all float32 or all
        bfloat16, on one device; head_dim one of ``HEAD_DIMS``.
      heads: head count.  sm_scale: score scale (usually head_dim ** -0.5).

    Returns:
      (B, T, D) in q's dtype, contiguous.  On a CUDA device the launch is
      asynchronous on the current stream.  The kernel defines no gradient:
      on a CUDA device, under grad mode with an input that requires grad, it
      raises RuntimeError (``utils/device.py:refuse_autograd``).
    """
    hd = _check_args(q, k, v, heads)
    if q.device.type == "cpu":
        return whole_seq_attention_reference(q, k, v, heads, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"whole_seq_attention runs on cuda or cpu tensors, got {q.device}")
    refuse_autograd("whole_seq_attention", q, k, v)
    B, T, D = q.shape
    if B > 65535:
        raise ValueError(f"at most 65535 sequences per launch, got {B}")
    q, k, v = _strided(q), _strided(k), _strided(v)
    out = torch.empty((B, T, D), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 8)(
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), out.stride(0), out.stride(1),
    )
    plan = (ctypes.c_int * 4)()  # float32: unused
    if q.dtype == torch.bfloat16:
        plan[:] = dataclasses.astuple(plan_bf16(T, hd))
    with torch.cuda.device(q.device):
        rc = _library().whole_seq_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, T, heads, hd, strides, float(sm_scale), _DTYPE_CODE[q.dtype], plan,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"whole_seq_attention kernel launch failed: cudaError_t {rc}")
    whole_seq_attention.launches += int(B > 0 and T > 0)  # the C entry launches nothing for no work
    return out


whole_seq_attention.launches = 0
