"""A residual add and the LayerNorm after it in one launch: CUDA for Hopper,
with its plain twin.

``add_layer_norm(x, d, weight, bias, eps)`` returns ``(s, y)``:
``s = x + d`` in x's dtype (``s`` is ``x`` when ``d`` is None) and ``y`` the
LayerNorm of ``s`` over its last axis, in x's dtype: float32 statistics,
biased variance, float32 ``weight`` and ``bias`` -- what
``models/cutr/layers.py:LayerNorm`` computes (``F.layer_norm(s.float(),
...)``, cast back).  The image towers' blocks call it twice a block
(``models/clip/model.py:add_norm``).

On a CUDA tensor it launches ``csrc/layer_norm_kernel.cu`` (built with nvcc
at first use, ops/build.py) and counts the launch in
``add_layer_norm.launches``: bfloat16 rows only, one pass that reads x and d
and writes s and y (8 bytes an element; 4 without d), where the twin's four
launches move 26.  ``s`` is bit-equal to the twin's (one rounding of the
float32 sum, as PyTorch's add); ``y`` is within one bfloat16 ulp of it (the
float32 statistics are summed in another order).  On a CPU tensor it runs
``add_layer_norm_reference``.  There is no other path: a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from boxfusion_tpu_torch.ops import build
from boxfusion_tpu_torch.utils.device import refuse_autograd

MAX_WIDTH = 1280  # the kernel's widths: multiples of 8 up to this (csrc/layer_norm_kernel.cu)


def add_layer_norm_reference(x: torch.Tensor, d: Optional[torch.Tensor], weight: torch.Tensor,
                             bias: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin: the add in x's dtype, then ``LayerNorm``'s
    float32 norm, cast to x's dtype."""
    s = x if d is None else x + d
    y = F.layer_norm(s.float(), (s.shape[-1],), weight, bias, eps)
    return s, y.to(x.dtype)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the kernel can read it in place (contiguous, 16-byte aligned),
    else a fresh contiguous copy."""
    return t if t.is_contiguous() and t.data_ptr() % 16 == 0 else t.clone(memory_format=torch.contiguous_format)


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load("layer_norm_kernel")
    lib.add_layer_norm_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    lib.add_layer_norm_launch.restype = ctypes.c_int
    lib.add_layer_norm_info.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.add_layer_norm_info.restype = ctypes.c_int
    return lib


def kernel_info(width: int, residual: bool = True) -> dict:
    """What the compiler says of the kernel a launch at ``width`` runs:
    registers and local (spill + stack) bytes per thread, static and dynamic
    shared bytes, threads and rows a block.  Needs a card (it loads the
    library)."""
    info = (ctypes.c_int * 6)()
    rc = _library().add_layer_norm_info(width, int(residual), info)
    if rc != 0:
        raise RuntimeError(f"add_layer_norm_info failed: cudaError_t {rc}")
    return dict(registers=info[0], local_bytes=info[1], smem_bytes=info[2], threads=info[3],
                dynamic_smem_bytes=info[4], rows_per_block=info[5])


def add_layer_norm(x: torch.Tensor, d: Optional[torch.Tensor], weight: torch.Tensor,
                   bias: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x + d, LayerNorm(x + d))``, or ``(x, LayerNorm(x))`` without ``d``.

    Args:
      x, d: (..., D) of one dtype and shape, on one device (``d`` may be None).
      weight, bias: (D,) float32.  eps: the norm's epsilon.

    Returns:
      (s, y), both (..., D) in x's dtype; on a CUDA device ``y`` and (with
      ``d``) ``s`` are fresh contiguous tensors and the launch is
      asynchronous on the current stream.  On a CUDA device x must be
      bfloat16 and D a multiple of 8 up to ``MAX_WIDTH``; the kernel defines
      no gradient, so under grad mode with an input that requires grad it
      raises RuntimeError (``utils/device.py:refuse_autograd``).
    """
    D = x.shape[-1]
    if d is not None and (d.shape != x.shape or d.dtype != x.dtype or d.device != x.device):
        raise ValueError(f"d must match x: {tuple(d.shape)} {d.dtype} {d.device} against "
                         f"{tuple(x.shape)} {x.dtype} {x.device}")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.shape != (D,) or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"{name} must be ({D},) float32 on {x.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if x.device.type == "cpu":
        return add_layer_norm_reference(x, d, weight, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"add_layer_norm runs on cuda or cpu tensors, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"add_layer_norm's kernel takes bfloat16 rows, got {x.dtype}")
    if D % 8 != 0 or not 0 < D <= MAX_WIDTH:
        raise ValueError(f"add_layer_norm's kernel takes widths that are multiples of 8 up to "
                         f"{MAX_WIDTH}, got {D}")
    refuse_autograd("add_layer_norm", *(t for t in (x, d, weight, bias) if t is not None))
    x, weight, bias = _aligned(x), _aligned(weight), _aligned(bias)
    y = torch.empty_like(x)
    s = x
    if d is not None:
        d = _aligned(d)
        s = torch.empty_like(x)
    rows = x.numel() // D
    with torch.cuda.device(x.device):
        rc = _library().add_layer_norm_launch(
            x.data_ptr(), None if d is None else d.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            s.data_ptr(), y.data_ptr(), rows, D, float(eps),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"add_layer_norm kernel launch failed: cudaError_t {rc}")
    add_layer_norm.launches += int(rows > 0)  # the C entry launches nothing for no rows
    return s, y


add_layer_norm.launches = 0
