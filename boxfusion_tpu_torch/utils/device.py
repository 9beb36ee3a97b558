"""Device selection for the port's entry points.

Every entry point (``OnlinePipeline``, ``CuTRDetector``, ``optimize_boxes``,
``make_cutr``) runs on the GPU unless its caller names another device.  No
entry point falls back to the CPU when no GPU is present: it raises, so a
run that was meant for the card never silently measures the host.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; None means ``cuda``.

    Raises RuntimeError when a CUDA device is asked for (explicitly or by
    default) and ``torch.cuda.is_available()`` is false.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "boxfusion_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain-PyTorch path"
        )
    return dev


def refuse_autograd(what: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd would record ``what`` -- a hand-written kernel
    that defines no gradient -- on ``tensors``.

    The kernel writes its result into a fresh tensor outside autograd, so
    under grad mode the result would carry no ``grad_fn`` and backward would
    pass nothing through it, silently.  The JAX package defines no gradient
    for its Pallas kernels either.  Inference (``torch.no_grad``,
    ``torch.inference_mode``, or inputs that require no grad) passes.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the CUDA kernel defines no gradient, and an input requires one; "
            "run it under torch.no_grad() / torch.inference_mode(), or use the plain "
            "PyTorch path (CuTR attn_impl='xla'; CPU tensors run the plain twin)"
        )


class HostReads:
    """Count of device-to-host reads that steer control flow.

    Eager PyTorch has no on-device loop or branch: a loop that ends early or
    a stage that is skipped needs its predicate on the host, and on a CUDA
    device that read waits for everything enqueued before it.  Every such
    read in the device engine and in the optimizer's early exit goes through
    ``read``, so a run can say how many it paid for.
    """

    def __init__(self):
        self.count = 0

    def read(self, value: torch.Tensor):
        """``value`` on the host: a Python scalar for a 0-d tensor, else a
        list.  One read, whatever its size."""
        self.count += 1
        return value.tolist()


host_reads = HostReads()


def torch_dtype(dtype: Optional[Union[str, torch.dtype]]) -> torch.dtype:
    """'float32' / 'bfloat16' / a torch dtype -> torch dtype (None -> f32)."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[str(dtype)]
