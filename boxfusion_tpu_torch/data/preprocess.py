"""Frame preprocessing: pixel normalization, depth whitening, square padding.

Port of ``boxfusion_tpu/data/preprocess.py``.  Capability target:
``Augmentor`` / ``Preprocessor`` (reference boxfusion/preprocessor.py:39-217)
and ``ImageList.from_tensors`` square-pad bucketing (reference
imagelist.py:54-115).  The reference computes the 10%-trimmed depth
whitening on the CPU per frame; here it is a sort on the device the frame
was uploaded to.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from boxfusion_tpu_torch.models.cutr.model import PIXEL_MEAN, PIXEL_STD, FrameBatch
from boxfusion_tpu_torch.utils.device import DeviceLike, device_constant, resolve_device

# Reference bucket list (preprocessor.py:86, imagelist.py:87-97).
SQUARE_PAD_BUCKETS = (256, 384, 512, 640, 768, 896, 1024)


def pick_square_pad(longest_edge: int, buckets=SQUARE_PAD_BUCKETS) -> int:
    """Smallest bucket >= longest edge (preprocessor.py:178-183)."""
    for b in buckets:
        if b >= longest_edge:
            return int(b)
    raise ValueError(f"image long side {longest_edge} exceeds buckets {buckets}")


def standardize_depth(depth: torch.Tensor, trunc_value: float = 0.1):
    """Per-frame trimmed-whitening of a depth map (preprocessor.py:97-129).

    Invalid (<= 0) pixels become NaN, the valid values are sorted, the top and
    bottom 10% are trimmed, and the map is standardized by the trimmed
    mean / sqrt(var + 1e-2); NaNs are replaced by the mean (-> 0 after
    standardization).

    Args:
      depth: (H, W) raw metric depth, float32.

    Returns:
      (whitened (H, W), params (2,) = (mean, std)).
    """
    flat = depth.reshape(-1)
    n = flat.shape[0]
    valid = flat > 0.0
    n_valid = valid.sum().to(torch.float32)

    # sort with invalids pushed to the end (NaN-at-end of torch.sort)
    s = torch.sort(torch.where(valid, flat, torch.inf)).values

    lo = (trunc_value * n_valid).to(torch.int32)
    hi = ((1.0 - trunc_value) * n_valid).to(torch.int32)
    idx = torch.arange(n, device=depth.device)
    in_trim = (idx >= lo) & (idx < hi)
    count = torch.clamp(in_trim.sum(), min=1).to(torch.float32)

    mean = torch.where(in_trim, s, 0.0).sum() / count
    # unbiased variance like torch.var (preprocessor.py:117)
    var = torch.where(in_trim, (s - mean) ** 2, 0.0).sum() / torch.clamp(count - 1, min=1)
    std = torch.sqrt(var + 1e-2)

    # degenerate guard (preprocessor.py:111-114)
    degenerate = (hi - lo) <= 1
    mean = torch.where(degenerate, 0.0, mean)
    std = torch.where(degenerate, 1.0, std)

    out = (torch.where(depth > 0.0, depth, mean) - mean) / std
    return out, torch.stack([mean, std])


# The reference normalizes with `pixel_mean.to(measurement.data)` where
# `data` is still the raw uint8 image (preprocessor.py:142), so the float
# constants get uint8-TRUNCATED before use.  Mirrored for activation parity.
PIXEL_MEAN_U8 = PIXEL_MEAN.astype(np.uint8).astype(np.float32)
PIXEL_STD_U8 = PIXEL_STD.astype(np.uint8).astype(np.float32)


def package_frame(
    image_u8: torch.Tensor,
    depth: Optional[torch.Tensor],
    K: torch.Tensor,
    T_gravity: torch.Tensor,
    square: int,
    ratio: int,
) -> FrameBatch:
    """One frame, already on its device -> a batch of one (NHWC, padded)."""
    h, w = image_u8.shape[0], image_u8.shape[1]
    dev = image_u8.device
    mean = device_constant(PIXEL_MEAN_U8, dev)
    std = device_constant(PIXEL_STD_U8, dev)
    img = (image_u8.to(torch.float32) - mean) / std
    img = F.pad(img, (0, 0, 0, square - w, 0, square - h))

    if depth is not None:
        dh, dw = depth.shape
        dsq = square // ratio
        white, params = standardize_depth(depth)
        white = F.pad(white, (0, dsq - dw, 0, dsq - dh))
        depth_out = white[None, :, :, None]
        params_out = params[None]
    else:
        depth_out = None
        params_out = torch.zeros((1, 2), dtype=torch.float32, device=dev)

    return FrameBatch(
        image=img[None],
        depth=depth_out,
        K=K[None],
        image_hw=device_constant([[h, w]], dev),
        depth_params=params_out,
        T_gravity=T_gravity[None],
    )


def resolve_pad_and_ratio(image, depth, buckets=SQUARE_PAD_BUCKETS):
    """(square_pad, rgb:depth ratio) for one frame -- the reference's bucket
    rule (imagelist.py:87-97) + ratio constraint (preprocessor.py:163-166)."""
    h, w = image.shape[:2]
    square = pick_square_pad(max(h, w), buckets)
    if depth is not None:
        ratio = round(w / depth.shape[1])
        if ratio not in (1, 2, 4):
            raise ValueError(f"Unsupported rgb -> depth ratio: {ratio}")
    else:
        ratio = 1
    return square, ratio


class Preprocessor:
    """Host-facing preprocessor: numpy frame -> FrameBatch on ``device``.

    Mirrors the reference's normalize+batch pipeline (preprocessor.py:131-217)
    with the {256..1024} square-pad buckets and the rgb:depth ratio rule.
    """

    def __init__(self, buckets=SQUARE_PAD_BUCKETS, device: DeviceLike = None):
        self.buckets = buckets
        self.device = resolve_device(device)

    def __call__(
        self,
        image: np.ndarray,
        depth: Optional[np.ndarray],
        K: np.ndarray,
        T_gravity: np.ndarray,
    ) -> Tuple[FrameBatch, int, int]:
        """Args: image (H, W, 3) uint8 (oriented); depth (Hd, Wd) metric;
        K (3, 3) at image resolution; T_gravity (3, 3).

        Returns (FrameBatch, square, ratio)."""
        square, ratio = resolve_pad_and_ratio(image, depth, self.buckets)
        dev = self.device
        batch = package_frame(
            torch.as_tensor(np.ascontiguousarray(image), device=dev),
            torch.as_tensor(np.asarray(depth, np.float32), device=dev) if depth is not None else None,
            torch.as_tensor(np.asarray(K, np.float32), device=dev),
            torch.as_tensor(np.asarray(T_gravity, np.float32), device=dev),
            square,
            ratio,
        )
        return batch, square, ratio
