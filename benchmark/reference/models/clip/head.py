"""Open-vocabulary labeling head: CLIP crops vs precomputed text features.

Port of ``boxfusion_tpu/models/clip/head.py``.  Capability target: the
reference's per-keyframe labeling path (tools/utils.py:355-494 +
demo.py:161-171):

  * ``scale_boxes`` x1.5 around fixed centers (tools/utils.py:355-381);
  * crop each detection, resize to the tower's crop size (224x224 for
    CLIP; zero-size crops -> black, tools/utils.py:395), batch-encode;
  * cosine scores ``100 * img @ text.T`` against the precomputed class
    features, with an appended "background" column at ``sim_thres`` so
    low-similarity boxes get the empty label and are dropped
    (tools/utils.py:478-494).

Crop + resize is one batched pass on the device: per box and per axis a
crop-size x size interpolation matrix, contracted with the image by two matrix
products (the construction of ``jax.image.scale_and_translate`` with
``method="bilinear", antialias=False``, which is neither ``F.interpolate``
nor ``F.grid_sample``: triangle-kernel weights at half-pixel centres,
normalised over the in-bounds taps, zero where the sample falls outside the
input).  The similarity product runs in full float32 (the package turns
TF32 off at import): label argmax ties need it.
"""
from __future__ import annotations

import numpy as np
import torch

_F32_EPS = float(np.finfo(np.float32).eps)


def scale_boxes(boxes, H, W, scale: float = 1.2):
    """Scale xyxy boxes about their centers, clipped to the image
    (tools/utils.py:355-381).  Works on numpy arrays or torch tensors."""
    cx = (boxes[:, 0] + boxes[:, 2]) / 2
    cy = (boxes[:, 1] + boxes[:, 3]) / 2
    w = (boxes[:, 2] - boxes[:, 0]) * scale
    h = (boxes[:, 3] - boxes[:, 1]) * scale
    cols = [(cx - w / 2, W), (cy - h / 2, H), (cx + w / 2, W), (cy + h / 2, H)]
    if isinstance(boxes, torch.Tensor):
        def clip(x, hi):
            hi = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
            return torch.minimum(torch.clamp(x, min=0), hi)

        return torch.stack([clip(x, hi) for x, hi in cols], dim=1)
    return np.stack([np.clip(x, 0, hi) for x, hi in cols], axis=1)


def _interp_matrix(in_size: int, scale: torch.Tensor, translation: torch.Tensor,
                   out_size: int) -> torch.Tensor:
    """(N, out_size, in_size) bilinear weights of ``out = scale * in + translation``.

    Row a of box n holds the weights of output pixel a over the input pixels:
    the triangle kernel around the sample position (half-pixel centres),
    normalised over the taps that exist, and all zero when the sample lies
    outside the input."""
    dev = scale.device
    inv = 1.0 / scale
    out_pos = torch.arange(out_size, dtype=torch.float32, device=dev)
    sample = (out_pos[None] + 0.5) * inv[:, None] - translation[:, None] * inv[:, None] - 0.5
    taps = torch.arange(in_size, dtype=torch.float32, device=dev)
    w = torch.clamp(1.0 - (sample[:, :, None] - taps[None, None, :]).abs(), min=0.0)
    total = w.sum(-1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _F32_EPS, w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, :, None], w, 0.0)


def batched_crop_resize(image: torch.Tensor, boxes: torch.Tensor, size: int) -> torch.Tensor:
    """Crop + bilinear-resize every box to size x size in one batched device pass.

    Args:
      image: (H, W, 3) float tensor in [0, 255] (float32, or bfloat16 for a
        bfloat16 tower: the interpolation then runs in bfloat16).
      boxes: (N, 4) xyxy float tensor on the image's device.  Degenerate
        boxes produce black crops (tools/utils.py:395).

    Returns:
      (N, size, size, 3) crops in the image's dtype.
    """
    H, W, C = image.shape
    boxes = boxes.to(torch.float32)
    # integer crop bounds like the reference's array slicing
    x1, y1, x2, y2 = (torch.floor(boxes[:, i]) for i in range(4))
    w, h = x2 - x1, y2 - y1
    ok = (w > 0) & (h > 0)
    sw = size / torch.clamp(w, min=1.0)
    sh = size / torch.clamp(h, min=1.0)
    mh = _interp_matrix(H, sh, -y1 * sh, size).to(image.dtype)  # (N, size, H)
    mw = _interp_matrix(W, sw, -x1 * sw, size).to(image.dtype)  # (N, size, W)
    N = boxes.shape[0]
    rows = (mh @ image.reshape(H, W * C)).reshape(N, size, W, C)    # rows resized
    out = torch.einsum("nbw,nawc->nabc", mw, rows)                  # then columns
    return torch.where(ok[:, None, None, None], out, 0.0)


def _crop_normalize(image: torch.Tensor, boxes: torch.Tensor, dtype: torch.dtype, size: int,
                    mean: np.ndarray, std: np.ndarray) -> torch.Tensor:
    """Crop + resize to size x size + normalize by ``mean`` and ``std`` (of
    [0, 1] pixels: CLIP's for its towers) in the tower's compute dtype.

    With a bfloat16 tower the image is cast to bfloat16 BEFORE the
    interpolation (the two matrix products then run in bfloat16; the pixel
    error stays below the bfloat16 tower's own rounding).  float32 towers
    (all CPU parity tests) keep the exact float32 path."""
    if dtype == torch.bfloat16:
        image = image.to(torch.bfloat16)
    crops = batched_crop_resize(image, boxes, size)
    dt, dev = crops.dtype, crops.device
    mean = torch.as_tensor(mean, dtype=dt, device=dev)
    std = torch.as_tensor(std, dtype=dt, device=dev)
    return (crops / 255.0 - mean) / std
