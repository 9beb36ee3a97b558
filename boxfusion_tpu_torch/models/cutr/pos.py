"""Camera-ray positional embedding (reference boxfusion/pos.py:61-186).

Port of ``boxfusion_tpu/models/cutr/pos.py``.  The reference generates
per-pixel ray directions at full image resolution, zero-pads to the square
pad size, then nearest-downsamples to the feature resolution; nearest
interpolation with integer stride 16 samples exactly the pixel at
(16*i, 16*j), so rays are generated directly at those pixels.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from boxfusion_tpu_torch.models.cutr.layers import Linear
from boxfusion_tpu_torch.utils.device import device_constant


def ray_directions_at_features(
    K: torch.Tensor, image_hw: torch.Tensor, feat_size: int, stride: int = 16
) -> torch.Tensor:
    """Unit ray directions sampled at feature-cell origins.

    Args:
      K: (B, 3, 3) intrinsics at actual image resolution.
      image_hw: (B, 2) actual (H, W) of the (unpadded) images.
      feat_size: F (padded square size / stride).

    Returns:
      (B, F, F, 3) unit rays; zero where the sample falls in the pad region.
    """
    px = torch.arange(feat_size, dtype=torch.float32, device=K.device) * stride + 0.5
    gx = px[None, None, :].expand(1, feat_size, feat_size)
    gy = px[None, :, None].expand(1, feat_size, feat_size)
    fx, fy = K[:, 0, 0, None, None], K[:, 1, 1, None, None]
    cx, cy = K[:, 0, 2, None, None], K[:, 1, 2, None, None]
    rx = (gx - cx) / fx
    ry = (gy - cy) / fy
    rays = torch.stack([rx, ry, torch.ones_like(rx)], dim=-1)
    norm = torch.sqrt((rays * rays).sum(-1, keepdim=True))
    rays = rays / torch.clamp(norm, min=1e-12)

    h, w = image_hw[:, 0, None, None, None], image_hw[:, 1, None, None, None]
    valid = (gy[..., None] - 0.5 < h) & (gx[..., None] - 0.5 < w)
    return torch.where(valid, rays, 0.0)


def fourier_features(x: torch.Tensor, dim: int, max_freq: float) -> torch.Tensor:
    """Log-spaced sin Fourier features (pos.py:110-149, use_log=True).

    Args:
      x: (..., D_in) in [-1, 1].
      dim: channel budget; num_bands = dim // D_in.

    Returns:
      (..., D_in * num_bands).
    """
    d_in = x.shape[-1]
    num_bands = dim // d_in
    scales = 2.0 ** np.linspace(0.0, np.log2(max_freq), num_bands)
    scales = device_constant(scales, x.device, x.dtype)
    xs = x[..., None] * scales * np.pi
    return torch.sin(xs).reshape(*x.shape[:-1], d_in * num_bands)


class CameraRayEmbedding(nn.Module):
    """Fourier-encoded camera rays -> linear projection (pos.py:152-186)."""

    def __init__(self, dim: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim = dim
        self.proj = Linear(3 * (dim // 3), dim, dtype=dtype)

    def forward(self, K: torch.Tensor, image_hw: torch.Tensor, feat_size: int) -> torch.Tensor:
        """K: (B, 3, 3); image_hw: (B, 2); returns (B, F, F, dim)."""
        r = ray_directions_at_features(K, image_hw, feat_size)
        # rays + Fourier features stay f32; only the projection runs in dtype
        ff = fourier_features(r, dim=self.dim, max_freq=feat_size // 2)
        return self.proj(ff)
