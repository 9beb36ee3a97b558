"""Shared small layers and box transforms of the CuTR port (torch, NHWC).

Port of ``boxfusion_tpu/models/cutr/layers.py``.  Parity targets: MLP
(reference cubify_transformer.py:48-63), box format helpers
(cubify_transformer.py:24-32), DeltaBox2DTransform (cubify_transformer.py:
445-511), torch-convention bicubic resize of the ViT absolute position
embeddings (vit.py:60-86).

Mixed precision follows the JAX package: every layer takes a compute
``dtype``; parameters stay float32 and are cast at use, matmuls run in the
compute dtype, and normalisation statistics are float32.  With float32 the
casts are no-ops.
"""
from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from boxfusion_tpu_torch.utils.device import device_constant


def box_cxcywh_to_xyxy(x: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = x.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def box_xyxy_to_cxcywh(x: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = x.unbind(-1)
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], dim=-1)


def topk_stable(x: torch.Tensor, k: int):
    """Top-k along the last axis; among ties the lowest index comes first,
    as ``jax.lax.top_k`` orders them (``torch.topk`` promises no order)."""
    out = torch.sort(x, dim=-1, descending=True, stable=True)
    return out.values[..., :k], out.indices[..., :k]


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` (a flax ``Dense(dtype=...)``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis: float32 statistics, ``dtype`` output."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)


class GroupNorm(nn.GroupNorm):
    """GroupNorm on NHWC tensors: float32 statistics, ``dtype`` output."""

    def __init__(self, num_groups: int, dim: int, eps: float, dtype: torch.dtype = torch.float32):
        super().__init__(num_groups, dim, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float().permute(0, 3, 1, 2), self.num_groups, self.weight, self.bias, self.eps)
        return y.permute(0, 2, 3, 1).to(self.compute_dtype)


class PatchConv(nn.Module):
    """Conv2d with kernel == stride and no padding, on NHWC tensors.

    Such a convolution is a matrix product over non-overlapping patches, so
    it runs as one: patches (B, H/k, W/k, k*k*C_in) times the weight.  The
    parameters keep torch's Conv2d layout (O, I, k, k) so that the original
    state dict loads as it is.
    """

    def __init__(self, in_ch: int, out_ch: int, k: int, dtype: torch.dtype = torch.float32,
                 bias: bool = True):
        super().__init__()
        self.k = k
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k, k))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, dt = self.k, self.compute_dtype
        B, H, W, C = x.shape
        Ho, Wo = H // k, W // k
        x = x[:, : Ho * k, : Wo * k]  # VALID padding drops a ragged edge
        patches = x.reshape(B, Ho, k, Wo, k, C).permute(0, 1, 3, 2, 4, 5).reshape(B, Ho, Wo, k * k * C)
        w = self.weight.permute(0, 2, 3, 1).reshape(self.weight.shape[0], -1)
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(patches.to(dt), w.to(dt), b)


class Embedding(nn.Embedding):
    """Embedding lookup returning ``dtype``."""

    def __init__(self, num: int, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__(num, dim)
        self.compute_dtype = dtype

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return self.weight[idx].to(self.compute_dtype)


class MLP(nn.Module):
    """ReLU MLP matching reference MLP (cubify_transformer.py:48-63)."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int, num_layers: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            Linear(dims[i], dims[i + 1], dtype=dtype) for i in range(num_layers)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


def apply_box_deltas(
    deltas: torch.Tensor,
    boxes_cxcywh: torch.Tensor,
    clamp_wh,
    wh_ratio_clip: float = 0.016,
) -> torch.Tensor:
    """DeltaBox2DTransform.apply_deltas (cubify_transformer.py:478-511).

    Args:
      deltas: (..., 4) (dx, dy, dw, dh).
      boxes_cxcywh: (..., 4) source boxes.
      clamp_wh: (W, H) floats to clamp the output xyxy to, or None.

    Returns:
      (..., 4) xyxy boxes.
    """
    dxy = deltas[..., :2]
    max_ratio = abs(math.log(wh_ratio_clip))
    dwh = torch.clamp(deltas[..., 2:], -max_ratio, max_ratio)
    pxy = boxes_cxcywh[..., :2]
    pwh = boxes_cxcywh[..., 2:]

    gxy = pxy + pwh * dxy
    gwh = pwh * torch.exp(dwh)
    out = torch.cat([gxy - gwh * 0.5, gxy + gwh * 0.5], dim=-1)
    if clamp_wh is not None:
        w, h = clamp_wh
        hi = device_constant((w, h, w, h), out.device, out.dtype)
        out = torch.minimum(torch.clamp(out, min=0.0), hi)
    return out


def torch_bicubic_matrix(in_size: int, out_size: int, a: float = -0.75) -> np.ndarray:
    """Row-stochastic (out, in) matrix reproducing torch bicubic interpolation.

    F.interpolate(mode="bicubic", align_corners=False) uses the Keys cubic
    kernel with a=-0.75 and edge-clamped taps; the map is separable and
    static per (in, out) pair, so it is baked into a matrix (exactly the
    JAX package's matrix, so the resized embeddings agree).
    """
    def kernel(t: np.ndarray) -> np.ndarray:
        t = np.abs(t)
        out = np.zeros_like(t)
        m1 = t <= 1
        out[m1] = (a + 2) * t[m1] ** 3 - (a + 3) * t[m1] ** 2 + 1
        m2 = (t > 1) & (t < 2)
        out[m2] = a * t[m2] ** 3 - 5 * a * t[m2] ** 2 + 8 * a * t[m2] - 4 * a
        return out

    M = np.zeros((out_size, in_size), dtype=np.float64)
    scale = in_size / out_size
    for i in range(out_size):
        x = (i + 0.5) * scale - 0.5
        base = int(np.floor(x))
        t = x - base
        taps = np.array([base - 1, base, base + 1, base + 2])
        w = kernel(np.array([t + 1.0, t, 1.0 - t, 2.0 - t]))
        for tap, wt in zip(taps, w):
            M[i, int(np.clip(tap, 0, in_size - 1))] += wt
    return M.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _bicubic(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """``torch_bicubic_matrix`` as a tensor on ``device``, made once per
    shape and device (a copy at each call would wait for the card).

    Made outside inference mode whatever the caller's mode: a cached
    inference tensor could never be saved for backward, so a training step
    after an inference pass in the same process would fail."""
    with torch.inference_mode(False):
        return torch.from_numpy(torch_bicubic_matrix(in_size, out_size)).to(device)


def resize_pos_embed(pos: torch.Tensor, grid: int, out_hw: Sequence[int]) -> torch.Tensor:
    """(1, grid*grid, C) -> (1, H, W, C) via torch-convention bicubic (f32).

    Mirrors get_abs_pos (vit.py:60-86); the cls token must already be
    stripped by the caller.
    """
    h, w = out_hw
    p = pos.reshape(grid, grid, pos.shape[-1])
    if (h, w) != (grid, grid):
        mh = _bicubic(grid, h, pos.device)
        mw = _bicubic(grid, w, pos.device)
        p = torch.einsum("hi,ijc,wj->hwc", mh, p, mw)
    return p[None]
