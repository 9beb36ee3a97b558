"""CuTR prediction heads and prompt encoders (torch).

Port of ``boxfusion_tpu/models/cutr/heads.py``.  Parity targets (reference
cubify_transformer.py):
  * ScalePredictor (391-411): two linear heads on the 2 metric tokens,
    exponentiated -> predicted depth (shift, scale).
  * ClassPredictor (413-434): foreground logits with focal-style bias init.
  * DeltaBox2DPredictor (436-532): 3-layer MLP producing clipped box deltas
    decoded against the proposal boxes.
  * AbsoluteBox3DPredictor (534-643): projected-center offset, unscaled z,
    log-dims and yaw-only pose; z / dims de-whitened with the depth
    whitening parameters.
  * Box2DPromptEncoderLearned (360-383): discretized xywh embedding lookup.
Coordinate decoding is float32 whatever the compute dtype.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from boxfusion_tpu_torch.models.cutr.layers import (
    MLP,
    Embedding,
    Linear,
    apply_box_deltas,
    box_xyxy_to_cxcywh,
)
from boxfusion_tpu_torch.utils.device import device_constant


class ClassPredictor(nn.Module):
    """Foreground logits (cubify_transformer.py:413-434), returned as f32."""

    def __init__(self, dim: int, num_classes: int = 2, prior_prob: float = 0.01, dtype=torch.float32):
        super().__init__()
        self.bias_value = -math.log((1 - prior_prob) / prior_prob)
        self.linear = Linear(dim, num_classes, dtype=dtype)

    def forward(self, x):
        return self.linear(x).float()


class DeltaBox2DPredictor(nn.Module):
    """MLP deltas + decode (cubify_transformer.py:514-532).

    Returns (deltas, new_boxes_cxcywh), both float32."""

    def __init__(self, dim: int, num_layers: int = 3, dtype=torch.float32):
        super().__init__()
        self.mlp = MLP(dim, dim, 4, num_layers, dtype=dtype)

    def forward(self, x, proposal_boxes_cxcywh, clamp_wh):
        deltas = self.mlp(x).float()
        xyxy = apply_box_deltas(deltas, proposal_boxes_cxcywh.float(), clamp_wh)
        return deltas, box_xyxy_to_cxcywh(xyxy)


class ScalePredictor(nn.Module):
    """exp(linear) shift/scale from the two metric tokens (391-411)."""

    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.shift = Linear(dim, 1, dtype=dtype)
        self.scale = Linear(dim, 1, dtype=dtype)

    def forward(self, x2):
        shift = torch.exp(self.shift(x2[..., 0:1, :]).float())
        scale = torch.exp(self.scale(x2[..., 1:2, :]).float())
        return torch.cat([shift, scale], dim=-1)[..., 0, :]  # (B, 2)


class AbsoluteBox3DPredictor(nn.Module):
    """3D box head (cubify_transformer.py:534-643), pose_type='z'.

    Returns dict(proj_xy, z_unscaled, z_scaled, dims, pose)."""

    def __init__(self, dim: int, num_layers: int = 3, dtype=torch.float32):
        super().__init__()
        self.mlp = MLP(dim, dim, 2 + 1 + 3 + 1, num_layers, dtype=dtype)

    def forward(self, x, pred_boxes_cxcywh, depth_params, clamp_wh):
        out = self.mlp(x).float()
        pred_boxes_cxcywh = pred_boxes_cxcywh.float()
        dxy = out[..., 0:2]
        z_unscaled = out[..., 2:3]
        log_dims = out[..., 3:6]
        yaw = out[..., 6]

        # pose_type="z": euler 'YXZ' with only the Y angle set -> R_y(yaw)
        c, s = torch.cos(yaw), torch.sin(yaw)
        zero, one = torch.zeros_like(c), torch.ones_like(c)
        pose = torch.stack([c, zero, s, zero, one, zero, -s, zero, c], dim=-1).reshape(*yaw.shape, 3, 3)

        shift = depth_params[..., None, 0:1]
        scale = depth_params[..., None, 1:2]
        z_scaled = scale * z_unscaled + shift
        dims = torch.exp(torch.clamp(log_dims, max=5.0)) * scale

        proj_xy = pred_boxes_cxcywh[..., :2] + dxy * pred_boxes_cxcywh[..., 2:]
        w, h = clamp_wh
        hi = device_constant((w, h), proj_xy.device, proj_xy.dtype)
        proj_xy = torch.minimum(torch.clamp(proj_xy, min=0.0), hi)
        return dict(proj_xy=proj_xy, z_unscaled=z_unscaled, z_scaled=z_scaled, dims=dims, pose=pose)


class Box2DPromptEncoderLearned(nn.Module):
    """Discretized xywh embedding lookups (cubify_transformer.py:360-383)."""

    def __init__(self, embed_dim: int = 256, max_xywh: int = 1280, dtype=torch.float32):
        super().__init__()
        self.max_xywh = max_xywh
        quarter = embed_dim // 4
        self.x = Embedding(max_xywh, quarter, dtype=dtype)
        self.y = Embedding(max_xywh, quarter, dtype=dtype)
        self.w = Embedding(max_xywh, quarter, dtype=dtype)
        self.h = Embedding(max_xywh, quarter, dtype=dtype)
        # the original module's constant clamp bounds, kept for state-dict parity
        self.register_buffer("min_bounds", torch.zeros(4))
        self.register_buffer("max_bounds", torch.full((4,), float(max_xywh - 1)))

    def forward(self, boxes_cxcywh):
        idx = torch.clamp(boxes_cxcywh, 0.0, self.max_xywh - 1).to(torch.int64)
        return torch.cat(
            [emb(idx[..., i]) for i, emb in enumerate((self.x, self.y, self.w, self.h))], dim=-1
        )
