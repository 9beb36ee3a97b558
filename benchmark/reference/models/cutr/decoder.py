"""DETR-style prompt decoder with box-conditioned global cross attention.

Port of ``boxfusion_tpu/models/cutr/decoder.py``.  Capability targets
(reference cubify_transformer.py):
  * GlobalCrossAttention (93-200): full attention from queries to the
    flattened stride-16 feature map, biased by a relative-position term from
    per-query MLPs over the signed deltas between the query's current 2D box
    edges and every feature column / row ("Plain-DETR" rpe, 146-167).  The
    bias applies to box-prompt queries only (box_attn_prior_mask, 180-183).
  * PreNormGlobalDecoderLayer (203-283): pre-norm self-attention over the
    query set (block-diagonal mask between prompt groups), the global cross
    attention, and a ReLU FFN.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.models.cutr.layers import cast, LayerNorm, Linear


def _linspace_f32(start: float, stop: float, num: int, device) -> torch.Tensor:
    """jnp.linspace in float32: start*(1-t) + stop*t with t = i/(num-1)."""
    step = torch.arange(num - 1, dtype=torch.float32, device=device) / float(num - 1)
    out = start * (1 - step) + stop * step
    return torch.cat([out, torch.full((1,), stop, dtype=torch.float32, device=device)])


class TorchMHA(nn.Module):
    """torch.nn.MultiheadAttention-compatible self-attention (packed qkv).

    `mask` is boolean with True = blocked (torch convention).
    """

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.compute_dtype = dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = Linear(dim, dim, dtype=dtype)

    def forward(self, q, k, v, mask: Optional[torch.Tensor] = None):
        B, Nq, C = q.shape
        Nk = k.shape[1]
        hd = C // self.num_heads
        dt = self.compute_dtype
        wq, wk, wv = cast(self.in_proj_weight, dt).chunk(3, dim=0)
        bq, bk, bv = cast(self.in_proj_bias, dt).chunk(3, dim=0)
        qh = F.linear(cast(q, dt), wq, bq).reshape(B, Nq, self.num_heads, hd).transpose(1, 2)
        kh = F.linear(cast(k, dt), wk, bk).reshape(B, Nk, self.num_heads, hd).transpose(1, 2)
        vh = F.linear(cast(v, dt), wv, bv).reshape(B, Nk, self.num_heads, hd).transpose(1, 2)

        attn = (qh @ kh.transpose(-1, -2)) * (hd ** -0.5)
        if mask is not None:
            attn = attn.masked_fill(mask, -torch.inf)
        attn = torch.softmax(attn.float(), dim=-1).to(vh.dtype)
        o = (attn @ vh).transpose(1, 2).reshape(B, Nq, C)
        return self.out_proj(o)


class GlobalCrossAttention(nn.Module):
    def __init__(self, dim: int = 256, num_heads: int = 8, rpe_hidden_dim: int = 512,
                 feature_stride: int = 16, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.feature_stride = feature_stride
        # the rpe MLPs stay float32: their inputs are raw pixel deltas that
        # bf16 would quantize to multiples of 4 px
        self.cpb_mlp1 = nn.Sequential(
            nn.Linear(2, rpe_hidden_dim), nn.ReLU(), nn.Linear(rpe_hidden_dim, num_heads, bias=False)
        )
        self.cpb_mlp2 = nn.Sequential(
            nn.Linear(2, rpe_hidden_dim), nn.ReLU(), nn.Linear(rpe_hidden_dim, num_heads, bias=False)
        )
        self.q = Linear(dim, dim, dtype=dtype)
        self.k = Linear(dim, dim, dtype=dtype)
        self.v = Linear(dim, dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, query, reference_2d, k_input, v_input, hw, num_prefix: int):
        """query (B, Nq, C); reference_2d (B, Nb, 4) cxcywh of the box
        prompts; k_input / v_input (B, HW, C); the first `num_prefix`
        queries attend without the rpe prior."""
        B, Nq, C = query.shape
        h, w = hw
        hd = C // self.num_heads
        stride = self.feature_stride

        ref2d = reference_2d.float()
        ref = torch.cat(
            [ref2d[..., :2] - ref2d[..., 2:] / 2, ref2d[..., :2] + ref2d[..., 2:] / 2], dim=-1
        )  # (B, Nb, 4) xyxy
        pos_x = _linspace_f32(0.5, w - 0.5, w, query.device) * stride
        pos_y = _linspace_f32(0.5, h - 0.5, h, query.device) * stride

        delta_x = ref[..., None, 0::2] - pos_x[None, None, :, None]  # (B, Nb, w, 2)
        delta_y = ref[..., None, 1::2] - pos_y[None, None, :, None]
        rpe_x = self.cpb_mlp1(delta_x)  # (B, Nb, w, heads)
        rpe_y = self.cpb_mlp2(delta_y)
        rpe = rpe_x[:, :, None] + rpe_y[:, :, :, None]  # (B, Nb, h, w, heads)
        rpe = rpe.reshape(B, ref.shape[1], h * w, self.num_heads).permute(0, 3, 1, 2)

        q = self.q(query).reshape(B, Nq, self.num_heads, hd).transpose(1, 2)
        k = self.k(k_input).reshape(B, -1, self.num_heads, hd).transpose(1, 2)
        v = self.v(v_input).reshape(B, -1, self.num_heads, hd).transpose(1, 2)

        attn = (q * (hd ** -0.5)) @ k.transpose(-1, -2)  # (B, heads, Nq, HW)
        # the rpe bias rounds to the score dtype, box queries only
        bias = torch.cat(
            [torch.zeros_like(attn[:, :, :num_prefix]), rpe.to(attn.dtype)], dim=2
        )
        attn = torch.softmax((attn + bias).float(), dim=-1).to(v.dtype)
        o = (attn @ v).transpose(1, 2).reshape(B, Nq, C)
        return self.proj(o)


class DecoderLayer(nn.Module):
    """PreNormGlobalDecoderLayer (cubify_transformer.py:203-283)."""

    def __init__(self, d_model: int = 256, d_ffn: int = 2048, n_heads: int = 8, dtype=torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(d_model, eps=1e-5, dtype=dtype)
        self.norm2 = LayerNorm(d_model, eps=1e-5, dtype=dtype)
        self.norm3 = LayerNorm(d_model, eps=1e-5, dtype=dtype)
        self.self_attn = TorchMHA(d_model, n_heads, dtype=dtype)
        self.xattn = GlobalCrossAttention(d_model, n_heads, dtype=dtype)
        self.linear1 = Linear(d_model, d_ffn, dtype=dtype)
        self.linear2 = Linear(d_ffn, d_model, dtype=dtype)

    def forward(self, tgt, query_pos, reference_2d, src, src_pos, hw, self_attn_mask, num_prefix):
        t2 = self.norm2(tgt)
        qk = t2 + query_pos
        tgt = tgt + self.self_attn(qk, qk, t2, mask=self_attn_mask)

        t2 = self.norm1(tgt)
        tgt = tgt + self.xattn(t2 + query_pos, reference_2d, src + src_pos, src, hw, num_prefix)

        t2 = self.norm3(tgt)
        return tgt + self.linear2(F.relu(self.linear1(t2)))
