"""RGB-D ViT backbone (torch, NHWC).

Port of ``boxfusion_tpu/models/cutr/vit.py``.  Capability target: the
reference's ViTDet-style backbone with joint RGB-D windowed attention
(reference boxfusion/vit.py:16-521):

  * separate 16x16 patch embeds for RGB (3ch) and depth (1ch), each with its
    own absolute position embedding bicubic-resized from the 224/16 = 14
    pretraining grid (vit.py:60-86);
  * 12 blocks; window attention (window 16) on blocks {0,1,3,4,6,7,9,10}
    where RGB and depth tokens attend *jointly*: one score matrix over the
    concatenated keys, split per modality before softmax (vit.py:170-203);
  * the depth window is the RGB window divided by the RGB/depth resolution
    ratio, restricted to {4, 8, 16} (vit.py:205,289-307);
  * global blocks {2,5,8,11} attend RGB only (vit.py:466,511-515);
  * the MLP is shared between modalities within a block (vit.py:326-340).

Attention is the plain einsum + float32-softmax form (the JAX package's
default for CuTR): scores in the compute dtype, softmax in float32.
Module names follow the original state dict (``backbone.0.blocks.i.attn.qkv``
and so on) so checkpoints load with ``load_state_dict``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.models.cutr.layers import cast, LayerNorm, Linear, PatchConv, resize_pos_embed

DEPTH_WINDOW_SIZES = (4, 8, 16)


def window_partition(x: torch.Tensor, window: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(B, H, W, C) -> (B*nW, win, win, C), zero-padding to window multiples."""
    B, H, W, C = x.shape
    pad_h = (-H) % window
    pad_w = (-W) % window
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.reshape(B, Hp // window, window, Wp // window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, C), (Hp, Wp)


def window_unpartition(
    windows: torch.Tensor, window: int, pad_hw: Tuple[int, int], hw: Tuple[int, int]
) -> torch.Tensor:
    Hp, Wp = pad_hw
    H, W = hw
    B = windows.shape[0] // (Hp * Wp // window // window)
    x = windows.reshape(B, Hp // window, Wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W]


class PatchEmbed(nn.Module):
    """16x16 stride-16 patchifier (vit.py:102-128), NHWC in/out."""

    def __init__(self, in_ch: int, embed_dim: int, patch: int = 16, dtype=torch.float32):
        super().__init__()
        self.proj = PatchConv(in_ch, embed_dim, patch, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


def attend(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor, scale: float) -> torch.Tensor:
    """(B, Nq, h, c) x (B, Nk, h, c) -> (B, Nq, h, c); float32 softmax."""
    q = qh.transpose(1, 2) * scale
    a = q @ kh.permute(0, 2, 3, 1)  # (B, h, Nq, Nk) in the compute dtype
    a = torch.softmax(a.float(), dim=-1).to(vh.dtype)
    return (a @ vh.transpose(1, 2)).transpose(1, 2)


class JointAttention(nn.Module):
    """Multi-head attention with optional joint RGB-D tokens (vit.py:130-203).

    Both modalities share the qkv / proj weights; the keys and values are
    the concatenated sequence, and each query block takes its own softmax
    row over it.
    """

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, depth: Optional[torch.Tensor] = None):
        B, H, W, C = x.shape
        hd = C // self.num_heads
        scale = hd ** -0.5

        def split_qkv(t, n):
            r = self.qkv(t).reshape(B, n, 3, self.num_heads, hd)
            return r[:, :, 0], r[:, :, 1], r[:, :, 2]

        q, k, v = split_qkv(x.reshape(B, H * W, C), H * W)
        out_d = None
        if depth is not None:
            _, Hd, Wd, _ = depth.shape
            qd, kd, vd = split_qkv(depth.reshape(B, Hd * Wd, C), Hd * Wd)
            k = torch.cat([k, kd], dim=1)
            v = torch.cat([v, vd], dim=1)
            out_d = self.proj(attend(qd, k, v, scale).reshape(B, Hd, Wd, C))
        out = self.proj(attend(q, k, v, scale).reshape(B, H, W, C))
        return out, out_d


class Mlp(nn.Module):
    """timm-style MLP (fc1 / exact GELU / fc2) of the reference blocks."""

    def __init__(self, dim: int, hidden_dim: int, dtype=torch.float32):
        super().__init__()
        self.fc1 = Linear(dim, hidden_dim, dtype=dtype)
        self.fc2 = Linear(hidden_dim, dim, dtype=dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class LayerScale(nn.Module):
    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))
        self.compute_dtype = dtype

    def forward(self, x):
        return x * cast(self.gamma, self.compute_dtype)


class Block(nn.Module):
    """Pre-norm transformer block with optional windowing + depth modality
    (vit.py:206-342)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, window_size: int = 0,
                 depth_modality: bool = False, layer_scale: bool = False, dtype=torch.float32):
        super().__init__()
        self.window_size = window_size
        self.depth_modality = depth_modality
        self.norm1 = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.norm2 = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.attn = JointAttention(dim, num_heads, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)
        if layer_scale:
            self.ls1 = LayerScale(dim, dtype=dtype)
            self.ls2 = LayerScale(dim, dtype=dtype)
        else:
            self.ls1 = self.ls2 = None

    def forward(self, x: torch.Tensor, depth: Optional[torch.Tensor] = None):
        shortcut = x
        xn = self.norm1(x)
        use_depth = self.depth_modality and depth is not None
        H, W = xn.shape[1], xn.shape[2]
        if self.window_size > 0:
            xn, pad_hw = window_partition(xn, self.window_size)

        if use_depth:
            dn = self.norm1(depth)
            Hd, Wd = dn.shape[1], dn.shape[2]
            # depth window from the RGB/depth resolution ratio (vit.py:296-304)
            dws = int(self.window_size // (H / Hd))
            if dws not in DEPTH_WINDOW_SIZES:
                raise ValueError(f"Unexpected depth window size {dws}")
            dn, pad_hw_d = window_partition(dn, dws)
            xn, dn = self.attn(xn, dn)
            dn = window_unpartition(dn, dws, pad_hw_d, (Hd, Wd))
        else:
            xn, _ = self.attn(xn)

        if self.window_size > 0:
            xn = window_unpartition(xn, self.window_size, pad_hw, (H, W))

        if self.ls1 is not None:
            xn = self.ls1(xn)
            if use_depth:
                dn = self.ls1(dn)

        x = shortcut + xn
        y = self.mlp(self.norm2(x))
        if self.ls2 is not None:
            y = self.ls2(y)
        x = x + y

        if use_depth:
            depth = depth + dn
            yd = self.mlp(self.norm2(depth))
            if self.ls2 is not None:
                yd = self.ls2(yd)
            depth = depth + yd
        return x, depth


class ViT(nn.Module):
    """RGB-D ViT backbone (vit.py:344-521).

    forward(image, depth): NHWC image (B, S, S, 3) and depth (B, Sd, Sd, 1)
    -> the stride-16 feature map (B, S/16, S/16, C).
    """

    def __init__(
        self,
        embed_dim: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        window_size: int = 16,
        window_block_indexes: Sequence[int] = (0, 1, 3, 4, 6, 7, 9, 10),
        depth_modality: bool = True,
        layer_scale: bool = False,
        encoder_norm: bool = False,
        pretrain_img_size: int = 224,
        patch: int = 16,
        dtype=torch.float32,
    ):
        super().__init__()
        self.grid = pretrain_img_size // patch
        self.dtype = dtype
        n_pos = self.grid * self.grid + 1  # + the pretraining cls token
        self.patch_embed = PatchEmbed(3, embed_dim, patch, dtype=dtype)
        self.pos_embed = nn.Parameter(torch.zeros(1, n_pos, embed_dim))
        self.depth_modality = depth_modality
        if depth_modality:
            self.patch_embed_depth = PatchEmbed(1, embed_dim, patch, dtype=dtype)
            self.pos_embed_depth = nn.Parameter(torch.zeros(1, n_pos, embed_dim))
        self.blocks = nn.ModuleList(
            Block(
                embed_dim, num_heads, mlp_ratio,
                window_size=window_size if i in window_block_indexes else 0,
                # depth participates only in window blocks (vit.py:466)
                depth_modality=depth_modality and i in window_block_indexes,
                layer_scale=layer_scale, dtype=dtype,
            )
            for i in range(depth)
        )
        self.encoder_norm = LayerNorm(embed_dim, eps=1e-6, dtype=dtype) if encoder_norm else None

    def forward(self, image: torch.Tensor, depth: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.patch_embed(cast(image, self.dtype))
        # bicubic resize in f32, cast once
        pos = resize_pos_embed(self.pos_embed[:, 1:], self.grid, (x.shape[1], x.shape[2]))
        x = x + cast(pos, self.dtype)

        d = None
        if self.depth_modality and depth is not None:
            d = self.patch_embed_depth(cast(depth, self.dtype))
            pd = resize_pos_embed(self.pos_embed_depth[:, 1:], self.grid, (d.shape[1], d.shape[2]))
            d = d + cast(pd, self.dtype)

        for blk in self.blocks:
            if blk.depth_modality and d is not None:
                x, d = blk(x, d)
            else:
                x, _ = blk(x)

        if self.encoder_norm is not None:
            x = self.encoder_norm(x)
        return x
