"""CLIP image + text towers (torch), open_clip-compatible.

Port of ``boxfusion_tpu/models/clip/model.py``.  Capability target: the
reference's open-vocabulary head relies on an external CLIP (reference
demo.py:458-459; the documented fallback is open_clip ViT-H-14,
tools/utils.py:342-353) through two calls: image embeddings of 224x224 crops
and normalized text embeddings of the class names.

Parameter names follow open_clip's state dict (``conv1.weight``,
``transformer.resblocks.{i}.attn.in_proj_weight``, ``...mlp.c_fc``,
``ln_pre``, ``ln_post``, ``proj``; the image tower's keys without their
``visual.`` prefix), so a real checkpoint loads with ``load_state_dict``
(convert.py).  Weights must be supplied by the user; random weights still
exercise the whole compute path.

Numerics, as in the JAX package: parameters float32, matmuls in
``cfg.dtype``, q pre-scaled by ``hd ** -0.5``, softmax in float32,
probabilities cast to v's dtype, LayerNorm statistics in float32, ``ln_post``
on the class token, final projection in float32.  ``conv1`` is a
stride-``patch`` patchify and runs as a reshape and one matmul (no cuDNN, so
no TF32 convolution; the package also turns TF32 off at import).
"""
from __future__ import annotations

import dataclasses
import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.models.cutr.layers import cast, LayerNorm, Linear, PatchConv
from benchmark.reference.ops.attention_kernel import whole_seq_attention_reference
from benchmark.reference.utils.device import torch_dtype

CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """ViT-H/14 by default (the reference's text-feature source)."""

    image_size: int = 224
    patch: int = 14
    width: int = 1280
    layers: int = 32
    heads: int = 16
    embed_dim: int = 1024
    quick_gelu: bool = False
    # compute dtype (a torch dtype, "float32" or "bfloat16"): parameters stay
    # float32; softmax and norm statistics stay float32; the returned
    # embeddings are float32
    dtype: object = torch.float32

    def __post_init__(self):
        object.__setattr__(self, "dtype", torch_dtype(self.dtype))


def _gelu(x: torch.Tensor, quick: bool) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x) if quick else F.gelu(x)


class _Attention(nn.Module):
    """The parameters of torch's ``nn.MultiheadAttention`` (packed in-proj)."""

    def __init__(self, d: int, dtype: torch.dtype):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = Linear(d, d, dtype=dtype)


class _Mlp(nn.Module):
    def __init__(self, d: int, dtype: torch.dtype):
        super().__init__()
        self.c_fc = Linear(d, 4 * d, dtype=dtype)
        self.c_proj = Linear(4 * d, d, dtype=dtype)


class ResidualBlock(nn.Module):
    """Pre-norm transformer block of the image tower."""

    def __init__(self, d: int, heads: int, quick_gelu: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = heads
        self.quick_gelu = quick_gelu
        self.compute_dtype = dtype
        self.ln_1 = LayerNorm(d, eps=1e-5, dtype=dtype)
        self.attn = _Attention(d, dtype)
        self.ln_2 = LayerNorm(d, eps=1e-5, dtype=dtype)
        self.mlp = _Mlp(d, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        d = x.shape[-1]
        hd = d // self.heads
        h = self.ln_1(x)
        qkv = F.linear(h, cast(self.attn.in_proj_weight, dt), cast(self.attn.in_proj_bias, dt))
        q, k, v = qkv.chunk(3, dim=-1)
        o = whole_seq_attention_reference(q, k, v, self.heads, hd ** -0.5)
        x = x + self.attn.out_proj(o)
        h = _gelu(self.mlp.c_fc(self.ln_2(x)), self.quick_gelu)
        return x + self.mlp.c_proj(h)


class _Transformer(nn.Module):
    def __init__(self, d: int, layers: int, heads: int, quick_gelu: bool, dtype: torch.dtype):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualBlock(d, heads, quick_gelu, dtype=dtype) for _ in range(layers)
        )


class CLIPImageTower(nn.Module):
    """open_clip VisionTransformer: patchify, cls token, pre/post LN, proj."""

    def __init__(self, cfg: CLIPConfig = CLIPConfig()):
        super().__init__()
        self.cfg = cfg
        c, dt = cfg, cfg.dtype
        self.conv1 = PatchConv(3, c.width, c.patch, dtype=dt, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(c.width))
        self.positional_embedding = nn.Parameter(
            torch.empty((c.image_size // c.patch) ** 2 + 1, c.width)
        )
        self.ln_pre = LayerNorm(c.width, eps=1e-5, dtype=dt)
        self.transformer = _Transformer(c.width, c.layers, c.heads, c.quick_gelu, dt)
        self.ln_post = LayerNorm(c.width, eps=1e-5, dtype=dt)
        self.proj = nn.Parameter(torch.empty(c.width, c.embed_dim))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: (B, 224, 224, 3) NHWC, already CLIP-normalized.

        Returns (B, embed_dim) unnormalized float32 embeddings."""
        c, dt = self.cfg, self.cfg.dtype
        x = self.conv1(cast(images, dt))
        B = x.shape[0]
        x = x.reshape(B, -1, c.width)
        cls = cast(self.class_embedding, dt)[None, None].expand(B, 1, c.width)
        x = torch.cat([cls, x], dim=1) + cast(self.positional_embedding[None], dt)
        x = self.ln_pre(x)
        for blk in self.transformer.resblocks:
            x = blk(x)
        x = self.ln_post(x[:, 0])
        # final projection + the cosine-similarity math downstream stay float32
        return x.float() @ self.proj
