"""SigLIP's image tower (torch): patchify, a learned position embedding and
no class token, pre-norm blocks, a post-LayerNorm and an attention-pool head.

SigLIP (Zhai et al., "Sigmoid Loss for Language Image Pre-Training",
arXiv:2303.15343) at the widths of ``google/siglip-so400m-patch14-384``'s
``vision_config`` by default: 384 x 384 crops, 14 x 14 patches (VALID: the
last 6 pixel rows and columns are dropped), 729 tokens 1152 wide, 27 blocks
of 16 heads of 72, an MLP of 4304 with tanh-GELU, LayerNorm eps 1e-6, crops
normalised as ``(x / 255 - 0.5) / 0.5``.

    x_0 = PatchConv(crop) + P                     (no class token, no pre-LN)
    h   = x + Attn(LN_1(x));  x' = h + FC2(gelu_tanh(FC1(LN_2(h))))
    y   = LN_post(x_L)
    a   = MHA(q = probe, k = y, v = y)            (one query, packed in-proj)
    z   = a + MLP(LN_head(a));  embedding = z[0]  (width wide, no projection)

The blocks are ``model.py``'s ``ResidualBlock`` at SigLIP's MLP width, eps
and GELU, so their attention is ``whole_seq_attention`` (heads of 72 on the
card).  The pool's one-query attention is plain torch: its products in the
compute dtype, its softmax in float32, the probe's query projection once a
call.  Numerics otherwise as ``CLIPImageTower``'s: parameters float32,
matmuls in ``cfg.dtype``, LayerNorm statistics in float32, a float32
embedding; the last block's closing add and ``LN_post`` are one ``add_norm``
(``model.py``).  The head runs inside the span ``label.pool``
(``utils/profiling.span``).

Parameter names follow the port's blocks (``transformer.resblocks.{i}``)
and, for the rest, Hugging Face's ``SiglipVisionTransformer``
(``patch_embedding``, ``post_layernorm``, ``head.probe``,
``head.attention.in_proj_weight``, ...); ``convert.py:
load_siglip_image_params`` maps a checkpoint's keys onto them.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from boxfusion_tpu_torch.models.clip.model import (
    ATTN_IMPLS,
    _Attention,
    _Transformer,
    add_norm,
    init_clip_weights,
)
from boxfusion_tpu_torch.models.cutr.layers import LayerNorm, Linear, PatchConv
from boxfusion_tpu_torch.utils.device import torch_dtype
from boxfusion_tpu_torch.utils.profiling import span


def _triple(x) -> Tuple[float, float, float]:
    t = tuple(float(v) for v in (x if isinstance(x, (tuple, list)) else (x,) * 3))
    if len(t) != 3:
        raise ValueError(f"a per-channel statistic has 3 values, got {x!r}")
    return t


@dataclasses.dataclass(frozen=True)
class SigLIPConfig:
    """SigLIP SO400M/14 at 384 px by default (``vision_config``)."""

    image_size: int = 384
    patch: int = 14
    width: int = 1152
    layers: int = 27
    heads: int = 16
    mlp_width: int = 4304
    ln_eps: float = 1e-6
    # per-channel statistics of [0, 1] pixels (a number is all three)
    image_mean: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    image_std: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    # compute dtype and attention path, as CLIPConfig's
    dtype: object = torch.float32
    attn_impl: str = "auto"

    def __post_init__(self):
        object.__setattr__(self, "dtype", torch_dtype(self.dtype))
        object.__setattr__(self, "image_mean", _triple(self.image_mean))
        object.__setattr__(self, "image_std", _triple(self.image_std))
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {self.attn_impl!r}")

    @property
    def embed_dim(self) -> int:
        """The embedding is the pool head's output, ``width`` wide."""
        return self.width

    @property
    def tokens(self) -> int:
        return (self.image_size // self.patch) ** 2

    def image_tower(self) -> "SigLIPImageTower":
        """The image tower of this config, its weights not yet set."""
        return SigLIPImageTower(self)


class _PoolMlp(nn.Module):
    def __init__(self, d: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = Linear(d, hidden, dtype=dtype)
        self.fc2 = Linear(hidden, d, dtype=dtype)


class AttentionPoolHead(nn.Module):
    """SigLIP's multihead attention pooling ("MAP") head: one learned query
    over the tower's tokens, then a residual MLP behind a LayerNorm."""

    def __init__(self, d: int, heads: int, mlp_width: int, ln_eps: float, dtype: torch.dtype):
        super().__init__()
        self.heads, self.compute_dtype = heads, dtype
        self.probe = nn.Parameter(torch.empty(1, 1, d))
        self.attention = _Attention(d, dtype)
        self.layernorm = LayerNorm(d, eps=ln_eps, dtype=dtype)
        self.mlp = _PoolMlp(d, mlp_width, dtype)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        """y: (B, T, d) in the compute dtype.  Returns (B, d) float32."""
        dt, heads = self.compute_dtype, self.heads
        B, T, d = y.shape
        hd = d // heads
        w, b = self.attention.in_proj_weight.to(dt), self.attention.in_proj_bias.to(dt)
        q = F.linear(self.probe[0].to(dt), w[:d], b[:d])             # (1, d): once a call
        k, v = F.linear(y, w[d:], b[d:]).chunk(2, dim=-1)            # (B, T, d) each
        qh = (q * hd ** -0.5).reshape(1, heads, 1, hd)
        kh = k.reshape(B, T, heads, hd).permute(0, 2, 3, 1)          # (B, h, hd, T)
        vh = v.reshape(B, T, heads, hd).transpose(1, 2)              # (B, h, T, hd)
        p = torch.softmax((qh @ kh).float(), dim=-1).to(v.dtype)     # (B, h, 1, T)
        a = self.attention.out_proj((p @ vh).reshape(B, d))
        z = a + self.mlp.fc2(F.gelu(self.mlp.fc1(self.layernorm(a)), approximate="tanh"))
        return z.float()


class SigLIPImageTower(nn.Module):
    """SigLIP's vision transformer with its attention-pool head."""

    def __init__(self, cfg: SigLIPConfig = SigLIPConfig()):
        super().__init__()
        self.cfg = cfg
        c, dt = cfg, cfg.dtype
        self.patch_embedding = PatchConv(3, c.width, c.patch, dtype=dt, bias=True)
        self.positional_embedding = nn.Parameter(torch.empty(c.tokens, c.width))
        self.transformer = _Transformer(c.width, c.layers, c.heads, "tanh", dt, mlp_width=c.mlp_width,
                                        ln_eps=c.ln_eps)
        self.post_layernorm = LayerNorm(c.width, eps=c.ln_eps, dtype=dt)
        self.head = AttentionPoolHead(c.width, c.heads, c.mlp_width, c.ln_eps, dt)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: (B, image_size, image_size, 3) NHWC, already normalised.

        Returns (B, width) unnormalized float32 embeddings."""
        c, dt = self.cfg, self.cfg.dtype
        x = self.patch_embedding(images.to(dt))
        x = x.reshape(x.shape[0], -1, c.width) + self.positional_embedding[None].to(dt)
        impl = c.attn_impl
        if impl == "auto":
            impl = "kernel" if x.device.type == "cuda" else "xla"
        h = add_norm(x, None, self.transformer.resblocks[0].ln_1)[1]
        for blk, next_norm in self.transformer.chain(self.post_layernorm):
            x, h = blk.step(x, h, next_norm, attn_impl=impl)
        with span("label.pool"):
            return self.head(h)

    def init_random(self, gen: torch.Generator) -> None:
        init_siglip_weights(self, gen)


@torch.no_grad()
def init_siglip_weights(tower: SigLIPImageTower, gen: torch.Generator) -> None:
    """Random weights in ``init_clip_weights``' scheme (lecun-normal kernels,
    zero biases, xavier-uniform in-projections, norms at identity), the
    position embedding and the probe normal(0.02)."""
    init_clip_weights(tower, gen)
    tower.patch_embedding.bias.zero_()
    tower.positional_embedding.normal_(0.0, 0.02, generator=gen)
    tower.head.probe.normal_(0.0, 0.02, generator=gen)
