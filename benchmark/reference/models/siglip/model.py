"""SigLIP's image tower, plain: written from the published equations
(Zhai et al., arXiv:2303.15343; the widths of
``google/siglip-so400m-patch14-384``'s ``vision_config``), float32 unless
told otherwise, with no kernel of the program.

    x_0 = Conv_14x14/14(crop) + P      VALID patches, no class token, no pre-LN
    h   = x + Attn(LN_1(x))            q, k, v and out projections with bias,
    x'  = h + FC2(gelu_tanh(FC1(LN_2(h))))     scale hd^-0.5, no mask
    y   = LN_post(x_L)
    a   = MHA(q = probe, k = y, v = y) one learned query per crop, packed
                                       in-projection with bias, out-projection
    z   = a + FC2(gelu_tanh(FC1(LN_head(a))));   the embedding is z

The compute dtype ``dtype`` is honoured as the CLIP reference honours it:
parameters float32, each product's operands cast to it (``layers.cast``:
for float8, rounded under one scale per tensor and carried in bfloat16),
LayerNorm statistics and the softmax in float32, a float32 embedding.
Parameter names are the program's (``transformer.resblocks.{i}.attn.
in_proj_weight``, ``head.probe``, ...), so ``weights.fill`` hands both the
same weights.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.models.cutr.layers import LayerNorm, Linear, PatchConv, cast
from benchmark.reference.ops.attention_kernel import whole_seq_attention_reference
from benchmark.reference.utils.device import torch_dtype


@dataclasses.dataclass(frozen=True)
class SigLIPConfig:
    image_size: int = 384
    patch: int = 14
    width: int = 1152
    layers: int = 27
    heads: int = 16
    mlp_width: int = 4304
    ln_eps: float = 1e-6
    dtype: object = torch.float32

    def __post_init__(self):
        object.__setattr__(self, "dtype", torch_dtype(self.dtype))


class _Attention(nn.Module):
    """Packed q, k, v in-projection with bias, and the out-projection."""

    def __init__(self, d: int, dtype: torch.dtype):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = Linear(d, d, dtype=dtype)


class _Mlp(nn.Module):
    def __init__(self, d: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.c_fc = Linear(d, hidden, dtype=dtype)
        self.c_proj = Linear(hidden, d, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(F.gelu(self.c_fc(x), approximate="tanh"))


class _PoolMlp(nn.Module):
    def __init__(self, d: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = Linear(d, hidden, dtype=dtype)
        self.fc2 = Linear(hidden, d, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class Block(nn.Module):
    """h = x + Attn(LN_1(x)); x' = h + MLP(LN_2(h))."""

    def __init__(self, c: SigLIPConfig, dtype: torch.dtype):
        super().__init__()
        self.heads, self.compute_dtype = c.heads, dtype
        self.ln_1 = LayerNorm(c.width, eps=c.ln_eps, dtype=dtype)
        self.attn = _Attention(c.width, dtype)
        self.ln_2 = LayerNorm(c.width, eps=c.ln_eps, dtype=dtype)
        self.mlp = _Mlp(c.width, c.mlp_width, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, d = self.compute_dtype, x.shape[-1]
        qkv = F.linear(self.ln_1(x), cast(self.attn.in_proj_weight, dt), cast(self.attn.in_proj_bias, dt))
        q, k, v = qkv.chunk(3, dim=-1)
        h = x + self.attn.out_proj(whole_seq_attention_reference(q, k, v, self.heads, (d // self.heads) ** -0.5))
        return h + self.mlp(self.ln_2(h))


class _Transformer(nn.Module):
    def __init__(self, c: SigLIPConfig, dtype: torch.dtype):
        super().__init__()
        self.resblocks = nn.ModuleList(Block(c, dtype) for _ in range(c.layers))


class PoolHead(nn.Module):
    """Multihead attention pooling: the probe attends to every token."""

    def __init__(self, c: SigLIPConfig, dtype: torch.dtype):
        super().__init__()
        self.heads, self.compute_dtype = c.heads, dtype
        self.probe = nn.Parameter(torch.empty(1, 1, c.width))
        self.attention = _Attention(c.width, dtype)
        self.layernorm = LayerNorm(c.width, eps=c.ln_eps, dtype=dtype)
        self.mlp = _PoolMlp(c.width, c.mlp_width, dtype)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        dt, heads = self.compute_dtype, self.heads
        B, T, d = y.shape
        hd = d // heads
        w, b = self.attention.in_proj_weight, self.attention.in_proj_bias
        q = F.linear(cast(self.probe, dt), cast(w[:d], dt), cast(b[:d], dt))     # (1, 1, d): the same query for every crop
        k = F.linear(y, cast(w[d:2 * d], dt), cast(b[d:2 * d], dt))              # (B, T, d)
        v = F.linear(y, cast(w[2 * d:], dt), cast(b[2 * d:], dt))
        qh = q.reshape(1, 1, heads, hd).transpose(1, 2) * hd ** -0.5              # (1, h, 1, hd)
        kh = k.reshape(B, T, heads, hd).transpose(1, 2)                          # (B, h, T, hd)
        vh = v.reshape(B, T, heads, hd).transpose(1, 2)
        p = torch.softmax((qh @ kh.transpose(-1, -2)).float(), dim=-1).to(vh.dtype)
        a = self.attention.out_proj((p @ vh).transpose(1, 2).reshape(B, d))
        return a + self.mlp(self.layernorm(a))


class SigLIPImageTower(nn.Module):
    def __init__(self, cfg: SigLIPConfig = SigLIPConfig()):
        super().__init__()
        self.cfg = cfg
        c, dt = cfg, cfg.dtype
        self.patch_embedding = PatchConv(3, c.width, c.patch, dtype=dt, bias=True)
        self.positional_embedding = nn.Parameter(torch.empty((c.image_size // c.patch) ** 2, c.width))
        self.transformer = _Transformer(c, dt)
        self.post_layernorm = LayerNorm(c.width, eps=c.ln_eps, dtype=dt)
        self.head = PoolHead(c, dt)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: (B, image_size, image_size, 3) NHWC, normalised.
        Returns (B, width) float32 embeddings, unnormalised."""
        dt = self.cfg.dtype
        x = self.patch_embedding(images)
        x = x.reshape(x.shape[0], -1, self.cfg.width) + cast(self.positional_embedding, dt)
        for blk in self.transformer.resblocks:
            x = blk(x)
        return self.head(self.post_layernorm(x)).float()
