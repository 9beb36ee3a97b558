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

Each residual add and the LayerNorm after it are one ``add_norm``: a block's
``x + out_proj(o)`` with its ``ln_2``, its closing ``x + c_proj(h)`` with the
next block's ``ln_1`` (``_Transformer.chain``).  On a bfloat16 CUDA stream
that is one launch of ``ops/layer_norm_kernel.py:add_layer_norm``; anywhere
else, the add and the ``LayerNorm`` it replaces.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from boxfusion_tpu_torch.models.cutr.layers import LayerNorm, Linear, PatchConv
from boxfusion_tpu_torch.ops.attention_kernel import (
    whole_seq_attention,
    whole_seq_attention_reference,
)
from boxfusion_tpu_torch.ops.layer_norm_kernel import add_layer_norm
from boxfusion_tpu_torch.utils.device import torch_dtype

CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

ATTN_IMPLS = ("auto", "kernel", "xla")
# a block's GELU: exact (open_clip's ViT-H), quick (OpenAI's ViT-L), or the
# tanh approximation (SigLIP's gelu_pytorch_tanh)
GELUS = ("exact", "quick", "tanh")


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """ViT-H/14 by default (the reference's text-feature source)."""

    image_size: int = 224
    patch: int = 14
    width: int = 1280
    layers: int = 32
    heads: int = 16
    embed_dim: int = 1024
    # text tower
    vocab_size: int = 49408
    context_length: int = 77
    text_width: int = 1024
    text_layers: int = 24
    text_heads: int = 16
    quick_gelu: bool = False
    # compute dtype (a torch dtype, "float32" or "bfloat16"): parameters stay
    # float32; softmax and norm statistics stay float32; the returned
    # embeddings are float32
    dtype: object = torch.float32
    # Attention of unmasked (image-tower) blocks:
    #   "xla"    -- the plain form: einsum scores + float32 softmax (the name
    #               is the JAX package's);
    #   "kernel" -- ops/attention_kernel.py:whole_seq_attention (the CUDA
    #               kernel on a CUDA tensor; its plain twin on a CPU tensor);
    #   "auto"   -- "kernel" for CUDA tensors, the plain form for CPU tensors.
    # Masked (text-tower causal) blocks always take the plain form.
    attn_impl: str = "auto"

    def __post_init__(self):
        object.__setattr__(self, "dtype", torch_dtype(self.dtype))
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {self.attn_impl!r}")

    @property
    def gelu(self) -> str:
        return "quick" if self.quick_gelu else "exact"

    # the labeler's crops: image_size square, normalised by CLIP's statistics
    # of [0, 1] pixels
    @property
    def image_mean(self) -> np.ndarray:
        return CLIP_IMAGE_MEAN

    @property
    def image_std(self) -> np.ndarray:
        return CLIP_IMAGE_STD

    def image_tower(self) -> "CLIPImageTower":
        """The image tower of this config, its weights not yet set."""
        return CLIPImageTower(self)

    @staticmethod
    def vit_l14() -> "CLIPConfig":
        return CLIPConfig(
            patch=14, width=1024, layers=24, heads=16, embed_dim=768,
            text_width=768, text_layers=12, text_heads=12, quick_gelu=True,
        )

    @staticmethod
    def vit_h14() -> "CLIPConfig":
        return CLIPConfig()


def add_norm(x: torch.Tensor, d: Optional[torch.Tensor], norm: LayerNorm):
    """``(s, norm(s))`` for the residual stream ``s = x + d`` (``s = x``
    without ``d``).

    A bfloat16 CUDA stream under a bfloat16 ``norm``, outside autograd, takes
    one ``add_layer_norm`` launch (s bit-equal, the norm within a bfloat16
    ulp); anything else (CPU, float32, a graph that records gradients) runs
    the composition that launch replaces: the add in the compute dtype, then
    ``norm``."""
    if (x.is_cuda and x.dtype == torch.bfloat16 and norm.compute_dtype == torch.bfloat16
            and not (torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in (x, d, norm.weight, norm.bias)))):
        return add_layer_norm(x, d, norm.weight, norm.bias, norm.eps)
    s = x if d is None else x + d
    return s, norm(s)


def _gelu(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "quick":
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x, approximate="tanh" if kind == "tanh" else "none")


class _Attention(nn.Module):
    """The parameters of torch's ``nn.MultiheadAttention`` (packed in-proj)."""

    def __init__(self, d: int, dtype: torch.dtype):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = Linear(d, d, dtype=dtype)


class _Mlp(nn.Module):
    def __init__(self, d: int, dtype: torch.dtype, hidden: Optional[int] = None):
        super().__init__()
        hidden = 4 * d if hidden is None else hidden
        self.c_fc = Linear(d, hidden, dtype=dtype)
        self.c_proj = Linear(hidden, d, dtype=dtype)


class ResidualBlock(nn.Module):
    """Pre-norm transformer block of both towers (and of SigLIP's, siglip.py).

    ``gelu`` is one of ``GELUS``; it, ``mlp_width`` (default 4 x ``d``) and
    ``ln_eps`` default to open_clip's block.  ``forward``'s ``attn_impl`` is "kernel" or "xla"
    ("auto" is resolved by the image tower from its input's device); a block
    given a mask takes the plain form.
    """

    def __init__(self, d: int, heads: int, gelu: str = "exact",
                 dtype: torch.dtype = torch.float32, mlp_width: Optional[int] = None,
                 ln_eps: float = 1e-5):
        super().__init__()
        if gelu not in GELUS:
            raise ValueError(f"gelu must be one of {GELUS}, got {gelu!r}")
        self.heads = heads
        self.gelu = gelu
        self.compute_dtype = dtype
        self.ln_1 = LayerNorm(d, eps=ln_eps, dtype=dtype)
        self.attn = _Attention(d, dtype)
        self.ln_2 = LayerNorm(d, eps=ln_eps, dtype=dtype)
        self.mlp = _Mlp(d, dtype, mlp_width)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                attn_impl: str = "xla") -> torch.Tensor:
        """The block's output for the residual stream ``x``."""
        return self.step(x, add_norm(x, None, self.ln_1)[1], None, mask, attn_impl)[0]

    def step(self, x: torch.Tensor, h: torch.Tensor, next_norm: Optional[LayerNorm],
             mask: Optional[torch.Tensor] = None, attn_impl: str = "xla"):
        """The block on the residual stream ``x``, given ``h = ln_1(x)``.

        Returns ``(x', next_norm(x'))``, ``x'`` the block's output, its
        closing add and ``next_norm`` in one ``add_norm``; ``(x', None)``
        without ``next_norm``."""
        dt = self.compute_dtype
        d = x.shape[-1]
        hd = d // self.heads
        qkv = F.linear(h, self.attn.in_proj_weight.to(dt), self.attn.in_proj_bias.to(dt))
        q, k, v = qkv.chunk(3, dim=-1)
        if attn_impl == "kernel" and mask is None:
            # scores and probabilities never reach device memory; same
            # numerics contract as the plain form below
            o = whole_seq_attention(q, k, v, heads=self.heads, sm_scale=hd ** -0.5)
        elif mask is None:
            o = whole_seq_attention_reference(q, k, v, self.heads, hd ** -0.5)
        else:
            B, N, _ = q.shape
            qh = (q * (hd ** -0.5)).reshape(B, N, self.heads, hd).transpose(1, 2)
            kh = k.reshape(B, N, self.heads, hd).permute(0, 2, 3, 1)
            vh = v.reshape(B, N, self.heads, hd).transpose(1, 2)
            attn = torch.softmax(((qh @ kh) + mask).float(), dim=-1).to(v.dtype)
            o = (attn @ vh).transpose(1, 2).reshape(B, N, d)
        x, h = add_norm(x, self.attn.out_proj(o), self.ln_2)
        # rebound as they go, so that ln_2's output is freed before the GELU,
        # and c_fc's before c_proj (the card's peak memory is at the MLP)
        h = self.mlp.c_fc(h)
        h = _gelu(h, self.gelu)
        out = self.mlp.c_proj(h)
        if next_norm is None:
            return x + out, None
        return add_norm(x, out, next_norm)


class _Transformer(nn.Module):
    def __init__(self, d: int, layers: int, heads: int, gelu: str, dtype: torch.dtype, **block_kw):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualBlock(d, heads, gelu, dtype=dtype, **block_kw) for _ in range(layers)
        )

    def chain(self, final_norm: Optional[LayerNorm] = None):
        """Each block with the norm its closing add feeds, in one
        ``add_norm``: the next block's ``ln_1``, and ``final_norm`` after the
        last block (None: a plain add).

        A tower runs ``h = add_norm(x, None, blocks[0].ln_1)[1]``, then ``x, h
        = blk.step(x, h, next_norm)`` over these pairs, in its own loop: a
        helper that took ``x`` would keep the tower's first stream alive
        through every block."""
        blocks = list(self.resblocks)
        return zip(blocks, [b.ln_1 for b in blocks[1:]] + [final_norm])


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
        self.transformer = _Transformer(c.width, c.layers, c.heads, c.gelu, dt)
        self.ln_post = LayerNorm(c.width, eps=1e-5, dtype=dt)
        self.proj = nn.Parameter(torch.empty(c.width, c.embed_dim))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: (B, 224, 224, 3) NHWC, already CLIP-normalized.

        Returns (B, embed_dim) unnormalized float32 embeddings."""
        c, dt = self.cfg, self.cfg.dtype
        x = self.conv1(images.to(dt))
        B = x.shape[0]
        x = x.reshape(B, -1, c.width)
        cls = self.class_embedding.to(dt)[None, None].expand(B, 1, c.width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding[None].to(dt)
        x = add_norm(x, None, self.ln_pre)[1]
        impl = c.attn_impl
        if impl == "auto":
            impl = "kernel" if x.device.type == "cuda" else "xla"
        h = add_norm(x, None, self.transformer.resblocks[0].ln_1)[1]
        for blk, next_norm in self.transformer.chain():
            x, h = blk.step(x, h, next_norm, attn_impl=impl)
        x = self.ln_post(x[:, 0])
        # final projection + the cosine-similarity math downstream stay float32
        return x.float() @ self.proj

    def init_random(self, gen: torch.Generator) -> None:
        init_clip_weights(self, gen)


class CLIPTextTower(nn.Module):
    """open_clip text transformer with causal mask + EOT pooling."""

    def __init__(self, cfg: CLIPConfig = CLIPConfig()):
        super().__init__()
        self.cfg = cfg
        c, dt = cfg, cfg.dtype
        self.token_embedding = nn.Embedding(c.vocab_size, c.text_width)
        self.positional_embedding = nn.Parameter(torch.empty(c.context_length, c.text_width))
        self.transformer = _Transformer(c.text_width, c.text_layers, c.text_heads, c.gelu, dt)
        self.ln_final = LayerNorm(c.text_width, eps=1e-5, dtype=dt)
        self.text_projection = nn.Parameter(torch.empty(c.text_width, c.embed_dim))
        L = c.context_length
        causal = torch.full((L, L), float("-inf")).triu(1)[None, None]
        self.register_buffer("causal_mask", causal, persistent=False)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: (B, context_length) integer ids.  Returns (B, embed_dim) float32."""
        dt = self.cfg.dtype
        x = self.token_embedding.weight[tokens].to(dt) + self.positional_embedding[None].to(dt)
        for blk in self.transformer.resblocks:
            x = blk(x, mask=self.causal_mask)
        x = self.ln_final(x)
        eot = tokens.argmax(dim=-1)  # the EOT token has the highest id
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return pooled.float() @ self.text_projection


@torch.no_grad()
def init_clip_weights(tower: nn.Module, gen: torch.Generator) -> None:
    """Random weights in the JAX package's scheme: Dense kernels lecun-normal
    with zero biases, in-projections xavier-uniform, norms at identity, class
    and position embeddings normal(0.02) (text positions 0.01), projections
    normal(width ** -0.5), token embeddings normal(1)."""
    from boxfusion_tpu_torch.models.cutr.model import _lecun_normal_

    for m in tower.modules():
        if isinstance(m, nn.Linear):
            _lecun_normal_(m.weight, m.in_features, gen)
            m.bias.zero_()
        elif isinstance(m, PatchConv):
            _lecun_normal_(m.weight, m.weight[0].numel(), gen)
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, _Attention):
            nn.init.xavier_uniform_(m.in_proj_weight, generator=gen)
            m.in_proj_bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=gen)
    if isinstance(tower, CLIPImageTower):
        tower.class_embedding.normal_(0.0, 0.02, generator=gen)
        tower.positional_embedding.normal_(0.0, 0.02, generator=gen)
        tower.proj.normal_(0.0, tower.cfg.width ** -0.5, generator=gen)
    elif isinstance(tower, CLIPTextTower):
        tower.positional_embedding.normal_(0.0, 0.01, generator=gen)
        tower.text_projection.normal_(0.0, tower.cfg.text_width ** -0.5, generator=gen)
