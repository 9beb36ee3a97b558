"""SigLIP's image tower (no class token, a learned position embedding, pre-norm
blocks with an MLP of ``mlp_width`` and tanh-GELU, a post-LayerNorm and an
attention-pool head), scored against class features by cosine: a labeler
family.

Section keys: ``image_size``, ``patch``, ``width``, ``layers``, ``heads``,
``mlp_width``, ``ln_eps``, ``image_mean``, ``image_std``, ``embed_dim`` (the
pool head's output: ``width``) and ``dtype``.  The program is the port's
``SigLIPImageTower`` inside its ``OpenVocabLabeler``, which crops every box
to the tower's ``image_size`` and normalises with its mean and std; the
reference is the plain tower under ``benchmark/reference/models/siglip/``.
"""
import math

import numpy as np
import torch
import torch.nn as nn

from benchmark.harness import counts
from benchmark.harness.system import dtype_of

ATTENTION_SITES = ("boxfusion_tpu_torch.models.clip.model.whole_seq_attention",)
_KEYS = ("image_size", "patch", "width", "layers", "heads", "mlp_width", "ln_eps")


def _kwargs(section: dict) -> dict:
    return {k: section[k] for k in _KEYS}


def program(section: dict, device) -> torch.nn.Module:
    from boxfusion_tpu_torch.models.clip.siglip import SigLIPConfig, SigLIPImageTower

    cfg = SigLIPConfig(**_kwargs(section), image_mean=section["image_mean"], image_std=section["image_std"],
                       dtype=dtype_of(section["dtype"]))
    with torch.device(device):
        tower = SigLIPImageTower(cfg)
    return tower.to(device).eval()


def labeler(section: dict, tower: torch.nn.Module, text_features: torch.Tensor, device):
    from boxfusion_tpu_torch.models.clip import OpenVocabLabeler

    n = int(section["n_classes"])
    out = OpenVocabLabeler([f"class{i}" for i in range(n)], text_features.cpu().numpy(), cfg=tower.cfg,
                           sim_thres=float(section["sim_thres"]), device=device)
    return out.set_tower(tower)


def reference(section: dict, dtype: torch.dtype, device) -> torch.nn.Module:
    from benchmark.reference.models.siglip.model import SigLIPConfig, SigLIPImageTower

    with torch.device(device):
        tower = SigLIPImageTower(SigLIPConfig(**_kwargs(section), dtype=dtype))
    return tower.to(device).eval()


def table(reference_tower: torch.nn.Module) -> dict:
    """{parameter name: ("normal", std) or ("const", value)}: in-projections
    (the blocks' and the pool's) at the Xavier variance, norms at identity,
    biases zero, the position embedding and the probe normal(0.02), every
    other kernel normal with variance 1 / fan-in, but the two kernels that
    close each block's residual branches (``attn.out_proj``, ``mlp.c_proj``)
    scaled by 1 / sqrt(2 x layers), as GPT-2 initialises its residual layers.

    That scale keeps the random stream from collapsing onto one direction:
    unscaled, the blocks' near-uniform attention and GELU's positive mean add
    the same vector to every token, the tokens of a crop read a mean cosine
    of 0.81 after 27 layers, the pool's near-uniform average of them is that
    common direction, and one class wins nearly every crop by a margin that
    neither bfloat16 nor float8 rounding crosses, so the label check could
    not tell the two apart.  Scaled, the tokens' cosine is 0.24."""
    from benchmark.reference.models.siglip import model as siglip

    residual = 1.0 / math.sqrt(2 * len(reference_tower.transformer.resblocks))
    out = {}
    for mname, m in reference_tower.named_modules():
        pre = f"{mname}." if mname else ""
        for pname, p in m.named_parameters(recurse=False):
            name = pre + pname
            if isinstance(m, nn.LayerNorm):
                out[name] = ("const", 1.0 if pname == "weight" else 0.0)
            elif isinstance(m, siglip._Attention) and pname == "in_proj_weight":
                out[name] = ("normal", math.sqrt(2.0 / (p.shape[0] + p.shape[1])))
            elif pname in ("positional_embedding", "probe"):
                out[name] = ("normal", 0.02)
            elif p.dim() == 1:
                out[name] = ("const", 0.0)
            elif p.dim() == 4:
                out[name] = ("normal", 1.0 / math.sqrt(p[0].numel()))
            elif name.startswith("transformer.") and name.endswith(("attn.out_proj.weight", "mlp.c_proj.weight")):
                out[name] = ("normal", residual / math.sqrt(p.shape[-1]))
            else:
                out[name] = ("normal", 1.0 / math.sqrt(p.shape[-1]))
    return out


def flops(section: dict, crops: int) -> int:
    """FLOPs of one tower call over ``crops`` crops: the patch embedding, each
    block's linears and its two attention products (4 T^2 D), and the pool
    head (the probe's query projection once a call; per crop the k and v
    projections over T tokens, the one query's two products, the
    out-projection and the MLP)."""
    T = (section["image_size"] // section["patch"]) ** 2
    D, M = section["width"], section["mlp_width"]
    lin = counts._linear
    block = lin(T, D, 3 * D) + 4 * T * T * D + lin(T, D, D) + lin(T, D, M) + lin(T, M, D)
    pool = lin(T, D, 2 * D) + 4 * T * D + lin(1, D, D) + lin(1, D, M) + lin(1, M, D)
    per_crop = lin(T, section["patch"] ** 2 * 3, D) + section["layers"] * block + pool
    return int(crops * per_crop + lin(1, D, D))


def crops(section: dict, image: torch.Tensor, boxes: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    from benchmark.reference.models.clip.head import _crop_normalize

    return _crop_normalize(image, boxes, dtype, size=section["image_size"],
                           mean=np.asarray(section["image_mean"], np.float32),
                           std=np.asarray(section["image_std"], np.float32))


def attention_shapes(section: dict) -> list:
    """The tower's one attention shape: the patch grid (no class token), at
    the head width."""
    return [((section["image_size"] // section["patch"]) ** 2, section["width"] // section["heads"])]
