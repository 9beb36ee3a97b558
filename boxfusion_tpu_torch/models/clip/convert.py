"""CLIP weights into the PyTorch towers.

Port of ``boxfusion_tpu/models/clip/convert.py``, reversed: the torch towers
already use open_clip's / OpenAI's state-dict names (the reference loads
``open_clip_pytorch_model.bin``, reference demo.py:395; tools/utils.py:342-353
loads ViT-H-14), so

  * ``load_clip_image_params`` / ``load_clip_text_params`` read such a
    checkpoint from disk, infer the config from its shapes (``infer_config``)
    and load it with ``load_state_dict``;
  * ``image_tower_from_flax`` / ``text_tower_from_flax`` turn a JAX-package
    parameter tree (a nested dict of arrays) into the towers' state dicts --
    this module's own copy of the mapping, so the port needs nothing of the
    JAX package;
  * ``load_siglip_image_params`` maps a Hugging Face SigLIP vision state
    dict (``vision_model.embeddings.patch_embedding``,
    ``encoder.layers.{i}.self_attn.{q,k,v}_proj``, ``head.probe``, ...) onto
    ``siglip.py``'s names, q, k and v concatenated into one in-projection.

Layout conventions: Dense kernel (in, out) -> Linear weight (out, in); conv
kernel HWIO -> (O, I, kh, kw); LayerNorm scale -> weight; Embed embedding ->
weight.
"""
from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from boxfusion_tpu_torch.models.clip.model import CLIPConfig, CLIPImageTower, CLIPTextTower
from boxfusion_tpu_torch.models.clip.siglip import SigLIPConfig, SigLIPImageTower
from boxfusion_tpu_torch.utils.device import DeviceLike, resolve_device

# open_clip vision-tower head counts by width: head_dim is 64 for B/L but
# grows for the larger towers (H: 80, g: 88, bigG: 104), so width alone
# cannot be divided by a fixed head size.
_VISION_HEADS = {768: 12, 1024: 16, 1280: 16, 1408: 16, 1664: 16}


def infer_config(sd: Mapping, quick_gelu: Optional[bool] = None, **kw) -> CLIPConfig:
    """The CLIPConfig of an open_clip / OpenAI state dict, from its shapes.

    ``kw`` passes further CLIPConfig fields through (``dtype``, ``attn_impl``).
    """
    width = sd["visual.conv1.weight"].shape[0]
    patch = sd["visual.conv1.weight"].shape[-1]
    # grid side from the positional-embedding token count (CLS + side**2)
    grid = int(round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5))
    layers = max(
        int(k.split(".")[3]) for k in sd if k.startswith("visual.transformer.resblocks.")
    ) + 1
    text_width = sd["ln_final.weight"].shape[0]
    text_layers = max(
        int(k.split(".")[2]) for k in sd if k.startswith("transformer.resblocks.")
    ) + 1
    embed_dim = sd["text_projection"].shape[1]
    return CLIPConfig(
        patch=int(patch),
        image_size=int(grid * patch),
        vocab_size=int(sd["token_embedding.weight"].shape[0]),
        context_length=int(sd["positional_embedding"].shape[0]),
        width=int(width),
        layers=int(layers),
        heads=_VISION_HEADS.get(int(width), int(width) // 64),
        embed_dim=int(embed_dim),
        text_width=int(text_width),
        text_layers=int(text_layers),
        text_heads=int(text_width) // 64,
        # The activation is NOT recoverable from tensor shapes: OpenAI L/14
        # uses QuickGELU while laion open_clip L/14 (identical shapes) uses
        # exact GELU.  Callers that know the checkpoint's provenance should
        # pass quick_gelu explicitly; the shape heuristic is only a default.
        quick_gelu=bool(width == 1024 and embed_dim == 768)
        if quick_gelu is None
        else bool(quick_gelu),
        **kw,
    )


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().float()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _load(tower: torch.nn.Module, sd: Mapping, what: str) -> None:
    missing, _ = tower.load_state_dict({k: _tensor(v) for k, v in sd.items()}, strict=False)
    if missing:
        raise ValueError(f"state dict lacks {len(missing)} {what} tensors, e.g. {missing[:3]}")


def convert_image_tower(sd: Mapping, quick_gelu: Optional[bool] = None,
                        device: DeviceLike = None, **kw) -> Tuple[CLIPImageTower, CLIPConfig]:
    """An image tower built to a full CLIP state dict's shapes, weights loaded."""
    cfg = infer_config(sd, quick_gelu, **kw)
    tower = CLIPImageTower(cfg)
    _load(tower, {k[len("visual."):]: v for k, v in sd.items() if k.startswith("visual.")},
          "image-tower")
    return tower.to(resolve_device(device)).eval(), cfg


def convert_text_tower(sd: Mapping, quick_gelu: Optional[bool] = None,
                       device: DeviceLike = None, **kw) -> Tuple[CLIPTextTower, CLIPConfig]:
    """A text tower built to a full CLIP state dict's shapes, weights loaded."""
    cfg = infer_config(sd, quick_gelu, **kw)
    tower = CLIPTextTower(cfg)
    _load(tower, {k: v for k, v in sd.items() if not k.startswith("visual.")}, "text-tower")
    return tower.to(resolve_device(device)).eval(), cfg


def _read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"CLIP checkpoint not found: {path} (expected open_clip/OpenAI "
            "torch weights, e.g. ViT-H-14; see README 'Checkpoints')"
        )
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k.replace("module.", ""): v for k, v in sd.items()}


def load_clip_image_params(path: str, device: DeviceLike = None, **kw):
    """Load a torch CLIP checkpoint -> (image tower on ``device``, CLIPConfig)."""
    return convert_image_tower(_read_state_dict(path), device=device, **kw)


def load_clip_text_params(path: str, device: DeviceLike = None, **kw):
    """Load a torch CLIP checkpoint -> (text tower on ``device``, CLIPConfig)."""
    return convert_text_tower(_read_state_dict(path), device=device, **kw)


# ---------------------------------------------------------- from the JAX trees
def _resblock_from_flax(sd: dict, prefix: str, node: Mapping) -> None:
    def norm(name, n):
        sd[f"{prefix}.{name}.weight"] = np.asarray(n["scale"])
        sd[f"{prefix}.{name}.bias"] = np.asarray(n["bias"])

    def dense(name, n):
        sd[f"{prefix}.{name}.weight"] = np.asarray(n["kernel"]).T
        sd[f"{prefix}.{name}.bias"] = np.asarray(n["bias"])

    norm("ln_1", node["ln_1"])
    sd[prefix + ".attn.in_proj_weight"] = np.asarray(node["attn_in_proj_weight"])
    sd[prefix + ".attn.in_proj_bias"] = np.asarray(node["attn_in_proj_bias"])
    dense("attn.out_proj", node["attn_out_proj"])
    norm("ln_2", node["ln_2"])
    dense("mlp.c_fc", node["mlp_fc"])
    dense("mlp.c_proj", node["mlp_proj"])


def _resblocks_from_flax(sd: dict, p: Mapping) -> None:
    i = 0
    while f"resblocks_{i}" in p:
        _resblock_from_flax(sd, f"transformer.resblocks.{i}", p[f"resblocks_{i}"])
        i += 1


def image_tower_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX-package CLIPImageTower parameters -> the torch tower's state dict."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, np.ndarray] = {
        "conv1.weight": np.asarray(p["conv1"]["kernel"]).transpose(3, 2, 0, 1),
        "class_embedding": np.asarray(p["class_embedding"]),
        "positional_embedding": np.asarray(p["positional_embedding"]),
        "ln_pre.weight": np.asarray(p["ln_pre"]["scale"]),
        "ln_pre.bias": np.asarray(p["ln_pre"]["bias"]),
        "ln_post.weight": np.asarray(p["ln_post"]["scale"]),
        "ln_post.bias": np.asarray(p["ln_post"]["bias"]),
        "proj": np.asarray(p["proj"]),
    }
    _resblocks_from_flax(sd, p)
    return {k: _tensor(v) for k, v in sd.items()}


def text_tower_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX-package CLIPTextTower parameters -> the torch tower's state dict."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, np.ndarray] = {
        "token_embedding.weight": np.asarray(p["token_embedding"]["embedding"]),
        "positional_embedding": np.asarray(p["positional_embedding"]),
        "ln_final.weight": np.asarray(p["ln_final"]["scale"]),
        "ln_final.bias": np.asarray(p["ln_final"]["bias"]),
        "text_projection": np.asarray(p["text_projection"]),
    }
    _resblocks_from_flax(sd, p)
    return {k: _tensor(v) for k, v in sd.items()}


# ------------------------------------------------------ SigLIP (Hugging Face)
# SigLIP vision-tower head counts by width: SO400M's 16 heads of 72 (a tower
# of another width names its heads)
_SIGLIP_HEADS = {1152: 16}
_SIGLIP_PREFIX = "vision_model."


def siglip_state_dict(sd: Mapping) -> Dict[str, torch.Tensor]:
    """A Hugging Face SigLIP vision state dict (keys with or without the
    ``vision_model.`` prefix; other towers' keys ignored) -> the state dict of
    ``SigLIPImageTower``: ``self_attn.{q,k,v}_proj`` concatenated, in that
    order, into ``attn.in_proj_weight`` / ``in_proj_bias``; the position
    embedding's ``nn.Embedding`` weight as the ``positional_embedding``."""
    src = {k[len(_SIGLIP_PREFIX):] if k.startswith(_SIGLIP_PREFIX) else k: v for k, v in sd.items()}
    out = {
        "patch_embedding.weight": src["embeddings.patch_embedding.weight"],
        "patch_embedding.bias": src["embeddings.patch_embedding.bias"],
        "positional_embedding": src["embeddings.position_embedding.weight"],
    }
    for name in ("weight", "bias"):
        out[f"post_layernorm.{name}"] = src[f"post_layernorm.{name}"]
    out["head.probe"] = src["head.probe"]
    for k in ("in_proj_weight", "in_proj_bias", "out_proj.weight", "out_proj.bias"):
        out[f"head.attention.{k}"] = src[f"head.attention.{k}"]
    for k in ("layernorm.weight", "layernorm.bias", "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight",
              "mlp.fc2.bias"):
        out[f"head.{k}"] = src[f"head.{k}"]
    i = 0
    while f"encoder.layers.{i}.layer_norm1.weight" in src:
        a, b = f"encoder.layers.{i}.", f"transformer.resblocks.{i}."
        for name in ("weight", "bias"):
            out[b + f"attn.in_proj_{name}"] = torch.cat(
                [_tensor(src[a + f"self_attn.{x}_proj.{name}"]) for x in "qkv"])
            out[b + f"attn.out_proj.{name}"] = src[a + f"self_attn.out_proj.{name}"]
            out[b + f"ln_1.{name}"] = src[a + f"layer_norm1.{name}"]
            out[b + f"ln_2.{name}"] = src[a + f"layer_norm2.{name}"]
            out[b + f"mlp.c_fc.{name}"] = src[a + f"mlp.fc1.{name}"]
            out[b + f"mlp.c_proj.{name}"] = src[a + f"mlp.fc2.{name}"]
        i += 1
    return {k: _tensor(v) for k, v in out.items()}


def infer_siglip_config(sd: Mapping, **kw) -> SigLIPConfig:
    """The SigLIPConfig of a port-named SigLIP state dict, from its shapes.

    The crop size is not in the shapes (a 27 x 27 grid of 14-px patches is a
    378- or a 384-px crop): SigLIPConfig's default where its grid matches,
    else the grid times the patch.  LayerNorm eps is SigLIP's 1e-6 and the
    pixel statistics its 0.5; ``kw`` passes these and further SigLIPConfig
    fields through (``heads``, ``image_size``, ``dtype``, ``attn_impl``)."""
    width, _, patch, _ = sd["patch_embedding.weight"].shape
    grid = int(round(sd["positional_embedding"].shape[0] ** 0.5))
    layers = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("transformer.resblocks."))
    if "heads" not in kw and int(width) not in _SIGLIP_HEADS:
        raise ValueError(f"a SigLIP tower {int(width)} wide: pass its heads")
    default = SigLIPConfig()
    fields = dict(
        image_size=default.image_size if default.image_size // patch == grid else grid * patch,
        patch=int(patch), width=int(width), layers=int(layers),
        heads=_SIGLIP_HEADS.get(int(width)),
        mlp_width=int(sd["transformer.resblocks.0.mlp.c_fc.weight"].shape[0]),
    )
    fields.update(kw)
    return SigLIPConfig(**fields)


def load_siglip_image_params(source, device: DeviceLike = None,
                             **kw) -> Tuple[SigLIPImageTower, SigLIPConfig]:
    """A Hugging Face SigLIP checkpoint (a path ``torch.load`` reads, or a
    state dict) -> (``SigLIPImageTower`` on ``device`` with its weights,
    its SigLIPConfig); ``kw`` as ``infer_siglip_config``'s."""
    sd = siglip_state_dict(_read_state_dict(source) if isinstance(source, str) else source)
    cfg = infer_siglip_config(sd, **kw)
    tower = SigLIPImageTower(cfg)
    tower.load_state_dict(sd, strict=True)
    return tower.to(resolve_device(device)).eval(), cfg
