"""An open_clip-layout ViT image tower (a class token, ``ln_pre``,
``ln_post`` and ``proj``, an MLP of 4 x width, GELU or quick-GELU), scored
against class features by cosine: a labeler family.

Section keys: ``image_size``, ``patch``, ``width``, ``layers``, ``heads``,
``embed_dim``, ``quick_gelu`` and ``dtype``.  The program is the port's
``CLIPImageTower`` inside its ``OpenVocabLabeler``, which crops every box
to 224 x 224 and normalises with CLIP's mean and std; the reference is the
plain copy under ``benchmark/reference/models/clip/``.
"""
import torch

from benchmark.harness import counts, weights
from benchmark.harness.system import dtype_of

# the port's labeler crops to this size (models/clip/head.py:CROP)
CROP = 224
ATTENTION_SITES = ("boxfusion_tpu_torch.models.clip.model.whole_seq_attention",)
_KEYS = ("image_size", "patch", "width", "layers", "heads", "embed_dim", "quick_gelu")


def _kwargs(section: dict) -> dict:
    return {k: section[k] for k in _KEYS}


def program(section: dict, device) -> torch.nn.Module:
    from boxfusion_tpu_torch.models.clip.model import CLIPConfig, CLIPImageTower

    with torch.device(device):
        tower = CLIPImageTower(CLIPConfig(**_kwargs(section), dtype=dtype_of(section["dtype"])))
    return tower.to(device).eval()


def labeler(section: dict, tower: torch.nn.Module, text_features: torch.Tensor, device):
    from boxfusion_tpu_torch.models.clip import OpenVocabLabeler

    n = int(section["n_classes"])
    out = OpenVocabLabeler([f"class{i}" for i in range(n)], text_features.cpu().numpy(), cfg=tower.cfg,
                           sim_thres=float(section["sim_thres"]), device=device)
    return out.set_tower(tower)


def reference(section: dict, dtype: torch.dtype, device) -> torch.nn.Module:
    from benchmark.reference.models.clip.model import CLIPConfig, CLIPImageTower

    with torch.device(device):
        tower = CLIPImageTower(CLIPConfig(**_kwargs(section), dtype=dtype))
    return tower.to(device).eval()


def table(reference_tower: torch.nn.Module) -> dict:
    return weights.clip_table(reference_tower)


def flops(section: dict, crops: int) -> int:
    return counts.tower_flops(crops, section["image_size"], section["patch"], section["width"],
                              section["layers"], section["embed_dim"])


def crops(section: dict, image: torch.Tensor, boxes: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    from benchmark.reference.models.clip.head import _crop_normalize
    from benchmark.reference.models.clip.model import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD

    return _crop_normalize(image, boxes, dtype, size=CROP, mean=CLIP_IMAGE_MEAN, std=CLIP_IMAGE_STD)


def attention_shapes(section: dict) -> list:
    """The tower's one attention shape: the patch grid and the class token,
    at the head width."""
    return [((section["image_size"] // section["patch"]) ** 2 + 1, section["width"] // section["heads"])]
