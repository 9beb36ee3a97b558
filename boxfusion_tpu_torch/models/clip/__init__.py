from boxfusion_tpu_torch.models.clip.head import OpenVocabLabeler, build_labeler, scale_boxes
from boxfusion_tpu_torch.models.clip.model import CLIPConfig, CLIPImageTower, CLIPTextTower
from boxfusion_tpu_torch.models.clip.siglip import SigLIPConfig, SigLIPImageTower

__all__ = [
    "OpenVocabLabeler",
    "build_labeler",
    "scale_boxes",
    "CLIPImageTower",
    "CLIPTextTower",
    "CLIPConfig",
    "SigLIPConfig",
    "SigLIPImageTower",
]
