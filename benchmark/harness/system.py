"""The system under test: the port's fused engine, built for one configuration.

``FusedDevicePipeline`` (``boxfusion_tpu_torch.runtime.fused``) with chunk 1
and the engine's default label bucketing, over a CuTR detector and a CLIP
labeler whose weights come from ``weights.fill``.  This is the only module
of the harness that constructs the program; the window drives it through
``process_keyframe``, ``flush``, ``reset`` and ``export_world``.
"""
from __future__ import annotations

import dataclasses

import torch

from benchmark.harness import weights


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def reference_shapes(config: dict):
    """The plain reference's CuTR and CLIP tower on the ``meta`` device:
    parameter names and shapes, no memory."""
    from benchmark.reference.models.clip.model import CLIPConfig, CLIPImageTower
    from benchmark.reference.models.cutr.model import CubifyTransformer, CuTRConfig

    det, lab = config["detector"], config["labeler"]
    with torch.device("meta"):
        cutr = CubifyTransformer(CuTRConfig(embed_dim=det["embed_dim"], depth_model=det["depth_model"]))
        tower = CLIPImageTower(CLIPConfig(**clip_kwargs(lab), dtype=torch.float32))
    return cutr, tower


def clip_kwargs(lab: dict) -> dict:
    return {k: lab[k] for k in ("image_size", "patch", "width", "layers", "heads", "embed_dim",
                                "quick_gelu")}


@dataclasses.dataclass
class Program:
    pipe: object          # FusedDevicePipeline
    model: torch.nn.Module
    labeler: object       # OpenVocabLabeler
    config: dict


def build_program(config: dict, traffic: dict, device: torch.device) -> Program:
    """The port's fused engine with the configuration's weights, on ``device``."""
    from boxfusion_tpu_torch.models.clip import CLIPConfig, OpenVocabLabeler
    from boxfusion_tpu_torch.models.clip.model import CLIPImageTower
    from boxfusion_tpu_torch.models.cutr.model import CubifyTransformer, CuTRConfig
    from boxfusion_tpu_torch.runtime.detector import CuTRDetector
    from boxfusion_tpu_torch.runtime.fused import FusedDevicePipeline
    from boxfusion_tpu_torch.utils.config import load_config

    det, lab = config["detector"], config["labeler"]
    ref_cutr, ref_tower = reference_shapes(config)
    with torch.device(device):
        model = CubifyTransformer(CuTRConfig(embed_dim=det["embed_dim"], depth_model=det["depth_model"],
                                             dtype=dtype_of(det["dtype"])))
        tower = CLIPImageTower(CLIPConfig(**clip_kwargs(lab), dtype=dtype_of(lab["dtype"])))
    model = model.to(device).eval()
    seed = int(config["weight_seed"])
    weights.fill(model, weights.cutr_table(ref_cutr, traffic["class_bias_lift"]), seed, device)
    weights.fill(tower, weights.clip_table(ref_tower), seed + 2, device)
    features = weights.text_features(lab["n_classes"], lab["embed_dim"], seed, device)
    labeler = OpenVocabLabeler([f"class{i}" for i in range(lab["n_classes"])], features.cpu().numpy(),
                               cfg=tower.cfg, sim_thres=float(lab["sim_thres"]), device=device)
    labeler.set_tower(tower)
    settings = load_config(None, overrides=config["settings"])
    pipe = FusedDevicePipeline(settings, CuTRDetector(model, device=device), labeler=labeler,
                               capacity=int(config["capacity"]), depth_scale=float(config["depth_scale"]),
                               device=device, chunk=1)
    return Program(pipe=pipe, model=model, labeler=labeler, config=config)
