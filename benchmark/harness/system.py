"""The system under test: the port's fused engine, built for one configuration.

``FusedDevicePipeline`` (``boxfusion_tpu_torch.runtime.fused``) with chunk 1
and the engine's default label bucketing, over the detector and the labeler
that the configuration's families build (``spec.load_families``), with
weights from ``weights.fill``.  This is the only module of the harness that
constructs the program; the window drives it through ``process_keyframe``,
``flush``, ``reset`` and ``export_world``.
"""
from __future__ import annotations

import dataclasses

import torch

from benchmark.harness import weights
from benchmark.harness.spec import Families


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


@dataclasses.dataclass
class Program:
    pipe: object          # FusedDevicePipeline
    model: torch.nn.Module
    labeler: object       # the labeler family's labeler object
    config: dict
    families: Families


def build_program(config: dict, families: Families, traffic: dict, device: torch.device) -> Program:
    """The port's fused engine with the configuration's weights, on ``device``."""
    from boxfusion_tpu_torch.runtime.fused import FusedDevicePipeline
    from boxfusion_tpu_torch.utils.config import load_config

    det, lab = config["detector"], config["labeler"]
    ref_det = families.detector.reference(det, torch.float32, "meta")
    ref_tower = families.labeler.reference(lab, torch.float32, "meta")
    model = families.detector.program(det, device)
    tower = families.labeler.program(lab, device)
    seed = int(config["weight_seed"])
    weights.fill(model, families.detector.table(ref_det, traffic["class_bias_lift"]), seed, device)
    weights.fill(tower, families.labeler.table(ref_tower), seed + 2, device)
    features = weights.text_features(lab["n_classes"], lab["embed_dim"], seed, device)
    labeler = families.labeler.labeler(lab, tower, features, device)
    settings = load_config(None, overrides=config["settings"])
    pipe = FusedDevicePipeline(settings, families.detector.detector(det, model, device), labeler=labeler,
                               capacity=int(config["capacity"]), depth_scale=float(config["depth_scale"]),
                               device=device, chunk=1)
    return Program(pipe=pipe, model=model, labeler=labeler, config=config, families=families)
