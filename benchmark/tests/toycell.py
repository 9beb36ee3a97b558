"""A toy cell for the CPU tests, written as new files into a directory of
its own: a configuration cut from ``ca1m-cutr768-vith14`` (CuTR-192, a
two-layer tower, a 128-particle search), a traffic mix of small scans, its
limits and one extra metric reader; with ``toy_labeler`` also a labeler
family of its own (``TOY_FAMILY``), a tower the open_clip family cannot
express.  The harness finds them by name, next to the benchmark's own
folder, and no file of the benchmark is edited."""
from __future__ import annotations

import json
import os

import torch

from benchmark.harness import weights
from benchmark.harness.spec import BENCH_DIR, load_cell, load_families

TOY_METRIC = '''"""Keyframes of the unprofiled window (a toy reader)."""


def read(obs):
    return float(obs.unprofiled.keyframes)
'''

TOY_FAMILY = '''"""A toy labeler family: a plain ViT image tower with no class token,
mean-pooled over its patch tokens, with an MLP of 2 x width.  The program
runs it on the port's layers and attention entry point, inside the port's
``OpenVocabLabeler`` (224-px crops, CLIP's mean and std); the reference on
the benchmark's plain layers."""
import types

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.harness import counts, weights
from benchmark.harness.system import dtype_of

CROP = 224
ATTENTION_SITES = ("boxfusion_tpu_torch.ops.attention_kernel.whole_seq_attention",)


def _port_attention(q, k, v, heads, sm_scale):
    from boxfusion_tpu_torch.ops import attention_kernel

    return attention_kernel.whole_seq_attention(q, k, v, heads=heads, sm_scale=sm_scale)


def _reference_attention(q, k, v, heads, sm_scale):
    from benchmark.reference.ops.attention_kernel import whole_seq_attention_reference

    return whole_seq_attention_reference(q, k, v, heads, sm_scale)


class _Block(nn.Module):
    def __init__(self, width, heads, layers, dtype, attention):
        super().__init__()
        self.heads, self.attention = heads, attention
        self.ln_1 = layers.LayerNorm(width, eps=1e-6, dtype=dtype)
        self.qkv = layers.Linear(width, 3 * width, dtype=dtype)
        self.out = layers.Linear(width, width, dtype=dtype)
        self.ln_2 = layers.LayerNorm(width, eps=1e-6, dtype=dtype)
        self.fc1 = layers.Linear(width, 2 * width, dtype=dtype)
        self.fc2 = layers.Linear(2 * width, width, dtype=dtype)

    def forward(self, x):
        q, k, v = self.qkv(self.ln_1(x)).chunk(3, dim=-1)
        x = x + self.out(self.attention(q, k, v, self.heads, (x.shape[-1] // self.heads) ** -0.5))
        return x + self.fc2(F.gelu(self.fc1(self.ln_2(x))))


class ToyTower(nn.Module):
    def __init__(self, section, dtype, layers, attention):
        super().__init__()
        w, p = section["width"], section["patch"]
        self.cfg = types.SimpleNamespace(dtype=dtype)  # what the labeler reads of a tower
        self.conv1 = layers.PatchConv(3, w, p, dtype=dtype, bias=False)
        self.positional_embedding = nn.Parameter(torch.empty((CROP // p) ** 2, w))
        self.blocks = nn.ModuleList(_Block(w, section["heads"], layers, dtype, attention)
                                    for _ in range(section["layers"]))
        self.ln_post = layers.LayerNorm(w, eps=1e-6, dtype=dtype)
        self.head = layers.Linear(w, section["embed_dim"])

    def forward(self, images):
        x = self.conv1(images)
        x = x.reshape(x.shape[0], -1, x.shape[-1]) + self.positional_embedding.to(x.dtype)
        for blk in self.blocks:
            x = blk(x)
        return self.head(self.ln_post(x.float().mean(dim=1)).float())


def program(section, device):
    from boxfusion_tpu_torch.models.cutr import layers

    with torch.device(device):
        tower = ToyTower(section, dtype_of(section["dtype"]), layers, _port_attention)
    return tower.to(device).eval()


def labeler(section, tower, text_features, device):
    from boxfusion_tpu_torch.models.clip import OpenVocabLabeler

    n = int(section["n_classes"])
    out = OpenVocabLabeler([f"class{i}" for i in range(n)], text_features.cpu().numpy(), cfg=tower.cfg,
                           sim_thres=float(section["sim_thres"]), device=device)
    return out.set_tower(tower)


def reference(section, dtype, device):
    from benchmark.reference.models.cutr import layers

    with torch.device(device):
        tower = ToyTower(section, dtype, layers, _reference_attention)
    return tower.to(device).eval()


def table(reference_tower):
    return weights.clip_table(reference_tower)


def flops(section, crops):
    w, p = section["width"], section["patch"]
    grid = (CROP // p) ** 2
    return (counts._linear(crops * grid, p * p * 3, w)
            + section["layers"] * counts._vit_block(crops * grid, crops * grid * grid, w, 2 * w)
            + counts._linear(crops, w, section["embed_dim"]))


def crops(section, image, boxes, dtype):
    from benchmark.reference.models.clip.head import _crop_normalize
    from benchmark.reference.models.clip.model import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD

    return _crop_normalize(image, boxes, dtype, CROP, CLIP_IMAGE_MEAN, CLIP_IMAGE_STD)


def attention_shapes(section):
    return [((CROP // section["patch"]) ** 2, section["width"] // section["heads"])]
'''
TOY_LABELER = dict(family="toy_vit", arch="toy: no class token, mean-pooled, MLP 2 x width", patch=32, width=64,
                   layers=2, heads=2, embed_dim=32, dtype="bfloat16", n_classes=8, sim_thres=0.0)

# set from the toy's readings on the CPU (PERF.md): the program (bfloat16)
# against the float32 reference over seeds 1-12, and the control over seeds
# 1-3 (test_bench_control.py)
TOY_LIMITS = dict(det_enc_logit=0.15, det_row=2.0, det_miss=0.15, label_sim=1.0, label_sim_mean=0.05,
                  step_mismatch=0.0, fusion_fit=0.5)


def write_toy(root: str, limits=None, toy_labeler: bool = False) -> str:
    """Write the toy layout under ``root``; returns its BENCHMARK.json."""
    for sub in ("configs", "traffic", "limits", "metrics", "families"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    with open(os.path.join(BENCH_DIR, "configs", "ca1m-cutr768-vith14.json")) as f:
        config = json.load(f)
    config.update(name="toy", capacity=128)
    config["detector"].update(embed_dim=192)
    config["labeler"].update(arch="toy", patch=32, width=64, layers=2, heads=2, embed_dim=32, n_classes=8)
    if toy_labeler:
        config["labeler"] = dict(TOY_LABELER)
        with open(os.path.join(root, "families", "toy_vit.py"), "w") as f:
            f.write(TOY_FAMILY)
    s = config["settings"]
    s["box_fusion"].update(pst_size=128, iters=3, max_fusions_per_frame=4)
    s["association"].update(max_views=5, max_observations=1024)
    with open(os.path.join(BENCH_DIR, "traffic", "scan.cluttered.json")) as f:
        traffic = json.load(f)
    traffic.update(frame_hw=[192, 256], frames_per_scan=24, gap=3, scans=2, orbit_sweep_deg=40.0, live_target=30,
                   lift_keyframes=3, warmup_keyframes=2, profiled_keyframes=2, check_keyframes=2,
                   check_searches=2, check_label_keyframes=2)
    # the calibration the traffic file keeps for each configuration it serves
    families = load_families(config, [root, BENCH_DIR])
    traffic["class_bias_lift"] = {"toy": weights.fit_lift(config, families, traffic, torch.device("cpu"))[0]}
    files = {
        "configs/toy.json": config,
        "traffic/toy.json": traffic,
        "limits/toy.cell.json": {"limits": {k: {"limit": v} for k, v in (limits or TOY_LIMITS).items()}},
    }
    for rel, data in files.items():
        with open(os.path.join(root, rel), "w") as f:
            json.dump(data, f, indent=1)
    with open(os.path.join(root, "metrics", "toy_keyframes.py"), "w") as f:
        f.write(TOY_METRIC)
    with open(os.path.join(BENCH_DIR, os.pardir, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [dict(bench["configs"][0], name="toy", file="configs/toy.json")]
    bench["workloads"] = [dict(name="toy.cell", config="toy", traffic="toy", chips=1, why="toy")]
    bench["per_layer"] = bench["per_layer"] + [dict(name="toy_keyframes", unit="keyframes", better="higher",
                                                    source="program_counter", layer="engine loop",
                                                    moves="frames_per_s")]
    path = os.path.join(root, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(bench, f, indent=1)
    return path


def toy_cell(root: str, limits=None, toy_labeler: bool = False):
    return load_cell("toy.cell", bench_json=write_toy(root, limits, toy_labeler), dirs=[root, BENCH_DIR])
