#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (boxfusion_tpu_torch) on one GPU.

Usage, from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure stops the run with a non-zero exit code:

  1. build   -- compile every CUDA kernel of the package from csrc/ with
                nvcc (sm_90a), all sources at once; print the build seconds
                and ptxas's register / spill lines of each library.
  2. kernels -- each kernel against its plain PyTorch twin on the card, on
                seeded inputs; fail beyond the stated tolerance; time the
                kernel, the twin and (attention) one library call with CUDA
                events.  fitness_cells at the main path's 160 cells x 1024
                particles; whole_seq_attention at the CLIP label batch
                (B = 128, T = 257, 16 x 64) in bfloat16 and float32, a ragged
                float32 case, ViT-H's head width 80 and CuTR's global shape
                (T = 1024).
  3. main    -- the host engine's keyframe path end to end, twice, on a
                synthetic 512x384 sequence, every frame a keyframe:
                (a) CuTR-768 RGB-D (random weights from a seed, bf16, class
                bias lifted as bench.py does) -> association -> 1024-particle
                PST fusion; (b) the same with open-vocabulary labeling: a CLIP
                ViT-L/14 image tower (full width and depth, bf16, random
                weights from a seed) over every detection's crop, 473 random
                text features, the CLIP score boost.  The kernels' launch
                counts are zeroed just before each run and read just after; a
                kernel of the path that never launched fails the run.
  4. oracle  -- known-answer fusion: 60 frames, 6 boxes, oracle detections
                with 2 cm noise must recover every ground-truth box within
                0.15 m and fuse at least one.
  5. cli     -- the normal entry point, in-process on the card:
                boxfusion_tpu_torch.cli.main(["synthetic", "--config", ...])
                with config/ca1m.yaml's output_dir pointed at a temporary
                directory; it must return 0 and write a readable
                framewise_boxes.pkl.

Every phase prints one JSON record per line.  After them come the card's name
and power limit (as nvidia-smi gives them), then the kernels' record
{"kernels": [{"name", "route", "source", "replaces", "launches",
"max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}, ...]},
and the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device it prints nothing on stdout and exits 1.
"""
from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): float32 outside the tensor
# cores, dense bf16 on them, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

FITNESS_TOL = 2e-3  # the JAX package's own Pallas-vs-XLA bound
CELLS_OBJECTS, CELLS_VIEWS, PARTICLES = 16, 10, 1024  # max_fusions x max_views x pst_size

# whole_seq_attention cases: name -> (B, T, heads, head width, dtype).  The
# first is the main path's shape (the CLIP ViT-L/14 label batch) and the one
# that is timed.
ATTENTION_CASES = {
    "clip_l14_bf16": (128, 257, 16, 64, "bfloat16"),
    "clip_l14_f32": (128, 257, 16, 64, "float32"),
    "ragged_f32": (3, 37, 4, 16, "float32"),       # tests/test_ops.py:51-69
    "clip_h14_bf16": (8, 257, 16, 80, "bfloat16"),
    "cutr_global_bf16": (1, 1024, 12, 64, "bfloat16"),
}
MAIN_ATTENTION_CASE = "clip_l14_bf16"


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------------- phase 1
def phase_build() -> dict:
    from boxfusion_tpu_torch.ops import build

    t0 = time.perf_counter()
    builds = build.build_all()
    wall = time.perf_counter() - t0
    for b in builds.values():
        lines = [ln.strip() for ln in b.log.splitlines()
                 if "registers" in ln or "spill" in ln or "stack frame" in ln]
        print(json.dumps({"phase": "build", "kernel": b.name, "seconds": round(b.seconds, 3),
                          "ptxas": lines}))
    print(json.dumps({"phase": "build", "wall_seconds": round(wall, 3)}))
    return builds


# --------------------------------------------------------------------- phase 2
def fitness_scene(device, n_obj=CELLS_OBJECTS, n_views=CELLS_VIEWS, n_particles=PARTICLES, seed=0):
    """Arguments of fitness_cells at the main path's shapes.

    n_obj boxes, each observed from 3-7 views of a camera ring around it
    (projections of the true box), the remaining view slots padded the way
    the pipeline pads them (identity pose, zero corners, masked); the
    candidate is the true box perturbed, as at a PST iteration.
    """
    import numpy as np
    import torch

    from boxfusion_tpu_torch.fusion.kernel import kernel_inputs, project_candidates
    from boxfusion_tpu_torch.fusion.pst import synthesize_pst
    from boxfusion_tpu_torch.geometry.boxes import box_corners
    from boxfusion_tpu_torch.geometry.projection import project_corners_to_image
    from boxfusion_tpu_torch.ops.fitness_kernel import prepare_observed

    rng = np.random.RandomState(seed)
    K = np.array([[460.8, 0, 256], [0, 460.8, 192], [0, 0, 1]], np.float32)
    gt = np.concatenate([rng.uniform(-1.5, 1.5, (n_obj, 3)), rng.uniform(0.2, 0.9, (n_obj, 3))], 1)
    yaw = rng.uniform(-np.pi, np.pi, n_obj)
    R = np.zeros((n_obj, 3, 3), np.float32)
    R[:, 0, 0], R[:, 0, 1], R[:, 1, 0], R[:, 1, 1] = np.cos(yaw), -np.sin(yaw), np.sin(yaw), np.cos(yaw)
    R[:, 2, 2] = 1.0
    poses = np.tile(np.eye(4, dtype=np.float32), (n_obj, n_views, 1, 1))
    vmask = np.zeros((n_obj, n_views), np.float32)
    for o in range(n_obj):
        m = rng.randint(3, 8)  # about half the slots live
        for i in range(m):
            ang = rng.uniform(0, 2 * np.pi)
            eye = gt[o, :3] + np.array([3 * np.cos(ang), 3 * np.sin(ang), 0.8])
            fwd = gt[o, :3] - eye
            fwd /= np.linalg.norm(fwd)
            right = np.cross(np.array([0.0, 0.0, -1.0]), fwd)
            right /= np.linalg.norm(right)
            poses[o, i, :3, :3] = np.stack([right, np.cross(fwd, right), fwd], 1)
            poses[o, i, :3, 3] = eye
            vmask[o, i] = 1.0
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    corners3d = box_corners(t(gt), t(R))[:, None].expand(n_obj, n_views, 8, 3)
    obs = project_corners_to_image(corners3d, t(poses), t(K), 384.0, 512.0)
    obs = torch.where(t(vmask)[..., None, None] > 0, obs, 0.0)  # padded slots: zeros
    cand = gt + rng.normal(0, 0.05, gt.shape)
    uv = project_candidates(t(cand), t(R), t(synthesize_pst(n_particles)), t(np.full((n_obj, 6), 0.1)),
                            t(poses), t(K), 384.0, 512.0)
    prep = prepare_observed(obs.reshape(n_obj * n_views, 8, 2))
    return kernel_inputs(uv, prep, t(vmask) > 0)


def check_fitness(device) -> dict:
    import torch

    from boxfusion_tpu_torch.ops.fitness_kernel import (
        fitness_cells,
        fitness_cells_reference,
        operation_count,
    )

    args = fitness_scene(device)
    u, v, hull, planes, pvalid, area, wmask = args
    got = fitness_cells(*args)
    want = fitness_cells_reference(*args)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise RuntimeError("fitness_cells: non-finite output")
    if (got[wmask[:, 0] == 0] != 0).any():
        raise RuntimeError("fitness_cells: a masked cell is not zero")
    err = float((got - want).abs().max())
    if not err <= FITNESS_TOL:
        raise RuntimeError(f"fitness_cells disagrees with its plain twin: max |diff| {err} > {FITNESS_TOL}")

    ms = cuda_ms(lambda: fitness_cells(*args), reps=200, warmup=10)
    plain_ms = cuda_ms(lambda: fitness_cells_reference(*args), reps=10, warmup=2)

    C, _, P = u.shape
    live = int((wmask[:, 0] > 0).sum())
    n_bytes = (live * 2 * 8 * P + C * (16 + 36 + 12 + 2) + C * P) * 4
    ops = operation_count(u, v, pvalid, wmask)
    t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, n_bytes / PEAK_BYTES_PER_S * 1e3
    rec = dict(
        name="fitness_cells", route="cuda",
        source="boxfusion_tpu_torch/csrc/fitness_kernel.cu",
        replaces="boxfusion_tpu/ops/fitness_kernel.py:344",
        cells=C, live_cells=live, particles=P, operations=ops, bytes=n_bytes,
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=None,  # no single PyTorch call computes this function
    )
    print(json.dumps({"phase": "kernels", **rec}))
    return rec


def attention_tolerance(dtype):
    """(atol, rtol) of whole_seq_attention against its twin on the card.

    float32: rtol = atol = 1e-5, the JAX package's own Pallas-vs-XLA bound
    (tests/test_ops.py:68-69); key tiling changes the summation order only.
    bfloat16, against the twin run in bfloat16 on unit-variance inputs: atol
    2e-2 (the twin rounds its scores to bfloat16, the kernel keeps them in
    float32; then one bfloat16 rounding of a probability and of an output)
    plus rtol 2^-7, one bfloat16 ulp of an output above 2.5.
    """
    import torch

    return (1e-5, 1e-5) if dtype == torch.float32 else (2e-2, 2.0 ** -7)


def attention_case(device, case: str, seed: int = 0):
    """(q, k, v, heads, sm_scale) of one ATTENTION_CASES entry: unit-variance
    values from a seeded generator, as the three chunk views of one
    (B, T, 3D) tensor -- the strided views the CLIP block hands the wrapper."""
    import torch

    B, T, heads, hd, dtype = ATTENTION_CASES[case]
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(B, T, 3 * heads * hd, generator=gen, device=device).to(getattr(torch, dtype))
    q, k, v = qkv.chunk(3, dim=-1)
    return q, k, v, heads, hd ** -0.5


def check_attention(device) -> dict:
    import torch
    import torch.nn.functional as F

    from boxfusion_tpu_torch.ops.attention_kernel import (
        whole_seq_attention,
        whole_seq_attention_reference,
    )

    main = None
    for case, (B, T, heads, hd, dtype) in ATTENTION_CASES.items():
        q, k, v, _, scale = attention_case(device, case)
        got = whole_seq_attention(q, k, v, heads, scale)
        want = whole_seq_attention_reference(q, k, v, heads, scale)
        torch.cuda.synchronize()
        if got.dtype != q.dtype or got.shape != q.shape or not torch.isfinite(got).all():
            raise RuntimeError(f"whole_seq_attention[{case}]: bad dtype, shape or non-finite output")
        atol, rtol = attention_tolerance(q.dtype)
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        if float((diff - (atol + rtol * want.float().abs())).max()) > 0:
            raise RuntimeError(f"whole_seq_attention[{case}] disagrees with its plain twin: "
                               f"max |diff| {err} beyond atol {atol} + rtol {rtol}")
        rec = dict(phase="kernels", name="whole_seq_attention", case=case, B=B, T=T, heads=heads,
                   head_dim=hd, dtype=dtype, max_abs_err=err, atol=atol, rtol=rtol)
        if case == "clip_l14_f32":  # the FMA kernel's time at the main shape, for the record
            q4, k4, v4 = (x.reshape(B, T, heads, hd).transpose(1, 2) for x in (q, k, v))
            rec["ms"] = cuda_ms(lambda: whole_seq_attention(q, k, v, heads, scale), reps=20)
            rec["plain_ms"] = cuda_ms(
                lambda: whole_seq_attention_reference(q, k, v, heads, scale), reps=10)
            rec["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale), reps=20)
        if case != MAIN_ATTENTION_CASE:
            print(json.dumps(rec))
            continue

        # timing at the main shape.  q, k, v (269 MB) exceed the 50 MB L2, so
        # every launch finds the cache cold, as in the tower.
        ms = cuda_ms(lambda: whole_seq_attention(q, k, v, heads, scale), reps=50, warmup=5)
        plain_ms = cuda_ms(lambda: whole_seq_attention_reference(q, k, v, heads, scale), reps=10, warmup=2)
        # yardstick only: one library call computing the same function on the
        # same tensors; the package never calls it
        q4, k4, v4 = (x.reshape(B, T, heads, hd).transpose(1, 2) for x in (q, k, v))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale),
                             reps=50, warmup=5)
        ops = 4 * B * heads * T * T * hd                 # QK^T and PV, 2 per multiply-add
        n_bytes = 4 * B * T * heads * hd * q.element_size()  # q, k, v read once, o written once
        t_ops, t_bytes = ops / PEAK_BF16_FLOPS * 1e3, n_bytes / PEAK_BYTES_PER_S * 1e3
        main = dict(
            name="whole_seq_attention", route="cuda",
            source="boxfusion_tpu_torch/csrc/attention_kernel.cu",
            replaces="boxfusion_tpu/ops/attention_kernel.py:87",
            operations=ops, bytes=n_bytes, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=library_ms,
        )
        print(json.dumps({**rec, **main}))
    return main


def phase_kernels(device) -> list:
    return [check_fitness(device), check_attention(device)]


# --------------------------------------------------------------------- phase 3
def main_path_config():
    """config/ca1m.yaml as bench.py's on-card recipe sets it."""
    from boxfusion_tpu_torch.utils.config import load_config

    c = load_config(os.path.join(HERE, "config/ca1m.yaml"))
    c["detection"]._data["score_thresh"] = 0.3
    c["detection"]._data["uv_bound"] = False
    c["detection"]._data["floor_mask"] = False
    c["box_fusion"]._data["pst_path"] = None  # synthesize_pst(1024)
    for sec, key, want in (("association", "max_views", 10), ("box_fusion", "max_fusions_per_frame", 16),
                           ("box_fusion", "iters", 20), ("box_fusion", "pst_size", 1024)):
        if int(c[sec][key]) != want:
            raise RuntimeError(f"{sec}.{key} is {c[sec][key]}, the main path needs {want}")
    return c


def lift_class_bias(model, delta: float = 3.2) -> None:
    """bench.py's calibration: random-init logits sit at the focal prior
    (score ~0.01), so +3.2 on every class head puts a realistic detection
    load above the 0.3 filter.  FLOPs are unchanged."""
    import torch

    from boxfusion_tpu_torch.models.cutr.heads import ClassPredictor

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, ClassPredictor):
                m.linear.bias += delta


def clip_l14_config():
    """The CLIP ViT-L/14 image tower as bench.py sizes it for the card."""
    from boxfusion_tpu_torch.models.clip import CLIPConfig

    return CLIPConfig(patch=14, width=1024, layers=24, heads=16, embed_dim=1024,
                      quick_gelu=True, dtype="bfloat16")


class CountingLabeler:
    """The labeler, counting the crops it is given and the rows it drops."""

    def __init__(self, labeler):
        self.labeler, self.calls, self.crops, self.dropped = labeler, 0, 0, 0

    def __call__(self, image, boxes):
        categories, feats, sims = self.labeler(image, boxes)
        self.calls += 1
        self.crops += len(categories)
        self.dropped += sum(c == "" for c in categories)
        return categories, feats, sims


def make_labeler(device, clip_cfg=None, n_classes=473):
    """Random tower weights from seed 0; bench.py's random text features."""
    import numpy as np

    from boxfusion_tpu_torch.models.clip import OpenVocabLabeler

    clip_cfg = clip_cfg or clip_l14_config()
    text = np.random.RandomState(1).randn(n_classes, clip_cfg.embed_dim).astype(np.float32)
    names = [f"class{i}" for i in range(n_classes)]
    return OpenVocabLabeler(names, text, cfg=clip_cfg, device=device).init_random(0)


def run_main_path(device, dimension=768, n_frames=24, gap=1, image_hw=(384, 512), kernels=(),
                  label=False, clip_cfg=None):
    """Drive OnlinePipeline + CuTRDetector once, with or without the CLIP
    labeler; returns (record, pipeline)."""
    import numpy as np

    from boxfusion_tpu_torch.data.synthetic import SyntheticSequence
    from boxfusion_tpu_torch.models.cutr import make_cutr
    from boxfusion_tpu_torch.runtime import CuTRDetector, OnlinePipeline

    cfg = main_path_config()
    model = make_cutr(dimension, depth_model=True, device=device, seed=0,
                      dtype=cfg["detection"]["compute_dtype"])
    lift_class_bias(model)
    seq = SyntheticSequence(n_frames=n_frames, n_boxes=8, image_hw=image_hw, seed=0)
    frames = list(seq)  # synthesis is not pipeline work
    labeler = None
    if label:
        cfg["box_fusion"]._data["clip_sim_coeff"] = 1.0  # config/cubicle.yaml
        labeler = CountingLabeler(make_labeler(device, clip_cfg))
    pipe = OnlinePipeline(cfg, CuTRDetector(model, device=device), labeler=labeler, device=device)

    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    world = pipe.run(frames, gap=gap)  # warms the detector on frame 0 first
    seconds = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}

    n_kf = len(range(0, n_frames, gap)) + (0 if (n_frames - 1) % gap == 0 else 1)
    xyz = world.arrays.get("xyzlhw", np.zeros((0, 6)))
    if len(world) == 0 or not np.isfinite(xyz).all():
        raise RuntimeError(f"main path: world has {len(world)} boxes, finite={np.isfinite(xyz).all()}")
    if label and (set(world.categories) <= {"object"} or "" in world.categories
                  or world.arrays["features"].shape[1] != labeler.labeler.cfg.embed_dim):
        raise RuntimeError("main path: the world rows carry no CLIP labels or features")
    rec = dict(
        phase="main", labelled=bool(label), cutr_width=dimension,
        dtype=str(cfg["detection"]["compute_dtype"]),
        frames=n_frames, gap=gap, keyframes=n_kf, seconds=seconds, keyframes_per_s=n_kf / seconds,
        stage_ms_per_keyframe={k: 1e3 * v / n_kf for k, v in sorted(pipe.timings.items())},
        world_boxes=len(world), observations=pipe.box_count,
        fused_boxes=int(np.sum(pipe.manager.fusion_flag)), launches=launches,
    )
    if label:
        c = labeler.labeler.cfg
        rec.update(clip=dict(width=c.width, layers=c.layers, heads=c.heads, patch=c.patch,
                             embed_dim=c.embed_dim, dtype=str(c.dtype)),
                   labelled_keyframes=labeler.calls, crops=labeler.crops,
                   crops_per_keyframe=labeler.crops / max(labeler.calls, 1),
                   labelled_rows=labeler.crops - labeler.dropped, dropped_rows=labeler.dropped,
                   classes_in_world=len(set(world.categories)))
    return rec, pipe


def phase_main(device) -> dict:
    """Both paths, each with the counts zeroed just before and read just
    after; returns the launch counts of the labelled run."""
    from boxfusion_tpu_torch.ops.attention_kernel import whole_seq_attention
    from boxfusion_tpu_torch.ops.fitness_kernel import fitness_cells

    kernels = (fitness_cells, whole_seq_attention)
    plain, _ = run_main_path(device, kernels=kernels)
    print(json.dumps(plain))
    if plain["launches"]["fitness_cells"] <= 0:
        raise RuntimeError("main path: fitness_cells was never launched")
    if plain["launches"]["whole_seq_attention"] != 0:
        raise RuntimeError("main path without a labeler launched whole_seq_attention")

    rec, _ = run_main_path(device, kernels=kernels, label=True)
    print(json.dumps(rec))
    for name, n in rec["launches"].items():
        if n <= 0:
            raise RuntimeError(f"labelled main path: {name} was never launched")
    if rec["launches"]["whole_seq_attention"] != rec["clip"]["layers"] * rec["labelled_keyframes"]:
        raise RuntimeError("labelled main path: not one attention launch per tower block")
    return rec


# --------------------------------------------------------------------- phase 4
def run_oracle(device, n_frames=60, n_boxes=6, noise=0.02):
    """The CLI's synthetic default with oracle detections (cli.py:136-149)."""
    import numpy as np

    from boxfusion_tpu_torch.data.synthetic import OracleDetector, SyntheticSequence
    from boxfusion_tpu_torch.runtime import OnlinePipeline
    from boxfusion_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(HERE, "config/ca1m.yaml"))
    cfg["box_fusion"]._data["pst_path"] = None  # the CLI's synthetic fallback
    seq = SyntheticSequence(n_frames=n_frames, n_boxes=n_boxes)
    pipe = OnlinePipeline(cfg, OracleDetector(seq, noise=noise), device=device)
    world = pipe.run(seq)  # the config's keyframe gap, as the CLI runs it
    d = np.linalg.norm(world.arrays["xyzlhw"][:, None, :3] - seq.gt_xyzlhw[None, :, :3], axis=-1)
    rec = dict(phase="oracle", world_boxes=len(world), gt_boxes=n_boxes,
               max_gt_match_m=float(d.min(0).max()), fused_boxes=int(np.sum(pipe.manager.fusion_flag)))
    return rec


def phase_oracle(device) -> dict:
    rec = run_oracle(device)
    print(json.dumps(rec))
    if not rec["max_gt_match_m"] < 0.15:
        raise RuntimeError(f"oracle: a GT box is {rec['max_gt_match_m']:.3f} m from every world box")
    if rec["fused_boxes"] < 1:
        raise RuntimeError("oracle: no box was fused")
    return rec


# --------------------------------------------------------------------- phase 5
def phase_cli(extra_args=()) -> dict:
    """The package's normal entry point on its default device (the card)."""
    import numpy as np
    import yaml

    from boxfusion_tpu_torch import cli

    with open(os.path.join(HERE, "config/ca1m.yaml")) as f:
        raw = yaml.safe_load(f)
    with tempfile.TemporaryDirectory() as tmp:
        raw["data"]["output_dir"] = os.path.join(tmp, "results")
        cfg_path = os.path.join(tmp, "ca1m.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(raw, f)
        t0 = time.perf_counter()
        rc = cli.main(["synthetic", "--config", cfg_path, *extra_args])
        seconds = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"cli: main returned {rc}")
        with open(os.path.join(raw["data"]["output_dir"], "framewise_boxes.pkl"), "rb") as f:
            saved = pickle.load(f)
    corners = np.stack([np.asarray(row[1]) for row in saved[0]])
    rec = dict(phase="cli", rc=rc, seconds=seconds, observations=len(saved[0]),
               classes=sorted({int(row[0]) for row in saved[0]}))
    print(json.dumps(rec))
    if corners.shape[1:] != (8, 3) or len(corners) < 6 or not np.isfinite(corners).all():
        raise RuntimeError(f"cli: framewise_boxes.pkl holds corners of shape {corners.shape}")
    return rec


# ------------------------------------------------------------------------ main
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    device = torch.device("cuda", 0)

    log("phase 1: build")
    phase_build()
    log("phase 2: kernels against their plain twins")
    krecs = phase_kernels(device)
    log("phase 3: main path (CuTR-768 -> [CLIP ViT-L/14 labels] -> association -> PST fusion)")
    mrec = phase_main(device)
    log("phase 4: known-answer fusion (oracle)")
    phase_oracle(device)
    log("phase 5: the command-line entry point")
    phase_cli()

    keys = ("name", "route", "source", "replaces", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    kernels = [{**{k: rec[k] for k in keys}, "launches": mrec["launches"][rec["name"]]}
               for rec in krecs]
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
