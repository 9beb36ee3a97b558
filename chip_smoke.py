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
                float32 case, ViT-H's head width 80, CuTR's global shape
                (T = 1024), and bfloat16 cases at the bfloat16 kernel's tails
                (B = 69, T = 65, 129 at hd 128, 37 at hd 16), with registers,
                shared memory, blocks per SM and TB/s at the main shape;
                tiled_attention at CuTR's global blocks (12 x 1024
                and 12 x 4096, D = 64) and two ragged lengths, float32 and
                bfloat16, timed in float32 at 12 x 1024 and in bfloat16 at
                12 x 4096, with registers, shared memory and blocks per SM.
  2b. ablation -- the path that runs tiled_attention
                (boxfusion_tpu_torch/tools/attention_ablation.py): at the two
                global-block shapes, milliseconds of tiled_attention, of
                whole_seq_attention on the same data, of
                F.scaled_dot_product_attention and of the plain twin.
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
                framewise_boxes.pkl.  Then the same with --engine device
                --capacity 48: returns 0 and prints the world-box count.
  6. device oracle -- the sequence of phase 4 through DevicePipeline (state
                on the card) under engine "loops" and again under "unrolled":
                every ground-truth box within 0.15 m, at least one fused, no
                dropped or truncated count, the two engines' worlds equal
                (integers exact, floats 1e-6); milliseconds and host reads
                per keyframe of each.  Then save_state at the middle of a run,
                restore_state into a fresh pipeline, and the resumed world
                equal to the uninterrupted one.
  7. device main -- phase 3's configuration through
                CuTRDetector(device_output=True) -> DevicePipeline(capacity
                2048), unlabelled and then labelled by CLIP ViT-L/14 through
                label_boost_device (label budget 128: no row unlabelled), with
                keyframes/s, host reads per keyframe and the kernels' launch
                counts, zeroed just before each run and read just after; then
                one more unlabelled run with a synchronise around every stage
                of the step, for the stage split only.

Every phase prints one JSON record per line.  After them come the card's name
and power limit (as nvidia-smi gives them), then the kernels' record
{"kernels": [{"name", "route", "source", "replaces", "launches",
"max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}, ...]}
(both attention entries also have "registers", "local_bytes",
"smem_bytes" and "blocks_per_sm"; whole_seq_attention's "achieved_tb_s";
tiled_attention's, timed in float32 at (12, 1024), its bfloat16 reading at
(12, 4096) under "bf16"),
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
    # the bfloat16 kernel's tail logic: the host engine's label batch (69
    # live crops), one row past a key tile, hd 128, hd 16 with T < 64
    "label_batch_bf16": (69, 257, 16, 64, "bfloat16"),
    "tail_65_bf16": (3, 65, 4, 64, "bfloat16"),
    "tail_129_hd128_bf16": (2, 129, 2, 128, "bfloat16"),
    "ragged_bf16": (2, 37, 4, 16, "bfloat16"),
}
MAIN_ATTENTION_CASE = "clip_l14_bf16"
# what the kernels record adds for whole_seq_attention: kernel_info's, and the rate
KERNEL_INFO_KEYS = ("registers", "local_bytes", "smem_bytes", "blocks_per_sm")
ATTENTION_RECORD_KEYS = KERNEL_INFO_KEYS + ("achieved_tb_s",)


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
        kernel_info,
        whole_seq_attention,
        whole_seq_attention_reference,
    )

    main = None
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
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
        if case in ("clip_l14_f32", MAIN_ATTENTION_CASE):
            # ptxas's registers, shared memory and occupancy of the launch;
            # the query tiles (items), the blocks launched, and waves of
            # blocks (blocks_per_sm x SMs at a time)
            info = kernel_info(T, hd, q.dtype)
            items = info.get("n_qtiles", -(-T // 64)) * heads * B
            grid = info.get("n_groups", -(-T // 64)) * heads * B
            rec.update(info, items=items, grid=grid,
                       waves=grid / (n_sm * max(info["blocks_per_sm"], 1)))
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
            library_ms=library_ms, achieved_tb_s=n_bytes / (ms * 1e-3) / 1e12,
            **{key: rec[key] for key in KERNEL_INFO_KEYS},
        )
        print(json.dumps({**rec, **main}))
    return main


# tiled_attention cases: (BH, N), D = 64.  The first two are CuTR's global
# blocks (12 heads; N = (S / 16)^2 at 512 px and at 1024 px) and are the
# ablation's shapes; the last two are ragged against the 64-row tiles.
TILED_CASES = ((12, 1024), (12, 4096), (4, 320), (4, 576))
TILED_HEAD_DIM = 64
TILED_F32_TOL = 2e-4  # rtol = atol, the JAX package's bound for its kernel (tests/test_ops.py:31)
TILED_BF16_ROW_TOL = 2.0 ** -3  # bfloat16 atol, in units of the output row's root mean square


def tiled_tolerance(want):
    """The bound on |tiled_attention - reference_attention| at each element,
    from the twin's output ``want`` (BH, N, D).

    float32: TILED_F32_TOL + TILED_F32_TOL |want|.  bfloat16: rtol 2^-7 (one
    bfloat16 ulp of an output, as attention_tolerance) plus, per output row,
    an atol of TILED_BF16_ROW_TOL times the row's root mean square over its D
    channels, capped at attention_tolerance's 2e-2.  The difference comes
    from the twin's rounding of its scores to bfloat16 (the kernel keeps them
    in float32) and of each probability, so it scales with the row: on
    unit-variance inputs at N = 4096 an output is about 0.027 rms, and a
    fixed 2e-2 would pass errors as large as the values compared.
    """
    import torch

    w = want.float()
    if want.dtype == torch.float32:
        return TILED_F32_TOL * (1 + w.abs())
    atol = (w.pow(2).mean(-1, keepdim=True).sqrt() * TILED_BF16_ROW_TOL).clamp(
        max=attention_tolerance(torch.bfloat16)[0])
    return atol + 2.0 ** -7 * w.abs()


def tiled_row_error(got, want) -> float:
    """The largest difference beyond the rtol term, in units of its output
    row's root mean square: what TILED_BF16_ROW_TOL bounds."""
    w = want.float()
    beyond = (got.float() - w).abs() - 2.0 ** -7 * w.abs()
    return float((beyond / w.pow(2).mean(-1, keepdim=True).sqrt().clamp(min=1e-30)).max())


def tiled_case(device, bh: int, n: int, dtype, seed: int = 0):
    """Unit-variance (BH, N, 64) q, k, v from a seeded generator."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(bh, n, TILED_HEAD_DIM, generator=gen, device=device).to(dtype)
                 for _ in range(3))


def tiled_record(device, q, k, v, got, want) -> dict:
    """tiled_attention's timed record on (q, k, v), whose output ``got`` was
    checked against the twin's ``want``: its errors (bfloat16: also
    tiled_row_error), milliseconds of the kernel, its twin and SDPA on the
    same tensors, the bound at the dtype's peak (float32 FMA, or bf16 on the
    tensor cores), and kernel_info's keys."""
    import torch
    import torch.nn.functional as F

    from boxfusion_tpu_torch.tools.attention_ablation import kernel_info, reference_attention, tiled_attention

    bh, n, hd = q.shape
    reps = 50 if n <= 1024 else 10
    ms = cuda_ms(lambda: tiled_attention(q, k, v), reps=reps, warmup=5)
    plain_ms = cuda_ms(lambda: reference_attention(q, k, v), reps=10 if n <= 1024 else 3, warmup=2)
    # yardstick only: the package never calls it
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q[None], k[None], v[None]), reps=reps, warmup=5)
    ops = 4 * bh * n * n * hd                        # QK^T and PV once each, 2 per multiply-add
    n_bytes = 4 * bh * n * hd * q.element_size()     # q, k, v read once, o written once
    peak = PEAK_F32_FLOPS if q.dtype == torch.float32 else PEAK_BF16_FLOPS
    t_ops, t_bytes = ops / peak * 1e3, n_bytes / PEAK_BYTES_PER_S * 1e3
    info = kernel_info(bh, n, hd, q.dtype)
    err = float((got.float() - want.float()).abs().max())
    if q.dtype == torch.bfloat16:
        info["row_err"] = tiled_row_error(got, want)
    return dict(
        name="tiled_attention", route="cuda",
        source="boxfusion_tpu_torch/csrc/tiled_attention_kernel.cu",
        replaces="tools/pallas_attention_ablation.py:103",
        operations=ops, bytes=n_bytes, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=library_ms, **info,
    )


def check_tiled_attention(device) -> dict:
    """tiled_attention against reference_attention at every case, in float32
    and bfloat16.  Returns the kernel's record at (12, 1024) float32, with the
    bf16 record at (12, 4096) under "bf16"."""
    import torch

    from boxfusion_tpu_torch.tools.attention_ablation import reference_attention, tiled_attention

    timed = {(torch.float32, TILED_CASES[0]): None, (torch.bfloat16, TILED_CASES[1]): None}
    for dtype in (torch.float32, torch.bfloat16):
        for bh, n in TILED_CASES:
            q, k, v = tiled_case(device, bh, n, dtype)
            got = tiled_attention(q, k, v)
            want = reference_attention(q, k, v)
            torch.cuda.synchronize()
            if got.dtype != q.dtype or got.shape != q.shape or not torch.isfinite(got).all():
                raise RuntimeError(f"tiled_attention[{bh}x{n} {dtype}]: bad dtype, shape or non-finite")
            diff = (got.float() - want.float()).abs()
            err = float(diff.max())
            if float((diff - tiled_tolerance(want)).max()) > 0:
                raise RuntimeError(f"tiled_attention[{bh}x{n} {dtype}] disagrees with its plain twin: "
                                   f"max |diff| {err} beyond tiled_tolerance")
            rec = dict(phase="kernels", name="tiled_attention", BH=bh, N=n, head_dim=TILED_HEAD_DIM,
                       dtype=str(dtype).replace("torch.", ""), max_abs_err=err)
            if dtype == torch.float32:
                rec.update(atol=TILED_F32_TOL, rtol=TILED_F32_TOL)
            else:
                rec.update(row_err=tiled_row_error(got, want), row_tol=TILED_BF16_ROW_TOL, rtol=2.0 ** -7,
                           out_rms=float(want.float().pow(2).mean().sqrt()))
            if (dtype, (bh, n)) in timed:
                timed[dtype, (bh, n)] = tiled_record(device, q, k, v, got, want)
                rec.update(timed[dtype, (bh, n)])
            print(json.dumps(rec))
    f32, bf16 = timed.values()
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err", "row_err") + KERNEL_INFO_KEYS
    return {**f32, "bf16": {"BH": TILED_CASES[1][0], "N": TILED_CASES[1][1], **{k: bf16[k] for k in keys}}}


def phase_kernels(device) -> list:
    return [check_fitness(device), check_attention(device), check_tiled_attention(device)]


def phase_ablation(device) -> dict:
    """The attention ablation (boxfusion_tpu_torch/tools/attention_ablation.py):
    at CuTR's two global-block shapes, milliseconds of tiled_attention,
    whole_seq_attention on the same data with heads = 1,
    F.scaled_dot_product_attention and the plain twin.
    Returns tiled_attention's launch count over the phase."""
    import torch
    import torch.nn.functional as F

    from boxfusion_tpu_torch.ops.attention_kernel import whole_seq_attention
    from boxfusion_tpu_torch.tools.attention_ablation import reference_attention, tiled_attention

    tiled_attention.launches = 0
    for bh, n in TILED_CASES[:2]:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = tiled_case(device, bh, n, dtype)
            scale = TILED_HEAD_DIM ** -0.5
            reps = 100 if n <= 1024 else 20
            cols = dict(
                tiled_attention_ms=cuda_ms(lambda: tiled_attention(q, k, v), reps=reps, warmup=10),
                whole_seq_attention_ms=cuda_ms(lambda: whole_seq_attention(q, k, v, 1, scale), reps=reps,
                                               warmup=10),
                sdpa_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q[None], k[None], v[None]),
                                reps=reps, warmup=10),
                plain_ms=cuda_ms(lambda: reference_attention(q, k, v), reps=5, warmup=1),
            )
            same = float((tiled_attention(q, k, v).float()
                          - whole_seq_attention(q, k, v, 1, scale).float()).abs().max())
            print(json.dumps(dict(phase="ablation", BH=bh, N=n, head_dim=TILED_HEAD_DIM,
                                  dtype=str(dtype).replace("torch.", ""),
                                  tiled_vs_online_max_abs_diff=same, **cols)))
    torch.cuda.synchronize()
    launches = tiled_attention.launches
    if launches <= 0:
        raise RuntimeError("ablation: tiled_attention was never launched")
    return {"tiled_attention": launches}


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

    # the device engine through the same entry point
    import contextlib
    import io

    with open(os.path.join(HERE, "config/ca1m.yaml")) as f:
        raw = yaml.safe_load(f)
    out = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        raw["data"]["output_dir"] = os.path.join(tmp, "results")
        cfg_path = os.path.join(tmp, "ca1m.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(raw, f)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["synthetic", "--config", cfg_path, "--engine", "device",
                           "--capacity", "48", *extra_args])
        seconds = time.perf_counter() - t0
    lines = [ln for ln in out.getvalue().splitlines() if "device engine:" in ln]
    dev = dict(phase="cli", engine="device", rc=rc, seconds=seconds, printed=lines)
    print(json.dumps(dev))
    if rc != 0 or lines != ["[cli] device engine: 6 world boxes"]:
        raise RuntimeError(f"cli --engine device: rc {rc}, printed {lines}")
    return rec


# --------------------------------------------------------------------- phase 6
def _oracle_config(engine: str):
    from boxfusion_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(HERE, "config/ca1m.yaml"))
    cfg["box_fusion"]._data["pst_path"] = None  # the CLI's synthetic fallback
    cfg["association"]._data["engine"] = engine
    return cfg


def _worlds_equal(a: dict, b: dict, what: str) -> None:
    """Integer fields exact, floats within 1e-6 (tests/test_unrolled_engine.py:47-53)."""
    import numpy as np

    for k in ("init_id", "fusion_flag", "valid_num", "category", "frame_id"):
        if not np.array_equal(a[k], b[k]):
            raise RuntimeError(f"{what}: {k} differs: {a[k]} vs {b[k]}")
    if a["fusion_list"] != b["fusion_list"] or a["stats"] != b["stats"]:
        raise RuntimeError(f"{what}: fusion lists or stats differ")
    for k in ("xyzlhw", "R", "scores"):
        err = float(np.abs(a[k] - b[k]).max()) if len(a[k]) else 0.0
        if not err <= 1e-6:
            raise RuntimeError(f"{what}: {k} differs by {err}")


def run_device_oracle(device, engine: str, n_frames=60, n_boxes=6, noise=0.02):
    """Phase 4's sequence through DevicePipeline; returns (record, world)."""
    import numpy as np

    from boxfusion_tpu_torch.data.synthetic import OracleDetector, SyntheticSequence
    from boxfusion_tpu_torch.runtime import DevicePipeline

    seq = SyntheticSequence(n_frames=n_frames, n_boxes=n_boxes)
    pipe = DevicePipeline(_oracle_config(engine), OracleDetector(seq, noise=noise), capacity=512,
                          device=device)
    pipe.run(seq, export=False)  # first pass: allocator and library warm-up
    pipe.reset()
    pipe.detector = OracleDetector(seq, noise=noise)
    t0 = time.perf_counter()
    world = pipe.run(seq)
    seconds = time.perf_counter() - t0
    st = world["stats"]
    d = np.linalg.norm(world["xyzlhw"][:, None, :3] - seq.gt_xyzlhw[None, :, :3], axis=-1)
    rec = dict(phase="device_oracle", engine=engine, world_boxes=len(world["scores"]),
               gt_boxes=n_boxes, max_gt_match_m=float(d.min(0).max()),
               fused_boxes=int(world["fusion_flag"].sum()), keyframes=st["keyframes"],
               ms_per_keyframe=1e3 * seconds / st["keyframes"],
               step_ms_per_keyframe=1e3 * pipe.timings["step"] / st["keyframes"],
               host_reads_per_keyframe=pipe.host_reads / st["keyframes"], stats=st)
    print(json.dumps(rec))
    if not rec["max_gt_match_m"] < 0.15:
        raise RuntimeError(f"device oracle [{engine}]: a GT box is {rec['max_gt_match_m']:.3f} m away")
    if rec["fused_boxes"] < 1:
        raise RuntimeError(f"device oracle [{engine}]: no box was fused")
    bad = {k: v for k, v in st.items() if k != "keyframes" and v}
    if bad:
        raise RuntimeError(f"device oracle [{engine}]: dropped or truncated counts {bad}")
    if (engine == "unrolled") != (pipe.host_reads == 0):
        raise RuntimeError(f"device oracle [{engine}]: {pipe.host_reads} host reads")
    return rec, world


def run_snapshot_round_trip(device, n_frames=60, cut=40, noise=0.02) -> dict:
    """save_state after `cut` frames, restore_state into a fresh pipeline, run
    on: the world of the run that was never interrupted."""
    from boxfusion_tpu_torch.data.synthetic import OracleDetector, SyntheticSequence
    from boxfusion_tpu_torch.runtime import DevicePipeline

    seq = SyntheticSequence(n_frames=n_frames, n_boxes=6)
    frames = list(seq)
    cfg = _oracle_config("loops")
    gap = int(cfg["data"]["gap"])
    straight = DevicePipeline(cfg, OracleDetector(seq, noise=noise), capacity=512, device=device).run(frames)

    det = OracleDetector(seq, noise=noise)  # one noise stream across the cut
    first = DevicePipeline(cfg, det, capacity=512, device=device)
    for frame in frames[:cut]:
        if first.count % gap == 0:
            first.process_keyframe(frame)
        first.count += 1
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.pt")
        first.save_state(path)
        n_bytes = os.path.getsize(path)
        second = DevicePipeline(cfg, det, capacity=512, device=device)
        second.restore_state(path, count=first.count)
    resumed = second.run(frames[cut:])
    _worlds_equal(resumed, straight, "snapshot round trip")
    rec = dict(phase="device_snapshot", cut_frame=cut, snapshot_bytes=n_bytes,
               keyframes_before=int(first.state.stats[3]), world_boxes=len(resumed["scores"]),
               fused_boxes=int(resumed["fusion_flag"].sum()), equal_to_uninterrupted=True)
    print(json.dumps(rec))
    return rec


def phase_device_oracle(device) -> None:
    loops, w_loops = run_device_oracle(device, "loops")
    unrolled, w_unrolled = run_device_oracle(device, "unrolled")
    _worlds_equal(w_loops, w_unrolled, "loops vs unrolled")
    print(json.dumps(dict(phase="device_oracle", engines_equal=True,
                          unrolled_over_loops=unrolled["ms_per_keyframe"] / loops["ms_per_keyframe"])))
    run_snapshot_round_trip(device)


# --------------------------------------------------------------------- phase 7
STEP_STAGES = ("_append_detections", "_gated_iou_rows", "_nms_greedy", "_nms_greedy_unrolled",
               "_correspondence", "_correspondence_unrolled", "_compact", "_fuse_device")


class StageClock:
    """Host-clock seconds per stage of the keyframe step, each stage wrapped
    in a synchronise.  The syncs cost time themselves: used for one extra run
    that reports the split and no rate.  _gated_iou_rows runs inside
    _fuse_device too; its own entry counts both calls."""

    def __init__(self):
        self.seconds, self.saved = {}, {}

    def __enter__(self):
        import torch

        from boxfusion_tpu_torch.runtime import device_step

        sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
        for name in STEP_STAGES:
            fn = self.saved[name] = getattr(device_step, name)

            def timed(*args, _fn=fn, _name=name, **kw):
                sync()
                t0 = time.perf_counter()
                out = _fn(*args, **kw)
                sync()
                self.seconds[_name] = self.seconds.get(_name, 0.0) + time.perf_counter() - t0
                return out

            setattr(device_step, name, timed)
        return self

    def __exit__(self, *exc):
        from boxfusion_tpu_torch.runtime import device_step

        for name, fn in self.saved.items():
            setattr(device_step, name, fn)


def run_device_main_path(device, dimension=768, n_frames=24, gap=1, image_hw=(384, 512), kernels=(),
                         label=False, clip_cfg=None, capacity=2048, engine="loops", stage_clock=False):
    """Drive DevicePipeline + CuTRDetector(device_output=True) once, with or
    without the CLIP labeler (label_boost_device); returns (record, pipeline)."""
    import contextlib

    import numpy as np
    import torch

    from boxfusion_tpu_torch.data.synthetic import SyntheticSequence
    from boxfusion_tpu_torch.models.cutr import make_cutr
    from boxfusion_tpu_torch.runtime import CuTRDetector, DevicePipeline

    cfg = main_path_config()
    cfg["association"]._data["engine"] = engine
    # the device path labels a fixed budget of rows; 128 covers the detector's
    # top-100, so no row is left unlabelled (the host engine labels every row)
    cfg["detection"]._data["max_label_boxes"] = 128
    model = make_cutr(dimension, depth_model=True, device=device, seed=0,
                      dtype=cfg["detection"]["compute_dtype"])
    lift_class_bias(model)
    seq = SyntheticSequence(n_frames=n_frames, n_boxes=8, image_hw=image_hw, seed=0)
    frames = list(seq)  # synthesis is not pipeline work
    labeler = None
    if label:
        cfg["box_fusion"]._data["clip_sim_coeff"] = 1.0  # config/cubicle.yaml
        labeler = make_labeler(device, clip_cfg)
    detector = CuTRDetector(model, device=device, device_output=True, export_image=label)
    pipe = DevicePipeline(cfg, detector, labeler=labeler, capacity=capacity, device=device)
    detector(frames[0])  # warm the detector on frame 0, as the host engine's run does
    if device.type == "cuda":
        torch.cuda.synchronize()

    for k in kernels:
        k.launches = 0
    clock = StageClock() if stage_clock else contextlib.nullcontext()
    t0 = time.perf_counter()
    with clock:
        world = pipe.run(frames, gap=gap)
    seconds = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}

    st = world["stats"]
    n_kf = st["keyframes"]
    if len(world["scores"]) == 0 or not np.isfinite(world["xyzlhw"]).all():
        raise RuntimeError(f"device main path: world has {len(world['scores'])} boxes or is not finite")
    if st["dropped_world_capacity"] or st["dropped_obs_capacity"] or st["label_overflow"]:
        raise RuntimeError(f"device main path: dropped or unlabelled rows: {st}")
    if label and not set(world["categories"]) - {""}:
        raise RuntimeError("device main path: the world rows carry no CLIP labels")
    rec = dict(
        phase="device_main", labelled=bool(label), engine=engine, cutr_width=dimension,
        dtype=str(cfg["detection"]["compute_dtype"]), capacity=capacity,
        frames=n_frames, gap=gap, keyframes=n_kf, seconds=seconds, keyframes_per_s=n_kf / seconds,
        ms_per_keyframe=1e3 * seconds / n_kf, host_reads_per_keyframe=pipe.host_reads / n_kf,
        stage_ms_per_keyframe={k: 1e3 * v / n_kf for k, v in sorted(pipe.timings.items())},
        world_boxes=len(world["scores"]), observations=int(pipe.state.obs_n),
        fused_boxes=int(world["fusion_flag"].sum()), launches=launches, stats=st,
    )
    if label:
        rec["classes_in_world"] = len(set(world["categories"]))
    if stage_clock:
        rec["phase"] = "device_main_stage_split"
        rec["synced_step_stage_ms_per_keyframe"] = {k: 1e3 * v / n_kf for k, v in sorted(clock.seconds.items())}
        for k in ("seconds", "keyframes_per_s", "ms_per_keyframe"):
            del rec[k]  # the synchronises are in them
    return rec, pipe


def phase_device_main(device) -> dict:
    """Unlabelled, labelled, then the synced stage split; returns the launch
    counts of the labelled run."""
    from boxfusion_tpu_torch.ops.attention_kernel import whole_seq_attention
    from boxfusion_tpu_torch.ops.fitness_kernel import fitness_cells
    from boxfusion_tpu_torch.tools.attention_ablation import tiled_attention

    kernels = (fitness_cells, whole_seq_attention, tiled_attention)
    plain, _ = run_device_main_path(device, kernels=kernels)
    print(json.dumps(plain))
    if plain["launches"]["fitness_cells"] <= 0:
        raise RuntimeError("device main path: fitness_cells was never launched")
    if plain["launches"]["whole_seq_attention"] != 0:
        raise RuntimeError("device main path without a labeler launched whole_seq_attention")

    rec, _ = run_device_main_path(device, kernels=kernels, label=True)
    print(json.dumps(rec))
    for name in ("fitness_cells", "whole_seq_attention"):
        if rec["launches"][name] <= 0:
            raise RuntimeError(f"labelled device main path: {name} was never launched")
    if rec["launches"]["whole_seq_attention"] != 24 * rec["keyframes"]:
        raise RuntimeError("labelled device main path: not one attention launch per tower block")

    split, _ = run_device_main_path(device, stage_clock=True)
    print(json.dumps(split))
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
    log("phase 2b: the attention ablation (the path of tiled_attention)")
    launches = phase_ablation(device)
    log("phase 3: main path (CuTR-768 -> [CLIP ViT-L/14 labels] -> association -> PST fusion)")
    mrec = phase_main(device)
    log("phase 4: known-answer fusion (oracle)")
    phase_oracle(device)
    log("phase 5: the command-line entry point, host and device engines")
    phase_cli()
    log("phase 6: device engine, known answer under loops and unrolled; snapshot round trip")
    phase_device_oracle(device)
    log("phase 7: device engine, main path at full width, without and with labels")
    drec = phase_device_main(device)

    # launches: each kernel's count over the main path that runs it -- the
    # labelled host-engine run plus the labelled device-engine run for the
    # first two, the ablation for the third
    for name in ("fitness_cells", "whole_seq_attention"):
        launches[name] = mrec["launches"][name] + drec["launches"][name]
    keys = ("name", "route", "source", "replaces", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    extra = {"fitness_cells": (), "whole_seq_attention": ATTENTION_RECORD_KEYS,
             "tiled_attention": KERNEL_INFO_KEYS + ("bf16",)}
    kernels = [{**{k: rec[k] for k in keys + extra[rec["name"]]}, "launches": launches[rec["name"]]}
               for rec in krecs]
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
