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
                particles; pst_search (the whole PST search, one launch) at
                16 objects x 10 view slots x 1024 particles, 20 iterations
                and one, against pst_search_reference, timed beside the
                plain version and the eager loop around fitness_cells (the
                path before it, whose launches it counts), with registers,
                shared memory and the cluster; whole_seq_attention at the CLIP label batch
                (B = 128, T = 257, 16 x 64) in bfloat16 and float32, a ragged
                float32 case, ViT-H's head width 80, CuTR's global shape
                (T = 1024), and bfloat16 cases at the bfloat16 kernel's tails
                (B = 69, T = 65, 129 at hd 128, 37 at hd 16), with registers,
                shared memory, blocks per SM and TB/s at the main shape;
                tiled_attention at CuTR's global blocks (12 x 1024
                and 12 x 4096, D = 64) and two ragged lengths, float32 and
                bfloat16, timed in float32 at 12 x 1024 and in bfloat16 at
                12 x 4096, with registers, shared memory and blocks per SM;
                the step kernels (nms_greedy, correspond_hits) against their
                twins on a recorded keyframe of a synthetic scan and on
                random worlds at the cells' shapes (2048 slots, 10 views,
                16,384 observations), every output equal, timed beside the
                twins on the card, with registers, spills and shared memory,
                and the bit check of their float32 pose terms against
                PyTorch's operations (10^5 pose pairs, card and CPU).
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
                kernel of the path that never launched fails the run, and so
                does a fitness_cells launch (fusion is pst_search's).
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
                on the card, the one keyframe step): every ground-truth box
                within 0.15 m, at least one fused, no dropped or truncated
                count; milliseconds and host reads per keyframe.  Then
                save_state at the middle of a run, restore_state into a fresh
                pipeline, and the resumed world equal to the uninterrupted
                one (integers exact, floats 1e-6).
  7. device main -- phase 3's configuration through
                CuTRDetector(device_output=True) -> DevicePipeline(capacity
                2048), unlabelled and then labelled by CLIP ViT-L/14 through
                label_boost_device (label budget 128: no row unlabelled), with
                keyframes/s, host reads per keyframe and the kernels' launch
                counts, zeroed just before each run and read just after; then
                one more unlabelled run with a synchronise around every stage
                of the step, for the stage split only.
  8. fused   -- FusedDevicePipeline on phase 7's configuration and frames
                (depth in whole millimetres, so its u16 upload is lossless)
                beside DevicePipeline in the same call: unlabelled at chunk 1
                and 8, labelled with the fixed budget of 100 crops and with
                label buckets (0, 32, 64, 96, 100) at chunk 1 and 8.  Held
                equal (integers exact, floats 1e-6): fused to device,
                unlabelled and at the fixed budget; chunk 8 to chunk 1.  The
                buckets against the fixed budget run the tower at another
                batch: the bf16 difference is printed, and the same
                comparison at float32 (8 frames) is held (LABEL_BOUNDS:
                decisions equal, scores and boxes 1e-4).  Keyframes/s, host reads per
                keyframe, label crops and the label stage's synced ms per
                keyframe, world and fused boxes, launches per run.
  9. batched -- BatchedPipeline, 4 lanes (seeds 0-3), packed, unlabelled and
                labelled (one tower call over 4 x 100 crops a round):
                keyframes/s, per-lane frames/s, host reads per round, the
                CLIP batch whole_seq_attention saw.  Each lane held equal to
                a DevicePipeline run of its frames fed the detections that
                lane's step took; against a plain single-sequence
                device-engine run (CuTR at batch 1, the tower at 100 crops)
                the bf16 difference is printed.
 10. eval    -- ``python -m boxfusion_tpu_torch.eval --config
                config/ca1m.yaml --synthetic 2`` as a subprocess must print
                AP@0.25 = AP@0.50 = 1.0000; evaluate_sequences_batched over 4
                synthetic sequences with CuTR-768 must return and write its
                4 pickles.
 11. train   -- ``python -m boxfusion_tpu_torch.train`` as a subprocess at
                full width (CuTR-768 RGB-D float32, 384x512 frames, depth at
                1/4, batch 8, 20 steps): rc 0, every printed loss finite, the
                step-20 checkpoint restored to equal parameters, steps/s over
                steps 2-20.  In process, on one batch of 8: synced ms of
                forward + loss, backward and AdamW over 5 steps at lr 1e-4
                (the loss must fall), peak memory, the float32 bound (3 x the
                forward's matmul FLOPs over 67 TFLOP/s), the trainer's sharded
                step at world size 1, and every kernel's launches over those
                steps (0: training runs plain attention).  CuTR-192 on the
                card against the CPU path, one step from the same weights:
                assignments and top-k equal, loss rtol 1e-4, gradients within
                1e-3 relative L2 plus twice the CPU path's own spread.  A
                fine-tune from tests/fixtures/cutr_trained_192_f16.pth, the
                ``--data-root`` mode on a capture converted by the port's
                ``data_process convert`` (prints "dataset: 4 frames"),
                shard_inference of CuTR-768 on a one-rank mesh equal to the
                plain forward (1e-6), and both attention wrappers refusing
                inputs that require grad.
 12. native  -- the port's native loader (g++, into _build/): built and
                held against PIL and a bilinear model on tests/test_native.py's
                cases, or, when it does not build, its compiler's reason
                printed.  The main path's frames (24, 384x512) written in the
                CA-1M layout and streamed back through CA1MDataset and
                Prefetcher(depth=3) into the fused engine with CuTR-768 bf16:
                the world equals the list-fed one (decisions equal, floats
                within 1e-6).  Read ms per frame, native and PIL.
 13. trace   -- boxfusion_tpu_torch.tools.trace_keyframe (oracle, 200
                frames at 512 px, gap 20) and trace_stress (CuTR-768 bf16
                detections, 100 a keyframe, replayed) under torch.profiler:
                top device rows, the device's busy share of the traced loop
                (the union of kernel, memcpy and memset intervals over its
                record_function span) and its five longest idle gaps with
                the host op through each; the trace's pst_search kernel
                events must equal the wrapper's launch count over the run.
 14. tools   -- the A12b tools (boxfusion_tpu_torch/tools/):
                profile_stress_ablate at full size (CuTR-768 bf16
                detections, 512 px, 200 frames, gap 20, capacity 512) over
                its four variants: ms a keyframe, world count, pst_search
                launches; the full step's world equals trace_stress.replay's
                on the same recording, and pst_search launches in the full
                step only.  profile_clip_attn's five variants at B = 32, 64,
                69, 96, 100, 128, 400 (ms per layer), and at each B one
                layer's whole_seq_attention held against its twin on the
                same q, k, v (attention_tolerance(bfloat16)), the attention
                alone timed beside SDPA's flash backend.
                profile_bench_real (CuTR-768 bf16 + CLIP ViT-L labels, fused
                engine, 400 frames, gap 20): the per-keyframe split and the
                pipelined runs, whose world equals the synced run's.
                build_parity_fixture with one stage of 20 steps: the export
                loads into CuTR-192 with no missing or unexpected key and
                has the committed fixture's keys.  The three reference-parity
                tools with the reference pointed at an empty directory: each
                exits with status 2 and its one line.
  15. bench   -- the port's bench (boxfusion_tpu_torch/bench.py), its five
                phases in this process at full width: CuTR-768 bf16, CLIP
                ViT-L/14 bf16, 512 px, capacity 2048, 128 crops, gap 20, at
                half depth (BENCH_CUTS: 2 runs, 200 frames; printed).
                Checked: the headline not saturated and its world not empty,
                every headline run ending in the same world (count and
                stats), no secondary figure left out, 0 < detector_mfu <=
                1.05, the measured bf16 matmul ceiling at most 1.05 x the
                table peak, pst_search and whole_seq_attention launched on
                the headline.  One headline run at the record's 400 frames
                under torch.profiler: busy share, device ms by the keyframe
                stage that launched them, crops per keyframe.  Then
                profile_gap1 and profile_r5 (gap1, stages, det) at 40
                frames, each launching both kernels.  whole_seq_attention
                held against its twin at every shape these paths gave it.

Every phase prints one JSON record per line.  After them come the card's name
and power limit (as nvidia-smi gives them), then the kernels' record
{"kernels": [{"name", "route", "source", "replaces", "launches",
"max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}, ...]}
(every kernel's "launches_by_path": pst_search's and whole_seq_attention's
the count of each path of phases 3, 7, 8, 9, 11, 12, 13, 14 and 15, the
step kernel's the counts of nms_greedy and correspond_hits on the same paths
(its "launches" their sums), the other two's phase 11's; pst_search's also "eager_kernel_ms", "one_iter_max_abs_err", "registers",
"local_bytes", "smem_bytes", "threads", "cluster" and "max_active_clusters";
both attention entries also have "registers", "local_bytes",
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
# The fitness and PST search kernels are built with -fmad=false: every
# counted multiply, add, compare and select is one instruction, and the card
# executes 132 SMs x 128 float32 lanes x 1.98 GHz = 33.5e12 of them a second.
# PEAK_F32_FLOPS counts an FMA as two operations, so it is twice that rate.
PEAK_F32_NO_FMA_OPS = PEAK_F32_FLOPS / 2

FITNESS_TOL = 2e-3  # the JAX package's own Pallas-vs-XLA bound
CELLS_OBJECTS, CELLS_VIEWS, PARTICLES = 16, 10, 1024  # max_fusions x max_views x pst_size
SEARCH_ITERS = 20  # box_fusion.iters
# pst_search against pst_search_reference: fused boxes within the port's
# cross-stack PST bound after a full search (sums over particles in another
# order and the projection rounded apart from torch's einsum flip particles
# that tie particle 0, and the search is chaotic after that), and within
# 1e-3 after one iteration; need_update equal.
SEARCH_TOL, ONE_ITER_TOL = 5e-3, 1e-3

# The package's kernels whose launches the phases count, each by its
# ``launches`` counter: (module under boxfusion_tpu_torch.ops, function).  A
# phase that runs the ablation adds tiled_attention (counted_kernels).
COUNTED_KERNELS = (("fitness_kernel", "fitness_cells"), ("pst_search", "pst_search"),
                   ("attention_kernel", "whole_seq_attention"), ("step_kernel", "nms_greedy"),
                   ("step_kernel", "correspond_hits"), ("layer_norm_kernel", "add_layer_norm"))

# The step kernels (ops/step_kernel.py) at the cells' shapes: world slots,
# view slots, observation-bank rows (benchmark/configs/*.json); the pose
# pairs of the float32 bit check; the synthetic scan that is recorded
# (every frame a keyframe, so NMS and correspondence run each keyframe).
STEP_CAPACITY, STEP_VIEWS, STEP_OBS = 2048, 10, 16384
POSE_PAIRS = 100_000
STEP_SCAN = dict(n_frames=40, n_boxes=24, noise=0.05)

# whole_seq_attention cases: name -> (B, T, heads, head width, dtype).  The
# first is the main path's shape (the CLIP ViT-L/14 label batch) and the one
# that is timed.  Every case hands the kernel the chunk views of one qkv
# tensor (attention_inputs), so a load past a head's channels reads the next
# head's (or k's) and shows.
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
    # head width 72 (SigLIP SO400M/14@384): the 96-crop label bucket of the
    # ca1m SigLIP cell, and three crops whose heads 72 wide sit back to back
    # in the qkv tensor
    "siglip_so400m_bf16": (96, 729, 16, 72, "bfloat16"),
    "siglip_chunk_bf16": (3, 729, 16, 72, "bfloat16"),
}
MAIN_ATTENTION_CASE = "clip_l14_bf16"
# cases besides the main one whose kernel_info and times are printed for the record
RECORDED_ATTENTION_CASES = ("clip_l14_f32", "siglip_so400m_bf16")
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
def pst_scene(device, n_obj=CELLS_OBJECTS, n_views=CELLS_VIEWS, n_particles=PARTICLES, seed=0,
              offset=0.05):
    """optimize_boxes' arguments (as a dict) at the main path's shapes.

    n_obj boxes, each observed from 3-7 views of a camera ring around it
    (projections of the true box), the remaining view slots padded the way
    the pipeline pads them (identity pose, zero corners, masked); the
    initial box is the true box perturbed by N(0, offset) in every
    parameter, as the mean of noisy member boxes is.
    """
    import numpy as np
    import torch

    from boxfusion_tpu_torch.fusion.pst import synthesize_pst
    from boxfusion_tpu_torch.geometry.boxes import box_corners
    from boxfusion_tpu_torch.geometry.projection import project_corners_to_image

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
        for i in range(min(m, n_views)):
            ang = rng.uniform(0, 2 * np.pi)
            eye = gt[o, :3] + np.array([3 * np.cos(ang), 3 * np.sin(ang), 0.8])
            fwd = gt[o, :3] - eye
            fwd /= np.linalg.norm(fwd)
            right = np.cross(np.array([0.0, 0.0, -1.0]), fwd)
            right /= np.linalg.norm(right)
            poses[o, i, :3, :3] = np.stack([right, np.cross(fwd, right), fwd], 1)
            poses[o, i, :3, 3] = eye
            vmask[o, i] = 1.0
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float32), device=device)
    corners3d = box_corners(t(gt), t(R))[:, None].expand(n_obj, n_views, 8, 3)
    obs = project_corners_to_image(corners3d, t(poses), t(K), 384.0, 512.0)
    obs = torch.where(t(vmask)[..., None, None] > 0, obs, 0.0)  # padded slots: zeros
    init = gt + rng.normal(0, offset, gt.shape)
    return dict(init_xyzlhw=t(init), init_R=t(R), pst=t(synthesize_pst(n_particles)), cam_poses=t(poses),
                obs_corners=obs.contiguous(), view_mask=t(vmask),
                obj_mask=torch.ones(n_obj, dtype=torch.bool, device=device), K=t(K), H=384.0, W=512.0)


def search_args(scene) -> tuple:
    """pst_search's arguments but cfg, from a pst_scene, as optimize_boxes
    builds them: (init, R, pst, poses, K, view mask, object mask, prep, H, W)."""
    from boxfusion_tpu_torch.ops.fitness_kernel import prepare_observed

    N, V = scene["view_mask"].shape
    prep = prepare_observed(scene["obs_corners"].reshape(N * V, 8, 2))
    return (scene["init_xyzlhw"], scene["init_R"], scene["pst"], scene["cam_poses"], scene["K"],
            scene["view_mask"] > 0, scene["obj_mask"], prep, scene["H"], scene["W"])


def fitness_scene(device, n_obj=CELLS_OBJECTS, n_views=CELLS_VIEWS, n_particles=PARTICLES, seed=0):
    """Arguments of fitness_cells at the main path's shapes: pst_scene's
    objects, the candidates of its initial boxes at search size 0.1, as at a
    PST iteration."""
    import torch

    from boxfusion_tpu_torch.fusion.kernel import kernel_inputs, project_candidates
    from boxfusion_tpu_torch.ops.fitness_kernel import prepare_observed

    s = pst_scene(device, n_obj, n_views, n_particles, seed)
    ss = torch.full((n_obj, 6), 0.1, dtype=torch.float32, device=device)
    uv = project_candidates(s["init_xyzlhw"], s["init_R"], s["pst"], ss, s["cam_poses"], s["K"],
                            s["H"], s["W"])
    prep = prepare_observed(s["obs_corners"].reshape(n_obj * n_views, 8, 2))
    return kernel_inputs(uv, prep, s["view_mask"] > 0)


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
    t_ops, t_bytes = ops / PEAK_F32_NO_FMA_OPS * 1e3, n_bytes / PEAK_BYTES_PER_S * 1e3
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


def check_pst_search(device) -> dict:
    """pst_search against pst_search_reference at the fitness scene (16
    objects x 10 view slots x 1024 particles, 20 iterations) and after one
    iteration; milliseconds of the kernel, of the plain version and of the
    eager loop around fitness_cells (the path before this kernel), whose
    fitness_cells launches are counted over one run; the bound from this
    run's iterations and data."""
    import torch

    from boxfusion_tpu_torch.fusion.optimizer import PSTOptConfig
    from boxfusion_tpu_torch.ops.fitness_kernel import (
        fitness_cells,
        fitness_cells_reference,
        operation_count,
    )
    from boxfusion_tpu_torch.ops.pst_search import (
        kernel_info,
        operation_count as search_operations,
        pst_search,
        pst_search_reference,
    )

    args = search_args(pst_scene(device))
    cfg = PSTOptConfig(iters=SEARCH_ITERS)
    counted = dict(operations=0, cells=0)  # the fitness body's, over the plain run

    def counting_cells(u, v, hull, planes, pvalid, area, wmask):
        counted["operations"] += operation_count(u, v, pvalid, wmask)
        counted["cells"] += int((wmask[:, 0] > 0).sum()) * u.shape[2]
        return fitness_cells_reference(u, v, hull, planes, pvalid, area, wmask)

    fused, upd, iters = pst_search(*args, cfg)
    want, want_upd, want_iters = pst_search_reference(*args, cfg, cells=counting_cells)
    one, one_upd, _ = pst_search(*args, PSTOptConfig(iters=1))
    one_want, one_want_upd, _ = pst_search_reference(*args, PSTOptConfig(iters=1))
    torch.cuda.synchronize()
    if not torch.isfinite(fused).all() or fused.shape != want.shape:
        raise RuntimeError("pst_search: non-finite output or wrong shape")
    if not (torch.equal(upd, want_upd) and torch.equal(one_upd, one_want_upd)):
        raise RuntimeError("pst_search: need_update differs from the plain version")
    err = float((fused - want).abs().max())
    err_one = float((one - one_want).abs().max())
    if not (err <= SEARCH_TOL and err_one <= ONE_ITER_TOL):
        raise RuntimeError(f"pst_search disagrees with its plain version: max |diff| {err} "
                           f"(bound {SEARCH_TOL}), after one iteration {err_one} (bound {ONE_ITER_TOL})")

    fitness_cells.launches = 0  # the eager path's launches, over one run
    pst_search_reference(*args, cfg, cells=fitness_cells)
    eager_launches = fitness_cells.launches
    ms = cuda_ms(lambda: pst_search(*args, cfg), reps=20, warmup=3)
    plain_ms = cuda_ms(lambda: pst_search_reference(*args, cfg), reps=2, warmup=1)
    eager_kernel_ms = cuda_ms(lambda: pst_search_reference(*args, cfg, cells=fitness_cells), reps=5, warmup=1)

    init, R, pst, poses, K, vmask, active, prep, _, _ = args
    P = pst.shape[0]
    fitness_ops = counted["operations"] / max(counted["cells"], 1)
    ops = search_operations(iters, vmask, P, fitness_ops)
    inputs = (init, R, pst, poses, K, vmask, active, *prep.values())
    n_bytes = sum(t.numel() * t.element_size() for t in inputs) + sum(
        t.numel() * t.element_size() for t in (fused, upd, iters))
    t_ops, t_bytes = ops / PEAK_F32_NO_FMA_OPS * 1e3, n_bytes / PEAK_BYTES_PER_S * 1e3
    rec = dict(
        name="pst_search", route="cuda",
        source="boxfusion_tpu_torch/csrc/pst_search_kernel.cu",
        replaces="boxfusion_tpu/ops/fitness_kernel.py:344",
        objects=int(init.shape[0]), view_slots=int(vmask.shape[1]), live_views=int(vmask.sum()),
        particles=P, max_iters=SEARCH_ITERS, iterations=iters.tolist(),
        plain_iterations=want_iters.tolist(), fitness_ops_per_live_particle=fitness_ops,
        operations=ops, bytes=n_bytes, max_abs_err=err, one_iter_max_abs_err=err_one,
        ms=ms, plain_ms=plain_ms, eager_kernel_ms=eager_kernel_ms,
        eager_fitness_cells_launches=eager_launches,
        bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=None,  # no single PyTorch call computes this function
        **kernel_info(P),
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


def attention_inputs(device, B, T, heads, hd, dtype, seed: int = 0):
    """(q, k, v, heads, sm_scale) at one shape: unit-variance values from a
    seeded generator, as the three chunk views of one (B, T, 3D) tensor --
    the strided views the CLIP block hands the wrapper."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(B, T, 3 * heads * hd, generator=gen, device=device).to(getattr(torch, dtype))
    q, k, v = qkv.chunk(3, dim=-1)
    return q, k, v, heads, hd ** -0.5


def attention_case(device, case: str, seed: int = 0):
    """attention_inputs of one ATTENTION_CASES entry."""
    return attention_inputs(device, *ATTENTION_CASES[case], seed=seed)


def hold_attention(device, B, T, heads, hd, dtype, what: str) -> float:
    """whole_seq_attention against its plain twin at one shape, within
    attention_tolerance; returns the largest difference."""
    import torch

    from boxfusion_tpu_torch.ops.attention_kernel import (
        whole_seq_attention,
        whole_seq_attention_reference,
    )

    q, k, v, _, scale = attention_inputs(device, B, T, heads, hd, dtype)
    got = whole_seq_attention(q, k, v, heads, scale)
    want = whole_seq_attention_reference(q, k, v, heads, scale)
    sync(device)
    if got.dtype != q.dtype or got.shape != q.shape or not torch.isfinite(got).all():
        raise RuntimeError(f"whole_seq_attention[{what}]: bad dtype, shape or non-finite output")
    atol, rtol = attention_tolerance(q.dtype)
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    if float((diff - (atol + rtol * want.float().abs())).max()) > 0:
        raise RuntimeError(f"whole_seq_attention[{what}] disagrees with its plain twin: "
                           f"max |diff| {err} beyond atol {atol} + rtol {rtol}")
    return err


def check_path_attention(device, shapes, what: str) -> list:
    """Hold whole_seq_attention against its twin at every (B, T, heads,
    head width, dtype) a path gave it (AttentionBatches.shapes), on fresh
    unit-variance inputs; one record per shape."""
    import torch

    recs = []
    for shape in sorted(shapes):
        err = hold_attention(device, *shape, what=f"{what} {shape}")
        atol, rtol = attention_tolerance(getattr(torch, shape[4]))
        recs.append(dict(zip(("B", "T", "heads", "head_dim", "dtype"), shape), max_abs_err=err,
                         atol=atol, rtol=rtol))
    return recs


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
        err = hold_attention(device, B, T, heads, hd, dtype, case)
        q, k, v, _, scale = attention_case(device, case)
        atol, rtol = attention_tolerance(q.dtype)
        rec = dict(phase="kernels", name="whole_seq_attention", case=case, B=B, T=T, heads=heads,
                   head_dim=hd, dtype=dtype, max_abs_err=err, atol=atol, rtol=rtol)
        if case in RECORDED_ATTENTION_CASES + (MAIN_ATTENTION_CASE,):
            # ptxas's registers, shared memory and occupancy of the launch;
            # the query tiles (items), the blocks launched, and waves of
            # blocks (blocks_per_sm x SMs at a time)
            info = kernel_info(T, hd, q.dtype)
            items = info.get("n_qtiles", -(-T // 64)) * heads * B
            grid = info.get("n_groups", -(-T // 64)) * heads * B
            rec.update(info, items=items, grid=grid,
                       waves=grid / (n_sm * max(info["blocks_per_sm"], 1)))
        if case in RECORDED_ATTENTION_CASES:  # times for the record (the FMA kernel at the main shape; hd 72)
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


def random_poses(rng, n, spread, yaw_deg=45.0, tilt_deg=10.0):
    """n row-major 4x4 camera-to-world poses: a tilt about x within
    +-tilt_deg, then a yaw within +-yaw_deg; translations within +-spread m."""
    import numpy as np

    a = np.deg2rad(rng.uniform(-yaw_deg, yaw_deg, n))
    b = np.deg2rad(rng.uniform(-tilt_deg, tilt_deg, n))
    ca, sa, cb, sb, z, o = np.cos(a), np.sin(a), np.cos(b), np.sin(b), np.zeros(n), np.ones(n)
    yaw = np.stack([ca, -sa, z, sa, ca, z, z, z, o], -1).reshape(n, 3, 3)
    tilt = np.stack([o, z, z, z, cb, -sb, z, sb, cb], -1).reshape(n, 3, 3)
    p = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    p[:, :3, :3] = yaw @ tilt
    p[:, :3, 3] = rng.uniform(-spread, spread, (n, 3))
    return p


def manager_scene(device, seed=0, G=64, V=10, M=256, n=None, density=0.3, single_share=0.5,
                  max_count=None, pose_spread=0.5, nms_threshold=0.1):
    """``step_kernel.nms_greedy``'s tensor arguments (a dict, on ``device``)
    for a random world of ``n`` live slots out of G: scores with ties (one
    decimal), an asymmetric IoU cache (a share ``density`` of the live pairs
    in [0, 0.4)), fusion lists of one member (a share ``single_share``) or
    2..``max_count`` sorted observation ids below M, observation poses
    ``pose_spread`` m and 45 degrees of yaw apart at most (about half the
    pose tests differ at the config's gaps), box centres within +-0.6 m (the
    centre-distance escape goes both ways), and ``_contested``'s masks."""
    import numpy as np
    import torch

    from boxfusion_tpu_torch.runtime.device_state import PAD_ID

    rng = np.random.RandomState(seed)
    n = G if n is None else n
    max_count = V if max_count is None else max_count
    iou = rng.uniform(0, 0.4, (G, G)).astype(np.float32)
    iou[rng.rand(G, G) >= density] = 0.0
    iou[n:], iou[:, n:] = 0.0, 0.0
    np.fill_diagonal(iou, 0.0)
    fcount = np.where(rng.rand(G) < single_share, 1, rng.randint(2, max_count + 1, G)).astype(np.int32)
    flist = np.full((G, V), PAD_ID, np.int32)
    for g in range(G):
        flist[g, :fcount[g]] = np.sort(rng.choice(M, fcount[g], replace=False))
    scene = dict(
        scores=rng.uniform(0.3, 0.95, G).round(1).astype(np.float32), iou=iou, flist=flist,
        fcount=fcount, fflag=rng.rand(G) < 0.4, valid_num=rng.randint(0, 4, G).astype(np.float32),
        xyzlhw=np.concatenate([rng.uniform(-0.6, 0.6, (G, 3)), rng.uniform(0.2, 0.9, (G, 3))],
                              1).astype(np.float32),
        obs_pose=random_poses(rng, M, pose_spread), init_id=flist[:, 0].copy())
    scene = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in scene.items()}
    live = torch.arange(G, device=device) < n
    pair_on = (scene["iou"] > nms_threshold) & live[None, :] & live[:, None]
    scene["contested"] = pair_on.any(1) | pair_on.any(0)
    scene["isolated"] = live & ~scene["contested"]
    return scene


def corr_scene(device, seed=0, G=64, V=10, M=256, hits=8):
    """``step_kernel.correspond_hits``' tensor arguments (a dict): the state
    fields of ``manager_scene``, ``hits`` pending slots in the upper half
    that hit, each with a best match in the lower half (two may share one)
    and a coin for who wins, and NMS's keep (most slots kept)."""
    import numpy as np
    import torch

    scene = manager_scene(device, seed, G, V, M)
    rng = np.random.RandomState(seed + 7)
    todo = np.zeros(G, bool)
    todo[rng.choice(np.arange(G // 2, G), hits, replace=False)] = True
    plan = dict(todo=todo, best=rng.randint(0, G // 2, G).astype(np.int64),
                new_wins=rng.rand(G) < 0.5, keep=rng.rand(G) < 0.8)
    plan = {k: torch.from_numpy(v).to(device) for k, v in plan.items()}
    return {**plan, **{k: scene[k] for k in ("flist", "fcount", "fflag", "valid_num", "obs_pose",
                                              "init_id")}}


NMS_ARGS = ("scores", "iou", "contested", "isolated", "flist", "fcount", "fflag", "valid_num",
            "xyzlhw", "obs_pose", "init_id")
CORR_ARGS = ("todo", "best", "new_wins", "keep", "flist", "fcount", "fflag", "valid_num",
             "obs_pose", "init_id")


def step_kernel_against_twin(kind: str, scene: dict, cfg) -> dict:
    """``kind`` ("nms_greedy" or "correspond_hits") on the card's tensors of
    ``scene`` and its twin on their CPU copies: every output and the tally's
    growth, each equal or RuntimeError.  Returns the outputs' summary."""
    import torch

    from boxfusion_tpu_torch.ops import step_kernel

    names = NMS_ARGS if kind == "nms_greedy" else CORR_ARGS
    outs = (("keep", "success", "flist", "fcount", "fflag", "valid_num", "trunc") if kind == "nms_greedy"
            else ("keep", "flist", "fcount", "fflag", "valid_num", "trunc"))
    fn = getattr(step_kernel, kind)
    card = scene[names[0]].device
    before = (step_kernel.tally(card).cpu(), step_kernel.tally("cpu").clone(), fn.launches)
    got = fn(*(scene[k] for k in names), cfg)
    want = fn(*(scene[k].cpu() for k in names), cfg)
    torch.cuda.synchronize()
    grown = (step_kernel.tally(card).cpu() - before[0], step_kernel.tally("cpu") - before[1])
    if fn.launches != before[2] + 1:
        raise RuntimeError(f"{kind}: {fn.launches - before[2]} launches for one call")
    max_abs_err = 0.0
    for name, g, w in zip(outs, got, want):
        err = float((g.cpu().double() - w.double()).abs().max())
        max_abs_err = max(max_abs_err, err)
        if not torch.equal(g.cpu(), w):
            raise RuntimeError(f"{kind}: {name} differs from the twin's (largest difference {err})")
    if not torch.equal(*grown):
        raise RuntimeError(f"{kind}: tally grew by {grown[0].tolist()}, the twin's {grown[1].tolist()}")
    return dict(tally=dict(zip(step_kernel.TALLY_NAMES, grown[0].tolist())), trunc=int(got[-1]),
                kept=int(got[0].sum()), max_abs_err=max_abs_err)


def recorded_step_inputs(device):
    """The arguments of the last ``nms_greedy`` and ``correspond_hits`` calls
    of a synthetic scan (STEP_SCAN, every frame a keyframe) through
    DevicePipeline at the cells' world and observation capacities."""
    from boxfusion_tpu_torch.data.synthetic import OracleDetector, SyntheticSequence
    from boxfusion_tpu_torch.ops import step_kernel
    from boxfusion_tpu_torch.runtime import DevicePipeline

    cfg = _oracle_config()
    cfg["data"]._data["gap"] = 1
    cfg["association"]._data["max_observations"] = STEP_OBS
    seq = SyntheticSequence(n_frames=STEP_SCAN["n_frames"], n_boxes=STEP_SCAN["n_boxes"])
    pipe = DevicePipeline(cfg, OracleDetector(seq, noise=STEP_SCAN["noise"]), capacity=STEP_CAPACITY,
                          device=device)
    recorded = {}

    def recording(kind, names):
        def call(*args):
            recorded[kind] = dict(zip(names, (a.clone() for a in args[:-1])))
            return getattr(step_kernel, kind)(*args)
        return call

    with stepping_through(nms_greedy=recording("nms_greedy", NMS_ARGS),
                          correspond_hits=recording("correspond_hits", CORR_ARGS)):
        pipe.run(seq, export=False)
    return recorded, pipe.step_cfg


class stepping_through:
    """For the length of a ``with`` block, the keyframe step calls the given
    functions in place of ``step_kernel.nms_greedy`` / ``correspond_hits``
    (it reaches them as ``device_step.step_kernel``); the wrappers' own
    launch counts stay whole."""

    def __init__(self, **functions):
        self.functions = functions

    def __enter__(self):
        import types

        from boxfusion_tpu_torch.ops import step_kernel
        from boxfusion_tpu_torch.runtime import device_step

        self.saved = device_step.step_kernel
        device_step.step_kernel = types.SimpleNamespace(
            nms_greedy=self.functions.get("nms_greedy", step_kernel.nms_greedy),
            correspond_hits=self.functions.get("correspond_hits", step_kernel.correspond_hits))
        return self

    def __exit__(self, *exc):
        from boxfusion_tpu_torch.runtime import device_step

        device_step.step_kernel = self.saved
        return False


def pose_bit_shares(device, n_refs=POSE_PAIRS // 10, views=10, n_centres=20_000, seed=0) -> dict:
    """How often the step kernels' float32 pose terms (``step_kernel.pose_bits``:
    the baseline norm, the relative rotation's trace, the angle, and the
    baseline's norm as the centre escape takes it) differ in bits from
    PyTorch's own operations in ``_pose_differs`` and ``_center_far``, run as
    the step runs them (one reference pose against ``views`` member poses a
    call), on the card and on the CPU; and how often the decision at the
    gaps differs.  Random rotations over the whole sphere and translations
    within +-1 m."""
    import math

    import numpy as np
    import torch

    from boxfusion_tpu_torch.ops import step_kernel

    rng = np.random.RandomState(seed)
    pm = random_poses(rng, n_refs * views, 1.0, yaw_deg=180.0, tilt_deg=180.0)
    pr = random_poses(rng, n_refs, 1.0, yaw_deg=180.0, tilt_deg=180.0)
    gaps = (0.8, 30.0)
    n_centres = min(n_centres, n_refs)
    m_flat = torch.from_numpy(pm).to(device)
    r_flat = torch.from_numpy(pr).to(device).repeat_interleave(views, 0).contiguous()
    col = dict(zip(step_kernel.POSE_BITS_COLUMNS, step_kernel.pose_bits(m_flat, r_flat, *gaps).unbind(1)))
    picked = torch.arange(n_centres, device=device) * views

    def share(a, b):
        return float((a.view(torch.int32) != b.view(torch.int32)).double().mean())

    shares = {}
    for where in (device, torch.device("cpu")):
        m = torch.from_numpy(pm).to(where).reshape(n_refs, views, 4, 4)
        r = torch.from_numpy(pr).to(where)
        base, trace, angle, differs = [], [], [], []
        for k in range(n_refs):  # _pose_differs' operations, one call's shapes
            b = torch.linalg.norm(m[k][:, :3, 3] - r[k][:3, 3], dim=-1)
            rel = torch.einsum("ij,vkj->vik", r[k][:3, :3], m[k][:, :3, :3])
            s = rel.diagonal(dim1=1, dim2=2).sum(-1)
            a = torch.arccos(torch.clamp((s - 1) / 2, -1.0, 1.0)) * (180.0 / math.pi)
            base.append(b), trace.append(s), angle.append(a)
            differs.append((b > gaps[0]) | (a > gaps[1]))
        centre = torch.stack([torch.linalg.norm(m[k, 0, :3, 3] - r[k, :3, 3]) for k in range(n_centres)])
        base, trace, angle, differs = (torch.cat(x).to(device) for x in (base, trace, angle, differs))
        shares[where.type] = dict(baseline=share(col["baseline"], base), trace=share(col["trace"], trace),
                                  angle=share(col["angle"], angle),
                                  centre=share(col["baseline"][picked], centre.to(device)),
                                  decision=float(col["differs"].ne(differs.float()).double().mean()))
    return dict(pairs=n_refs * views, centre_pairs=n_centres, shares=shares)


def check_step_kernel(device) -> dict:
    """nms_greedy and correspond_hits against their twins on a recorded
    keyframe of a synthetic scan at the cells' shapes (STEP_CAPACITY slots,
    STEP_VIEWS views, STEP_OBS observations), and on random worlds at that
    capacity with 300+ contested slots; milliseconds of each kernel and of
    its twin on the card (the loop the step ran before); launches,
    registers, spills, shared memory; the float32 pose terms' bit shares."""
    import torch

    from boxfusion_tpu_torch.ops import step_kernel

    recorded, cfg = recorded_step_inputs(device)
    held = {kind: step_kernel_against_twin(kind, recorded[kind], cfg)
            for kind in ("nms_greedy", "correspond_hits") if kind in recorded}
    big = manager_scene(device, seed=1, G=STEP_CAPACITY, V=STEP_VIEWS, M=STEP_OBS, n=1200,
                        density=0.0005)
    contested = int(big["contested"].sum())
    if contested < 300:
        raise RuntimeError(f"step kernel: the large world has {contested} contested slots")
    held["nms_greedy_large"] = step_kernel_against_twin("nms_greedy", big, cfg)
    corr = corr_scene(device, seed=1, G=STEP_CAPACITY, V=STEP_VIEWS, M=STEP_OBS, hits=40)
    held["correspond_hits_large"] = step_kernel_against_twin("correspond_hits", corr, cfg)

    times = {}
    for kind, names, scenes in (("nms_greedy", NMS_ARGS, (recorded.get("nms_greedy"), big)),
                                ("correspond_hits", CORR_ARGS, (recorded.get("correspond_hits"), corr))):
        fn, twin = getattr(step_kernel, kind), getattr(step_kernel, kind + "_reference")
        for label, scene in zip(("recorded", "large"), scenes):
            if scene is None:
                continue
            args = [scene[k] for k in names]
            times[f"{kind}.{label}"] = dict(ms=cuda_ms(lambda: fn(*args, cfg), reps=20),
                                            plain_ms=cuda_ms(lambda: twin(*args, cfg), reps=2, warmup=1))
    rec = dict(name="step_kernel", route="cuda", source="boxfusion_tpu_torch/csrc/step_kernel.cu",
               replaces=None, capacity=STEP_CAPACITY, views=STEP_VIEWS, observations=STEP_OBS,
               contested_large=contested, held=held, times=times,
               ms=times["nms_greedy.large"]["ms"], plain_ms=times["nms_greedy.large"]["plain_ms"],
               max_abs_err=max(h["max_abs_err"] for h in held.values()), bound_ms=None,
               bound_by="latency (a serial chain of picks and records)",
               library_ms=None, info=step_kernel.kernel_info(STEP_CAPACITY),
               pose_bits=pose_bit_shares(device))
    print(json.dumps({"phase": "kernels", **rec}))
    for where, shares in rec["pose_bits"]["shares"].items():
        if shares["decision"]:
            raise RuntimeError(f"step kernel: the pose test decides apart from PyTorch's on the {where} "
                               f"in a share {shares['decision']} of the pairs")
    return rec


# add_layer_norm at the towers' shapes: name -> (rows, width, eps), the rows
# those of the 96-crop label bucket (crops x tokens).  The first is timed for
# the kernels record.
LAYER_NORM_CASES = {
    "vit_h14": (96 * 257, 1280, 1e-5),
    "vit_l14": (96 * 257, 1024, 1e-5),
    "siglip_so400m": (96 * 729, 1152, 1e-6),
}
LAYER_NORM_ULP_FLOOR = 2.0 ** -10


def bf16_ulp(t):
    """One bfloat16 ulp at each |t|, and at least the ulp at
    LAYER_NORM_ULP_FLOOR (2^-17).  add_layer_norm's y is held within it of
    its twin's: the two sum the float32 statistics in other orders, which
    moves a normalised value by ~1e-7 of the row's scale, and so a rounding
    to bfloat16 by at most one ulp -- except near 0, where an ulp is smaller
    than that move: hence the floor."""
    import torch

    a = t.float().abs().clamp_min(LAYER_NORM_ULP_FLOOR)
    return torch.ldexp(torch.ones_like(a), torch.frexp(a)[1] - 8)


def layer_norm_inputs(device, rows, width, residual=True, seed=0):
    """(x, d, weight, bias) for add_layer_norm: bfloat16 rows of mean 0.5
    and deviation 3 (d unit normal; None without ``residual``), float32
    weight 1 + N(0, 0.1) and bias N(0, 0.1), from a seeded generator."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    x = (3 * torch.randn(rows, width, generator=gen, device=device) + 0.5).bfloat16()
    d = torch.randn(rows, width, generator=gen, device=device).bfloat16() if residual else None
    weight = 1 + 0.1 * torch.randn(width, generator=gen, device=device)
    bias = 0.1 * torch.randn(width, generator=gen, device=device)
    return x, d, weight, bias


def hold_layer_norm(x, d, weight, bias, eps, what: str) -> float:
    """add_layer_norm against its twin on the same tensors: s bit-equal, y
    within bf16_ulp; returns the largest |y - y_twin|."""
    import torch

    from boxfusion_tpu_torch.ops.layer_norm_kernel import add_layer_norm, add_layer_norm_reference

    s, y = add_layer_norm(x, d, weight, bias, eps)
    s_want, y_want = add_layer_norm_reference(x, d, weight, bias, eps)
    sync(x.device)
    if not torch.equal(s, s_want):
        raise RuntimeError(f"add_layer_norm[{what}]: s differs from x + d")
    diff = (y.float() - y_want.float()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if y.dtype != x.dtype or y.shape != x.shape or bool((diff > bf16_ulp(y_want)).any()):
        raise RuntimeError(f"add_layer_norm[{what}]: y beyond one bfloat16 ulp of its twin (max |diff| {err})")
    return err


def check_layer_norm(device) -> dict:
    """add_layer_norm at each tower's shape, with and without the residual:
    held against its twin, its milliseconds beside the twin's (the add, the
    two casts and F.layer_norm the blocks ran before), the bound by bytes
    (8 an element with the residual, 4 without, at 3.35 TB/s) and its share,
    registers, spills, shared memory."""
    from boxfusion_tpu_torch.ops.layer_norm_kernel import (
        add_layer_norm,
        add_layer_norm_reference,
        kernel_info,
    )

    cases = []
    for case, (rows, width, eps) in LAYER_NORM_CASES.items():
        for residual in (True, False):
            x, d, w, b = layer_norm_inputs(device, rows, width, residual)
            err = hold_layer_norm(x, d, w, b, eps, f"{case}, residual {residual}")
            # every launch finds the L2 cold: x, d, s, y are 51-161 MB each
            ms = cuda_ms(lambda: add_layer_norm(x, d, w, b, eps), reps=50, warmup=5)
            plain_ms = cuda_ms(lambda: add_layer_norm_reference(x, d, w, b, eps), reps=20, warmup=3)
            n_bytes = (8 if residual else 4) * rows * width
            bound_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
            rec = dict(phase="kernels", name="add_layer_norm", case=case, rows=rows, width=width,
                       eps=eps, residual=residual, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bytes=n_bytes, bound_ms=bound_ms, bound_share=bound_ms / ms,
                       achieved_tb_s=n_bytes / (ms * 1e-3) / 1e12, **kernel_info(width, residual))
            print(json.dumps(rec))
            cases.append(rec)
    main = cases[0]
    return dict(name="add_layer_norm", route="cuda", source="boxfusion_tpu_torch/csrc/layer_norm_kernel.cu",
                replaces=None, max_abs_err=max(c["max_abs_err"] for c in cases), ms=main["ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"], bound_by="bytes", library_ms=None,
                cases=[{k: c[k] for k in ("case", "residual", "ms", "plain_ms", "bound_ms", "bound_share",
                                          "registers", "local_bytes")} for c in cases])


def phase_kernels(device) -> list:
    return [check_fitness(device), check_pst_search(device), check_attention(device),
            check_tiled_attention(device), check_step_kernel(device), check_layer_norm(device)]


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


def counted_kernels(ablation: bool = False) -> tuple:
    """COUNTED_KERNELS' functions, and tiled_attention after them with
    ``ablation``."""
    import importlib

    found = tuple(getattr(importlib.import_module("boxfusion_tpu_torch.ops." + mod), name)
                  for mod, name in COUNTED_KERNELS)
    if ablation:
        from boxfusion_tpu_torch.tools.attention_ablation import tiled_attention

        found += (tiled_attention,)
    return found


def run_main_path(device, dimension=768, n_frames=24, gap=1, image_hw=(384, 512), kernels=(),
                  label=False, clip_cfg=None):
    """Drive OnlinePipeline + CuTRDetector once, with or without the CLIP
    labeler; returns (record, pipeline)."""
    import numpy as np

    from boxfusion_tpu_torch.data.synthetic import SyntheticSequence
    from boxfusion_tpu_torch.models.cutr import make_cutr
    from boxfusion_tpu_torch.runtime import CuTRDetector, OnlinePipeline
    from boxfusion_tpu_torch.tools.common import lift_class_bias

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


def check_search_launches(launches: dict, what: str) -> None:
    """The fusion stage went through pst_search, one launch per fused
    batch, and never through the one-iteration fitness_cells."""
    if launches["pst_search"] <= 0:
        raise RuntimeError(f"{what}: pst_search was never launched")
    if launches["fitness_cells"] != 0:
        raise RuntimeError(f"{what}: fitness_cells ran {launches['fitness_cells']} times; "
                           "the search belongs to pst_search")


def phase_main(device) -> dict:
    """Both paths, each with the counts zeroed just before and read just
    after; returns the launch counts of the labelled run."""
    kernels = counted_kernels()
    plain, _ = run_main_path(device, kernels=kernels)
    print(json.dumps(plain))
    check_search_launches(plain["launches"], "main path")
    if plain["launches"]["whole_seq_attention"] != 0:
        raise RuntimeError("main path without a labeler launched whole_seq_attention")

    rec, _ = run_main_path(device, kernels=kernels, label=True)
    print(json.dumps(rec))
    check_search_launches(rec["launches"], "labelled main path")
    if rec["launches"]["whole_seq_attention"] <= 0:
        raise RuntimeError("labelled main path: whole_seq_attention was never launched")
    if rec["launches"]["whole_seq_attention"] != rec["clip"]["layers"] * rec["labelled_keyframes"]:
        raise RuntimeError("labelled main path: not one attention launch per tower block")
    # ln_pre, block 0's ln_1, and two a block (the add before ln_2, the
    # closing add with the next ln_1; the last block's add stays plain)
    if rec["launches"]["add_layer_norm"] != (2 * rec["clip"]["layers"] + 1) * rec["labelled_keyframes"]:
        raise RuntimeError("labelled main path: not two add_layer_norm launches per tower block")
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
def _oracle_config():
    from boxfusion_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(HERE, "config/ca1m.yaml"))
    cfg["box_fusion"]._data["pst_path"] = None  # the CLI's synthetic fallback
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


def run_device_oracle(device, n_frames=60, n_boxes=6, noise=0.02):
    """Phase 4's sequence through DevicePipeline; returns its record."""
    import numpy as np

    from boxfusion_tpu_torch.data.synthetic import OracleDetector, SyntheticSequence
    from boxfusion_tpu_torch.runtime import DevicePipeline

    seq = SyntheticSequence(n_frames=n_frames, n_boxes=n_boxes)
    pipe = DevicePipeline(_oracle_config(), OracleDetector(seq, noise=noise), capacity=512,
                          device=device)
    pipe.run(seq, export=False)  # first pass: allocator and library warm-up
    pipe.reset()
    pipe.timings, pipe.host_reads = {}, 0  # totals run on over reset(): this run's alone
    pipe.detector = OracleDetector(seq, noise=noise)
    t0 = time.perf_counter()
    world = pipe.run(seq)
    seconds = time.perf_counter() - t0
    st = world["stats"]
    d = np.linalg.norm(world["xyzlhw"][:, None, :3] - seq.gt_xyzlhw[None, :, :3], axis=-1)
    rec = dict(phase="device_oracle", world_boxes=len(world["scores"]),
               gt_boxes=n_boxes, max_gt_match_m=float(d.min(0).max()),
               fused_boxes=int(world["fusion_flag"].sum()), keyframes=st["keyframes"],
               ms_per_keyframe=1e3 * seconds / st["keyframes"],
               step_ms_per_keyframe=1e3 * pipe.timings["step"] / st["keyframes"],
               host_reads_per_keyframe=pipe.host_reads / st["keyframes"], stats=st)
    print(json.dumps(rec))
    if not rec["max_gt_match_m"] < 0.15:
        raise RuntimeError(f"device oracle: a GT box is {rec['max_gt_match_m']:.3f} m away")
    if rec["fused_boxes"] < 1:
        raise RuntimeError("device oracle: no box was fused")
    bad = {k: v for k, v in st.items() if k != "keyframes" and v}
    if bad:
        raise RuntimeError(f"device oracle: dropped or truncated counts {bad}")
    if pipe.host_reads == 0:  # the step reads its stage gates at every keyframe
        raise RuntimeError("device oracle: no host read was counted")
    return rec


def run_snapshot_round_trip(device, n_frames=60, cut=40, noise=0.02) -> dict:
    """save_state after `cut` frames, restore_state into a fresh pipeline, run
    on: the world of the run that was never interrupted."""
    from boxfusion_tpu_torch.data.synthetic import OracleDetector, SyntheticSequence
    from boxfusion_tpu_torch.runtime import DevicePipeline

    seq = SyntheticSequence(n_frames=n_frames, n_boxes=6)
    frames = list(seq)
    cfg = _oracle_config()
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
    run_device_oracle(device)
    run_snapshot_round_trip(device)


# --------------------------------------------------------------------- phase 7
STEP_STAGES = ("_append_detections", "_gated_iou_rows", "_nms_greedy", "_correspondence", "_compact",
               "_fuse_device")


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
                         label=False, clip_cfg=None, capacity=2048, stage_clock=False):
    """Drive DevicePipeline + CuTRDetector(device_output=True) once, with or
    without the CLIP labeler (label_boost_device); returns (record, pipeline)."""
    import contextlib

    import numpy as np
    import torch

    from boxfusion_tpu_torch.data.synthetic import SyntheticSequence
    from boxfusion_tpu_torch.models.cutr import make_cutr
    from boxfusion_tpu_torch.runtime import CuTRDetector, DevicePipeline
    from boxfusion_tpu_torch.tools.common import lift_class_bias

    cfg = main_path_config()
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
        phase="device_main", labelled=bool(label), cutr_width=dimension,
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
    kernels = counted_kernels(ablation=True)
    plain, _ = run_device_main_path(device, kernels=kernels)
    print(json.dumps(plain))
    check_search_launches(plain["launches"], "device main path")
    if plain["launches"]["whole_seq_attention"] != 0:
        raise RuntimeError("device main path without a labeler launched whole_seq_attention")

    rec, _ = run_device_main_path(device, kernels=kernels, label=True)
    print(json.dumps(rec))
    check_search_launches(rec["launches"], "labelled device main path")
    if rec["launches"]["whole_seq_attention"] <= 0:
        raise RuntimeError("labelled device main path: whole_seq_attention was never launched")
    if rec["launches"]["whole_seq_attention"] != 24 * rec["keyframes"]:
        raise RuntimeError("labelled device main path: not one attention launch per tower block")

    split, _ = run_device_main_path(device, stage_clock=True)
    print(json.dumps(split))
    return rec


# --------------------------------------------------------------------- phase 8
def quantised(frames):
    """Frames whose depth is whole millimetres: the fused engine's u16
    transfer is then lossless and every engine sees the same input."""
    import dataclasses

    import numpy as np

    return [dataclasses.replace(f, depth=(np.round(f.depth * 1000.0) / 1000.0).astype(np.float32))
            for f in frames]


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main_path_frames(seed=0, n_frames=24, image_hw=(384, 512)):
    from boxfusion_tpu_torch.data.synthetic import SyntheticSequence

    return quantised(SyntheticSequence(n_frames=n_frames, n_boxes=8, image_hw=image_hw, seed=seed))


def engine_config(label=False, bucketing=True):
    """Phase 7's configuration: the label budget covers the detector's top-100
    rows, so the fixed budget labels 100 crops and the buckets are
    (0, 32, 64, 96, 100)."""
    cfg = main_path_config()
    cfg["detection"]._data["max_label_boxes"] = 128
    cfg["detection"]._data["label_bucketing"] = bucketing
    if label:
        cfg["box_fusion"]._data["clip_sim_coeff"] = 1.0  # config/cubicle.yaml
    return cfg


def make_main_model(device, dtype="bfloat16", dimension=768):
    from boxfusion_tpu_torch.models.cutr import make_cutr
    from boxfusion_tpu_torch.tools.common import lift_class_bias

    model = make_cutr(dimension, depth_model=True, device=device, seed=0, dtype=dtype)
    lift_class_bias(model)
    return model


class AttentionBatches:
    """Records the batch (sequences) of every whole_seq_attention call the
    CLIP tower makes, and the set of its shapes (B, T, heads, head width,
    dtype), by wrapping the name the tower calls."""

    def __init__(self):
        self.batches, self.shapes = [], set()

    def __enter__(self):
        from boxfusion_tpu_torch.models.clip import model as clip_model

        self.saved = fn = clip_model.whole_seq_attention

        def recorded(q, k, v, heads, sm_scale):
            B, T, D = (int(x) for x in q.shape)
            self.batches.append(B)
            self.shapes.add((B, T, int(heads), D // int(heads), str(q.dtype).split(".")[-1]))
            return fn(q, k, v, heads=heads, sm_scale=sm_scale)

        clip_model.whole_seq_attention = recorded
        return self

    def __exit__(self, *exc):
        from boxfusion_tpu_torch.models.clip import model as clip_model

        clip_model.whole_seq_attention = self.saved


class LabelClock:
    """Crops per labelled keyframe (the rows each frame of a
    label_boost_lanes call sent through the tower) and, with ``synced``, the
    label stage's milliseconds with a synchronise before and after
    fused.label_boost_core (its bucket read included)."""

    def __init__(self, labeler, synced=False):
        self.labeler, self.synced, self.device = labeler, synced, labeler.device
        self.crops, self.seconds, self.calls = [], 0.0, 0

    def __enter__(self):
        from boxfusion_tpu_torch.runtime import fused

        real_boost, real_core = self.labeler.label_boost_lanes, fused.label_boost_core

        def boost(images, boxes, scores, hws, scale, coeff, budget=32):
            n, k = boxes.shape[:2]
            self.crops.extend([min(int(budget), int(k))] * int(n))
            return real_boost(images, boxes, scores, hws, scale, coeff, budget=budget)

        def core(*args, **kw):
            if self.synced:
                sync(self.device)
            t0 = time.perf_counter()
            out = real_core(*args, **kw)
            if self.synced:
                sync(self.device)
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out

        self.labeler.label_boost_lanes = boost
        self.saved_core, fused.label_boost_core = real_core, core
        return self

    def __exit__(self, *exc):
        from boxfusion_tpu_torch.runtime import fused

        del self.labeler.label_boost_lanes  # back to the class's method
        fused.label_boost_core = self.saved_core


def world_diff(a: dict, b: dict) -> dict:
    """What differs between two exported worlds: the decisions (world count,
    init ids, fusion flags and lists, categories, stats) and the largest
    score and box difference where the decisions agree."""
    import numpy as np

    same = (len(a["scores"]) == len(b["scores"]) and a["fusion_list"] == b["fusion_list"]
            and a["stats"] == b["stats"]
            and all(np.array_equal(a[k], b[k]) for k in
                    ("init_id", "fusion_flag", "valid_num", "category", "frame_id")))
    out = dict(decisions_equal=bool(same), world_boxes=[len(a["scores"]), len(b["scores"])],
               fused_boxes=[int(a["fusion_flag"].sum()), int(b["fusion_flag"].sum())])
    if same and len(a["scores"]):
        box = np.abs(a["xyzlhw"] - b["xyzlhw"]).max(axis=1)
        fused = np.asarray(a["fusion_flag"], bool)
        out["max_score_diff"] = float(np.abs(a["scores"] - b["scores"]).max())
        out["max_box_diff_unfused"] = float(box[~fused].max()) if (~fused).any() else 0.0
        out["max_box_diff_fused"] = float(box[fused].max()) if fused.any() else 0.0
    return out


# hold_close's bounds for the same detections labelled by the tower at another
# batch: scores within the CPU tests' 1e-4 (tests/test_torch_device_pipeline.py),
# boxes within 1e-4, fused or not (the tower moves no box).
LABEL_BOUNDS = dict(score_tol=1e-4, unfused_tol=1e-4, fused_tol=1e-4)


def hold_close(a: dict, b: dict, what: str, score_tol, unfused_tol, fused_tol) -> dict:
    """Decisions identical (world count, init ids, fusion flags and lists,
    categories, counters); scores, boxes never fused and fused boxes within
    their bounds."""
    d = world_diff(a, b)
    if not d["decisions_equal"] or d.get("max_score_diff", 0.0) > score_tol \
            or d.get("max_box_diff_unfused", 0.0) > unfused_tol \
            or d.get("max_box_diff_fused", 0.0) > fused_tol:
        raise RuntimeError(f"{what}: {d}")
    return d


def drive_engine(kind, device, model, frames, cfg, labeler=None, chunk=1, kernels=(),
                 label_clock=None, capacity=2048):
    """One timed run of the device ("device") or fused ("fused") engine over
    ``frames`` at gap 1, the kernels' counts zeroed just before and read just
    after; returns (record, world)."""
    import contextlib

    import numpy as np

    from boxfusion_tpu_torch.runtime import CuTRDetector, DevicePipeline, FusedDevicePipeline

    if kind == "device":
        det = CuTRDetector(model, device=device, device_output=True, export_image=labeler is not None)
        pipe = DevicePipeline(cfg, det, labeler=labeler, capacity=capacity, device=device)
    else:
        pipe = FusedDevicePipeline(cfg, CuTRDetector(model, device=device), labeler=labeler,
                                   capacity=capacity, device=device, chunk=chunk)
    sync(device)
    for k in kernels:
        k.launches = 0
    with AttentionBatches() as att, (label_clock or contextlib.nullcontext()):
        t0 = time.perf_counter()
        world = pipe.run(frames, gap=1)
        seconds = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    st = world["stats"]
    n_kf = st["keyframes"]
    if len(world["scores"]) == 0 or not np.isfinite(world["xyzlhw"]).all():
        raise RuntimeError(f"{kind} engine: world has {len(world['scores'])} boxes or is not finite")
    if st["dropped_world_capacity"] or st["dropped_obs_capacity"] or st["label_overflow"]:
        raise RuntimeError(f"{kind} engine: dropped or unlabelled rows: {st}")
    rec = dict(
        engine=kind, labelled=labeler is not None, chunk=chunk if kind == "fused" else None,
        label_bucketing=bool(cfg["detection"]["label_bucketing"]) if labeler is not None else None,
        keyframes=n_kf, seconds=seconds, keyframes_per_s=n_kf / seconds,
        ms_per_keyframe=1e3 * seconds / n_kf, host_reads_per_keyframe=pipe.host_reads / n_kf,
        stage_ms_per_keyframe={k: 1e3 * v / n_kf for k, v in sorted(pipe.timings.items())},
        world_boxes=len(world["scores"]), fused_boxes=int(world["fusion_flag"].sum()),
        launches=launches, clip_batches=sorted(set(att.batches)),
        attention_shapes=sorted(att.shapes),
    )
    if label_clock is not None:
        rec["label_crops_per_keyframe"] = float(np.mean(label_clock.crops)) if label_clock.crops else 0.0
        if label_clock.synced:
            rec["synced_label_ms_per_keyframe"] = 1e3 * label_clock.seconds / n_kf
    return rec, world


def check_path_launches(rec: dict, what: str) -> None:
    """The path went through pst_search (never fitness_cells) and, when
    labelled, through whole_seq_attention, which an unlabelled path never
    launches."""
    check_search_launches(rec["launches"], what)
    att = rec["launches"]["whole_seq_attention"]
    if rec["labelled"] and att <= 0:
        raise RuntimeError(f"{what}: whole_seq_attention was never launched")
    if not rec["labelled"] and att != 0:
        raise RuntimeError(f"{what}: launched whole_seq_attention without a labeler")


def phase_fused(device, dimension=768, clip_cfg=None, n_frames=24, image_hw=(384, 512),
                f32_frames=8) -> dict:
    """FusedDevicePipeline at full width beside the device engine in the same
    call, on phase 7's 24 frames with depth quantised to whole millimetres:
    unlabelled at chunk 1 and 8 (both equal to the device engine), labelled
    with the fixed budget (equal to the labelled device engine), with label
    buckets at chunk 1 and 8 (equal to each other; against the fixed budget
    the tower runs at another batch, so the difference is printed), one
    synced run each way for the label stage's milliseconds, the bucket
    rule held at float32 on 8 frames, and whole_seq_attention held against
    its twin at every shape these runs gave it.  Returns the launch counts
    per path."""
    import dataclasses

    t_phase = time.perf_counter()
    kernels = counted_kernels()
    clip_cfg = clip_cfg or clip_l14_config()
    model = make_main_model(device, dimension=dimension)
    labeler = make_labeler(device, clip_cfg)
    frames = main_path_frames(n_frames=n_frames, image_hw=image_hw)
    # warm both engines (allocator, library handles) on 3 frames
    for kind in ("device", "fused"):
        drive_engine(kind, device, model, frames[:3], engine_config(True), labeler=labeler)

    def run(name, kind, label=False, bucketing=True, chunk=1, synced=False, frames=frames,
            labeler=labeler, model=model):
        clock = LabelClock(labeler, synced=synced) if label else None
        rec, world = drive_engine(kind, device, model, frames, engine_config(label, bucketing),
                                  labeler=labeler if label else None, chunk=chunk, kernels=kernels,
                                  label_clock=clock)
        rec = dict(phase="fused", run=name, **rec)
        check_path_launches(rec, f"fused phase, {name}")
        print(json.dumps(rec))
        return rec, world

    recs, worlds = {}, {}
    for name, kw in (("device", dict(kind="device")),
                     ("fused_c1", dict(kind="fused")),
                     ("fused_c8", dict(kind="fused", chunk=8)),
                     ("device_labelled", dict(kind="device", label=True)),
                     ("fused_labelled_fixed_c1", dict(kind="fused", label=True, bucketing=False)),
                     ("fused_labelled_c1", dict(kind="fused", label=True)),
                     ("fused_labelled_c8", dict(kind="fused", label=True, chunk=8)),
                     ("fused_labelled_fixed_synced", dict(kind="fused", label=True, bucketing=False,
                                                          synced=True)),
                     ("fused_labelled_synced", dict(kind="fused", label=True, synced=True))):
        recs[name], worlds[name] = run(name, **kw)

    # equal where the shapes are the same
    _worlds_equal(worlds["fused_c1"], worlds["device"], "fused chunk 1 vs device engine")
    _worlds_equal(worlds["fused_c8"], worlds["fused_c1"], "fused chunk 8 vs chunk 1")
    _worlds_equal(worlds["fused_labelled_fixed_c1"], worlds["device_labelled"],
                  "labelled fused (fixed budget) vs labelled device engine")
    _worlds_equal(worlds["fused_labelled_c8"], worlds["fused_labelled_c1"],
                  "labelled fused chunk 8 vs chunk 1")
    # the tower at the bucket's batch against the full budget's, bf16
    bf16_diff = world_diff(worlds["fused_labelled_c1"], worlds["fused_labelled_fixed_c1"])

    # the same rule at float32 (CuTR and the tower), 8 frames
    f32_model, f32_labeler = make_main_model(device, "float32", dimension), make_labeler(
        device, dataclasses.replace(clip_cfg, dtype="float32"))
    short = frames[:f32_frames]
    f32_recs, f32 = {}, {}
    for b in (False, True):
        f32_recs[b], f32[b] = run(f"f32_labelled_bucketing_{b}", "fused", label=True, bucketing=b,
                                  frames=short, labeler=f32_labeler, model=f32_model)
    f32_diff = hold_close(f32[True], f32[False], "float32: label buckets vs the fixed budget",
                          **LABEL_BOUNDS)
    del f32_model, f32_labeler
    # the kernel against its twin at every shape these paths gave it
    attention = check_path_attention(
        device, {tuple(x) for r in [*recs.values(), *f32_recs.values()] for x in r["attention_shapes"]},
        "fused phase")

    summary = dict(
        phase="fused", summary=True, seconds=time.perf_counter() - t_phase,
        keyframes_per_s={k: recs[k]["keyframes_per_s"] for k in recs},
        host_reads_per_keyframe={k: recs[k]["host_reads_per_keyframe"] for k in recs},
        synced_label_ms_per_keyframe={
            "buckets": recs["fused_labelled_synced"]["synced_label_ms_per_keyframe"],
            "fixed_budget": recs["fused_labelled_fixed_synced"]["synced_label_ms_per_keyframe"]},
        label_crops_per_keyframe={
            "buckets": recs["fused_labelled_synced"]["label_crops_per_keyframe"],
            "fixed_budget": recs["fused_labelled_fixed_synced"]["label_crops_per_keyframe"]},
        equal=["fused_c1 = device", "fused_c8 = fused_c1", "fused_labelled_fixed_c1 = device_labelled",
               "fused_labelled_c8 = fused_labelled_c1"],
        bf16_buckets_vs_fixed=bf16_diff, f32_buckets_vs_fixed=f32_diff,
        attention_vs_twin=attention,
    )
    print(json.dumps(summary))
    return {k: recs[k]["launches"] for k in recs}


# --------------------------------------------------------------------- phase 9
# CuTR's lanes, held before the search (where rounding is not yet chaotic),
# each row within tol + tol x |value| of its partner, the 2D boxes in units
# of the image's longer side (a pixel coordinate near 0 is no more precise
# than one near 512).  LANE_SAME_TOL: lane i of the mixed batch against
# lane 0 of a batch of frame i repeated -- the same shapes, so only a lane
# leaking into another could move a row.  LANE_F32_TOL: float32 at batch N
# against batch 1, where the products run at another M: scores 1e-4; boxes
# 1e-3, since the decoder refines each box six times through deformable
# sampling at positions the box itself sets (measured on the card: 0.098 px
# and 6.0e-4 m in one lane of four, scores 3.0e-5).  The boosted scores of
# the label stage are held at the scores' bound.
LANE_ROW_KEYS = ("scores", "pred_boxes", "boxes3d")
LANE_SAME_TOL = dict.fromkeys(LANE_ROW_KEYS, 1e-6)
LANE_F32_TOL = dict(scores=1e-4, pred_boxes=1e-3, boxes3d=1e-3)


def cutr_lanes(model, frames, device):
    """CuTR on ``frames`` stacked as one batch of N and one at a time:
    (stacked FrameBatch, the batch-N output, the N batch-1 outputs)."""
    import torch

    from boxfusion_tpu_torch.data.preprocess import Preprocessor
    from boxfusion_tpu_torch.runtime.batched import _stack

    pre = Preprocessor(device=device)
    batches = [pre(f.image, f.depth, f.K, f.T_gravity)[0] for f in frames]
    with torch.inference_mode():
        stacked = _stack(batches)
        return stacked, model(stacked), [model(b) for b in batches]


def rows_apart(a: dict, b: dict, tol: dict, side: float) -> dict:
    """One lane's top-k rows (``a``) against another run's (``b``), each
    row paired with its nearest partner (a near-tie may swap two rows'
    ranks): the largest difference of each of LANE_ROW_KEYS over the pairs
    (2D boxes in pixels), the worst pair in units of tol[key] + tol[key] x
    |value| with the 2D boxes divided by the image's longer ``side`` (both
    ways; at most 1 when within), and the rows whose partner is not at
    their own rank."""
    import torch

    def rows(o, scale):
        return torch.cat([o[k].float().reshape(o[k].shape[0], -1) * scale[k] for k in LANE_ROW_KEYS], 1)

    unit = {k: 1.0 / side if k == "pred_boxes" else 1.0 for k in LANE_ROW_KEYS}
    ra, rb = rows(a, unit), rows(b, unit)
    t = torch.cat([torch.full((a[k][0].numel(),), tol[k], device=ra.device) for k in LANE_ROW_KEYS])
    dist = ((ra[:, None] - rb[None]).abs() / (t + t * rb[None].abs())).max(dim=-1).values
    pair = dist.argmin(dim=1)
    widths = [a[k][0].numel() for k in LANE_ROW_KEYS]
    diff = (ra - rb[pair]).abs().split(widths, dim=1)
    return dict(worst=max(float(dist.min(dim=1).values.max()), float(dist.min(dim=0).values.max())),
                reordered_rows=int((pair != torch.arange(len(pair), device=pair.device)).sum()),
                **{f"max_{k}_diff": float(d.max()) / unit[k] for k, d in zip(LANE_ROW_KEYS, diff)})


def lanes_vs_single(model, lanes, device, labeler=None, cfg=None, hold=False) -> dict:
    """CuTR on the lanes' first frames as one batch of N: each lane against
    lane 0 of a batch of its frame repeated N times (``same_shapes``,
    LANE_SAME_TOL), against a batch-1 run (``cutr``, LANE_F32_TOL) and a
    batch-1 run against another (``batch_1_twice``: what the card's
    products alone do between runs).  With a labeler, the label stage both
    engines share (fused.label_boost_core) on the batch-N detections: all N
    lanes in one tower call against one lane a call.  ``hold``: raise
    unless every row is within its bound and the labels and overflow are
    identical; else only ``same_shapes`` is held and the rest returned."""
    import torch

    from boxfusion_tpu_torch.runtime.fused import _detections, label_boost_core

    frames = [lane[0] for lane in lanes]
    n = len(frames)
    sides = [float(max(f.image.shape[:2])) for f in frames]
    stacked, together, alone = cutr_lanes(model, frames, device)
    _, _, again = cutr_lanes(model, frames, device)
    repeated = [cutr_lanes(model, [f] * n, device)[1] for f in frames]
    out = dict(
        same_shapes=[rows_apart(_detections(together, i), _detections(repeated[i], 0), LANE_SAME_TOL,
                                sides[i]) for i in range(n)],
        cutr=[rows_apart(_detections(together, i), _detections(alone[i], 0), LANE_F32_TOL, sides[i])
              for i in range(n)],
        batch_1_twice=[rows_apart(_detections(again[i], 0), _detections(alone[i], 0), LANE_SAME_TOL,
                                  sides[i]) for i in range(n)],
        live_rows_batch_n=[int(x) for x in (together["scores"] >= 0.3).sum(1)],
        live_rows_batch_1=[int((o["scores"] >= 0.3).sum()) for o in alone])
    if any(r["worst"] > 1.0 for r in out["same_shapes"]) or (
            hold and any(r["worst"] > 1.0 for r in out["cutr"])):
        raise RuntimeError(f"CuTR at batch {n}: a lane beyond its bound: {out}")
    if labeler is None:
        return out
    det_cfg = cfg["detection"]
    kw = dict(label_budget=int(det_cfg["max_label_boxes"]), scale_box=float(det_cfg["scale_box"]),
              clip_coeff=float(cfg["box_fusion"]["clip_sim_coeff"]),
              raw_score_thresh=float(det_cfg["score_thresh"]))
    dets = [_detections(together, i) for i in range(n)]
    hws = [tuple(float(x) for x in f.image.shape[:2]) for f in frames]
    with torch.inference_mode(), AttentionBatches() as att:
        got, got_ovf = label_boost_core(labeler, dets, stacked.image, hws, **kw)
        single = [label_boost_core(labeler, [dets[i]], stacked.image[i:i + 1], [hws[i]], **kw)
                  for i in range(n)]
    labels = []
    for i, ((want,), want_ovf) in enumerate(single):
        kept = want["scores"] > -1e8
        d = (got[i]["scores"] - want["scores"]).abs()[kept]
        labels.append(dict(
            kept_equal=bool(torch.equal(got[i]["scores"] > -1e8, kept)),
            categories_equal=bool(torch.equal(got[i]["category"], want["category"])),
            overflow=[int(got_ovf[i]), int(want_ovf[0])], kept=int(kept.sum()),
            max_score_diff=float(d.max()) if len(d) else 0.0,
            within=bool((d <= (1 + want["scores"][kept].abs()) * LANE_F32_TOL["scores"]).all())))
    out.update(labels=labels, label_batches=sorted(set(att.batches)),
               attention_shapes=sorted(att.shapes))
    if hold and not all(x["kept_equal"] and x["categories_equal"] and x["within"]
                        and x["overflow"][0] == x["overflow"][1] for x in labels):
        raise RuntimeError(f"label stage, {n} lanes in one call against one a call: {labels}")
    return out


class ReplayDetector:
    """Hands a DevicePipeline the detections one batched lane's step took,
    keyframe by keyframe (tensors on the card: keyframe_step_devdet)."""

    def __init__(self, dets):
        self.dets = iter(dets)

    def __call__(self, frame):
        return dict(next(self.dets))


def phase_batched(device, n_lanes=4, dimension=768, clip_cfg=None, n_frames=24,
                  image_hw=(384, 512)) -> dict:
    """BatchedPipeline, 4 lanes (sequences of seeds 0-3, phase 7's frames,
    depth in whole millimetres), packed, unlabelled and labelled.

    Each lane is held equal (integers exact, floats 1e-6) to a
    single-sequence DevicePipeline run of its frames fed the detections that
    lane's step took (the batched CuTR forward's, labelled by the batched
    tower call): the lane bookkeeping at the same shapes.  What batching
    changes is held before the search, at float32 (lanes_vs_single): no lane
    leaks into another at the same shapes (LANE_SAME_TOL), CuTR at batch 4
    against batch 1 and the label stage over 4 x 100 crops in one tower call
    against 100 a call within LANE_F32_TOL, labels identical.
    Each lane's world is also compared with a plain single-sequence
    device-engine run in bf16; the search and near-tie decisions amplify the
    rounding there, so that difference is printed, not held.
    whole_seq_attention is held against its twin at every shape these runs
    gave it.  Returns the launch counts per path."""
    import dataclasses

    import numpy as np

    from boxfusion_tpu_torch.runtime import BatchedPipeline, CuTRDetector, DevicePipeline

    t_phase = time.perf_counter()
    kernels = counted_kernels()
    model = make_main_model(device, dimension=dimension)
    labeler = make_labeler(device, clip_cfg)
    lanes = [main_path_frames(seed=s, n_frames=n_frames, image_hw=image_hw) for s in range(n_lanes)]

    def batched(label, lanes=lanes, name=None):
        pipe = BatchedPipeline(engine_config(label), CuTRDetector(model, device=device), n_lanes,
                               capacity=2048, transport="packed",
                               labeler=labeler if label else None, device=device)
        taken = [[] for _ in range(n_lanes)]
        step_lanes = pipe._step_lanes

        def recorded(dets, *args):
            for i, det in enumerate(dets):
                if det is not None:
                    taken[i].append({k: v.clone() for k, v in det.items()})
            return step_lanes(dets, *args)

        sync(device)
        for k in kernels:
            k.launches = 0
        with AttentionBatches() as att:
            t0 = time.perf_counter()
            pipe._step_lanes = recorded  # a copy per keyframe: in the timed run
            worlds = pipe.run(lanes, gap=1)
            seconds = time.perf_counter() - t0
        rec = dict(phase="batched", run=name, engine="batched", transport="packed", lanes=n_lanes,
                   labelled=label, rounds=pipe.rounds, keyframes=pipe.keyframes, seconds=seconds,
                   keyframes_per_s=pipe.keyframes / seconds,
                   lane_frames_per_s=[float(x) for x in pipe.lane_fps],
                   host_reads_per_round=pipe.host_reads / pipe.rounds,
                   host_reads_per_keyframe=pipe.host_reads / pipe.keyframes,
                   world_boxes=[len(w["scores"]) for w in worlds],
                   fused_boxes=[int(w["fusion_flag"].sum()) for w in worlds],
                   launches={k.__name__: k.launches for k in kernels},
                   clip_batches=sorted(set(att.batches)), attention_shapes=sorted(att.shapes))
        check_path_launches(rec, f"batched phase, {name}")
        for w in worlds:
            if len(w["scores"]) == 0 or not np.isfinite(w["xyzlhw"]).all():
                raise RuntimeError(f"batched {name}: an empty or non-finite lane world")
        print(json.dumps(rec))
        return rec, worlds, taken

    batched(False, lanes=[f[:2] for f in lanes], name="warm-up")
    recs, diffs = {}, {}
    for label in (False, True):
        name = "batched_labelled" if label else "batched"
        recs[name], worlds, taken = batched(label, name=name)
        diffs[name] = []
        for i, (lane, w) in enumerate(zip(lanes, worlds)):
            cfg = engine_config(label)
            replay = DevicePipeline(cfg, ReplayDetector(taken[i]), capacity=2048, device=device)
            if label:  # the raw filter ran before the tower (DevicePipeline.__init__)
                replay.step_cfg = dataclasses.replace(replay.step_cfg, score_thresh=-1e8)
            _worlds_equal(w, replay.run(lane, gap=1), f"{name} lane {i} vs its replay")
            _, single = drive_engine("device", device, model, lane, cfg,
                                     labeler=labeler if label else None)
            diffs[name].append(world_diff(w, single))
    bf16_rows = lanes_vs_single(model, lanes, device)
    del model, labeler
    # float32: the batched forward and the 4 x 100-crop tower call held to
    # batch 1 before the search
    f32_model = make_main_model(device, "float32", dimension)
    f32_labeler = make_labeler(device, dataclasses.replace(clip_cfg or clip_l14_config(),
                                                           dtype="float32"))
    f32_rows = lanes_vs_single(f32_model, lanes, device, f32_labeler, engine_config(True), hold=True)
    del f32_model, f32_labeler
    attention = check_path_attention(
        device, {tuple(x) for r in [*recs.values(), f32_rows] for x in r["attention_shapes"]},
        "batched phase")
    summary = dict(phase="batched", summary=True, seconds=time.perf_counter() - t_phase,
                   lanes_equal_to_replay=True, bf16_lanes_vs_device_engine=diffs,
                   bf16_batch_vs_single=bf16_rows, f32_batch_vs_single=f32_rows,
                   attention_vs_twin=attention)
    print(json.dumps(summary))
    return {k: recs[k]["launches"] for k in recs}


# -------------------------------------------------------------------- phase 10
def phase_eval(device, dimension=768, n_frames=24, image_hw=(384, 512), cli_args=()) -> dict:
    """The eval entry point: ``python -m boxfusion_tpu_torch.eval --synthetic
    2`` as a subprocess must print AP@0.25 = AP@0.50 = 1.0000; then
    evaluate_sequences_batched over 4 synthetic sequences with CuTR-768
    (4 lanes, packed) must return and write one pickle per sequence."""
    from boxfusion_tpu_torch.data.synthetic import SyntheticSequence
    from boxfusion_tpu_torch.eval import evaluate_sequences_batched
    from boxfusion_tpu_torch.ops.pst_search import pst_search
    from boxfusion_tpu_torch.runtime import CuTRDetector

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "boxfusion_tpu_torch.eval", "--config",
         os.path.join(HERE, "config/ca1m.yaml"), "--synthetic", "2", *cli_args],
        capture_output=True, text=True, timeout=600, cwd=HERE,
    )
    lines = [ln for ln in proc.stdout.splitlines() if "AP@0.25" in ln]
    rec = dict(phase="eval", cli_rc=proc.returncode, cli_printed=lines,
               cli_seconds=time.perf_counter() - t0)
    if proc.returncode != 0 or not lines or "AP@0.25 = 1.0000  AP@0.50 = 1.0000" not in lines[0]:
        print(json.dumps(rec))
        raise RuntimeError(f"eval --synthetic 2: rc {proc.returncode}, printed {lines}, "
                           f"stderr {proc.stderr[-2000:]}")

    t1 = time.perf_counter()
    seqs = [SyntheticSequence(n_frames=n_frames, n_boxes=8, image_hw=image_hw, seed=s,
                              video_id=f"synth{s}") for s in range(4)]
    pst_search.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        out = evaluate_sequences_batched(
            engine_config(), seqs, CuTRDetector(make_main_model(device, dimension=dimension),
                                                device=device), lanes=4,
            output_dir=tmp, capacity=2048, packed=True, device=device,
        )
        pickles = sorted(f for f in os.listdir(tmp) if f.endswith("_boxes.pkl"))
    rec.update(batched_seconds=time.perf_counter() - t1, batched_sequences=len(out["sequences"]),
               batched_boxes=[r["n_boxes"] for r in out["sequences"]],
               batched_lane_fps=[r["fps"] for r in out["sequences"]], pickles=pickles,
               pst_search_launches=pst_search.launches)
    print(json.dumps(rec))
    if pickles != [f"synth{s}_boxes.pkl" for s in range(4)] or len(out["sequences"]) != 4:
        raise RuntimeError(f"evaluate_sequences_batched: {len(out['sequences'])} results, pickles {pickles}")
    if pst_search.launches <= 0:
        raise RuntimeError("evaluate_sequences_batched: pst_search was never launched")
    return rec


# -------------------------------------------------------------------- phase 11
TRAIN_ARGS = ["--steps", "20", "--batch", "8", "--dim", "768", "--image-size", "512",
              "--n-sequences", "2", "--frames-per-seq", "8", "--n-boxes", "8", "--log-every", "5",
              "--warmup", "5", "--ckpt-every", "20"]
FIXTURE = "tests/fixtures/cutr_trained_192_f16.pth"
GRAD_TOL = 1e-3  # relative L2 per parameter, plus twice the plain path's own spread
SPLIT_STEPS = 5  # JAX's criterion: 5 steps at lr 1e-4 end below the first loss


def run_trainer(args, what: str, timeout: int = 600) -> dict:
    """``python -m boxfusion_tpu_torch.train`` as a subprocess on the card:
    its rc, printed losses and lines; fails unless rc 0 and every loss is
    finite."""
    import math

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "boxfusion_tpu_torch.train", *args],
                          capture_output=True, text=True, timeout=timeout, cwd=HERE)
    out = proc.stdout
    losses = [float(ln.split("loss")[1].split("|")[0]) for ln in out.splitlines() if "| loss" in ln]
    rec = dict(what=what, rc=proc.returncode, seconds=time.perf_counter() - t0, losses=losses,
               lines=[ln for ln in out.splitlines() if ln.startswith(("mesh", "dataset", "resumed", "saved",
                                                                      "steps 2-"))])
    if proc.returncode != 0 or not losses or not all(math.isfinite(x) for x in losses):
        print(json.dumps({"phase": "train", **rec}))
        raise RuntimeError(f"train ({what}): rc {proc.returncode}, losses {losses}, "
                           f"stderr {proc.stderr[-3000:]}")
    return rec


def write_capture(root, n_frames=4, hw=(48, 64)):
    """A raw CA-1M capture directory (the layout ``data_process convert``
    reads): per frame a .wide image + T_gravity and a .gt depth, pose and
    intrinsics, from a seeded generator; one world GT instance."""
    import numpy as np
    from PIL import Image

    cap = os.path.join(root, "42898867")
    h, w = hw
    rng = np.random.RandomState(0)
    K = [[50.0, 0, w / 2], [0, 50.0, h / 2], [0, 0, 1]]
    for i in range(n_frames):
        wide, gt = os.path.join(cap, f"{i:06d}.wide"), os.path.join(cap, f"{i:06d}.gt")
        for d in (wide, os.path.join(gt, "image"), os.path.join(gt, "depth")):
            os.makedirs(d, exist_ok=True)
        Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)).save(os.path.join(wide, "image.png"))
        Image.fromarray((rng.rand(h, w) * 3000).astype(np.uint16)).save(os.path.join(gt, "depth.png"))
        pose = np.eye(4)
        pose[:3, 3] = [0.1 * i, 0, 0]
        for path, value in ((os.path.join(gt, "RT.json"), pose.tolist()),
                            (os.path.join(wide, "T_gravity.json"), np.eye(3).tolist()),
                            (os.path.join(gt, "image", "K.json"), K),
                            (os.path.join(gt, "depth", "K.json"), K)):
            with open(path, "w") as f:
                json.dump(value, f)
    os.makedirs(os.path.join(cap, "world.gt"), exist_ok=True)
    with open(os.path.join(cap, "world.gt", "instances.json"), "w") as f:
        json.dump([{"corners": np.zeros((8, 3)).tolist()}], f)
    return cap


def train_batch(device, image_size, n_frames, batch, seed=0):
    """The trainer's synthetic epoch (``_build_dataset``) on ``device`` and a
    fixed batch of its first ``batch`` frames."""
    import argparse

    import numpy as np

    from boxfusion_tpu_torch.train.__main__ import _build_dataset, stack_frames, stack_targets, take

    args = argparse.Namespace(image_size=image_size, n_sequences=1, frames_per_seq=n_frames, n_boxes=8,
                              seed=seed, depth_ratio=4)
    frames, targets = _build_dataset(args)
    idx = np.arange(batch) % len(frames)
    return take(stack_frames(frames, device), idx), take(stack_targets(targets, device), idx)


def step_split(device, dimension=768, image_size=512, batch=8) -> dict:
    """SPLIT_STEPS train steps at a constant lr 1e-4 on one fixed batch, each
    through the trainer's own pieces (``batch_loss``, then ``apply_update``
    with a synchronise before the optimizer step): synced ms of forward +
    loss, backward and optimizer over steps 2.., peak memory, and the loss
    falling (JAX's criterion)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from boxfusion_tpu_torch.models.cutr import make_cutr
    from boxfusion_tpu_torch.train.step import apply_update, batch_loss, init_train_state, make_train_step

    fb, tg = train_batch(device, image_size, 16, batch)
    model = make_cutr(dimension, depth_model=True, device=device, seed=0)
    step, opt = make_train_step(model, learning_rate=1e-4)
    state = init_train_state(model, opt)
    marks = []
    real_step = opt.step

    def timed_step(*a, **kw):
        sync(device)
        marks.append(time.perf_counter())
        return real_step(*a, **kw)

    opt.step = timed_step
    on_card = torch.device(device).type == "cuda"
    sync(device)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    losses, parts = [], []
    for _ in range(SPLIT_STEPS):
        marks.clear()
        t0 = time.perf_counter()
        loss = batch_loss(model, fb, tg)
        sync(device)
        t1 = time.perf_counter()
        apply_update(state, step.schedule, loss)
        sync(device)
        t3 = time.perf_counter()
        losses.append(float(loss.detach()))
        parts.append(((t1 - t0) * 1e3, (marks[0] - t1) * 1e3, (t3 - marks[0]) * 1e3))
    peak = torch.cuda.max_memory_allocated(device) if on_card else float("nan")
    del opt.step
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model(fb, train=True)
    fwd_flops = fc.get_total_flops()
    mean = [sum(p[i] for p in parts[1:]) / (len(parts) - 1) for i in range(3)]
    rec = dict(forward_loss_ms=mean[0], backward_ms=mean[1], optimizer_ms=mean[2],
               step_ms=sum(mean), steps=SPLIT_STEPS, batch=batch, dimension=dimension,
               image_size=image_size, losses=losses, peak_memory_gib=peak / 2 ** 30,
               forward_flops=fwd_flops, step_flops=3 * fwd_flops,
               f32_bound_ms=3 * fwd_flops / PEAK_F32_FLOPS * 1e3)
    rec["bound_share"] = rec["f32_bound_ms"] / rec["step_ms"]
    if not losses[-1] < losses[0]:
        print(json.dumps({"phase": "train", **rec}))
        raise RuntimeError(f"train: {SPLIT_STEPS} steps at lr 1e-4 did not lower the loss: {losses}")
    return rec


def no_grad_params(names):
    """The parameters the set loss does not reach: the encoder proposals'
    class head and the decoder's metric-token scale heads (the RGB-D model
    de-whitens with the GT depth parameters) -- 26 at CuTR's 6 layers."""
    return [n for n in names if n.startswith("prompting.prompters.1.predictors.0.") or (
        n.startswith("decoder.predictors.") and n.split(".")[3] == "0")]


def sharded_step_ms(device, dimension=768, image_size=512, batch=8) -> dict:
    """The trainer's step as it runs it -- ``shard_train_step`` on a one-rank
    mesh, where every placement replicates, so no parameter is a DTensor and
    nothing is gathered -- on step_split's batch:
    synced ms a step over steps 2..SPLIT_STEPS, split at the optimizer step
    (forward + loss + backward, then AdamW)."""
    import torch
    import torch.distributed as dist

    from boxfusion_tpu_torch.models.cutr import make_cutr
    from boxfusion_tpu_torch.parallel import make_mesh, shard_train_step
    from boxfusion_tpu_torch.parallel.mesh import init_process_group
    from boxfusion_tpu_torch.train.step import init_train_state, make_train_step

    fb, tg = train_batch(device, image_size, 16, batch)
    made = init_process_group(torch.device(device).type)
    try:
        model = make_cutr(dimension, depth_model=True, device=device, seed=0)
        step, opt = make_train_step(model, learning_rate=1e-4)
        sstep, state, _, _ = shard_train_step(step, make_mesh(), init_train_state(model, opt), fb, tg)
        marks, real_step = [], state.optimizer.step

        def timed_step(*a, **kw):
            sync(device)
            marks.append(time.perf_counter())
            return real_step(*a, **kw)

        state.optimizer.step = timed_step
        parts = []
        for _ in range(SPLIT_STEPS):
            marks.clear()
            sync(device)
            t0 = time.perf_counter()
            state, m = sstep(state, fb, tg)
            sync(device)
            parts.append(((marks[0] - t0) * 1e3, (time.perf_counter() - marks[0]) * 1e3))
        del state.optimizer.step
        loss = float(m["loss"])
    finally:
        if made:
            dist.destroy_process_group()
    mean = [sum(p[i] for p in parts[1:]) / (len(parts) - 1) for i in range(2)]
    return dict(sharded_step_ms=sum(mean), sharded_forward_backward_ms=mean[0],
                sharded_optimizer_ms=mean[1], sharded_last_loss=loss)


def _grad_run(device, sd, inputs, targets, record):
    """One port train step's loss and gradients on ``device`` from the
    state dict ``sd``; ``record`` collects greedy_match's assignments."""
    import torch

    from boxfusion_tpu_torch.models.cutr import FrameBatch, make_cutr
    from boxfusion_tpu_torch.train import loss as loss_mod
    from boxfusion_tpu_torch.train.step import init_train_state, make_train_step

    model = make_cutr(192, depth_model=True, device=device)
    model.load_state_dict(sd)
    step, opt = make_train_step(model, learning_rate=1e-4)
    real = loss_mod.greedy_match

    def recorded(cost, mask):
        out = real(cost, mask)
        record.append(out.cpu())
        return out

    loss_mod.greedy_match = recorded
    try:
        fb = FrameBatch(**{k: torch.from_numpy(v).to(device) for k, v in inputs.items()})
        _, m = step(init_train_state(model, opt), fb,
                    {k: torch.from_numpy(v).to(device) for k, v in targets.items()})
    finally:
        loss_mod.greedy_match = real
    with torch.no_grad():
        enc = model(fb)["enc_logits"][..., 0]
    from boxfusion_tpu_torch.models.cutr.layers import topk_stable

    topk = topk_stable(enc, model.cfg.num_queries)[1].cpu()
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    return float(m["loss"]), grads, topk


def card_against_cpu(device, S=256, r=4, B=2, G=4) -> dict:
    """CuTR-192 float32, the same weights and batch through one train step on
    the card and on the port's CPU path: greedy assignments and top-k
    proposal indices equal, loss rtol 1e-4, every gradient within GRAD_TOL
    relative L2 plus twice the CPU path's own spread (its gradient's move
    when the image is scaled by 1 + 1e-7: CuTR's gradient has ReLU kinks a
    rounding-level change of the forward crosses), the parameters with no
    gradient exactly zero on both."""
    import numpy as np
    import torch

    from boxfusion_tpu_torch.models.cutr import make_cutr

    rng = np.random.RandomState(0)
    f = 0.6 * S
    inputs = dict(
        image=rng.randn(B, S, S, 3).astype(np.float32),
        depth=rng.randn(B, S // r, S // r, 1).astype(np.float32),
        K=np.tile(np.array([[f, 0, S / 2], [0, f, S / 2], [0, 0, 1]], np.float32)[None], (B, 1, 1)),
        image_hw=np.tile(np.array([[0.75 * S, S]], np.float32), (B, 1)),
        depth_params=np.tile(np.array([[2.0, 0.5]], np.float32), (B, 1)),
        T_gravity=np.tile(np.eye(3, dtype=np.float32)[None], (B, 1, 1)),
    )
    rng = np.random.RandomState(1)
    targets = dict(
        boxes2d=rng.uniform(50, 200, (B, G, 4)).astype(np.float32),
        proj_xy=rng.uniform(0, 256, (B, G, 2)).astype(np.float32),
        z=rng.uniform(0.5, 4.0, (B, G, 1)).astype(np.float32),
        dims=rng.uniform(0.1, 1.0, (B, G, 3)).astype(np.float32),
        pose=np.tile(np.eye(3, dtype=np.float32)[None, None], (B, G, 1, 1)),
        mask=np.ones((B, G), np.float32),
    )
    targets["mask"][1, G - 1] = 0.0
    sd = make_cutr(192, depth_model=True, device="cpu", seed=0).state_dict()
    a_gpu, a_cpu, a_nudged = [], [], []
    loss_gpu, g_gpu, topk_gpu = _grad_run(device, sd, inputs, targets, a_gpu)
    loss_cpu, g_cpu, topk_cpu = _grad_run("cpu", sd, inputs, targets, a_cpu)
    nudged = {**inputs, "image": inputs["image"] * np.float32(1 + 1e-7)}
    _, g_nudged, _ = _grad_run("cpu", sd, nudged, targets, a_nudged)

    errs, heads, zero = {}, [], []
    for name, want in g_cpu.items():
        if float(want.abs().max()) == 0.0:
            zero.append(name)
            if float(g_gpu[name].abs().max()) != 0.0:
                raise RuntimeError(f"train card vs cpu: {name} has no gradient on the CPU, one on the card")
            continue
        norm = max(float(want.norm()), 1e-4)
        err = float((g_gpu[name] - want).norm()) / norm
        spread = float((g_nudged[name] - want).norm()) / norm
        errs[name] = (err, spread)
        if name.startswith("decoder.predictors."):
            heads.append(err)
    rec = dict(loss_card=loss_gpu, loss_cpu=loss_cpu, assignments_equal=all(
        torch.equal(a, b) for a, b in zip(a_gpu, a_cpu)) and len(a_gpu) == len(a_cpu) == 6,
        topk_equal=bool(torch.equal(topk_gpu, topk_cpu)), n_params=len(g_cpu), n_zero_grad=len(zero),
        max_grad_rel_l2=max(e for e, _ in errs.values()),
        max_grad_rel_l2_heads=max(heads), max_cpu_spread=max(s for _, s in errs.values()),
        over_tol_alone=sum(e > GRAD_TOL for e, _ in errs.values()),
        failing=[n for n, (e, s) in errs.items() if e > GRAD_TOL + 2 * s])
    if (not rec["assignments_equal"] or not rec["topk_equal"] or rec["failing"]
            or abs(loss_gpu - loss_cpu) > 1e-4 * abs(loss_cpu) or not set(no_grad_params(g_cpu)) <= set(zero)):
        print(json.dumps({"phase": "train", "card_vs_cpu": rec}))
        raise RuntimeError(f"train card vs cpu: {rec}")
    return rec


def mesh_one_rank(device, dimension=768, S=512) -> dict:
    """shard_inference on a one-rank mesh (nccl) against the plain forward:
    every output within 1e-6."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from boxfusion_tpu_torch.models.cutr import FrameBatch, make_cutr
    from boxfusion_tpu_torch.parallel import make_mesh, shard_inference
    from boxfusion_tpu_torch.parallel.mesh import init_process_group, mesh_shape

    made = init_process_group(torch.device(device).type)
    try:
        mesh = make_mesh()
        model = make_cutr(dimension, depth_model=True, device=device, seed=0)
        rng = np.random.RandomState(0)
        f = 0.6 * S
        fb = FrameBatch(
            image=torch.from_numpy(rng.randn(1, S, S, 3).astype(np.float32)).to(device),
            depth=torch.from_numpy(rng.randn(1, S // 4, S // 4, 1).astype(np.float32)).to(device),
            K=torch.tensor([[[f, 0, S / 2], [0, f, S / 2], [0, 0, 1]]], device=device),
            image_hw=torch.tensor([[0.75 * S, S]], device=device),
            depth_params=torch.tensor([[2.0, 0.5]], device=device),
            T_gravity=torch.eye(3, device=device)[None],
        )
        with torch.no_grad():
            want = model(fb)
        apply, placed = shard_inference(model, mesh)
        got = apply(placed, fb)
        diff = {k: float((got[k].float() - want[k].float()).abs().max())
                for k in ("enc_logits", "enc_boxes", "scores", "pred_boxes", "boxes3d")}
        rec = dict(mesh=mesh_shape(mesh), backend=dist.get_backend(), max_abs_diff=diff)
    finally:
        if made:
            dist.destroy_process_group()
    if max(diff.values()) > 1e-6:
        print(json.dumps({"phase": "train", "mesh": rec}))
        raise RuntimeError(f"train: shard_inference at world size 1 differs from the plain forward: {diff}")
    return rec


def refusal_on_card(device) -> dict:
    """Both attention wrappers raise on inputs that require grad under grad
    mode (no launch counted) and launch under no_grad."""
    import torch

    from boxfusion_tpu_torch.ops.attention_kernel import whole_seq_attention
    from boxfusion_tpu_torch.tools.attention_ablation import tiled_attention

    q = torch.randn(2, 65, 128, device=device, requires_grad=True)
    t = torch.randn(2, 65, 64, device=device, requires_grad=True)
    before = (whole_seq_attention.launches, tiled_attention.launches)
    refused = []
    for name, call in (("whole_seq_attention", lambda: whole_seq_attention(q, q, q, 2, 64 ** -0.5)),
                       ("tiled_attention", lambda: tiled_attention(t, t, t))):
        try:
            call()
        except RuntimeError as e:
            if "no gradient" in str(e):
                refused.append(name)
    counted = (whole_seq_attention.launches, tiled_attention.launches) != before
    with torch.no_grad():
        whole_seq_attention(q, q, q, 2, 64 ** -0.5)
        tiled_attention(t, t, t)
    torch.cuda.synchronize(device)
    after = (whole_seq_attention.launches - before[0], tiled_attention.launches - before[1])
    rec = dict(refused=refused, launches_under_no_grad=after)
    if len(refused) != 2 or counted or after != (1, 1):
        raise RuntimeError(f"train: the attention wrappers' autograd refusal on the card: {rec}")
    return rec


def phase_train(device) -> dict:
    """Phase 11: the training path.  Returns each kernel's launch count over
    the in-process train steps (all 0: training runs plain attention)."""
    import numpy as np
    import torch

    from boxfusion_tpu_torch.data_process.__main__ import main as prep_main
    from boxfusion_tpu_torch.geometry.boxes import box_corners
    from boxfusion_tpu_torch.models.cutr import make_cutr
    from boxfusion_tpu_torch.utils.checkpoint import restore_params

    card = card_line()
    kernels = counted_kernels(ablation=True)

    # the trainer at full width, as a subprocess; its checkpoint restored
    with tempfile.TemporaryDirectory() as tmp:
        full = run_trainer([*TRAIN_ARGS, "--ckpt-dir", tmp], "full width")
        saved = os.path.join(tmp, "step_0000020")
        params = restore_params(saved)
        model = restore_params(saved, template=make_cutr(768, depth_model=True, device=device))
        restored = model.state_dict()
        equal = sorted(params) == sorted(restored) and all(
            torch.equal(params[k], restored[k].cpu()) for k in params)
        del model, restored
    rate = [ln for ln in full["lines"] if ln.startswith("steps 2-")]
    full.update(checkpoint_restored_equal=equal,
                steps_per_s_2_20=float(rate[0].split(":")[1].split()[0]) if rate else None)
    print(json.dumps({"phase": "train", "card": card, **full}))
    if not equal or not full["steps_per_s_2_20"]:
        raise RuntimeError(f"train: checkpoint restored equal {equal}, rate line {rate}")

    # the step split, in process; the kernels' counts over these steps
    for k in kernels:
        k.launches = 0
    split = step_split(device)
    split.update(sharded_step_ms(device))
    launches = {k.__name__: k.launches for k in kernels}
    print(json.dumps({"phase": "train", "card": card, "step_split": split, "launches": launches}))
    if any(launches.values()):
        raise RuntimeError(f"train: the training path launched a kernel: {launches}")
    torch.cuda.empty_cache()

    rec = card_against_cpu(device)
    print(json.dumps({"phase": "train", "card_vs_cpu": rec}))

    tune = run_trainer(["--resume", FIXTURE, "--dim", "192", "--steps", "4", "--log-every", "1",
                        "--warmup", "1"], "fine-tune")
    print(json.dumps({"phase": "train", **tune}))

    with tempfile.TemporaryDirectory() as tmp:
        cap = write_capture(tmp)
        out = os.path.join(tmp, "slam", "42898867")
        if prep_main(["convert", cap, out]) != 0:
            raise RuntimeError("train: data_process convert failed")
        xyzlhw = torch.tensor([[0.0, 0.0, 1.2, 0.4, 0.3, 0.2], [0.3, -0.1, 1.5, 0.2, 0.2, 0.5]])
        np.save(os.path.join(out, "after_filter_boxes.npy"),
                box_corners(xyzlhw, torch.eye(3).repeat(2, 1, 1)).numpy())
        with open(os.path.join(HERE, "config/ca1m.yaml")) as f:
            base = f.read()
        cfg_path = os.path.join(tmp, "cfg.yaml")
        with open(cfg_path, "w") as f:  # landscape 48x64: CA-1M stores W=height, H=width
            f.write(base.replace("H: 384", "H: 64").replace("W: 512", "W: 48"))
        real = run_trainer(["--steps", "2", "--batch", "8", "--dim", "192", "--data-root", out,
                            "--train-config", cfg_path, "--gap", "1", "--n-boxes", "4",
                            "--depth-ratio", "4", "--log-every", "1", "--warmup", "1"], "data-root")
    print(json.dumps({"phase": "train", **real}))
    if not any(ln.startswith("dataset: 4 frames") for ln in real["lines"]):
        raise RuntimeError(f"train --data-root: printed {real['lines']}")

    print(json.dumps({"phase": "train", "mesh_one_rank": mesh_one_rank(device)}))
    print(json.dumps({"phase": "train", "refusal": refusal_on_card(device)}))
    return launches


# ------------------------------------------------------------------------ main
def native_checks(loader) -> dict:
    """tests/test_native.py's cases on the port's native loader, against PIL
    (PNG rgb8 and uint16 equal; JPEG within a mean of 2 levels) and a numpy
    model of cv2-convention bilinear resize (1 level / 1e-5); a corrupt JPEG
    must raise ValueError."""
    import io

    import numpy as np
    from PIL import Image

    def encode(img, fmt, **kw):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format=fmt, **kw)
        return buf.getvalue()

    def bilinear(img, dh, dw):
        sh, sw = img.shape[:2]
        fy = (np.arange(dh) + 0.5) * sh / dh - 0.5
        fx = (np.arange(dw) + 0.5) * sw / dw - 0.5
        y0, x0 = np.clip(np.floor(fy), 0, sh - 1).astype(int), np.clip(np.floor(fx), 0, sw - 1).astype(int)
        y1, x1 = np.minimum(y0 + 1, sh - 1), np.minimum(x0 + 1, sw - 1)
        wy, wx = np.clip(fy - y0, 0, 1)[:, None], np.clip(fx - x0, 0, 1)[None, :]
        if img.ndim == 3:
            wy, wx = wy[..., None], wx[..., None]
        g = lambda ys, xs: img[np.ix_(ys, xs)].astype(np.float64)
        return (g(y0, x0) * (1 - wx) + g(y0, x1) * wx) * (1 - wy) + (g(y1, x0) * (1 - wx) + g(y1, x1) * wx) * wy

    rng = np.random.RandomState(0)
    rgb = rng.randint(0, 255, (37, 53, 3), np.uint8)
    u16 = (rng.rand(24, 31) * 60000).astype(np.uint16)
    jpg = rng.randint(0, 255, (40, 60, 3), np.uint8)
    jdata = encode(jpg, "JPEG", quality=95)
    img, dep = rng.randint(0, 255, (48, 64, 3), np.uint8), rng.rand(48, 64).astype(np.float32)
    rec = dict(
        png_rgb8_equal=bool(np.array_equal(loader.decode_png(encode(rgb, "PNG")), rgb)),
        png_u16_equal=bool(np.array_equal(loader.decode_png(encode(u16, "PNG")), u16)),
        jpeg_mean_abs_diff=float(np.mean(np.abs(loader.decode_jpeg(jdata).astype(int)
                                                - np.asarray(Image.open(io.BytesIO(jdata))).astype(int)))),
        resize_rgb_max_diff=max(float(np.abs(loader.resize_rgb(img, wh).astype(float) - bilinear(img, wh[1], wh[0])).max())
                                for wh in ((32, 24), (128, 96))),
        resize_f32_max_diff=max(float(np.abs(loader.resize_f32(dep, wh) - bilinear(dep, wh[1], wh[0])).max())
                                for wh in ((32, 24), (128, 96))),
    )
    try:
        loader.decode_jpeg(b"\xff\xd8\xff\xe0garbage-not-a-jpeg")
        rec["corrupt_jpeg_raises"] = False
    except ValueError:
        rec["corrupt_jpeg_raises"] = True
    ok = (rec["png_rgb8_equal"] and rec["png_u16_equal"] and rec["jpeg_mean_abs_diff"] < 2.0
          and rec["resize_rgb_max_diff"] <= 1.0 and rec["resize_f32_max_diff"] <= 1e-5
          and rec["corrupt_jpeg_raises"])
    if not ok:
        print(json.dumps(dict(phase="native", checks=rec)))
        raise RuntimeError(f"native loader against PIL / bilinear: {rec}")
    return rec


def phase_native(device, dimension=768, n_frames=24, image_hw=(384, 512)) -> dict:
    """The port's native loader (g++, boxfusion_tpu_torch/_build/): built and
    held against PIL, or, when it does not build, the compiler's reason
    printed and the readers on PIL.  Either way: the main path's frames
    written in the CA-1M layout, streamed back through CA1MDataset and
    Prefetcher(depth=3) into the fused engine with CuTR-768 (bfloat16) on the
    card, must give the world of the read-back frames fed as a list (integers
    equal, floats within 1e-6).  Prints the read ms per frame (decode and
    resize) with the native loader and with PIL.  Returns the kernels' launch
    counts over the streamed run."""
    import numpy as np

    import boxfusion_tpu_torch.data.readers as readers
    from boxfusion_tpu_torch.data.readers import CA1MDataset, write_ca1m_sequence
    from boxfusion_tpu_torch.native import Prefetcher, build_error, get_loader
    from boxfusion_tpu_torch.runtime import CuTRDetector, FusedDevicePipeline

    t0 = time.perf_counter()
    loader = get_loader()
    rec = dict(phase="native", built=loader is not None, build_seconds=time.perf_counter() - t0)
    if loader is None:
        print(f"native loader did not build; the readers decode with PIL. Reason: {build_error()}")
        rec["build_error"] = build_error()
    else:
        rec["checks"] = native_checks(loader)
    kernels = counted_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        frames = main_path_frames(seed=3, n_frames=n_frames, image_hw=image_hw)
        write_ca1m_sequence(frames, tmp)
        cfg = engine_config()
        for sec, key, val in (("data", "datadir", tmp), ("data", "start", 0), ("cam", "png_depth_scale", 1000.0),
                              ("cam", "H", image_hw[1]), ("cam", "W", image_hw[0])):
            cfg[sec]._data[key] = val

        def read_ms(native: bool) -> float:
            saved = readers._native
            if not native:
                readers._native = lambda: None
            try:
                t = time.perf_counter()
                got = list(CA1MDataset(cfg))
                return 1e3 * (time.perf_counter() - t) / len(got)
            finally:
                readers._native = saved

        read_ms(loader is not None)  # page cache warm
        rec["read_ms_per_frame_pil"] = read_ms(False)
        if loader is not None:
            rec["read_ms_per_frame_native"] = read_ms(True)
        read_back = list(CA1MDataset(cfg))
        model = make_main_model(device, dimension=dimension)

        def engine():
            return FusedDevicePipeline(cfg, CuTRDetector(model, device=device), capacity=2048, device=device)

        base = engine().run(read_back, gap=1)
        streamed_pipe = engine()
        sync(device)
        for k in kernels:
            k.launches = 0
        t1 = time.perf_counter()
        streamed = streamed_pipe.run(Prefetcher(CA1MDataset(cfg), depth=3), gap=1)
        rec["stream_seconds"] = time.perf_counter() - t1
        launches = {k.__name__: k.launches for k in kernels}
    diff = world_diff(streamed, base)
    if diff["decisions_equal"]:
        diff["max_R_diff"] = float(np.abs(streamed["R"] - base["R"]).max(initial=0.0))
    rec.update(frames=streamed_pipe.count, world_boxes=len(streamed["scores"]),
               fused_boxes=int(np.sum(streamed["fusion_flag"])), launches=launches, world_diff=diff)
    print(json.dumps(rec))
    floats = max((diff.get(k, 0.0) for k in ("max_score_diff", "max_box_diff_unfused", "max_box_diff_fused",
                                             "max_R_diff")), default=0.0)
    if streamed_pipe.count != n_frames or not diff["decisions_equal"] or floats > 1e-6:
        raise RuntimeError(f"native: streamed world differs from the list-fed one ({diff})")
    check_search_launches(launches, "native stream")
    return launches


def phase_trace(device) -> dict:
    """trace_keyframe (the oracle load) and trace_stress (CuTR-768 bfloat16,
    100 detections a keyframe) at full size under torch.profiler.  For each:
    the top device rows, the device's busy share of the traced loop (the
    union of kernel, memcpy and memset intervals over the loop's
    record_function span) and its five longest idle gaps with the host op
    running through each.  The pst_search, nms_greedy and correspond_hits
    kernel events of the whole trace must each equal the wrapper's launch
    count: the counts are zeroed just before
    the profiler starts and read after it stops, so the trace and the count
    cover the same run.  The span is on the host's clock and the kernels on
    the card's, so those inside the span are printed, not held: the last
    keyframe's search ends a millisecond or two before the span does, and a
    run whose clocks disagree by more moves it past the span's end.
    Returns each tool's launch counts."""
    from boxfusion_tpu_torch.tools import trace_keyframe, trace_stress
    from boxfusion_tpu_torch.utils.profiling import count_events, device_activity

    import torch

    kernels = counted_kernels()

    def zero():
        for k in kernels:
            k.launches = 0

    by_tool = {}
    with tempfile.TemporaryDirectory() as tmp, torch.inference_mode():
        for tool in (trace_keyframe, trace_stress):
            name = tool.__name__.rsplit(".", 1)[-1]
            t0 = time.perf_counter()
            res = tool.run(device, out=os.path.join(tmp, name), verbose=False, before_trace=zero)
            launches = {k.__name__: k.launches for k in kernels}
            events = res["events"]
            act = device_activity(events, tool.SPAN, n_gaps=5)
            in_trace = count_events(events, "pst_search_kernel")
            step_events = {k: count_events(events, k + "_kernel") for k in ("nms_greedy", "correspond_hits")}
            rec = dict(phase="trace", tool=name, keyframes=res["keyframes"], seconds=time.perf_counter() - t0,
                       trace_mb=os.path.getsize(res["path"]) / 1e6, launches=launches,
                       pst_search_events=in_trace, step_kernel_events=step_events,
                       pst_search_events_in_span=count_events(events, "pst_search_kernel", span=tool.SPAN), **act,
                       top=[dict(name=n[:100], ms=ms, count=c) for n, ms, c in res["rows"][:10]])
            print(json.dumps(rec))
            if act["n_device_events"] == 0:
                raise RuntimeError(f"{name}: the trace holds no device event")
            if in_trace != launches["pst_search"]:
                raise RuntimeError(f"{name}: {in_trace} pst_search kernel events in the trace, "
                                   f"{launches['pst_search']} launches counted")
            for k, n in step_events.items():
                if n != launches[k]:
                    raise RuntimeError(f"{name}: {n} {k} kernel events in the trace, {launches[k]} launches counted")
            check_search_launches(launches, name)
            by_tool[name] = launches
    return by_tool


# -------------------------------------------------------------------- phase 14
def _counts(kernels) -> dict:
    return {k.__name__: k.launches for k in kernels}


def tools_stress_ablate(device, zero, kernels) -> dict:
    """profile_stress_ablate at full size on one recording of CuTR-768
    detections; the full step's world equals trace_stress.replay's on the same
    recording and configuration; pst_search launches in the full step only."""
    from boxfusion_tpu_torch.runtime.device_pipeline import DevicePipeline
    from boxfusion_tpu_torch.tools import profile_stress_ablate, trace_stress
    from boxfusion_tpu_torch.tools.common import keyframes, tool_config

    gap = 20
    _, _, kf = keyframes(200, 512, gap)
    dets = trace_stress.record_detections(device, kf, 768)
    cfg = tool_config(gap, stress=True)
    pipe = DevicePipeline(cfg, lambda fr: None, capacity=profile_stress_ablate.CAPACITY, device=device)
    trace_stress.replay(pipe, kf, dets, int(cfg["detection"]["max_detections"]))
    replay_world = int(pipe.state.n)
    t0 = time.perf_counter()
    worlds = {}
    zero()
    res = profile_stress_ablate.run(device, 200, 512, 768, gap, dets=dets, worlds=worlds, verbose=False)
    launches = _counts(kernels)
    rec = dict(phase="tools", tool="profile_stress_ablate", keyframes=len(kf), seconds=time.perf_counter() - t0,
               variants={name: dict(ms_per_keyframe=ms, world=n, pst_search_launches=nl,
                                    fused=int(worlds[name]["fusion_flag"].sum()),
                                    dropped_world_capacity=worlds[name]["stats"]["dropped_world_capacity"])
                         for name, (ms, n, nl) in res.items()},
               trace_stress_replay_world=replay_world, launches=launches)
    print(json.dumps(rec))
    if res["full"][1] != replay_world:
        raise RuntimeError(f"profile_stress_ablate: the full step ends with {res['full'][1]} world boxes, "
                           f"trace_stress.replay with {replay_world}")
    if res["full"][2] == 0 or any(res[name][2] for name in res if name != "full"):
        raise RuntimeError(f"profile_stress_ablate: pst_search must launch in the full step only: {res}")
    return launches


def tools_clip_attn(device, zero, kernels) -> dict:
    """profile_clip_attn's five variants at the engines' batches; at each B
    one layer's whole_seq_attention output held against its plain twin on
    the same q, k, v, and the attention alone timed beside SDPA's flash
    backend with CUDA events."""
    import torch
    import torch.nn.functional as F

    from boxfusion_tpu_torch.ops.attention_kernel import whole_seq_attention, whole_seq_attention_reference
    from boxfusion_tpu_torch.tools import profile_clip_attn as pca

    t0 = time.perf_counter()
    zero()
    res = pca.run(device, pca.ENGINE_BATCHES, verbose=False)
    launches = _counts(kernels)
    atol, rtol = attention_tolerance(torch.bfloat16)
    per_b = {}
    for B, times in res.items():
        x0, p = pca.inputs(B, device)
        q, k, v = pca.qkv(x0, p)
        got = whole_seq_attention(q, k, v, pca.H, pca.HD ** -0.5)
        want = whole_seq_attention_reference(q, k, v, pca.H, pca.HD ** -0.5)
        diff = (got.float() - want.float()).abs()
        if not torch.isfinite(got).all() or float((diff - (atol + rtol * want.float().abs())).max()) > 0:
            raise RuntimeError(f"profile_clip_attn B = {B}: whole_seq_attention disagrees with its twin "
                               f"(max |diff| {float(diff.max())}, atol {atol} + rtol {rtol})")
        attn_bytes = 4 * B * pca.T * pca.D * 2  # q, k, v read once, the output written once, bfloat16
        q4, k4, v4 = (x.reshape(B, pca.T, pca.H, pca.HD).transpose(1, 2) for x in (q, k, v))
        per_b[B] = dict(ms_per_layer=times, max_abs_err=float(diff.max()),
                        kernel_attention_ms=cuda_ms(lambda: whole_seq_attention(q, k, v, pca.H, pca.HD ** -0.5), 20),
                        flash_attention_ms=cuda_ms(lambda: pca.attention(q, k, v, "flash"), 20),
                        # SDPA with its own choice of backend, as phase 2's library call
                        sdpa_attention_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                            q4, k4, v4, scale=pca.HD ** -0.5), 20),
                        attention_bound_ms=attn_bytes / PEAK_BYTES_PER_S * 1e3)
    print(json.dumps(dict(phase="tools", tool="profile_clip_attn", seconds=time.perf_counter() - t0,
                          layers_per_call=pca.LAYERS, atol=atol, rtol=rtol, by_batch=per_b, launches=launches)))
    return launches


def tools_bench_real(device, zero, kernels) -> dict:
    """profile_bench_real at bench's sizes: the per-keyframe split and the
    pipelined runs; the synced run and the pipelined run end with equal
    worlds."""
    import numpy as np

    from boxfusion_tpu_torch.tools import profile_bench_real

    t0 = time.perf_counter()
    zero()
    res = profile_bench_real.run(device, verbose=False)
    launches = _counts(kernels)
    split = res["split_ms"]
    print(json.dumps(dict(
        phase="tools", tool="profile_bench_real", seconds=time.perf_counter() - t0, keyframes=res["keyframes"],
        columns=list(profile_bench_real.COLUMNS), first_ms=split[0].tolist(), kf_1_4_ms=split[1:5].tolist(),
        median_ms=np.median(split, axis=0).tolist(), max_ms=split.max(axis=0).tolist(),
        total_median_ms=float(np.median(split.sum(axis=1))), pipelined_kf_per_s=res["pipelined_kf_per_s"],
        world_synced=res["n_synced"], world_pipelined=res["n_pipelined"], launches=launches)))
    if res["n_synced"] != res["n_pipelined"]:
        raise RuntimeError(f"profile_bench_real: the synced run ends with {res['n_synced']} world boxes, "
                           f"the pipelined run with {res['n_pipelined']}")
    return launches


def tools_parity_fixture(device, zero, kernels, steps=20) -> dict:
    """build_parity_fixture with one short stage: the export loads into
    CuTR-192 with no missing or unexpected key, and its keys are the
    committed fixture's."""
    import torch

    from boxfusion_tpu_torch.models.cutr.convert import load_torch_state_dict
    from boxfusion_tpu_torch.tools import build_parity_fixture

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "fixture.pth")
        zero()
        res = build_parity_fixture.run(device, os.path.join(tmp, "work"), out, stages=((steps, 1e-3),))
        launches = _counts(kernels)
        sd = torch.load(out, map_location="cpu", weights_only=True)["model"]
    model_keys = set(load_torch_state_dict(sd, device=device).state_dict())
    committed = set(torch.load(os.path.join(HERE, FIXTURE), map_location="cpu", weights_only=True)["model"])
    print(json.dumps(dict(phase="tools", tool="build_parity_fixture", steps=steps, seconds=res["seconds"],
                          steps_per_s=steps / res["seconds"], keys=len(sd), missing=len(model_keys - set(sd)),
                          unexpected=len(set(sd) - model_keys), keys_equal_committed=set(sd) == committed,
                          launches=launches)))
    if set(sd) != model_keys or set(sd) != committed:
        raise RuntimeError("build_parity_fixture: the export's keys are not CuTR-192's and the committed "
                           f"fixture's ({len(model_keys - set(sd))} missing, {len(set(sd) - model_keys)} "
                           f"unexpected, {len(set(sd) ^ committed)} apart from the fixture)")
    return launches


def tools_reference_refusal(device) -> None:
    """The three reference-parity tools with blackbox.REF on an empty
    directory: each exits with status 2 and its one line."""
    import contextlib
    import importlib
    import io

    from boxfusion_tpu_torch.tools import blackbox

    saved = blackbox.REF
    with tempfile.TemporaryDirectory() as tmp:
        blackbox.REF = os.path.join(tmp, "reference")
        try:
            for name in ("run_blackbox_parity", "diagnose_parity_band", "profile_host_engine"):
                mod = importlib.import_module(f"boxfusion_tpu_torch.tools.{name}")
                err = io.StringIO()
                with contextlib.redirect_stderr(err):
                    rc = mod.main(["--device", str(device), "--workdir", os.path.join(tmp, "work")])
                line = err.getvalue().strip()
                print(json.dumps(dict(phase="tools", tool=name, rc=rc, message=line)))
                if rc != 2 or os.path.join(blackbox.REF, "demo.py") not in line or "\n" in line:
                    raise RuntimeError(f"{name}: without the reference it returned {rc} and printed {line!r}")
        finally:
            blackbox.REF = saved


def phase_tools(device) -> dict:
    """The A12b tools on the card, each path's kernels' launch counts zeroed
    just before it and read just after; returns them by path."""
    import torch

    kernels = counted_kernels()

    def zero():
        for k in kernels:
            k.launches = 0

    by_path = {}
    with torch.inference_mode():
        by_path["stress_ablate"] = tools_stress_ablate(device, zero, kernels)
        by_path["clip_attn"] = tools_clip_attn(device, zero, kernels)
        by_path["bench_real"] = tools_bench_real(device, zero, kernels)
    by_path["parity_fixture"] = tools_parity_fixture(device, zero, kernels)
    tools_reference_refusal(device)
    return by_path


# -------------------------------------------------------------------- phase 15
BENCH_BUDGET_S = 1100.0  # a phase's seconds: enough for every secondary figure of the headline
# the bench's phases run at full width and half depth: 2 headline runs (the
# equal-world check needs two) over 200 frames (10 keyframes at gap 20; the
# secondaries follow: gap 1 over 50 keyframes, 4 lanes x 100 frames); the
# traced headline run keeps the record's 400 frames
BENCH_CUTS = dict(n_runs=2, n_frames=200)
TOOL_FRAMES = 40  # the tools' stream: 10 keyframes at gap 1 (the bench's 400: 100)
MFU_LIMIT = 1.05
STAGES = ("upload", "detect", "label", "step")  # a fused keyframe's spans (runtime/fused.py)


def bench_phases(device, zero, kernels) -> dict:
    """The port's bench phases in this process at BENCH_CUTS; each phase's
    record, its kernels' launches, counted from 0, and the whole_seq_attention
    shapes its tower calls gave."""
    from boxfusion_tpu_torch import bench

    wl = dict(bench._workload(True), **BENCH_CUTS)
    recs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in bench.PHASE_ORDER:
            path = os.path.join(tmp, f"{name}.json")
            t0 = time.perf_counter()
            zero()
            with AttentionBatches() as att:
                bench.PHASES[name](path, BENCH_BUDGET_S, device, wl)
            launches = _counts(kernels)
            with open(path) as f:
                rec = json.load(f)
            rec.pop("on_card", None)
            recs[name] = dict(rec, seconds=time.perf_counter() - t0, launches=launches,
                              attention_shapes=sorted(att.shapes))
            print(json.dumps(dict(phase="bench", bench_phase=name, **recs[name])))
    return recs


def check_bench(recs: dict) -> None:
    """The record's own checks: no saturation and a world with boxes, every
    headline run ending in the same world, no secondary figure left out, an
    MFU in (0, 1.05], a measured matmul ceiling at most 1.05 x the table
    peak, and both kernels of the path launched on the headline."""
    micro, head = recs["micro"], recs["headline"]
    if head["headline_saturated"] or head["world_boxes_final_run"] <= 0:
        raise RuntimeError(f"bench headline: saturated {head['headline_saturated']}, "
                           f"{head['world_boxes_final_run']} world boxes")
    if len(set(head["world_boxes_by_run"])) != 1 or any(
            st != head["world_stats_final_run"] for st in head["world_stats_by_run"]):
        raise RuntimeError(f"bench headline: the runs end in different worlds: {head['world_boxes_by_run']}, "
                           f"{head['world_stats_by_run']}")
    if head["skipped_figures"]:
        raise RuntimeError(f"bench headline: figures left out: {head['skipped_figures']}")
    mfu, peak = micro["detector_mfu"], micro["chip_peak_tflops_bf16"]
    if mfu is None or not 0 < mfu <= MFU_LIMIT:
        raise RuntimeError(f"bench micro: detector_mfu {mfu} outside (0, {MFU_LIMIT}]")
    if micro["measured_peak_tflops_bf16_matmul"] > MFU_LIMIT * peak:
        raise RuntimeError(f"bench micro: measured matmul ceiling {micro['measured_peak_tflops_bf16_matmul']} "
                           f"TFLOP/s above {MFU_LIMIT} x the {peak} table peak")
    check_search_launches(head["launches"], "bench headline")
    if head["launches"]["whole_seq_attention"] <= 0:
        raise RuntimeError("bench headline: whole_seq_attention was never launched")


def bench_headline_trace(device, zero, kernels) -> tuple:
    """One headline run as the bench's record times it (400 frames at gap
    20, 2048 slots, 128 crops), after its warm-up, under torch.profiler:
    the device's busy share of the run, its milliseconds by the keyframe
    stage that launched them (the engine's own ``boxfusion.`` spans; "other"
    is the flush), the host clock's stage seconds, the crops each keyframe
    sent through the tower (its label bucket) and the top device rows.
    Returns (launches, the whole_seq_attention shapes)."""
    from collections import Counter

    from boxfusion_tpu_torch import bench
    from boxfusion_tpu_torch.runtime.detector import CuTRDetector
    from boxfusion_tpu_torch.runtime.fused import FusedDevicePipeline
    from boxfusion_tpu_torch.utils.profiling import (SPAN_PREFIX, aggregate, annotate, device_activity,
                                                     device_ms_by_span, load_trace, trace)

    wl = bench._workload(True)
    gap = wl["gap"]
    model, _ = bench._build_model(device, wl)
    labeler = bench._make_labeler(True, device)
    _, frames = bench._frames(wl)
    pipe = FusedDevicePipeline(bench._headline_cfg(True, wl), CuTRDetector(model, device=device), labeler=labeler,
                               capacity=bench.HEADLINE_CAPACITY, device=device)
    bench._warm(pipe, frames[: 2 * gap + 1], gap)
    pipe.reset()
    pipe.timings, pipe.host_reads = {}, 0  # totals run on over reset(): the traced run's alone
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        zero()
        with LabelClock(labeler) as clock, AttentionBatches() as att:
            with trace(tmp, device) as path, annotate("headline"):
                t_run = time.perf_counter()
                pipe.run(frames, gap=gap, export=False)
                sync(device)
                run_s = time.perf_counter() - t_run
        launches = _counts(kernels)
        trace_mb = os.path.getsize(path) / 1e6
        events = load_trace(path)
    n_kf = int(pipe.state.stats[3])
    act = device_activity(events, "headline", n_gaps=3)
    by_stage = {k.removeprefix(SPAN_PREFIX): v
                for k, v in device_ms_by_span(events, [SPAN_PREFIX + s for s in STAGES]).items()}
    rec = dict(phase="bench", bench_trace="headline", frames=len(frames), keyframes=n_kf,
               traced_run_s=run_s, frames_per_s_traced=len(frames) / run_s, seconds=time.perf_counter() - t0,
               trace_mb=trace_mb, launches=launches, **act,
               device_ms_per_keyframe={k: v / n_kf for k, v in by_stage.items()},
               host_ms_per_keyframe={k: 1e3 * v / n_kf for k, v in sorted(pipe.timings.items())},
               label_crops_by_keyframe=clock.crops,
               keyframes_by_label_bucket=dict(sorted(Counter(clock.crops).items())),
               keyframes_without_crops=n_kf - len(clock.crops),
               top=[dict(name=n[:100], ms=ms, count=c) for n, ms, c in aggregate(events, True)[:10]])
    print(json.dumps(rec))
    if act["n_device_events"] == 0 or by_stage["label"] <= 0 or by_stage["detect"] <= 0:
        raise RuntimeError(f"bench headline trace: no device work charged to its stages: {by_stage}")
    check_search_launches(launches, "bench headline trace")
    return launches, att.shapes


def phase_bench(device) -> dict:
    """The port's bench at full width in this process (CuTR-768 bf16, CLIP
    ViT-L/14 bf16, 512 px, capacity 2048, 128 crops, gap 20) at
    BENCH_CUTS, checked; one headline run at full depth traced; then
    profile_gap1 and profile_r5 (its three sections) at TOOL_FRAMES frames.
    whole_seq_attention is held against its plain twin at every shape these
    paths gave it.  Returns the launches of each path: the bench's phases
    together, the traced run, each tool's run."""
    import torch

    from boxfusion_tpu_torch import bench
    from boxfusion_tpu_torch.tools import profile_gap1, profile_r5

    kernels = counted_kernels()

    def zero():
        for k in kernels:
            k.launches = 0

    full = bench._workload(True)
    print(json.dumps(dict(phase="bench", workload=full,
                          cuts={k: [full[k], v] for k, v in BENCH_CUTS.items()},
                          tool_frames=[full["n_frames"], TOOL_FRAMES])))
    recs = bench_phases(device, zero, kernels)
    check_bench(recs)
    shapes = {tuple(s) for r in recs.values() for s in r["attention_shapes"]}
    by_path = {"bench": {k.__name__: sum(r["launches"][k.__name__] for r in recs.values()) for k in kernels}}
    by_path["bench_trace"], traced = bench_headline_trace(device, zero, kernels)
    shapes |= traced

    t0 = time.perf_counter()
    zero()
    with torch.inference_mode(), AttentionBatches() as att:
        rates = profile_gap1.run(device, n_frames=TOOL_FRAMES)
    by_path["profile_gap1"] = _counts(kernels)
    shapes |= att.shapes
    print(json.dumps(dict(phase="bench", tool="profile_gap1", frames=TOOL_FRAMES, keyframes_per_s=rates,
                          seconds=time.perf_counter() - t0, launches=by_path["profile_gap1"],
                          attention_shapes=sorted(att.shapes))))
    t0 = time.perf_counter()
    zero()
    with AttentionBatches() as att:
        r5 = {section: profile_r5.run(section, device, n_frames=TOOL_FRAMES) for section in ("gap1", "stages", "det")}
    by_path["profile_r5"] = _counts(kernels)
    shapes |= att.shapes
    print(json.dumps(dict(phase="bench", tool="profile_r5", frames=TOOL_FRAMES, gap1=r5["gap1"],
                          stage_ms=r5["stages"]["stage_ms"],
                          det={tag: dict(ms=ms, gflop=fl / 1e9) for tag, (ms, fl) in r5["det"].items()},
                          seconds=time.perf_counter() - t0, launches=by_path["profile_r5"],
                          attention_shapes=sorted(att.shapes))))
    for tool in ("profile_gap1", "profile_r5"):
        check_search_launches(by_path[tool], tool)
        if by_path[tool]["whole_seq_attention"] <= 0:
            raise RuntimeError(f"{tool}: whole_seq_attention was never launched")
    attention = check_path_attention(device, shapes, "bench path")
    print(json.dumps(dict(phase="bench", attention_vs_twin=attention)))
    return by_path


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    from boxfusion_tpu_torch.bench import card

    return "{name}, {power_limit}".format(**card())


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
    log("phase 6: device engine, known answer; snapshot round trip")
    phase_device_oracle(device)
    log("phase 7: device engine, main path at full width, without and with labels")
    drec = phase_device_main(device)
    log("phase 8: fused engine beside the device engine, chunk 1 and 8, label buckets")
    by_path = {"host_labelled": mrec["launches"], "device_labelled": drec["launches"]}
    by_path.update(phase_fused(device))
    log("phase 9: batched engine, 4 lanes, packed, without and with labels")
    by_path.update(phase_batched(device))
    log("phase 10: the eval entry point (--synthetic 2) and evaluate_sequences_batched")
    phase_eval(device)
    log("phase 11: the training path (trainer at full width, step split, card vs CPU, "
        "fine-tune, --data-root, one-rank mesh, autograd refusal)")
    by_path["train"] = phase_train(device)
    log("phase 12: the native loader: built and held against PIL (or its reason printed); "
        "CA-1M on disk -> Prefetcher -> fused engine equals the list-fed world")
    native_launches = phase_native(device)
    by_path["native_stream"] = {**native_launches, "tiled_attention": 0}
    log("phase 13: torch.profiler traces of trace_keyframe and trace_stress: busy share, idle gaps, "
        "pst_search events against its launch count")
    for tool, counts in phase_trace(device).items():
        by_path[tool] = {**counts, "tiled_attention": 0}
    log("phase 14: the A12b tools (profile_stress_ablate, profile_clip_attn, profile_bench_real, "
        "build_parity_fixture, the reference tools' refusal)")
    for tool, counts in phase_tools(device).items():
        by_path[tool] = {**counts, "tiled_attention": 0}
    log("phase 15: the port's bench at full width (micro, headline, multistream, stages, stress), "
        "a traced headline run, then profile_gap1 and profile_r5")
    for path, counts in phase_bench(device).items():
        by_path[path] = {**counts, "tiled_attention": 0}

    # launches: each kernel's count over the path that runs it -- for
    # pst_search, whole_seq_attention and add_layer_norm the sum over the paths of phases 3,
    # 7, 8, 9, 11, 12, 13, 14 and 15 (labelled host and device engines, every
    # fused and batched run, the train steps, the native stream, the traced
    # runs, the A12b tools, the bench's phases, its traced headline run and
    # its two tools), each
    # path's own count under
    # "launches_by_path"; phase 2's run of the eager loop (multiview_fitness's
    # path, off the main path) for fitness_cells; the ablation for
    # tiled_attention; every kernel's count over phase 11's train steps (0:
    # training runs plain attention) under "launches_by_path" "train"; for
    # the step kernels each path's counts of nms_greedy and correspond_hits
    launches["fitness_cells"] = next(r for r in krecs if r["name"] == "pst_search")[
        "eager_fitness_cells_launches"]
    path_counts = {}
    for name in ("pst_search", "whole_seq_attention", "add_layer_norm"):
        path_counts[name] = {path: counts[name] for path, counts in by_path.items()}
        launches[name] = sum(path_counts[name].values())
    for name in ("fitness_cells", "tiled_attention"):  # their own paths' counts stay under "launches"
        path_counts[name] = {"train": by_path["train"][name]}
    keys = ("name", "route", "source", "replaces", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    extra = {"fitness_cells": (),
             "pst_search": ("eager_kernel_ms", "one_iter_max_abs_err", "registers", "local_bytes",
                            "smem_bytes", "threads", "cluster", "max_active_clusters"),
             "whole_seq_attention": ATTENTION_RECORD_KEYS,
             "tiled_attention": KERNEL_INFO_KEYS + ("bf16",),
             "step_kernel": ("held", "times", "info", "pose_bits"),
             "add_layer_norm": ("cases",)}
    # the step kernels: each path's launches of nms_greedy and
    # correspond_hits (one a stage entered on a card), and their sums
    path_counts["step_kernel"] = {
        path: {k: counts[k] for k in ("nms_greedy", "correspond_hits")} for path, counts in by_path.items()}
    launches["step_kernel"] = {k: sum(c[k] for c in path_counts["step_kernel"].values())
                               for k in ("nms_greedy", "correspond_hits")}
    kernels = [{**{k: rec[k] for k in keys + extra[rec["name"]]}, "launches": launches[rec["name"]],
                "launches_by_path": path_counts[rec["name"]]}
               for rec in krecs]
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
