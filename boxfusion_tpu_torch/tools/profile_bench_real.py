"""Dissect bench's real path: where do a keyframe's milliseconds go?

Port of ``tools/profile_bench_real.py``.  Bench's real path, built by
``boxfusion_tpu_torch/bench.py``'s builders: CuTR-768 in bfloat16 (random
weights, seed 0, class-head bias lifted by 3.2), the CLIP ViT-L/14 labeler
(bfloat16, quick-GELU, random weights, seed 0) over 473 random text features
(seed 1), ``FusedDevicePipeline`` with capacity 256 on a synthetic
400-frame stream at 512 px, gap 20.

After a warm-up (the keyframes of the first 2 gaps + 1 frames), each
keyframe is timed alone, the card synchronised after it, in four parts:

  pack       ``_pack_buffer`` (the host packs the frame into one buffer)
  shape key  ``resolve_pad_and_ratio`` (the pad bucket and depth ratio).  The
             JAX tool also fetches the compiled program here; eager PyTorch
             has no program cache, so this column is the shape key alone
  dispatch   ``_dispatch``: the upload and the keyframe's launches
  sync       ``torch.cuda.synchronize``: the device work still in flight

It prints the first keyframe, keyframes 1-4, the median, the max and the
median total, then ``--reps`` pipelined ``run(frames, gap, export=False)``
runs, timed (the card synchronised at the end of each).  The synced run
takes the keyframes ``run`` takes (every gap-th frame and the last), so the
two end with the same world.

    python -m boxfusion_tpu_torch.tools.profile_bench_real
    python -m boxfusion_tpu_torch.tools.profile_bench_real --device cpu --dim 192 --size 256 \\
        --frames 21 --clip-width 64 --clip-layers 1 --reps 1
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from boxfusion_tpu_torch.tools.common import sync, tool_config
from boxfusion_tpu_torch.utils.device import resolve_device

COLUMNS = ("pack", "shape key", "upload+dispatch", "device sync")
CAPACITY = 256  # world slots, bench's


def build(device, dim=768, size=512, n_frames=400, gap=20, clip_width=1024, clip_layers=24):
    """(pipeline, frames) of bench's real path at these sizes: CuTR, the
    labeler and the frames from ``boxfusion_tpu_torch/bench.py``'s builders
    (the card's workload: bfloat16, the ViT-L/14 tower cut to
    ``clip_width`` x ``clip_layers``)."""
    from boxfusion_tpu_torch import bench
    from boxfusion_tpu_torch.runtime.detector import CuTRDetector
    from boxfusion_tpu_torch.runtime.fused import FusedDevicePipeline

    wl = {**bench._workload(True), "dim": dim, "S": size, "n_frames": n_frames, "gap": gap}
    model, _ = bench._build_model(device, wl)
    _, frames = bench._frames(wl)
    labeler = bench._make_labeler(True, device, clip_width, clip_layers)
    pipe = FusedDevicePipeline(tool_config(gap), CuTRDetector(model, device=device), labeler=labeler,
                               capacity=CAPACITY, device=device)
    return pipe, frames


def synced_keyframes(pipe, frames, gap: int) -> np.ndarray:
    """Each keyframe of ``run``'s schedule alone, synchronised after it;
    returns the (keyframes, 4) ms of ``COLUMNS``."""
    from boxfusion_tpu_torch.data.preprocess import resolve_pad_and_ratio

    dev = pipe.device
    depth_model = pipe.detector.model.cfg.depth_model
    last = len(frames) - 1
    rows = []
    for i, fr in enumerate(frames):
        if i % gap and i != last:
            continue
        pipe.count = i  # the frame index, as run() has it at this frame
        t0 = time.perf_counter()
        buf = pipe._pack_buffer(fr)
        t1 = time.perf_counter()
        h, w = fr.image.shape[:2]
        dh, dw = fr.depth.shape[:2]
        key = (h, w, dh, dw, *resolve_pad_and_ratio(fr.image, fr.depth if depth_model else None,
                                                    pipe.detector.buckets))
        t2 = time.perf_counter()
        pipe._dispatch([(key, buf)])
        t3 = time.perf_counter()
        sync(dev)
        t4 = time.perf_counter()
        rows.append((t1 - t0, t2 - t1, t3 - t2, t4 - t3))
    pipe.count = len(frames)
    pipe.flush()
    return np.asarray(rows) * 1e3


def run(device=None, dim=768, size=512, n_frames=400, gap=20, clip_width=1024, clip_layers=24, reps=3,
        verbose=True) -> dict:
    dev = resolve_device(device)
    pipe, frames = build(dev, dim, size, n_frames, gap, clip_width, clip_layers)
    say = print if verbose else (lambda *a, **k: None)
    say("engine:", pipe.step_cfg.engine, flush=True)

    for i, fr in enumerate(frames[: 2 * gap + 1]):  # warm-up
        if i % gap == 0:
            pipe.process_keyframe(fr)
        pipe.count += 1
    pipe.flush()
    sync(dev)

    pipe.reset()
    rows = synced_keyframes(pipe, frames, gap)
    n_synced = int(pipe.state.n)
    say(f"{len(rows)} keyframes", flush=True)
    say(f"per-keyframe ms  [{', '.join(COLUMNS)}]:")
    with np.printoptions(precision=2, suppress=True):
        say("  first:", rows[0])
        say("  kf 1-4:", rows[1:5])
        say("  median:", np.median(rows, axis=0))
        say("  max   :", np.max(rows, axis=0))
    say("  total per kf (median):", round(float(np.median(rows.sum(axis=1))), 2), flush=True)

    rates = []
    for _ in range(reps):
        pipe.reset()
        t0 = time.perf_counter()
        pipe.run(frames, gap=gap, export=False)
        sync(dev)
        rates.append(len(rows) / (time.perf_counter() - t0))
    n_pipelined = int(pipe.state.n)
    say(f"pipelined: {', '.join(f'{r:.2f}' for r in rates)} keyframes/s; world {n_pipelined} "
        f"(synced run: {n_synced})", flush=True)
    return dict(split_ms=rows, keyframes=len(rows), pipelined_kf_per_s=rates, n_synced=n_synced,
                n_pipelined=n_pipelined)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--frames", type=int, default=400)
    ap.add_argument("--gap", type=int, default=20)
    ap.add_argument("--clip-width", type=int, default=1024)
    ap.add_argument("--clip-layers", type=int, default=24)
    ap.add_argument("--reps", type=int, default=3, help="pipelined runs")
    a = ap.parse_args(argv)
    with torch.inference_mode():
        run(a.device, a.dim, a.size, a.frames, a.gap, a.clip_width, a.clip_layers, reps=a.reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
