"""Where does a gap=1 keyframe's wall time go?

Port of ``tools/profile_gap1.py``.  Breaks the live-SLAM profile (every
frame a keyframe, cubicle.yaml:7) into, at the bench's workload
(``boxfusion_tpu_torch/bench.py``: CuTR-768 bf16, CLIP ViT-L/14 labels,
``FusedDevicePipeline`` with a 2048-slot world and a 128-crop budget on a
card; the bench's CPU sizes with ``--device cpu``), over the first quarter
of the stream:

  1. host pack only        ``pack_fused_buffer`` per frame, no dispatch
  2. full loop             pack + dispatch (the bench's keyframes_per_s_gap1)
  3. dispatch only         pre-packed buffers through ``_dispatch`` (the
                           upload and the keyframe's launches), no pack
  4. labeler ablation      the full loop without the CLIP labeler
  5. chunk=8               the full loop, 8 keyframes an upload

Each loop figure is the best of 3 runs, each ending in a synchronise.

    python -m boxfusion_tpu_torch.tools.profile_gap1
    python -m boxfusion_tpu_torch.tools.profile_gap1 --device cpu --frames 12
"""
from __future__ import annotations

import argparse
import time

import torch

from boxfusion_tpu_torch import bench
from boxfusion_tpu_torch.tools.common import sync
from boxfusion_tpu_torch.utils.device import resolve_device


def _line(tag: str, kf_per_s: float) -> str:
    return f"{tag:28s} {kf_per_s:8.1f} keyframes/s  ({1e3 / kf_per_s:6.2f} ms/kf)"


def run(device=None, n_frames=None) -> dict:
    """Prints one line per figure; returns {tag: keyframes/s}."""
    from boxfusion_tpu_torch.data.preprocess import resolve_pad_and_ratio
    from boxfusion_tpu_torch.runtime.detector import CuTRDetector
    from boxfusion_tpu_torch.runtime.fused import FusedDevicePipeline, pack_fused_buffer

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    wl = bench._workload(on_card)
    if n_frames is not None:
        wl["n_frames"] = n_frames
    n_kf = wl["n_frames"] // 4

    model, _ = bench._build_model(dev, wl)
    labeler = bench._make_labeler(on_card, dev)
    _seq, frames = bench._frames(wl)
    frames = frames[:n_kf]
    cfg = bench._headline_cfg(on_card, wl)
    capacity = bench.HEADLINE_CAPACITY if on_card else 256
    rates = {}

    def report(tag, kf_per_s):
        rates[tag] = kf_per_s
        print(_line(tag, kf_per_s), flush=True)

    def run_pipe(pipe, tag):
        bench._warm(pipe, frames[:3], 1)
        best = 0.0
        for _ in range(3):
            pipe.reset()
            pipe.run(frames, gap=1, export=False)  # run() ends in a synchronise
            best = max(best, pipe.fps)
        report(tag, best)

    def fused(lab, chunk=1):
        return FusedDevicePipeline(cfg, CuTRDetector(model, device=dev), labeler=lab, capacity=capacity,
                                   device=dev, chunk=chunk)

    pipe = fused(labeler)

    # 1. host pack only
    for _ in range(2):
        t0 = time.perf_counter()
        for fr in frames:
            pack_fused_buffer(fr, 0, pipe.depth_mode, pipe.depth_scale)
        dt = time.perf_counter() - t0
    report("host pack only", n_kf / dt)

    # 2. the full loop (the bench figure)
    run_pipe(pipe, "full loop (bench gap1)")

    # 3. dispatch only: every frame pre-packed, each keyframe's upload and
    # launches driven directly on this thread (no pack)
    packed = [pack_fused_buffer(fr, i, pipe.depth_mode, pipe.depth_scale) for i, fr in enumerate(frames)]
    fr0 = frames[0]
    square, ratio = resolve_pad_and_ratio(fr0.image, fr0.depth, pipe.detector.buckets)
    shape_key = (*fr0.image.shape[:2], *fr0.depth.shape[:2], square, ratio)
    best = 0.0
    with torch.inference_mode():
        for _ in range(3):
            pipe.reset()
            sync(dev)
            t0 = time.perf_counter()
            for buf in packed:
                pipe._dispatch([(shape_key, buf)])
            pipe.flush()
            sync(dev)
            best = max(best, n_kf / (time.perf_counter() - t0))
    report("dispatch only (pre-packed)", best)

    # 4. no labeler
    run_pipe(fused(None), "full loop, no labeler")

    # 5. chunked throughput mode (one upload per 8 keyframes)
    run_pipe(fused(labeler, chunk=8), "full loop, chunk=8")
    return rates


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=None,
                    help="stream length; the first quarter are keyframes (default: the bench's)")
    a = ap.parse_args(argv)
    with torch.inference_mode():
        run(a.device, a.frames)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
