"""Label bucketing A/B, stage decomposition and detector ablations.

Port of ``tools/profile_r5.py``, at the bench's workload
(``boxfusion_tpu_torch/bench.py``; its CPU sizes with ``--device cpu``).
Every timed window ends in a synchronise.  Sections (the first argument,
default ``gap1``):

  gap1   -- the live-SLAM A/B: the fused keyframe path at gap 1 over the
            first quarter of the stream, label buckets ON (the default)
            against the fixed 128-crop pad, and fusion-off / labeler-off
            ablations; then the gap-20 headline with buckets.
  stages -- the bench's ``phase_stages``: the CLIP tower at each bucket,
            crop + resize, the association step with fusion on and off.
  det    -- the detector: the full CuTR forward against 1 decoder layer and
            100 queries (random weights, seed 0), each with its ms, GFLOP
            (``bench._flops``) and TFLOP/s; the two deltas.

    python -m boxfusion_tpu_torch.tools.profile_r5 [gap1|stages|det]
    python -m boxfusion_tpu_torch.tools.profile_r5 gap1 --device cpu --frames 12
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

from boxfusion_tpu_torch import bench
from boxfusion_tpu_torch.tools.common import sync
from boxfusion_tpu_torch.utils.device import resolve_device


def _timed_pipe_run(pipe, frames, gap: int, n_runs: int = 2) -> float:
    """Frames/s: the best of ``n_runs`` runs from a fresh state."""
    return max(bench._timed_run(pipe, frames, gap) for _ in range(n_runs))


def section_gap1(dev, wl) -> dict:
    from boxfusion_tpu_torch.runtime.detector import CuTRDetector
    from boxfusion_tpu_torch.runtime.fused import FusedDevicePipeline

    on_card = dev.type == "cuda"
    model, _ = bench._build_model(dev, wl)
    labeler = bench._make_labeler(on_card, dev)
    _seq, frames = bench._frames(wl)
    kf = frames[: wl["n_frames"] // 4]
    capacity = bench.HEADLINE_CAPACITY if on_card else 256

    def pipeline(lab, bucketing=True, fusion=True):
        cfg = bench._headline_cfg(on_card, wl)
        cfg["detection"]._data["label_bucketing"] = bucketing
        cfg["box_fusion"]._data["use"] = fusion
        return FusedDevicePipeline(cfg, CuTRDetector(model, device=dev), labeler=lab, capacity=capacity,
                                   device=dev)

    variants = [
        ("bucketed (default)", dict(bucketing=True), labeler),
        ("fixed 128-crop pad", dict(bucketing=False), labeler),
        ("bucketed, fusion off", dict(bucketing=True, fusion=False), labeler),
        ("no labeler", dict(bucketing=True), None),
    ]
    rates = {}
    for tag, kw, lab in variants:
        pipe = pipeline(lab, **kw)
        bench._warm(pipe, kf[:3], 1)
        rates[tag] = kfs = _timed_pipe_run(pipe, kf, 1)
        print(f"gap1 {tag:24s} {kfs:7.2f} keyframes/s  ({1e3 / kfs:7.1f} ms/kf)", flush=True)

    # the headline check at gap 20 with buckets
    gap = wl["gap"]
    pipe = pipeline(labeler)
    bench._warm(pipe, frames[: 2 * gap + 1], gap)
    rates["gap20"] = fps = _timed_pipe_run(pipe, frames, gap)
    print(f"gap20 headline (bucketed)    {fps:7.2f} FPS", flush=True)
    return rates


def section_stages(dev, wl) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "stages.json")
        bench.phase_stages(path, 600.0, dev, wl)
        with open(path) as f:
            res = json.load(f)
    print(json.dumps(res, indent=1))
    return res


def section_det(dev, wl) -> dict:
    from boxfusion_tpu_torch.models.cutr import make_cutr

    on_card = dev.type == "cuda"
    batch = bench._bench_batch(dev, wl)
    reps = 30 if on_card else 3

    def timed_fwd(tag, **cfg_kw):
        model = make_cutr(wl["dim"], depth_model=True, device=dev, seed=0,
                          dtype="bfloat16" if on_card else "float32", **cfg_kw)
        chained = bench._chained_forward(model, batch)
        eps = chained(torch.zeros((), device=dev))
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            eps = chained(eps)
        sync(dev)
        ms = (time.perf_counter() - t0) / reps * 1e3
        fl = bench._flops(chained, torch.zeros((), device=dev))
        print(f"det {tag:28s} {ms:7.2f} ms   {fl / 1e9:7.1f} GFLOP   {fl / (ms * 1e-3) / 1e12:6.1f} TF/s",
              flush=True)
        return ms, fl

    res = {
        "full": timed_fwd("full (6 dec layers, 300q)"),
        "1_decoder_layer": timed_fwd("1 decoder layer", num_decoder_layers=1),
        "100_queries": timed_fwd("100 queries", num_queries=100),
    }
    full = res["full"][0]
    print(f"det decoder 5-layer delta: {full - res['1_decoder_layer'][0]:.2f} ms; "
          f"queries300->100 delta: {full - res['100_queries'][0]:.2f} ms", flush=True)
    return res


SECTIONS = {"gap1": section_gap1, "stages": section_stages, "det": section_det}


def run(section="gap1", device=None, n_frames=None) -> dict:
    dev = resolve_device(device)
    wl = bench._workload(dev.type == "cuda")
    if n_frames is not None:
        wl["n_frames"] = n_frames
    with torch.inference_mode():
        return SECTIONS[section](dev, wl)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("section", nargs="?", default="gap1", choices=sorted(SECTIONS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=None, help="stream length (default: the bench's)")
    a = ap.parse_args(argv)
    run(a.section, a.device, a.frames)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
