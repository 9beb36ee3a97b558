"""torch.profiler trace of the device keyframe step at the 100-detection load.

Port of ``tools/trace_stress.py``.  On a card: CuTR-768 in bfloat16 with
``device_output`` (random weights, seed 0), 200 frames at 512 px, gap 20; on
the CPU: CuTR-192 in float32 at 256 px, as the JAX tool chooses off the TPU.
Each keyframe's detections, all 100 rows (``score_thresh`` 0, no size cap),
are recorded once, then replayed through ``keyframe_step_devdet`` (the
device engine's step, with ``pack_meta``): one warm run, one traced run
inside an ``annotate`` span (SPAN).  Prints the top-30 aggregated durations.

    python -m boxfusion_tpu_torch.tools.trace_stress
    python -m boxfusion_tpu_torch.tools.trace_stress --device cpu --frames 3 --size 256
"""
from __future__ import annotations

import argparse
import shutil

import torch

from boxfusion_tpu_torch.tools.common import keyframes, sync, tool_config
from boxfusion_tpu_torch.utils.device import resolve_device
from boxfusion_tpu_torch.utils.profiling import aggregate, annotate, default_trace_dir, format_rows, load_trace, trace

SPAN = "stress_loop"
DET_KEYS = ("scores", "pred_boxes", "boxes3d", "R", "proj_xy")


def record_detections(device, kf, dim: int):
    """CuTR (``dim``, bfloat16 on a card, float32 on the CPU) on every
    keyframe, its outputs left on the device."""
    from boxfusion_tpu_torch.models.cutr import make_cutr
    from boxfusion_tpu_torch.runtime.detector import CuTRDetector

    dtype = "bfloat16" if device.type == "cuda" else "float32"
    model = make_cutr(dim, depth_model=True, device=device, dtype=dtype)
    detector = CuTRDetector(model, device=device, device_output=True)
    dets = [{k: v for k, v in detector(fr).items() if k in DET_KEYS} for fr in kf]
    sync(device)
    return dets


def replay(pipe, kf, dets, kmax: int) -> None:
    """The recorded detections through the device engine's step."""
    from boxfusion_tpu_torch.runtime import device_step
    from boxfusion_tpu_torch.runtime.device_pipeline import pack_meta

    for frame, det in zip(kf, dets):
        meta = pack_meta(frame, int(frame.timestamp))
        pipe._run_step(device_step.keyframe_step_devdet, dict(det), meta, pipe.pst, pipe.step_cfg, kmax)
    pipe.flush()
    sync(pipe.device)


def run(device=None, out=None, n_frames=200, size=None, dim=None, gap=20, capacity=512, top=30,
        verbose=True, before_trace=None) -> dict:
    """Record, warm, then the traced replay; returns the trace's path, its
    events, the aggregated rows and the number of keyframes.
    ``before_trace()`` is called just before the traced run."""
    from boxfusion_tpu_torch.runtime.device_pipeline import DevicePipeline

    dev = resolve_device(device)
    card = dev.type == "cuda"
    size = (512 if card else 256) if size is None else size
    dim = (768 if card else 192) if dim is None else dim
    out = default_trace_dir("stress_trace") if out is None else out
    shutil.rmtree(out, ignore_errors=True)
    _, _, kf = keyframes(n_frames, size, gap)
    dets = record_detections(dev, kf, dim)
    cfg = tool_config(gap, stress=True)
    kmax = int(cfg["detection"]["max_detections"])

    def pipeline():
        return DevicePipeline(cfg, lambda fr: None, capacity=capacity, device=dev)

    replay(pipeline(), kf, dets, kmax)  # warm
    pipe = pipeline()
    if before_trace is not None:  # e.g. zero the kernels' launch counts
        before_trace()
    with trace(out, dev) as path:
        with annotate(SPAN):
            replay(pipe, kf, dets, kmax)
    events = load_trace(path)
    rows = aggregate(events, on_device=card)
    if verbose:
        print(format_rows(rows, top, count_width=6))
    return dict(path=path, events=events, rows=rows, keyframes=len(kf))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--size", type=int, default=None, help="default 512 on a card, 256 on the CPU")
    ap.add_argument("--dim", type=int, default=None, help="default 768 on a card, 192 on the CPU")
    ap.add_argument("--gap", type=int, default=20)
    ap.add_argument("--top", type=int, default=30)
    a = ap.parse_args(argv)
    with torch.inference_mode():
        run(a.device, a.out, a.frames, a.size, a.dim, a.gap, top=a.top)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
