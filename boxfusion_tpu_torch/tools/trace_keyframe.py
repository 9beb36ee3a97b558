"""torch.profiler trace of device-engine keyframe steps; summarise op times.

Port of ``tools/trace_keyframe.py``: ``DevicePipeline`` fed by the oracle
(noise 0.03), 200 frames at 512 px, gap 20, capacity 256.  One warm run, then
one traced run inside an ``annotate`` span (SPAN) that ends after the card
has synchronised; prints the top-40 aggregated event durations -- the card's
kernels, copies and fills on a card, the CPU ops on the CPU.

    python -m boxfusion_tpu_torch.tools.trace_keyframe            # the card
    python -m boxfusion_tpu_torch.tools.trace_keyframe --device cpu --frames 3

``--out`` (default kf_trace under the temporary directory) is cleared first
and receives ``trace.json`` (Chrome trace format).
"""
from __future__ import annotations

import argparse
import shutil

import torch

from boxfusion_tpu_torch.tools.common import keyframes, sync, tool_config
from boxfusion_tpu_torch.utils.device import resolve_device
from boxfusion_tpu_torch.utils.profiling import aggregate, annotate, default_trace_dir, format_rows, load_trace, trace

SPAN = "keyframe_loop"


def run(device=None, out=None, n_frames=200, size=512, gap=20, capacity=256, top=40,
        verbose=True, before_trace=None) -> dict:
    """Warm run, then the traced run; returns the trace's path, its events,
    the aggregated rows and the number of keyframes.  ``before_trace()`` is
    called just before the traced run."""
    from boxfusion_tpu_torch.data.synthetic import OracleDetector
    from boxfusion_tpu_torch.runtime.device_pipeline import DevicePipeline

    dev = resolve_device(device)
    out = default_trace_dir("kf_trace") if out is None else out
    shutil.rmtree(out, ignore_errors=True)
    seq, _, kf = keyframes(n_frames, size, gap)
    oracle = OracleDetector(seq, noise=0.03, seed=1)
    cfg = tool_config(gap)

    pipe = DevicePipeline(cfg, oracle, capacity=capacity, device=dev)
    for frame in kf:
        pipe.process_keyframe(frame)
    pipe.flush()
    sync(dev)

    p2 = DevicePipeline(cfg, oracle, capacity=capacity, device=dev)
    if before_trace is not None:  # e.g. zero the kernels' launch counts
        before_trace()
    with trace(out, dev) as path:
        with annotate(SPAN):
            for frame in kf:
                p2.process_keyframe(frame)
            p2.flush()
            sync(dev)
    events = load_trace(path)
    rows = aggregate(events, on_device=dev.type == "cuda")
    if verbose:
        print(format_rows(rows, top))
    return dict(path=path, events=events, rows=rows, keyframes=len(kf))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--gap", type=int, default=20)
    ap.add_argument("--capacity", type=int, default=256)
    ap.add_argument("--top", type=int, default=40)
    a = ap.parse_args(argv)
    with torch.inference_mode():
        run(a.device, a.out, a.frames, a.size, a.gap, a.capacity, a.top)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
