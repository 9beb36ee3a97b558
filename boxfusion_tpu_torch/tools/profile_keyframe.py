"""Per-stage wall clock of the device keyframe step at bench scale.

Port of ``tools/profile_keyframe.py``: ``DevicePipeline`` fed by the oracle
(noise 0.03), 200 frames at 512 px, gap 20, capacity 256, under five
configurations (full; fusion off; 256 particles; 5 iterations; one fusion
per frame).  Each is warmed once, then run three times from a fresh
pipeline; the card is synchronised (``torch.cuda.synchronize``) before the
clock stops, and the median is printed as ms per keyframe.

    python -m boxfusion_tpu_torch.tools.profile_keyframe
    python -m boxfusion_tpu_torch.tools.profile_keyframe --device cpu --frames 41 --reps 1
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from boxfusion_tpu_torch.tools.common import keyframes, sync, tool_config
from boxfusion_tpu_torch.utils.device import resolve_device

CONFIGS = (
    ("full (fusion on, 1024 particles)", {}),
    ("fusion off", {"box_fusion.use": False}),
    ("fusion 256 particles", {"box_fusion.pst_size": 256}),
    ("fusion iters=5", {"box_fusion.iters": 5}),
    ("max_fusions=1", {"box_fusion.max_fusions_per_frame": 1}),
)


def run_config(device, seq, kf, over: dict, reps: int = 3, capacity: int = 256, gap: int = 20) -> float:
    """Median ms per keyframe of ``reps`` synchronised runs under ``over``."""
    from boxfusion_tpu_torch.data.synthetic import OracleDetector
    from boxfusion_tpu_torch.runtime.device_pipeline import DevicePipeline

    cfg = tool_config(gap)
    for k, v in over.items():
        sec, key = k.split(".")
        cfg[sec]._data[key] = v
    oracle = OracleDetector(seq, noise=0.03, seed=1)

    def once() -> float:
        pipe = DevicePipeline(cfg, oracle, capacity=capacity, device=device)
        t0 = time.perf_counter()
        for frame in kf:
            pipe.process_keyframe(frame)
        pipe.flush()
        sync(device)
        return time.perf_counter() - t0

    once()  # warm
    return float(np.median([once() for _ in range(reps)])) / len(kf) * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--gap", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    seq, _, kf = keyframes(a.frames, a.size, a.gap)
    with torch.inference_mode():
        for tag, over in CONFIGS:
            ms = run_config(dev, seq, kf, over, reps=a.reps, gap=a.gap)
            print(f"{tag:<40} {ms:7.2f} ms/keyframe")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
