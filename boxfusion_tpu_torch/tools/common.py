"""What the ported tracers and profilers share: the synthetic keyframes, the
configurations of the JAX tools, and synchronised timing on the card."""
from __future__ import annotations

import os
import time
from typing import Callable, List, Tuple

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def sync(device: torch.device) -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_ms(fn: Callable, device: torch.device, reps: int = 10) -> float:
    """Mean wall-clock ms of ``fn()`` over ``reps`` calls after one warm
    call, the card synchronised before the clock starts and after the last
    call."""
    fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(device)
    return (time.perf_counter() - t0) / reps * 1e3


def keyframes(n_frames: int, size: int, gap: int, n_boxes: int = 8) -> Tuple[object, list, List]:
    """The JAX tools' sequence: ``n_frames`` synthetic frames at
    (0.75 size, size), seed 0; returns (sequence, frames, every gap-th frame)."""
    from boxfusion_tpu_torch.data.synthetic import SyntheticSequence

    seq = SyntheticSequence(n_frames=n_frames, n_boxes=n_boxes, image_hw=(int(0.75 * size), size), seed=0)
    frames = list(seq)
    return seq, frames, [fr for i, fr in enumerate(frames) if i % gap == 0]


def tool_config(gap: int, stress: bool = False):
    """config/ca1m.yaml as the JAX tools set it: the oracle load (score
    filter 0.3), or the stress load (``stress``: filter 0 and no size cap,
    so all 100 top-k rows of CuTR enter association and fusion)."""
    from boxfusion_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(REPO, "config/ca1m.yaml"))
    cfg["data"]._data["gap"] = gap
    cfg["detection"]._data["score_thresh"] = 0.0 if stress else 0.3
    cfg["detection"]._data["uv_bound"] = False
    cfg["detection"]._data["floor_mask"] = False
    if stress:
        cfg["detection"]._data["size_max_thres"] = None
    cfg["box_fusion"]._data["pst_path"] = None
    return cfg
