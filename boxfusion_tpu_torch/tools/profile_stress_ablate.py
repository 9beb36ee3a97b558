"""Ablate the device keyframe step at the 100-detection stress load.

Port of ``tools/profile_stress_ablate.py``.  CuTR's detections (768 in
bfloat16 at 512 px on a card, 192 in float32 at 256 px on the CPU; random
weights, seed 0; all 100 top-k rows: ``score_thresh`` 0, no size cap) are
recorded once, then replayed through the device engine's step
(``trace_stress.replay``: ``pack_meta`` + ``keyframe_step_devdet``) with parts
of the step turned off, to attribute its time:

  full            the whole step (fusion, correspondence, suppression)
  fusion_off      ``box_fusion.use`` off
  nms_only        fusion off, ``association.small_threshold`` -1 (the
                  small-object correspondence never fires)
  no_suppression  fusion off, ``box_fusion.nms_threshold`` 2.0 (nothing is
                  suppressed: append and the IoU lattice only)

For each: ms a keyframe (the median of ``reps`` replays after one warm
replay, the card synchronised at the end of each), the final world count and
``pst_search``'s launches over the last replay (on the CPU the search runs
its plain version and launches nothing).

    python -m boxfusion_tpu_torch.tools.profile_stress_ablate
    python -m boxfusion_tpu_torch.tools.profile_stress_ablate --device cpu --frames 41 --gap 10 --reps 1
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from boxfusion_tpu_torch.tools.common import keyframes, tool_config
from boxfusion_tpu_torch.tools.trace_stress import record_detections, replay
from boxfusion_tpu_torch.utils.device import resolve_device

CAPACITY = 512  # world slots, the JAX tool's
# (name, the JAX tool's label, config overrides as "section.key": value)
VARIANTS = (
    ("full", "full step (fusion+corr+nms)", {}),
    ("fusion_off", "fusion OFF", {"box_fusion.use": False}),
    ("nms_only", "fusion+corr OFF (nms only)",
     {"association.small_threshold": -1.0, "box_fusion.use": False}),
    ("no_suppression", "no suppression (append+iou only)",
     {"box_fusion.nms_threshold": 2.0, "box_fusion.use": False}),
)


def variant_config(gap: int, overrides: dict):
    """``tool_config(gap, stress=True)`` (the JAX tool's ``base_cfg``) with
    one variant's overrides."""
    cfg = tool_config(gap, stress=True)
    for key, value in overrides.items():
        section, name = key.split(".")
        cfg[section]._data[name] = value
    return cfg


def run(device=None, n_frames=200, size=None, dim=None, gap=20, reps=3, dets=None,
        variants=VARIANTS, worlds=None, verbose=True) -> dict:
    """Returns ``{variant: (ms per keyframe, final world count, pst_search
    launches)}``.  ``dets``: the keyframes' detections to replay (numpy or
    tensors, one dict per keyframe, in the order of ``keyframes(n_frames,
    size, gap)``); recorded from CuTR when None.  ``worlds``: when a dict,
    each variant's exported world after its last replay is stored under its
    name."""
    from boxfusion_tpu_torch.ops.pst_search import pst_search
    from boxfusion_tpu_torch.runtime.device_pipeline import DevicePipeline
    from boxfusion_tpu_torch.runtime.device_state import export_world

    dev = resolve_device(device)
    card = dev.type == "cuda"
    size = (512 if card else 256) if size is None else size
    dim = (768 if card else 192) if dim is None else dim
    _, _, kf = keyframes(n_frames, size, gap)
    if dets is None:
        dets = record_detections(dev, kf, dim)
    else:
        dets = [{k: torch.as_tensor(v, device=dev) for k, v in det.items()} for det in dets]
    if len(dets) != len(kf):
        raise ValueError(f"{len(dets)} detection dicts for {len(kf)} keyframes")
    out = {}
    for name, label, overrides in variants:
        cfg = variant_config(gap, overrides)
        kmax = int(cfg["detection"]["max_detections"])

        def once():
            pipe = DevicePipeline(cfg, lambda fr: None, capacity=CAPACITY, device=dev)
            launches0 = pst_search.launches
            t0 = time.perf_counter()
            replay(pipe, kf, dets, kmax)
            return time.perf_counter() - t0, pipe, pst_search.launches - launches0

        once()  # warm
        runs = [once() for _ in range(reps)]
        dt = float(np.median([t for t, _, _ in runs]))
        _, pipe, launches = runs[-1]
        n_final = int(pipe.state.n)
        out[name] = (dt / len(kf) * 1000, n_final, launches)
        if worlds is not None:
            worlds[name] = export_world(pipe.state)
        if verbose:
            print(f"{label:<38} {out[name][0]:7.2f} ms/kf   (final n={n_final}, "
                  f"pst_search launches={launches})", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--size", type=int, default=None, help="default 512 on a card, 256 on the CPU")
    ap.add_argument("--dim", type=int, default=None, help="default 768 on a card, 192 on the CPU")
    ap.add_argument("--gap", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args(argv)
    with torch.inference_mode():
        run(a.device, a.frames, a.size, a.dim, a.gap, a.reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
