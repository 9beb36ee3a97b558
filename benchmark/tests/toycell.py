"""A toy cell for the CPU tests, written as new files into a directory of
its own: a configuration cut from ``ca1m-cutr768-vith14`` (CuTR-192, a
two-layer tower, a 128-particle search), a traffic mix of small scans, its
limits and one extra metric reader.  The harness finds them by name, next
to the benchmark's own folder, and no file of the benchmark is edited."""
from __future__ import annotations

import json
import os

import torch

from benchmark.harness import weights
from benchmark.harness.spec import BENCH_DIR, load_cell

TOY_METRIC = '''"""Keyframes of the unprofiled window (a toy reader)."""


def read(obs):
    return float(obs.unprofiled.keyframes)
'''

# set from the toy's readings on the CPU (PERF.md): the program (bfloat16)
# against the float32 reference over seeds 1-12, and the control over seeds
# 1-3 (test_bench_control.py)
TOY_LIMITS = dict(det_enc_logit=0.15, det_row=2.0, det_miss=0.15, label_sim=1.0, label_sim_mean=0.05,
                  step_mismatch=0.0, fusion_fit=0.5)


def write_toy(root: str, limits=None) -> str:
    """Write the toy layout under ``root``; returns its BENCHMARK.json."""
    for sub in ("configs", "traffic", "limits", "metrics"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    with open(os.path.join(BENCH_DIR, "configs", "ca1m-cutr768-vith14.json")) as f:
        config = json.load(f)
    config.update(name="toy", capacity=128)
    config["detector"].update(embed_dim=192)
    config["labeler"].update(arch="toy", patch=32, width=64, layers=2, heads=2, embed_dim=32, n_classes=8)
    s = config["settings"]
    s["box_fusion"].update(pst_size=128, iters=3, max_fusions_per_frame=4)
    s["association"].update(max_views=5, max_observations=1024)
    with open(os.path.join(BENCH_DIR, "traffic", "scan.cluttered.json")) as f:
        traffic = json.load(f)
    traffic.update(frame_hw=[192, 256], frames_per_scan=24, gap=3, scans=2, orbit_sweep_deg=40.0, live_target=30,
                   lift_keyframes=3, warmup_keyframes=2, profiled_keyframes=2, check_keyframes=2,
                   check_searches=2, check_label_keyframes=2)
    # the calibration the traffic file keeps for each configuration it serves
    traffic["class_bias_lift"] = {"toy": weights.fit_lift(config, traffic, torch.device("cpu"))[0]}
    files = {
        "configs/toy.json": config,
        "traffic/toy.json": traffic,
        "limits/toy.cell.json": {"limits": {k: {"limit": v} for k, v in (limits or TOY_LIMITS).items()}},
    }
    for rel, data in files.items():
        with open(os.path.join(root, rel), "w") as f:
            json.dump(data, f, indent=1)
    with open(os.path.join(root, "metrics", "toy_keyframes.py"), "w") as f:
        f.write(TOY_METRIC)
    with open(os.path.join(BENCH_DIR, os.pardir, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [dict(bench["configs"][0], name="toy", file="configs/toy.json")]
    bench["workloads"] = [dict(name="toy.cell", config="toy", traffic="toy", chips=1, why="toy")]
    bench["per_layer"] = bench["per_layer"] + [dict(name="toy_keyframes", unit="keyframes", better="higher",
                                                    source="program_counter", layer="engine loop",
                                                    moves="frames_per_s")]
    path = os.path.join(root, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(bench, f, indent=1)
    return path


def toy_cell(root: str, limits=None):
    return load_cell("toy.cell", bench_json=write_toy(root, limits), dirs=[root, BENCH_DIR])
