"""What a run reads from ``BENCHMARK.json`` and the files it names.

A cell names a configuration and a traffic mix.  The configuration's file
is the one ``BENCHMARK.json`` gives; the traffic mix is
``traffic/<traffic>.json``, the cell's correctness limits
``limits/<workload>.json`` and each per-layer metric's reader
``metrics/<name>.py``, looked up in the benchmark's folders in order, so
that a later cell or metric is a new file and no file is edited.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, Callable]


def _find(dirs: List[str], *parts: str) -> str:
    for d in dirs:
        path = os.path.join(d, *parts)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"{os.path.join(*parts)} in none of {dirs}")


def _reader(path: str) -> Callable:
    name = "bench_metric_" + os.path.splitext(os.path.basename(path))[0].replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_cell(name: str, bench_json: str = os.path.join(REPO, "BENCHMARK.json"),
              dirs: List[str] = (BENCH_DIR,)) -> Cell:
    dirs = list(dirs)
    with open(bench_json) as f:
        bench = json.load(f)
    workload = next((w for w in bench["workloads"] if w["name"] == name), None)
    if workload is None:
        raise KeyError(f"no workload {name!r} in {bench_json}")
    entry = next(c for c in bench["configs"] if c["name"] == workload["config"])
    with open(os.path.join(os.path.dirname(os.path.abspath(bench_json)), entry["file"])) as f:
        config = json.load(f)
    with open(_find(dirs, "traffic", workload["traffic"] + ".json")) as f:
        traffic = json.load(f)
    with open(_find(dirs, "limits", name + ".json")) as f:
        limits = {k: float(v["limit"]) for k, v in json.load(f)["limits"].items()}

    def applies(metric):
        return name in metric.get("workloads", [name])

    end_to_end = [m for m in bench["end_to_end"] if applies(m)]
    per_layer = [m for m in bench["per_layer"] if applies(m)]
    readers = {m["name"]: _reader(_find(dirs, "metrics", m["name"] + ".py")) for m in per_layer}
    return Cell(workload=workload, config=config, traffic=traffic, limits=limits,
                end_to_end=end_to_end, per_layer=per_layer, readers=readers)
