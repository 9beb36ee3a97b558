"""What a run reads from ``BENCHMARK.json`` and the files it names.

A cell names a configuration and a traffic mix.  The configuration's file
is the one ``BENCHMARK.json`` gives; the traffic mix is
``traffic/<traffic>.json``, the cell's correctness limits
``limits/<workload>.json``, each per-layer metric's reader
``metrics/<name>.py`` and the family of each of the configuration's two
models ``families/<family>.py``, looked up in the benchmark's folders in
order, so that a later cell, metric or architecture is a new file and no
file is edited.

A configuration's ``detector`` and ``labeler`` sections each name their
``family``.  Of a section the harness itself reads only ``family`` and
``dtype``, and of the labeler's also ``embed_dim`` (the width of the
features scored against the classes), ``n_classes`` and ``sim_thres``;
every other key is its family's.  A family module gives, from its section:

* ``program(section, device)``: the port's module on ``device``, computing
  in the section's ``dtype``, in eval mode;
* ``reference(section, dtype, device)``: the plain reference's module
  (``benchmark/reference/models/``) computing in ``dtype``; ``meta`` gives
  names and shapes;
* ``flops``: a detector's ``flops(section, pad, depth_ratio)`` of one
  keyframe, a labeler's ``flops(section, crops)`` of one tower call;
* a detector's ``table(reference, lift)`` and ``detector(section, model,
  device)``, the port's detector object around the model;
* a labeler's ``table(reference)``, ``labeler(section, tower,
  text_features, device)``, the port's labeler object around the tower;
  ``crops(section, image, boxes, dtype)``, the reference's crops of
  ``boxes`` as the tower takes them; ``attention_shapes(section)``, the
  ``(tokens, head_width)`` pairs of the tower's attention kernel; and
  ``ATTENTION_SITES``, the ``module.attribute`` names through which the
  port's tower calls that kernel.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from types import ModuleType
from typing import Callable, Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Families:
    detector: ModuleType
    labeler: ModuleType


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, Callable]
    families: Families


def _find(dirs: List[str], *parts: str) -> str:
    for d in dirs:
        path = os.path.join(d, *parts)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"{os.path.join(*parts)} in none of {dirs}")


def _module(path: str, prefix: str) -> ModuleType:
    name = prefix + os.path.splitext(os.path.basename(path))[0].replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_families(config: dict, dirs: List[str] = (BENCH_DIR,)) -> Families:
    """The family module that each model section of ``config`` names."""
    dirs = list(dirs)
    found = {}
    for role in ("detector", "labeler"):
        name = config.get(role, {}).get("family")
        if not name:
            raise LookupError(f"configuration {config.get('name')!r}: its {role} names no family "
                              f"(a \"family\" key, found as families/<name>.py in {dirs})")
        try:
            path = _find(dirs, "families", name + ".py")
        except FileNotFoundError:
            raise LookupError(f"configuration {config.get('name')!r}: {role} family {name!r} not found: "
                              f"families/{name}.py in none of {dirs}") from None
        found[role] = _module(path, "bench_family_")
    return Families(**found)


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
    families = load_families(config, dirs)
    with open(_find(dirs, "traffic", workload["traffic"] + ".json")) as f:
        traffic = json.load(f)
    with open(_find(dirs, "limits", name + ".json")) as f:
        limits = {k: float(v["limit"]) for k, v in json.load(f)["limits"].items()}

    def applies(metric):
        return name in metric.get("workloads", [name])

    end_to_end = [m for m in bench["end_to_end"] if applies(m)]
    per_layer = [m for m in bench["per_layer"] if applies(m)]
    readers = {m["name"]: _module(_find(dirs, "metrics", m["name"] + ".py"), "bench_metric_").read
               for m in per_layer}
    return Cell(workload=workload, config=config, traffic=traffic, limits=limits,
                end_to_end=end_to_end, per_layer=per_layer, readers=readers, families=families)
