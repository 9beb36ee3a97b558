"""Reading a ``torch.profiler`` trace of the profiled keyframes.

A frozen copy of the arithmetic of ``utils/profiling.py`` (``device_activity``:
the union of the device's intervals inside a span; ``device_ms_by_span``:
device time charged to the host span whose code launched it, by correlation
id), kept here so that the yardstick does not move when the program's
tracing does.  The trace is the Chrome-format export of the profiler, read
back as a list of complete ("X") events.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


def load(path: str) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    events = data.get("traceEvents", data) if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X"]


def span(events: Sequence[dict], name: str) -> Tuple[float, float]:
    """(start, end) in microseconds of the one user span ``name``."""
    found = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == name]
    if len(found) != 1:
        raise ValueError(f"trace has {len(found)} '{name}' spans, not one")
    start = float(found[0]["ts"])
    return start, start + float(found[0]["dur"])


def _merge(intervals):
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def device_events(events: Sequence[dict]) -> List[dict]:
    return [e for e in events if e.get("cat") in DEVICE_CATEGORIES]


def activity(events: Sequence[dict], lo: float, hi: float, n_gaps: int = 10) -> dict:
    """Busy seconds of the device inside [lo, hi] (the union of its
    intervals clipped to it) and the ``n_gaps`` longest idle gaps, each
    named by the host op that overlaps it most (the spans that hold the
    whole window excepted)."""
    device = [(max(float(e["ts"]), lo), min(float(e["ts"]) + float(e.get("dur", 0.0)), hi))
              for e in device_events(events)]
    busy = _merge([(a, b) for a, b in device if b > a])
    busy_us = sum(b - a for a, b in busy)
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    host = [e for e in events if e.get("cat") in HOST_CATEGORIES
            and not (float(e["ts"]) <= lo and float(e["ts"]) + float(e.get("dur", 0.0)) >= hi)]
    host.sort(key=lambda e: float(e["ts"]))
    starts = [float(e["ts"]) for e in host]
    gaps = []
    for a, b in sorted(idle, key=lambda g: g[0] - g[1])[:n_gaps]:
        best, best_key = "idle", (0.0, 0.0)
        for e in host[:bisect.bisect_right(starts, b)]:
            s, t = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
            overlap = min(t, b) - max(s, a)
            key = (overlap, -(t - s))
            if overlap > 0 and key > best_key:
                best, best_key = e["name"], key
        gaps.append((best, (b - a) / 1e6))
    return dict(busy_s=busy_us / 1e6, window_s=(hi - lo) / 1e6, gaps=gaps)


def device_s_by_span(events: Sequence[dict], names: Sequence[str]) -> Dict[str, float]:
    """Device seconds charged to the user span among ``names`` in which the
    launching host call started; "other" when none holds it."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                   for e in events if e.get("cat") == "user_annotation" and e.get("name") in names)
    starts = [a for a, _, _ in spans]
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in LAUNCH_CATEGORIES and "correlation" in e.get("args", {})}
    out = dict.fromkeys((*names, "other"), 0.0)
    for e in device_events(events):
        owner, ts = "other", launched.get(e.get("args", {}).get("correlation"))
        if ts is not None:
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and ts <= spans[i][1]:
                owner = spans[i][2]
        out[owner] += float(e.get("dur", 0.0)) / 1e6
    return out


def top_ops(events: Sequence[dict], n: int = 10) -> List[Tuple[str, float]]:
    """The device operations that took the most time, in seconds."""
    total: Dict[str, float] = defaultdict(float)
    for e in device_events(events):
        total[e["name"]] += float(e.get("dur", 0.0)) / 1e6
    return sorted(total.items(), key=lambda kv: -kv[1])[:n]


def kernel_seconds(events: Sequence[dict], name_part: str) -> Tuple[float, int]:
    """(seconds, count) of the kernel events whose name contains ``name_part``."""
    hits = [e for e in events if e.get("cat") == "kernel" and name_part in e.get("name", "")]
    return sum(float(e.get("dur", 0.0)) for e in hits) / 1e6, len(hits)
