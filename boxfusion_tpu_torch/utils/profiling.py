"""Tracing / profiling utilities (torch).

Port of ``boxfusion_tpu/utils/profiling.py``:

  * ``StageTimer``: cheap named wall-clock accumulators (a copy of JAX's);
  * ``trace()``: a context manager around ``torch.profiler`` -- CPU activity
    always, CUDA activity when the device is a card -- that writes a Chrome
    trace (``trace.json``) under its directory;
  * ``annotate()``: ``torch.profiler.record_function``, so host stages show
    up as spans in that trace.

And what reads such a trace, shared by the tracers
(``boxfusion_tpu_torch/tools/trace_*.py``) and ``chip_smoke.py``:

  * ``load_trace`` / ``aggregate``: complete events summed by name -- the
    device's (kernel, memcpy and memset categories) on a card, CPU ops on
    the CPU;
  * ``device_activity``: within one ``annotate`` span, the share of the
    span in which the device ran something (the union of its kernel, memcpy
    and memset intervals) and the longest idle gaps, each with the host op
    that was running through it;
  * ``device_ms_by_span``: the device's milliseconds by the ``annotate``
    span whose host code launched them.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from boxfusion_tpu_torch.utils.device import DeviceLike, resolve_device

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")  # the host calls that enqueue device work


class StageTimer:
    """Accumulating named timers: `with timer("detect"): ...`."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: dict(
                total_s=round(self.totals[k], 4),
                calls=self.counts[k],
                mean_ms=round(1000 * self.totals[k] / max(self.counts[k], 1), 2),
            )
            for k in sorted(self.totals)
        }

    def report(self) -> str:
        rows = [
            f"  {k:<24} {v['total_s']:>8.3f}s  x{v['calls']:<5} "
            f"{v['mean_ms']:>8.2f} ms/call"
            for k, v in self.summary().items()
        ]
        return "stage timings:\n" + "\n".join(rows)


def default_trace_dir(name: str = "boxfusion_trace") -> str:
    """``name`` under the temporary directory ($TMPDIR, else /tmp)."""
    return os.path.join(tempfile.gettempdir(), name)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, device: DeviceLike = None) -> Iterator[str]:
    """Profile the block with ``torch.profiler`` and write a Chrome trace.

    CPU activity is always recorded; CUDA activity too when ``device``
    (default "cuda"; raises if there is none) is a card, which is
    synchronised before the profiler stops.  Yields the path of the trace
    file, ``<log_dir>/trace.json``, written when the block exits, also when
    it raises (the exception then propagates), as JAX's ``trace`` stops its
    profiler in a ``finally``.
    """
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    log_dir = default_trace_dir() if log_dir is None else log_dir
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        with prof:
            try:
                yield path
            finally:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
    finally:
        prof.export_chrome_trace(path)


def annotate(name: str):
    """Host-side span that appears in the trace timeline."""
    return torch.profiler.record_function(name)


def load_trace(path: str) -> List[dict]:
    """The complete ("X") events of a Chrome trace file."""
    with open(path) as f:
        data = json.load(f)
    events = data.get("traceEvents", data) if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X"]


def aggregate(events: Sequence[dict], on_device: bool) -> List[Tuple[str, float, int]]:
    """(name, total ms, count) per event name, longest total first: the
    device's events (``DEVICE_CATEGORIES``) when ``on_device``, else the CPU
    ops."""
    cats = DEVICE_CATEGORIES if on_device else ("cpu_op",)
    total: Dict[str, float] = defaultdict(float)
    count: Dict[str, int] = defaultdict(int)
    for e in events:
        if e.get("cat") in cats:
            total[e["name"]] += float(e.get("dur", 0.0)) / 1e3
            count[e["name"]] += 1
    return sorted(((n, total[n], count[n]) for n in total), key=lambda r: -r[1])


def format_rows(rows: Sequence[Tuple[str, float, int]], top: int, count_width: int = 5) -> str:
    """The JAX tracers' table: total ms, count, name (110 characters)."""
    return "\n".join(f"{ms:9.2f} ms  x{n:<{count_width}} {name[:110]}" for name, ms, n in rows[:top])


def _span(events: Sequence[dict], name: str) -> Tuple[float, float]:
    spans = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == name]
    if len(spans) != 1:
        raise ValueError(f"trace has {len(spans)} '{name}' spans, not one")
    start = float(spans[0]["ts"])
    return start, start + float(spans[0]["dur"])


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def device_activity(events: Sequence[dict], span: str, n_gaps: int = 5) -> dict:
    """How busy the device was inside the ``annotate(span)`` span.

    Returns span_ms, busy_ms and busy_share (the union of the device's
    kernel, memcpy and memset intervals, clipped to the span, over the
    span), n_device_events, and ``gaps``: the ``n_gaps`` longest idle
    intervals (including the span's head and tail), each with its start
    (ms after the span's start), its length and the host op that overlaps
    it the most (the innermost among equals; "" when none).

    The span is stamped on the host's clock and the device's events on the
    card's, which the profiler maps onto one time base only to within about
    a millisecond or more: device work issued at the span's very end can
    land past it.  So ``n_outside`` counts the device events that start
    outside the span, and ``device_end_ms`` is where the last device event
    ends (ms after the span's start; beyond ``span_ms`` when it overran)."""
    lo, hi = _span(events, span)
    raw = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
           for e in events if e.get("cat") in DEVICE_CATEGORIES]
    device = [(max(a, lo), min(b, hi)) for a, b in raw]
    device = [(a, b) for a, b in device if b > a]
    busy = _merge(device)
    busy_us = sum(b - a for a, b in busy)
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    host = [e for e in events if e.get("cat") in HOST_CATEGORIES and e.get("name") != span]
    gaps = []
    for a, b in sorted(idle, key=lambda g: g[0] - g[1])[:n_gaps]:
        best, best_key = "", (0.0, 0.0)
        for e in host:
            s, t = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
            overlap = min(t, b) - max(s, a)
            key = (overlap, -(t - s))
            if overlap > 0 and key > best_key:
                best, best_key = e["name"], key
        gaps.append(dict(start_ms=(a - lo) / 1e3, ms=(b - a) / 1e3, host_op=best))
    return dict(span_ms=(hi - lo) / 1e3, busy_ms=busy_us / 1e3,
                busy_share=busy_us / (hi - lo) if hi > lo else 0.0,
                n_device_events=len(device), gaps=gaps,
                n_outside=sum(1 for a, _ in raw if not lo <= a <= hi),
                device_end_ms=(max(b for _, b in raw) - lo) / 1e3 if raw else 0.0)


def count_events(events: Sequence[dict], name_part: str, span: Optional[str] = None) -> int:
    """Device events whose name contains ``name_part`` (starting inside the
    span ``span`` when given; see ``device_activity`` on the two clocks)."""
    lo, hi = _span(events, span) if span is not None else (float("-inf"), float("inf"))
    return sum(1 for e in events if e.get("cat") in DEVICE_CATEGORIES and name_part in e.get("name", "")
               and lo <= float(e["ts"]) <= hi)


def device_ms_by_span(events: Sequence[dict], names: Sequence[str]) -> Dict[str, float]:
    """Device milliseconds (kernel, memcpy and memset events) by the span
    that launched them: each event is charged to the ``annotate`` span among
    ``names`` (every instance of it; the spans must not overlap) in which
    the CUDA API call with the event's correlation id started, and
    to "other" when no such span holds that call.  The call and the spans
    are stamped on the host's clock, so no mapping between the two clocks
    enters."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                   for e in events if e.get("cat") == "user_annotation" and e.get("name") in names)
    starts = [a for a, _, _ in spans]
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in LAUNCH_CATEGORIES and "correlation" in e.get("args", {})}
    ms = dict.fromkeys((*names, "other"), 0.0)
    for e in events:
        if e.get("cat") not in DEVICE_CATEGORIES:
            continue
        owner, ts = "other", launched.get(e.get("args", {}).get("correlation"))
        if ts is not None:
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and ts <= spans[i][1]:
                owner = spans[i][2]
        ms[owner] += float(e.get("dur", 0.0)) / 1e3
    return ms
