"""The port's benchmark: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell named in ``BENCHMARK.json`` (its configuration, traffic mix,
limits and metric readers), builds the port's fused engine with weights
made from the seed on the card, warms up every shape the cell's traffic
uses, streams scans through the engine for ``--seconds`` (``window.py``),
checks what the window produced against the plain reference (``check.py``)
and prints one JSON line: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit (also the last lines on
standard error).

``peak_memory_gib`` is the allocator's peak over the window net of the card
bytes that only the harness's records hold (``window.py``), so it does not
grow with the keyframes a window keeps; ``device.memory_peak_bytes`` is the
raw peak of set-up and window.

``--trace 0`` reports the cell's end-to-end metrics.  ``--trace 1`` runs
the same window unprofiled (host-clock and counter metrics, the MFU), then
``profiled_keyframes`` keyframes under ``torch.profiler`` (device metrics),
and reports the cell's per-layer metrics.

Without a CUDA device, or with fewer than the cell asks for, it prints no
result and exits 2.  It exits 3, with no result, when a JAX module is
loaded in the process once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import List, Optional  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# build and kernel caches of the program stay inside the checkout, at fixed paths
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(_var, os.path.join(REPO, ".bench_cache", _sub))

FORBIDDEN = ("jax", "jaxlib", "flax", "boxfusion_tpu")
PAD_BUCKETS = (256, 384, 512, 640, 768, 896, 1024)


def log(msg: str) -> None:
    print(f"bench[{time.perf_counter() - T_START:7.1f}s] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that belong to JAX or its package."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Unprofiled:
    keyframes: int
    seconds: float
    host_reads: int
    timings: dict
    crops: List[int]
    pad: int
    depth_ratio: int


@dataclasses.dataclass
class Profiled:
    keyframes: int
    events: list
    busy_s: float
    window_s: float
    gaps: list
    span_device_s: dict
    spans_found: dict
    searches: list
    attention: list


@dataclasses.dataclass
class Observation:
    config: dict
    families: object  # harness.spec.Families
    traffic: dict
    unprofiled: Unprofiled
    profiled: Optional[Profiled]


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def warm_up(prog, scans, traffic: dict, device) -> None:
    """Build the kernels (the search's, and the attention kernel at each
    shape the labeler family names), run the tower at each label bucket,
    then the first keyframes of a scan, a flush and an export."""
    import numpy as np
    import torch

    from benchmark.harness.system import dtype_of
    from benchmark.harness.window import run_window
    from benchmark.reference.engine import label_buckets_for
    from boxfusion_tpu_torch.runtime.device_state import export_world

    settings = prog.config["settings"]
    det = settings["detection"]
    if device.type == "cuda":
        from boxfusion_tpu_torch.ops import attention_kernel, pst_search

        lab = prog.config["labeler"]
        kernels = [(pst_search, (int(settings["box_fusion"]["pst_size"]),))]
        kernels += [(attention_kernel, (tokens, head_width, dtype_of(lab["dtype"])))
                    for tokens, head_width in prog.families.labeler.attention_shapes(lab)]
        for module, args in kernels:
            try:
                module.kernel_info(*args)
            except AttributeError:  # built at first use instead, inside the warm-up keyframes
                pass
    frame = scans[0].frames[0]
    h, w = frame.image.shape[:2]
    budget = min(int(det["max_label_boxes"]), int(det["max_detections"]))
    image = torch.as_tensor(frame.image, dtype=torch.float32, device=device)[None]
    rng = np.random.default_rng(0)
    x0, y0 = rng.uniform(0, w / 2, budget), rng.uniform(0, h / 2, budget)
    boxes = np.stack([x0, y0, x0 + w / 3, y0 + h / 3], -1).astype(np.float32)
    boxes = torch.as_tensor(boxes, device=device)[None]
    scores = torch.ones((1, budget), device=device)
    with torch.inference_mode():
        for b in label_buckets_for(budget)[1:]:
            prog.labeler.label_boost_lanes(image, boxes[:, :b], scores[:, :b], [(h, w)],
                                           float(det["scale_box"]),
                                           float(settings["box_fusion"]["clip_sim_coeff"]), budget=b)
    run_window(prog, scans[:1], math.inf, device, keep_records=False,
               max_keyframes=int(traffic["warmup_keyframes"]))
    export_world(prog.pipe.state)
    prog.pipe.reset()
    _sync(device)


def profile_keyframes(prog, scans, n: int, device) -> Profiled:
    """``n`` keyframes from a fresh scan under torch.profiler, read back."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.harness import trace
    from benchmark.harness.probes import SPANS, Probes
    from benchmark.harness.window import run_window

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with Probes(prog.model, prog.families.labeler.ATTENTION_SITES) as probes:
        with profile(activities=activities) as prof:
            with torch.profiler.record_function("bench.profiled"):
                run_window(prog, scans, math.inf, device, keep_records=False, max_keyframes=n)
            _sync(device)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = trace.load(path)
    finally:
        os.remove(path)
    del prof
    lo, hi = trace.span(events, "bench.profiled")
    events = [e for e in events if lo <= float(e["ts"]) <= hi or e.get("cat") in trace.LAUNCH_CATEGORIES]
    act = trace.activity(events, lo, hi)
    found = {"bench.detect": True,
             "bench.label": probes.found["boxfusion_tpu_torch.runtime.fused.label_boost_core"],
             "bench.step": probes.found["boxfusion_tpu_torch.runtime.fused._step"]}
    return Profiled(keyframes=n, events=events, busy_s=act["busy_s"], window_s=act["window_s"],
                    gaps=act["gaps"], span_device_s=trace.device_s_by_span(events, SPANS),
                    spans_found=found, searches=probes.searches, attention=probes.attention)


def run_cell(cell, seed: int, seconds: float, trace_run: bool, device) -> dict:
    """One run of ``cell`` on ``device``; returns the result's fields."""
    import numpy as np
    import torch

    from benchmark.harness import check, traffic as traffic_mod, weights
    from benchmark.harness.system import build_program
    from benchmark.harness.window import p95, run_window
    from benchmark.reference.engine import ReferenceEngine
    from boxfusion_tpu_torch.utils.device import host_reads

    traffic, config = cell.traffic, cell.config
    on_card = device.type == "cuda"
    log(f"{cell.workload['name']}: seed {seed}, {seconds} s, trace {int(trace_run)}")
    scans = traffic_mod.make_scans(traffic, seed)
    lift = weights.lift_for(config, traffic)
    traffic = dict(traffic, class_bias_lift=lift)
    prog = build_program(config, cell.families, traffic, device)
    log("built; warming up")
    warm_up(prog, scans, traffic, device)
    power = _power_limit() if on_card else None
    setup_s = time.perf_counter() - T_START
    log(f"set-up {setup_s:.1f} s; window")

    capture = check.sample_positions(traffic, seed, scans)
    peak_setup = torch.cuda.max_memory_allocated() if on_card else 0
    prog.pipe.timings = {}
    reads0 = host_reads.count
    win = run_window(prog, scans, seconds, device, capture=capture, measure_memory=True)
    reads = host_reads.count - reads0
    timings = dict(prog.pipe.timings)
    log(f"window: {win.keyframes} keyframes, {win.frames} frames in {win.seconds:.2f} s, "
        f"{win.scans_completed} scans")
    log(f"memory: window peak {win.peak_bytes} B, net {win.peak_net_bytes} B, harness-only up to "
        f"{win.harness_bytes} B; accounting {win.accounting_s / max(win.keyframes, 1) * 1e3:.4f} ms a keyframe")

    frame = scans[0].frames[0]
    h, w = frame.image.shape[:2]
    det = config["settings"]["detection"]
    budget = min(int(det["max_label_boxes"]), int(det["max_detections"]))
    thresh = float(det["score_thresh"])
    crops = [min(int((r.det["scores"] >= thresh).sum()), budget) for r in win.records]
    unprofiled = Unprofiled(keyframes=win.keyframes, seconds=win.seconds, host_reads=reads, timings=timings,
                            crops=crops, pad=next(b for b in PAD_BUCKETS if b >= max(h, w)),
                            depth_ratio=round(w / frame.depth.shape[1]))
    profiled = None
    if trace_run:
        profiled = profile_keyframes(prog, scans, int(traffic["profiled_keyframes"]), device)
        log(f"profiled {profiled.keyframes} keyframes: busy {profiled.busy_s:.3f} of {profiled.window_s:.3f} s")

    found = forbidden_modules()
    if found:
        raise SystemExit(f"JAX modules loaded in the benchmark's process: {found}")

    result = dict(correct=False, attempted=win.keyframes, failed=0)
    if trace_run:
        obs = Observation(config=config, families=cell.families, traffic=traffic, unprofiled=unprofiled,
                          profiled=profiled)
        metrics = {}
        for m in cell.per_layer:
            value = cell.readers[m["name"]](obs)
            if value is not None:
                metrics[m["name"]] = dict(value=float(value), unit=m["unit"])
    else:
        values = dict(frames_per_s=win.frames / win.seconds, keyframe_ms_p95=p95(win.latencies_ms),
                      peak_memory_gib=win.peak_net_bytes / 2 ** 30, setup_s=setup_s)
        metrics = {m["name"]: dict(value=float(values[m["name"]]), unit=m["unit"]) for m in cell.end_to_end}
    device_info = dict(platform="gpu" if on_card else "cpu",
                       kind=torch.cuda.get_device_name() if on_card else "cpu",
                       count=1, memory_peak_bytes=int(max(peak_setup, win.peak_bytes)))
    if power:
        device_info["power_limit"] = power
    if trace_run:
        device_info.update(busy_s=profiled.busy_s, window_s=profiled.window_s)
        from benchmark.harness import trace as trace_mod

        result["breakdown"] = dict(device_ops=[[n, s] for n, s in trace_mod.top_ops(profiled.events)],
                                   idle_gaps=[[n, s] for n, s in profiled.gaps])
        profiled.events = None

    # the check: after the window, with the program freed
    records, exports, searches = win.records, win.exports, win.searches
    del prog, win
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    engine = ReferenceEngine(config, cell.families, traffic, device)
    readings = check.judge(records, exports, scans, engine, capture,
                           check.sample_searches(searches, traffic, seed),
                           check.sample_keyframes(records, traffic, seed))
    correct, checks = check.verdict(readings, cell.limits)
    readings.update(lift=lift, live_mean=float(np.mean(crops)) if crops else 0.0,
                    **{f"scan0_{k}": v for k, v in exports.get(0, {}).get("stats", {}).items()})
    log(f"check: {time.perf_counter() - t0:.1f} s; readings {json.dumps(readings)}")
    result.update(correct=bool(correct), metrics=metrics, device=device_info, readings=readings)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark.harness.spec import load_cell

    cell = load_cell(args.workload)
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda"))
    result.pop("readings")
    found = forbidden_modules()
    if found:
        print(f"JAX modules loaded in the benchmark's process: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
