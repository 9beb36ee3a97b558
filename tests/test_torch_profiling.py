"""The port's profiling utilities and tracers, on the CPU.

``StageTimer`` is held to the JAX package's under one scripted clock (same
summary, same report).  The trace readers are held on a small synthetic
Chrome trace whose answers are known: ``aggregate`` (by name, device or CPU
categories), ``device_activity`` (busy share of a span as the union of the
device's intervals, idle gaps with the host op running through each) and
``count_events``, and ``device_ms_by_span`` (device work charged to the
span that launched it).  ``trace()`` on the CPU writes a Chrome trace that
``load_trace`` reads back, with the ``annotate`` span and the CPU ops, also
when the traced block raises (the exception reaching the caller).  Each
ported tool runs from its ``main`` with ``--device cpu`` at a tiny size.
"""
import itertools
import json
import time

import pytest
import torch

from boxfusion_tpu.utils.profiling import StageTimer as JaxStageTimer

from boxfusion_tpu_torch.utils import profiling
from boxfusion_tpu_torch.utils.profiling import StageTimer

torch.set_num_threads(2)


def test_stage_timer_matches_jax(monkeypatch):
    def drive(timer):
        for name in ("detect", "step", "detect", "label", "detect"):
            with timer(name):
                pass
        return timer.summary(), timer.report()

    for cls in (StageTimer, JaxStageTimer):
        clock = itertools.count(0.0, 0.0125)  # each block lasts 12.5 ms
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        if cls is StageTimer:
            got = drive(cls())
        else:
            want = drive(cls())
    assert got == want
    assert got[0]["detect"] == dict(total_s=0.0375, calls=3, mean_ms=12.5)


def _synthetic_trace():
    """A loop span 0..100 us; device work at 10-30, 25-40 (overlapping),
    50-55 (a copy) and 90-120 (past the span's end); host ops around."""
    x = lambda name, cat, ts, dur: dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, pid=0, tid=0)
    return [
        x("loop", "user_annotation", 0, 100),
        x("kernel_a", "kernel", 10, 20), x("kernel_b", "kernel", 25, 15),
        x("Memcpy HtoD", "gpu_memcpy", 50, 5), x("kernel_a", "kernel", 90, 30),
        x("Memset", "gpu_memset", 200, 1),          # outside the span
        x("aten::item", "cpu_op", 40, 12),          # through the 40-50 gap
        x("aten::nonzero", "cpu_op", 55, 35),       # through the 55-90 gap
        x("aten::copy_", "cpu_op", 56, 2),          # inside it, shorter overlap
        x("loop", "gpu_user_annotation", 0, 100),   # not device work
        {"ph": "i", "name": "marker", "ts": 5},     # not a complete event
    ]


def test_aggregate_and_device_activity_on_a_synthetic_trace(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": _synthetic_trace()}))
    events = profiling.load_trace(str(path))
    assert len(events) == 10
    rows = profiling.aggregate(events, on_device=True)
    assert rows == [("kernel_a", 0.05, 2), ("kernel_b", 0.015, 1), ("Memcpy HtoD", 0.005, 1),
                    ("Memset", 0.001, 1)]
    assert [r[0] for r in profiling.aggregate(events, on_device=False)] == [
        "aten::nonzero", "aten::item", "aten::copy_"]
    assert profiling.format_rows(rows, 1) == "     0.05 ms  x2     kernel_a"
    act = profiling.device_activity(events, "loop", n_gaps=3)
    # busy: 10-40, 50-55, 90-100 (clipped) = 45 of 100 us
    assert act["span_ms"] == 0.1 and act["busy_ms"] == pytest.approx(0.045)
    assert act["busy_share"] == pytest.approx(0.45) and act["n_device_events"] == 4
    assert act["gaps"] == [dict(start_ms=0.055, ms=pytest.approx(0.035), host_op="aten::nonzero"),
                           dict(start_ms=0.0, ms=0.01, host_op=""),
                           dict(start_ms=0.04, ms=0.01, host_op="aten::item")]
    # the memset starts past the span's end and ends last, at 201 us
    assert act["n_outside"] == 1 and act["device_end_ms"] == pytest.approx(0.2 + 0.001)
    assert profiling.count_events(events, "kernel_a") == 2
    assert profiling.count_events(events, "kernel", span="loop") == 3
    with pytest.raises(ValueError, match="0 'nope' spans"):
        profiling.device_activity(events, "nope")


def test_device_ms_by_span_charges_work_to_the_launching_span():
    """Two "detect" spans and a "step" span; each device event's launch
    call (a CUDA API call of either category, by correlation id) decides
    its span, not where the device ran it: kernel 3 runs inside "step" but
    was launched in "detect"."""
    x = lambda name, cat, ts, dur, **args: dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, args=args)
    events = [
        x("detect", "user_annotation", 0, 10), x("step", "user_annotation", 10, 10),
        x("detect", "user_annotation", 30, 10), x("aten::mm", "cpu_op", 1, 2),
        x("cudaLaunchKernel", "cuda_runtime", 1, 1, correlation=1),
        x("cudaLaunchKernel", "cuda_runtime", 12, 1, correlation=2),
        x("cuLaunchKernelEx", "cuda_driver", 8, 1, correlation=3),
        x("cudaMemcpyAsync", "cuda_runtime", 25, 1, correlation=4),
        x("cudaLaunchKernel", "cuda_runtime", 31, 1, correlation=5),
        x("k1", "kernel", 2, 4, correlation=1), x("k2", "kernel", 13, 6, correlation=2),
        x("k3", "kernel", 14, 3, correlation=3), x("Memcpy HtoD", "gpu_memcpy", 26, 2, correlation=4),
        x("k1", "kernel", 33, 5, correlation=5), x("k4", "kernel", 50, 7, correlation=99),
    ]
    got = profiling.device_ms_by_span(events, ("detect", "step"))
    assert got == dict(detect=pytest.approx(0.012), step=pytest.approx(0.006), other=pytest.approx(0.009))


def test_trace_on_the_cpu_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr"), device="cpu") as path:
        with profiling.annotate("block"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    events = profiling.load_trace(path)
    assert path == str(tmp_path / "tr" / "trace.json")
    assert any(e["name"] == "block" and e["cat"] == "user_annotation" for e in events)
    assert any(r[0] == "aten::mm" for r in profiling.aggregate(events, on_device=False))
    act = profiling.device_activity(events, "block")
    assert act["busy_share"] == 0.0 and act["n_device_events"] == 0  # no card, no device events
    assert act["n_outside"] == 0 and act["device_end_ms"] == 0.0
    assert len(act["gaps"]) == 1 and act["gaps"][0]["ms"] == pytest.approx(act["span_ms"])


def test_trace_keeps_its_trace_when_the_block_raises(tmp_path):
    """As JAX's ``trace`` stops its profiler in a ``finally``: a block that
    raises still leaves a readable trace, and the exception reaches the
    caller."""
    class Boom(Exception):
        pass

    with pytest.raises(Boom, match="inside the trace"):
        with profiling.trace(str(tmp_path / "tr"), device="cpu") as path:
            with profiling.annotate("block"):
                torch.ones(64, 64) @ torch.ones(64, 64)
            raise Boom("inside the trace")
    events = profiling.load_trace(path)
    assert path == str(tmp_path / "tr" / "trace.json")
    assert any(e["name"] == "block" and e["cat"] == "user_annotation" for e in events)
    assert any(r[0] == "aten::mm" for r in profiling.aggregate(events, on_device=False))


def test_trace_keyframe_on_the_cpu(tmp_path, capsys):
    from boxfusion_tpu_torch.tools import trace_keyframe

    out = tmp_path / "kf"
    (out / "stale").mkdir(parents=True)  # cleared first
    with torch.inference_mode():
        res = trace_keyframe.run("cpu", str(out), n_frames=11, size=128, gap=10, capacity=48, top=5)
    assert res["keyframes"] == 2 and not (out / "stale").exists()
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == 5 and all(" ms  x" in line for line in printed)
    assert any(e["name"] == trace_keyframe.SPAN for e in res["events"])
    assert res["rows"][0][1] >= res["rows"][-1][1]


@pytest.mark.parametrize("tool,args", [
    ("trace_stress", ["--frames", "11", "--size", "128", "--gap", "10", "--top", "3"]),
    ("profile_keyframe", ["--frames", "11", "--size", "128", "--gap", "10", "--reps", "1"]),
    ("profile_stress", ["--frames", "11", "--size", "128", "--gap", "10", "--reps", "1"]),
    ("profile_detector", ["--frames", "2", "--size", "128"]),
    ("profile_fused", ["--dim", "192", "--size", "256", "--clip-width", "64", "--clip-layers", "1",
                       "--reps", "1", "--steps", "1"]),
    ("profile_stress_ablate", ["--frames", "11", "--size", "128", "--gap", "10", "--reps", "1"]),
    ("profile_clip_attn", ["--batch", "1", "--layers", "1", "--reps", "1"]),
    ("profile_bench_real", ["--dim", "192", "--size", "256", "--frames", "21", "--clip-width", "64",
                            "--clip-layers", "1", "--reps", "1"]),
])
def test_tools_run_on_the_cpu(tool, args, tmp_path, capsys):
    import importlib

    mod = importlib.import_module(f"boxfusion_tpu_torch.tools.{tool}")
    extra = ["--out", str(tmp_path / "tr")] if tool.startswith("trace") else []
    assert mod.main(["--device", "cpu"] + args + extra) == 0
    out = capsys.readouterr().out
    assert " ms" in out and "nan" not in out
