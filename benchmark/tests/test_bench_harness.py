"""The harness on the CPU: a toy cell, added as new files, run end to end.

    python -m pytest benchmark/tests -q

The toy cell (``toycell.py``) is a configuration, a traffic mix, limits and
a metric reader written into a temporary directory; the harness finds them
by name beside the benchmark's own files.  The tests check the result
line's schema with and without the trace, that no module of JAX or of the
JAX package is loaded, that a run without a card prints nothing, and that
``correct`` comes out false when the timed path is broken underneath, and
how the window counts the card bytes only the harness holds.  The tests
marked ``cuda`` run a real cell briefly and the toy cell's window on the
card, and skip without one.
"""
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

from benchmark.harness import window
from benchmark.harness.spec import BENCH_DIR, REPO
from benchmark.tests.toycell import toy_cell

CPU = torch.device("cpu")
# the toy configuration's score filter (settings.detection.score_thresh)
TOY_THRESH = 0.4


def _run(tmp_path, seed=5, seconds=2.0, trace=False, limits=None):
    import benchmark.run as run

    return run.run_cell(toy_cell(str(tmp_path), limits), seed, seconds, trace, CPU)


def _assert_schema(result, names):
    line = json.loads(json.dumps(result))
    assert list(line)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert set(line["metrics"]) <= set(names)
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])


def test_result_line_end_to_end(tmp_path):
    result = _run(tmp_path)
    result.pop("readings")
    _assert_schema(result, ["frames_per_s", "keyframe_ms_p95", "peak_memory_gib", "setup_s"])
    assert set(result["metrics"]) == {"frames_per_s", "keyframe_ms_p95", "peak_memory_gib", "setup_s"}
    assert result["correct"] and result["attempted"] > 0 and result["failed"] == 0


def test_result_line_traced_with_a_metric_added_as_a_file(tmp_path):
    result = _run(tmp_path, trace=True)
    readings = result.pop("readings")
    bench = json.load(open(tmp_path / "BENCHMARK.json"))
    _assert_schema(result, [m["name"] for m in bench["per_layer"]])
    assert result["metrics"]["toy_keyframes"]["value"] == float(result["attempted"])
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["correct"] and readings["judged_steps"] >= 1


def test_no_jax_module_is_loaded(tmp_path):
    code = ("import sys, torch; sys.path.insert(0, %r); import benchmark.run as run; "
            "from benchmark.tests.toycell import toy_cell; "
            "run.run_cell(toy_cell(%r), 3, 1.0, False, torch.device('cpu')); "
            "print('LOADED', run.forbidden_modules(), sorted({m.split('.')[0] for m in sys.modules} "
            "& {'jax', 'jaxlib', 'flax', 'boxfusion_tpu'}))") % (REPO, str(tmp_path))
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "LOADED [] []"


def test_without_a_card_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cmd = [sys.executable, os.path.join(REPO, "benchmark", "run.py"), "--workload", "ca1m.scan.cluttered",
           "--seed", "2147483999", "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    cmd = [sys.executable, "benchmark/run.py", "--workload", "ca1m.scan.cluttered", "--seed", "1",
           "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=tmp_path, timeout=300,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and out.stdout == ""


def _fault(name, monkeypatch):
    """Break the timed path underneath the engine."""
    import dataclasses

    from boxfusion_tpu_torch.models.clip.head import OpenVocabLabeler
    from boxfusion_tpu_torch.models.cutr.model import CubifyTransformer
    from boxfusion_tpu_torch.runtime import fused

    if name == "half_the_detections_dropped":
        forward = CubifyTransformer.forward

        def dropped(self, *a, **k):
            # the lower-scoring half of each frame's live rows falls under the
            # score filter: live rows stay a prefix, as a truncated top-k leaves them
            out = dict(forward(self, *a, **k))
            scores = out["scores"]
            live = (scores >= TOY_THRESH).sum(-1, keepdim=True)
            rank = torch.arange(scores.shape[-1], device=scores.device)
            out["scores"] = torch.where(rank >= (live + 1) // 2, torch.zeros_like(scores), scores)
            return out
        monkeypatch.setattr(CubifyTransformer, "forward", dropped)
    elif name == "step_returns_its_state":
        monkeypatch.setattr(fused, "_step", lambda state, *a, **k: state)
    elif name == "world_answer_altered":
        step = fused._step

        def altered(*a, **k):
            state = step(*a, **k)
            return dataclasses.replace(state, xyzlhw=state.xyzlhw + 0.05)
        monkeypatch.setattr(fused, "_step", altered)
    else:
        label = OpenVocabLabeler.label_boost_lanes

        def broken(self, images, boxes, scores, hws, scale, coeff, budget=32):
            if name == "half_the_label_batch":
                return label(self, images, boxes, scores, hws, scale, coeff, budget=max(1, budget // 2))
            new, cats, feats, overflow = label(self, images, boxes, scores, hws, scale, coeff, budget=budget)
            cats = cats.clone()
            cats[0, 0] = (cats[0, 0] + 1) % len(self.class_list)
            return new, cats, feats, overflow
        monkeypatch.setattr(OpenVocabLabeler, "label_boost_lanes", broken)


@pytest.mark.parametrize("fault", ["step_returns_its_state", "world_answer_altered", "half_the_label_batch",
                                   "label_answer_altered", "half_the_detections_dropped"])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    _fault(fault, monkeypatch)
    result = _run(tmp_path, seed=6)
    assert not result["correct"], result["checks"]


@pytest.mark.cuda
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cmd = [sys.executable, os.path.join(REPO, "benchmark", "run.py"), "--workload", "ca1m.scan.cluttered",
           "--seed", "2147483999", "--seconds", "5", "--trace", "0"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=900, cwd=REPO)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1


@dataclasses.dataclass
class _State:
    a: torch.Tensor
    b: torch.Tensor


def _floats(n):
    return torch.zeros(n, dtype=torch.float32)


def _harness_bytes(kept, state):
    """The bytes only the harness holds once a segment that kept ``kept``
    is over, the engine's state ``state`` all along."""
    seg = window.Segments(types.SimpleNamespace(state=state, count=0), CPU)
    seg.open()
    seg.close(kept)
    assert seg.harness == 0  # a segment's own records are the program's while it runs
    seg.close()
    return seg.harness


def test_harness_bytes_count_views_of_one_storage_once():
    x = _floats(1024)
    assert _harness_bytes([x, x[:10], dict(v=x[512:]), (x.view(32, 32),)], None) == 4096


def test_harness_bytes_leave_out_what_the_live_state_holds():
    state = _State(_floats(1024), _floats(256))
    record = dict(det=state.a[:8], label=_floats(128))
    assert _harness_bytes([record, state], state) == 512


def test_harness_bytes_round_up_as_the_allocator_does():
    assert _harness_bytes([_floats(1)], None) == 512
    assert _harness_bytes([_floats(129)], None) == 1024
    assert _harness_bytes([torch.zeros(512, dtype=torch.uint8)], None) == 512


def test_harness_bytes_of_nothing_kept_is_zero():
    assert _harness_bytes([], _State(_floats(64), _floats(64))) == 0
    assert _harness_bytes([None, {}, [], _floats(0), _floats(64).to("meta")], None) == 0


def test_segments_subtract_only_what_the_harness_alone_held_through_a_segment():
    pipe = types.SimpleNamespace(state=_State(_floats(1024), _floats(1024)), count=0)
    seg = window.Segments(pipe, CPU)
    seg.open()
    old = pipe.state
    pipe.state = dataclasses.replace(old, b=_floats(2048))  # a step: one field new, one shared
    seg.close([dict(before=old, det=_floats(100))])
    assert seg.harness == 0
    pipe.state = dataclasses.replace(pipe.state, a=_floats(1024))
    seg.close()
    assert seg.harness == 4096 + 512  # old.b and the record; old.a was live when the segment opened
    seg.close([old.b[:3]])
    assert seg.harness == 2 * 4096 + 512  # old.a no longer live
    seg.close()
    assert seg.harness == 2 * 4096 + 512  # old.b kept again by a later record, counted once


@pytest.mark.cuda
def test_net_peak_on_the_card(tmp_path):
    """On the toy cell: with records kept the net peak is the peak without
    them, and a program that keeps 4 MiB more every keyframe shows it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import benchmark.run as run
    from benchmark.harness import check, traffic as traffic_mod, weights
    from benchmark.harness.system import build_program

    cell, seed, device = toy_cell(str(tmp_path)), 7, torch.device("cuda")
    scans = traffic_mod.make_scans(cell.traffic, seed)
    traffic = dict(cell.traffic, class_bias_lift=weights.lift_for(cell.config, cell.traffic))
    prog = build_program(cell.config, cell.families, traffic, device)
    run.warm_up(prog, scans, traffic, device)
    n = 2 * len(scans[0].keyframes) + 3  # two whole scans and the start of a third
    capture = check.sample_positions(traffic, seed, scans)

    def window_of(keep_records):
        return window.run_window(prog, scans, math.inf, device, capture=capture, keep_records=keep_records,
                                 max_keyframes=n, measure_memory=True)

    plain = window_of(False)
    assert plain.peak_net_bytes == plain.peak_bytes > 0 and plain.harness_bytes == 0
    kept = window_of(True)
    assert kept.keyframes == n and len(kept.records) == n and kept.harness_bytes > 0
    assert abs(kept.peak_net_bytes - plain.peak_bytes) <= 2 ** 20, (kept.peak_net_bytes, plain.peak_bytes)
    net = kept.peak_net_bytes
    del kept

    leak = []
    process = prog.pipe.process_keyframe

    def leaky(frame):
        process(frame)
        leak.append(torch.empty(2 ** 20, dtype=torch.float32, device=device))
    prog.pipe.process_keyframe = leaky
    leaked = window_of(True)
    assert len(leak) == n
    assert leaked.peak_net_bytes - net >= (n - 1) * 4 * 2 ** 20, (leaked.peak_net_bytes, net)
