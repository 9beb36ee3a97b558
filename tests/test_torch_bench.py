"""The port's bench (``boxfusion_tpu_torch/bench.py``) against the root
``bench.py``, on the CPU.

* The builders: ``_workload``, the ``_bench_cfg`` trees and the headline's,
  and the ``_frames`` arrays are equal to the JAX bench's, exactly.
* ``_build_model``: JAX's random CuTR-192 parameters (before the class-bias
  lift) carried over through ``from_flax_params`` and lifted by the port give
  exactly the parameters JAX's ``_build_model`` returns; the forward on the
  bench batch stays within the CuTR bounds of tests/test_torch_cutr.py:
  scores 2e-3, 2D boxes 0.5 px, 3D boxes 5 mm, R 1e-3, after the packaged
  rows are aligned where the two rankings differ at a near-tie (two rows
  whose scores lie 2e-6 apart swap ranks at this batch).
* ``_flops`` of the chained CuTR-192 forward at 256 px is within 2% of XLA's
  ``cost_analysis`` of JAX's ``chained`` (bench.py:334-341): the two count
  the same products, XLA also the elementwise work (1.0063 measured).
* ``python -m boxfusion_tpu_torch.bench --device cpu`` exits 0 with one JSON
  record as its last stdout line; a phase that fails is named and the exit
  code is not 0; a phase past the deadline is named as skipped, and so is a
  headline figure past the phase's budget.
"""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boxfusion_tpu_torch import bench

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORE_TOL, BOX2D_PX, BOX3D_M, R_TOL = 2e-3, 0.5, 5e-3, 1e-3  # tests/test_torch_cutr.py
NEAR_TIE = 1e-5  # two packaged scores this close may rank either way round (2e-6 measured)
FLOP_RTOL = 0.02


@pytest.fixture(scope="module")
def jbench():
    """The root bench.py (its parent process imports no JAX)."""
    spec = importlib.util.spec_from_file_location("jax_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("on_card", [False, True])
def test_workload_and_configs_match_jax(jbench, on_card):
    wl = bench._workload(on_card)
    assert wl == jbench._workload(on_card)
    assert bench._bench_cfg(on_card, wl).to_dict() == jbench._bench_cfg(on_card, wl).to_dict()
    want = jbench._bench_cfg(on_card, wl)  # the headline's overrides, bench.py:432-436
    if on_card:
        want["detection"]._data["max_label_boxes"] = 128
        want["association"]._data["max_observations"] = 16384
    assert bench._headline_cfg(on_card, wl).to_dict() == want.to_dict()


def test_frames_match_jax(jbench):
    wl = bench._workload(False)
    _, got = bench._frames(wl)
    _, want = jbench._frames(wl)
    assert len(got) == len(want) == wl["n_frames"]
    for g, w in zip(got, want):
        for field in ("image", "depth", "K", "K_depth", "T_gravity", "gt_pose"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype and np.array_equal(a, b), field
        assert (g.video_id, g.timestamp) == (w.video_id, w.timestamp)


@pytest.fixture(scope="module")
def jax_side(jbench):
    """JAX's ``_build_model(False, wl)``: its parameters before and after the
    class-bias lift (the tree handed to ``tree_map_with_path``), its forward
    on the bench batch, and XLA's FLOPs of its ``chained`` program."""
    wl = bench._workload(False)
    seen = {}
    tree_map_with_path = jax.tree_util.tree_map_with_path

    def recording(fn, tree, *rest, **kw):
        seen["raw"] = tree
        return tree_map_with_path(fn, tree, *rest, **kw)

    jax.tree_util.tree_map_with_path = recording
    try:
        model, params, batch = jbench._build_model(False, wl)
    finally:
        jax.tree_util.tree_map_with_path = tree_map_with_path
    out = jax.jit(model.apply)(params, batch)

    @jax.jit
    def chained(params, batch, eps):  # bench.py:334-341
        out = model.apply(params, dataclasses.replace(batch, image=batch.image + eps))
        dep = sum(jnp.sum(v).astype(jnp.float32) for v in jax.tree.leaves(out))
        return dep * 1e-12 + eps + 1e-3

    flops = jbench._compiled_flops(chained, params, batch, jnp.float32(0.0))
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return dict(wl=wl, raw=to_np(seen["raw"]), lifted=to_np(params), batch=to_np(batch), out=to_np(out),
                flops=flops)


def test_build_model_lifts_class_biases_as_jax(jax_side):
    from boxfusion_tpu_torch.models.cutr.convert import from_flax_params

    model, batch = bench._build_model(torch.device("cpu"), jax_side["wl"], flax_params=jax_side["raw"])
    got = model.state_dict()
    want = from_flax_params(jax_side["lifted"])
    raw = from_flax_params(jax_side["raw"])
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    lifted = [k for k in want if not torch.equal(want[k], raw[k])]
    # the encoder's proposal scorer and the six decoder layers' class heads
    assert len(lifted) == 7 and all(k.endswith("bias") for k in lifted), lifted
    for name in ("image", "depth", "K", "image_hw", "depth_params", "T_gravity"):
        assert np.array_equal(getattr(batch, name).numpy(), getattr(jax_side["batch"], name)), name


def _near_tie_order(got, want):
    """The permutation of the port's packaged rows onto JAX's: the identity,
    but where a row differs from JAX's row of the same rank, the row of JAX's
    box further down whose score is within NEAR_TIE of it (two detections
    whose scores the stacks round apart swap ranks)."""
    perm = np.arange(len(want["scores"]))
    for i in range(len(perm)):
        if np.abs(got["pred_boxes"][perm[i]] - want["pred_boxes"][i]).max() <= BOX2D_PX:
            continue
        swap = [j for j in range(i + 1, len(perm))
                if abs(got["scores"][perm[j]] - want["scores"][i]) < NEAR_TIE
                and np.abs(got["pred_boxes"][perm[j]] - want["pred_boxes"][i]).max() <= BOX2D_PX]
        assert swap, f"row {i} differs from JAX's and is no near-tie"
        perm[i], perm[swap[0]] = perm[swap[0]], perm[i]
    return perm


def test_bench_forward_matches_jax(jax_side):
    model, batch = bench._build_model(torch.device("cpu"), jax_side["wl"], flax_params=jax_side["raw"])
    with torch.inference_mode():
        got = {k: v[0].numpy() for k, v in model(batch).items()}
    want = {k: v[0] for k, v in jax_side["out"].items()}
    assert (want["scores"] > 0.3).sum() > 50  # the lift puts a heavy load above the filter
    perm = _near_tie_order(got, want)
    assert (perm != np.arange(len(perm))).sum() <= 4  # a near-tie or two, no more
    got = {k: v[perm] for k, v in got.items() if v.shape[:1] == perm.shape}
    np.testing.assert_allclose(got["scores"], want["scores"], atol=SCORE_TOL, rtol=0)
    np.testing.assert_allclose(got["pred_boxes"], want["pred_boxes"], atol=BOX2D_PX, rtol=0)
    np.testing.assert_allclose(got["boxes3d"], want["boxes3d"], atol=BOX3D_M, rtol=0)
    np.testing.assert_allclose(got["R"], want["R"], atol=R_TOL, rtol=0)
    np.testing.assert_array_equal(got["pred_classes"], want["pred_classes"])


def test_flops_match_jax_cost_analysis(jax_side):
    model, batch = bench._build_model(torch.device("cpu"), jax_side["wl"])
    with torch.inference_mode():
        got = bench._flops(bench._chained_forward(model, batch), torch.zeros(()))
    assert jax_side["flops"] > 1e10
    assert abs(got / jax_side["flops"] - 1) < FLOP_RTOL, (got, jax_side["flops"])


def test_chip_peak_table(monkeypatch):
    """Only the H100 parts of the table get a peak; any other card gets none."""
    assert bench._chip_peak_tflops(torch.device("cpu")) == (None, "cpu")
    for name, peak in (("NVIDIA H100 80GB HBM3", 989.4), ("NVIDIA H100 PCIe", 756.0), ("NVIDIA H100 NVL", 835.0),
                       ("NVIDIA A100-SXM4-80GB", None)):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None, _n=name: _n)
        assert bench._chip_peak_tflops(torch.device("cuda")) == (peak, name)


RECORD_KEYS = ("metric", "value", "unit", "vs_baseline", "detector_ms", "detector_gflops", "detector_mfu",
               "measured_peak_tflops_bf16_matmul", "detector_mfu_vs_measured_peak", "keyframes_per_s_gap1",
               "io_inclusive_fps_ca1m_layout", "fps_chunk8", "keyframes_per_s_gap1_chunk8",
               "world_boxes_final_run", "world_stats_final_run", "headline_saturated",
               "multistream_fps_4lanes_packed", "stage_ms", "stress_fps_oracle_load", "failed_phases",
               "skipped_phases", "bench_wall_s")


def test_bench_on_the_cpu(tmp_path):
    env = {**os.environ, "OMP_NUM_THREADS": "2", "TMPDIR": str(tmp_path)}
    out = subprocess.run([sys.executable, "-m", "boxfusion_tpu_torch.bench", "--device", "cpu"], cwd=REPO,
                         capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    records = [json.loads(line) for line in lines]  # stdout holds the record lines only
    assert len(records) == len(bench.PHASE_ORDER) + 1
    rec = records[-1]
    for key in RECORD_KEYS:
        assert key in rec, key
    assert rec["failed_phases"] == [] and rec["skipped_phases"] == [] and rec["bench_wall_s"] > 0
    assert rec["skipped_figures"] == []
    assert rec["unit"] == "frames/s" and rec["value"] > 0 and "note" in rec  # the CPU says so
    assert rec["device"] == "cpu" and rec["card"] is None and rec["detector_mfu"] is None
    assert abs(rec["detector_gflops"] - 12.0) < 0.3
    assert rec["world_boxes_final_run"] > 0
    assert len(set(rec["world_boxes_by_run"])) == 1 and all(
        st == rec["world_stats_final_run"] for st in rec["world_stats_by_run"])
    assert set(rec["stage_ms"]) == {"clip_tower_32", "crop_resize_128", "step_assoc_plus_fusion",
                                    "step_assoc_only", "fusion_delta"}
    for key in ("keyframes_per_s_gap1", "fps_chunk8", "io_inclusive_fps_ca1m_layout",
                "multistream_fps_4lanes_packed", "stress_fps_oracle_load"):
        assert rec[key] > 0, key


def test_a_failed_phase_is_named_and_the_exit_code_is_not_0(tmp_path, monkeypatch, capfd):
    """micro fails for real (its result file lies in a missing directory, so
    its first write raises), stress falls past the deadline."""
    monkeypatch.setattr(bench, "RESULTS", str(tmp_path))
    monkeypatch.setattr(bench, "_SCHEDULE", (("micro", 0.0, lambda left: 120.0),
                                             ("stress", 1e9, lambda left: 60.0)))
    argv = bench._phase_argv
    monkeypatch.setattr(bench, "_phase_argv", lambda name, out, t, dev: argv(
        name, os.path.join(str(tmp_path), "missing", "phase.json"), t, dev))
    assert bench.main(["--device", "cpu"]) == 1
    captured = capfd.readouterr()
    rec = json.loads(captured.out.strip().splitlines()[-1])
    assert rec["failed_phases"] == ["micro"] and rec["skipped_phases"] == ["stress"]
    assert "bench_wall_s" in rec and "FileNotFoundError" in captured.err


def test_a_figure_the_headline_budget_leaves_out_is_named(tmp_path):
    """With no budget left after the record's own runs, the I/O-inclusive
    and chunk-8 figures are not measured, and the phase names them."""
    out = str(tmp_path / "headline.json")
    wl = dict(bench._workload(False), n_frames=21, n_runs=1)  # two keyframes at gap 20
    with torch.inference_mode():
        bench.phase_headline(out, 0.0, "cpu", wl)
    with open(out) as f:
        rec = json.load(f)
    assert rec["skipped_figures"] == ["io_inclusive_fps_ca1m_layout", "keyframes_per_s_gap1_chunk8", "fps_chunk8"]
    assert not {"io_inclusive_fps_ca1m_layout", "fps_chunk8"} & set(rec)
    assert rec["value"] > 0 and rec["keyframes_per_s_gap1"] > 0 and rec["world_boxes_final_run"] > 0


@pytest.mark.parametrize("module", ["bench", "tools.profile_gap1", "tools.profile_r5"])
def test_refuses_to_start_without_a_card(module):
    """No silent CPU fallback: without ``--device cpu`` they want a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    mod = importlib.import_module(f"boxfusion_tpu_torch.{module}")
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main([])
