"""The port's rerun logging against the JAX package's, on a fake rerun SDK.

The fake SDK is tests/test_viz.py's (it records every call).  Both
packages' viz modules run on the same frames and worlds, each against its
own recorder, and the recordings must agree: the same entity paths and
kinds in the same order, the same keyword arguments, arrays within 1e-5
(the GT point cloud: the same points, 1e-4 m; float32 backprojection in two
stacks).  The port's CLI with ``vis.rerun`` set is held to JAX's the same
way, on the synthetic sequence with the host engine (the fused boxes within
the engines' 5e-3) and on the device engine (the final world only).
"""
import sys

import numpy as np
import pytest
import torch
import yaml

from tests.test_viz import _Record, _make_fake_rerun

torch.set_num_threads(2)


def _install(monkeypatch, module):
    rr, rrb, calls = _make_fake_rerun()
    monkeypatch.setitem(sys.modules, "rerun", rr)
    monkeypatch.setitem(sys.modules, "rerun.blueprint", rrb)
    monkeypatch.setattr(module, "rerun", rr)
    monkeypatch.setattr(module, "HAS_RERUN", True)
    return calls


@pytest.fixture()
def both(monkeypatch):
    """(port viz, its calls, JAX viz, its calls): one fake SDK each."""
    from boxfusion_tpu.utils import viz as jax_viz

    from boxfusion_tpu_torch.utils import viz

    return viz, _install(monkeypatch, viz), jax_viz, _install(monkeypatch, jax_viz)


def _same(a, b, path, tol):
    if isinstance(a, _Record):
        assert isinstance(b, _Record) and a.kind == b.kind, path
        assert len(a.args) == len(b.args) and sorted(a.kwargs) == sorted(b.kwargs), path
        for i, (x, y) in enumerate(zip(a.args, b.args)):
            _same(x, y, f"{path}.{a.kind}[{i}]", tol)
        for k in a.kwargs:
            _same(a.kwargs[k], b.kwargs[k], f"{path}.{a.kind}.{k}", tol)
    elif isinstance(a, (list, tuple)) and not (a and isinstance(a[0], (int, float, np.number))):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]", tol)
    elif isinstance(a, (np.ndarray, list, tuple, float, np.floating)) or torch.is_tensor(a):
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                   atol=tol, rtol=0, err_msg=path)
    else:
        assert a == b, (path, a, b)


def _same_calls(got, want, tol=1e-5):
    assert [c[0] for c in got] == [c[0] for c in want]
    for (path, a), (_, b) in zip(got, want):
        _same(a, b, path, tol)


def _frames(n=3):
    from boxfusion_tpu.data.synthetic import SyntheticSequence as JaxSequence

    from boxfusion_tpu_torch.data.synthetic import SyntheticSequence

    return (list(SyntheticSequence(n_frames=n, n_boxes=3, seed=0)),
            list(JaxSequence(n_frames=n, n_boxes=3, seed=0)))


@pytest.mark.parametrize("depth_model", [True, False], ids=["rgbd", "rgb"])
def test_blueprint_and_recording_match_jax(both, depth_model):
    viz, calls, jax_viz, jax_calls = both
    _same(viz.make_blueprint(depth_model), jax_viz.make_blueprint(depth_model), "blueprint", 0)
    rec, jrec = viz.init_recording("vid0", is_depth_model=depth_model), \
        jax_viz.init_recording("vid0", is_depth_model=depth_model)
    assert len(rec.blueprints) == len(jrec.blueprints) == 1
    _same(rec.blueprints[0], jrec.blueprints[0], "sent", 0)


def test_log_frame_and_point_cloud_match_jax(both):
    viz, calls, jax_viz, jax_calls = both
    frames, jframes = _frames()
    viz.init_recording("v")
    jax_viz.init_recording("v")
    for f, jf in zip(frames, jframes):
        viz.log_frame(f, f.gt_pose)
        jax_viz.log_frame(jf, jf.gt_pose)
    _same_calls(calls, jax_calls)
    assert "/device/trajectory" in [c[0] for c in calls]
    del calls[:], jax_calls[:]
    viz.log_gt_point_cloud(frames[0], max_depth=10.0)
    jax_viz.log_gt_point_cloud(jframes[0], max_depth=10.0)
    _same_calls(calls, jax_calls, tol=1e-4)
    assert len(calls[0][1].kwargs["positions"]) > 0


def test_visualize_online_boxes_matches_jax(both):
    viz, calls, jax_viz, jax_calls = both
    rng = np.random.RandomState(0)
    world = {"scores": rng.rand(4).astype(np.float32),
             "xyzlhw": rng.rand(4, 6).astype(np.float32),
             "R": np.tile(np.eye(3, dtype=np.float32), (4, 1, 1)),
             "categories": ["a", "b", "c", "d"]}
    empty = {"scores": np.zeros(0, np.float32), "xyzlhw": np.zeros((0, 6), np.float32),
             "R": np.zeros((0, 3, 3), np.float32)}
    for w, kw in ((world, {}), (world, {"show_class": True, "show_label": False}), (empty, {})):
        viz.visualize_online_boxes(w, **kw)
        jax_viz.visualize_online_boxes(w, **kw)
    _same_calls(calls, jax_calls)
    assert len(calls) == 2


def _rerun_cfg(tmp_path, name):
    with open("config/ca1m.yaml") as f:
        raw = yaml.safe_load(f)
    raw["data"].update(gap=5, output_dir=str(tmp_path / name))
    raw["detection"].update(score_thresh=0.3, uv_bound=False, floor_mask=False, compute_dtype="float32")
    raw["box_fusion"].update(pst_path=None, pst_size=128, iters=4, max_fusions_per_frame=4)
    raw["association"]["max_views"] = 5
    raw["vis"].update(rerun=True, gt_points=True, show_class=False)
    p = tmp_path / f"{name}.yaml"
    p.write_text(yaml.safe_dump(raw))
    return str(p)


@pytest.mark.parametrize("engine", ["host", "device"])
def test_cli_with_rerun_matches_jax(both, tmp_path, engine):
    """``python -m boxfusion_tpu_torch.cli synthetic --config <vis.rerun
    True> --device cpu`` logs what JAX's CLI logs."""
    from boxfusion_tpu import cli as jax_cli

    from boxfusion_tpu_torch import cli

    viz, calls, jax_viz, jax_calls = both
    extra = [] if engine == "host" else ["--engine", "device", "--capacity", "48"]
    assert cli.main(["synthetic", "--config", _rerun_cfg(tmp_path, "port"), "--device", "cpu"] + extra) == 0
    assert jax_cli.main(["synthetic", "--config", _rerun_cfg(tmp_path, "jax")] + extra) == 0
    paths = [c[0] for c in calls]
    assert paths == [c[0] for c in jax_calls]
    if engine == "host":
        assert {"/device/wide/image", "/device/wide/depth", "/world/xyz", "/device/trajectory"} <= set(paths)
        frame_calls = [i for i, p in enumerate(paths) if not p.endswith("pred_instances")]
        _same_calls([calls[i] for i in frame_calls], [jax_calls[i] for i in frame_calls], tol=1e-4)
    boxes = [i for i, p in enumerate(paths) if p.endswith("pred_instances")]
    assert boxes and paths[-1].endswith("pred_instances")
    # the fused world: same boxes, same order of slots, within the engines' 5e-3
    for i in boxes:
        a, b = calls[i][1].kwargs, jax_calls[i][1].kwargs
        assert a["labels"] == b["labels"]
        np.testing.assert_allclose(a["centers"], b["centers"], atol=5e-3, rtol=0)
        np.testing.assert_allclose(a["sizes"], b["sizes"], atol=5e-3, rtol=0)
