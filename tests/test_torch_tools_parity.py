"""The tools of A12b (``boxfusion_tpu_torch/tools/``) against the JAX tools
and the black-box harness, on the CPU, at small sizes.

* ``profile_stress_ablate``: one recording of detections (numpy) goes through
  the port's four variants and through the JAX device engine's
  ``_device_step_dev`` under the same four configurations; every world is held
  with ``tests/test_torch_device_pipeline.py:assert_worlds_match`` (decisions
  and counters exact, floats 1e-5, fused boxes 5e-3).
* ``profile_clip_attn``: one ViT-L block at B = 2 in bfloat16, the same
  numpy weights and input, against the JAX tool's ``block``.
* ``blackbox``: ``write_scene`` writes what ``tests/blackbox_harness.py``
  writes; the corner matchers give the harness's answers.
* ``build_parity_fixture``, the reference tools, ``profile_bench_real``: run
  at toy size (or, for the reference tools, without the reference).
"""
import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_device_pipeline import assert_worlds_match

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ------------------------------------------------------- profile_stress_ablate
# The step at the tools' stress configuration, cut for the CPU only in its
# search: 128 particles and 6 iterations (tests/test_torch_device_pipeline.py's
# sizes) in both stacks.  41 frames at 256 px, gap 10: five keyframes.
ABLATE_FRAMES, ABLATE_SIZE, ABLATE_GAP = 41, 256, 10
SMALL_SEARCH = {"box_fusion.pst_size": 128, "box_fusion.iters": 6}


def _stress_detections(kf):
    """One recording for every variant and both stacks (numpy): each
    keyframe's 2 cm oracle detections of the scene's 8 boxes (they recur
    across keyframes, so the full step fuses), then CuTR-192's rows (random
    weights, seed 0, float32, 256 px) up to the 100 the stress load keeps."""
    from boxfusion_tpu_torch.data.synthetic import OracleDetector
    from boxfusion_tpu_torch.tools.common import keyframes
    from boxfusion_tpu_torch.tools.trace_stress import DET_KEYS, record_detections

    seq, _, _ = keyframes(ABLATE_FRAMES, ABLATE_SIZE, ABLATE_GAP)
    oracle = OracleDetector(seq, noise=0.02, seed=1)
    with torch.inference_mode():
        cutr = record_detections(torch.device("cpu"), kf, 192)
    dets = []
    for frame, c in zip(kf, cutr):
        o = oracle(frame)
        dets.append({k: np.concatenate([o[k], c[k].numpy()])[:100].astype(np.float32) for k in DET_KEYS})
    return dets


def _jax_ablate_world(kf, dets, overrides):
    """The JAX tool's replay (tools/profile_stress_ablate.py:49-63) under its
    base_cfg (:38-46) and one variant's overrides; the exported world."""
    from boxfusion_tpu.runtime.device_pipeline import DevicePipeline, pack_meta
    from boxfusion_tpu.runtime.device_state import export_world
    from boxfusion_tpu.utils.config import load_config

    cfg = load_config(os.path.join(REPO, "config/ca1m.yaml"))
    cfg["data"]._data["gap"] = ABLATE_GAP
    cfg["detection"]._data["score_thresh"] = 0.0
    cfg["detection"]._data["uv_bound"] = False
    cfg["detection"]._data["floor_mask"] = False
    cfg["detection"]._data["size_max_thres"] = None
    cfg["box_fusion"]._data["pst_path"] = None
    for key, value in overrides.items():
        section, name = key.split(".")
        cfg[section]._data[name] = value
    pipe = DevicePipeline(cfg, lambda fr: None, capacity=512)  # profile_stress_ablate.CAPACITY
    kmax = int(cfg["detection"]["max_detections"])
    for frame, det in zip(kf, dets):
        pipe._device_step_dev({k: jnp.asarray(v) for k, v in det.items()},
                              pack_meta(frame, int(frame.timestamp)), kmax)
    return export_world(pipe.state)


def test_profile_stress_ablate_matches_jax_device_step(capsys):
    from boxfusion_tpu_torch.tools import profile_stress_ablate as tool
    from boxfusion_tpu_torch.tools.common import keyframes

    _, _, kf = keyframes(ABLATE_FRAMES, ABLATE_SIZE, ABLATE_GAP)
    dets = _stress_detections(kf)
    variants = tuple((name, label, {**ov, **SMALL_SEARCH}) for name, label, ov in tool.VARIANTS)
    worlds = {}
    with torch.inference_mode():
        res = tool.run("cpu", ABLATE_FRAMES, ABLATE_SIZE, 192, ABLATE_GAP, reps=1, dets=dets, variants=variants,
                       worlds=worlds)
    assert list(res) == ["full", "fusion_off", "nms_only", "no_suppression"]
    printed = capsys.readouterr().out.strip().splitlines()
    assert [line.split("  ")[0] for line in printed] == [label for _, label, _ in tool.VARIANTS]
    for name, (ms, n_final, launches) in res.items():
        assert ms > 0 and n_final == len(worlds[name]["scores"]) and launches == 0  # the CPU runs no kernel
    assert worlds["full"]["fusion_flag"].any() and not worlds["fusion_off"]["fusion_flag"].any()
    assert res["no_suppression"][1] > res["fusion_off"][1]  # nothing merged
    for name, _, overrides in variants:
        assert_worlds_match(worlds[name], _jax_ablate_world(kf, dets, overrides))


# ----------------------------------------------------------- profile_clip_attn
# A bfloat16 block rounds its residual stream after each of its three matmul
# sums, at points where XLA on the CPU and ATen differ: outputs of magnitude
# 2-3 differ by one bfloat16 ulp (2^-6), small ones by the rounding carried
# in the residual (1.4e-2 at most, measured).  So atol 2e-2 plus rtol 2^-7
# (chip_smoke.attention_tolerance's bfloat16 bound), and the mean difference
# below 5e-3 (2e-3 measured).
CLIP_ATOL, CLIP_RTOL, CLIP_MEAN = 2e-2, 2.0 ** -7, 5e-3


@pytest.fixture(scope="module")
def jax_clip_attn():
    """The JAX tool, loaded with ``B = 2`` (it reads B from sys.argv at import)."""
    path = os.path.join(REPO, "tools", "profile_clip_attn.py")
    saved = sys.argv
    sys.argv = [path, "2"]
    try:
        spec = importlib.util.spec_from_file_location("jax_profile_clip_attn", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.argv = saved
    assert mod.B == 2
    return mod


@pytest.mark.parametrize("impl,jax_impl", [("full", "full"), ("nosmax", "nosmax"), ("mlponly", "mlponly"),
                                           ("kernel", "full")])
def test_profile_clip_attn_block_matches_jax(jax_clip_attn, impl, jax_impl):
    """One port block against the JAX tool's ``block`` on the same numpy
    weights and input, B = 2, bfloat16.  JAX's ``kernel`` calls the Pallas
    kernel outside interpret mode, which the CPU cannot run, so the port's
    ``kernel`` (its plain twin here) is held against JAX's ``full``."""
    import jax

    from boxfusion_tpu_torch.tools import profile_clip_attn as tool

    rng = np.random.RandomState(0)
    p = jax_clip_attn._params(rng)
    x0 = rng.randn(2, tool.T, tool.D) * 0.02
    ours = tool.params(np.random.RandomState(0))
    assert all(np.array_equal(np.asarray(p[k]), ours[k]) for k in p)
    want = np.asarray(jax.jit(lambda x: jax_clip_attn.block(x, p, jax_impl))(
        jnp.asarray(x0, jnp.bfloat16)).astype(jnp.float32))
    x, pt = tool.inputs(2, "cpu")
    np.testing.assert_array_equal(x.float().numpy(), np.asarray(jnp.asarray(x0, jnp.bfloat16), np.float32))
    with torch.inference_mode():
        got = tool.block(x, pt, impl)
    assert got.dtype == torch.bfloat16 and got.shape == (2, tool.T, tool.D)
    d = np.abs(got.float().numpy() - want)
    assert (d <= CLIP_ATOL + CLIP_RTOL * np.abs(want)).all(), d.max()
    assert d.mean() < CLIP_MEAN, d.mean()


def test_profile_clip_attn_runs_on_the_cpu(capsys):
    """Every variant at B = 2 but flash, which the tool reports as needing a
    card and does not replace."""
    from boxfusion_tpu_torch.tools import profile_clip_attn as tool

    assert tool.main(["--device", "cpu", "--batch", "2", "--layers", "1", "--reps", "1"]) == 0
    out = capsys.readouterr().out
    for impl in ("full", "kernel", "nosmax", "mlponly"):
        assert f"{impl:8s}" in out and "ms/layer" in out
    assert "flash    needs a CUDA device" in out and "nan" not in out
    with torch.inference_mode():
        res = tool.run("cpu", (2,), layers=1, reps=1, verbose=False)
    assert res[2]["flash"] is None and all(res[2][i] > 0 for i in ("full", "kernel", "nosmax", "mlponly"))


# -------------------------------------------------------------------- blackbox
def test_blackbox_write_scene_matches_the_harness(tmp_path):
    """The same files: names, poses and intrinsics equal, every PNG (RGB and
    16-bit depth) byte for byte, the ground-truth corners within 1e-6."""
    from tests import blackbox_harness as bh

    from boxfusion_tpu_torch.tools import blackbox

    want_dir, got_dir = tmp_path / "harness", tmp_path / "port"
    assert bh.write_scene(str(want_dir), n_frames=6, image_hw=(192, 256)) == 6
    assert blackbox.write_scene(str(got_dir), n_frames=6, image_hw=(192, 256)) == 6
    names = lambda d: sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())
    assert names(got_dir) == names(want_dir)
    assert {"rgb/0.png", "depth/5.png", "all_poses.npy", "K_depth.txt", "after_filter_boxes.npy"} <= set(
        names(want_dir))
    for name in names(want_dir):
        a, b = want_dir / name, got_dir / name
        if name.endswith(".png"):
            assert a.read_bytes() == b.read_bytes(), name
        elif name == "after_filter_boxes.npy":
            want, got = np.load(a), np.load(b)
            assert got.shape == want.shape == (6, 8, 3) and got.dtype == want.dtype
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        elif name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(b), np.load(a))
        else:
            np.testing.assert_array_equal(np.loadtxt(b), np.loadtxt(a))


def test_blackbox_config_and_assets_match_the_harness(tmp_path):
    import yaml

    from tests import blackbox_harness as bh

    from boxfusion_tpu_torch.tools import blackbox

    args = dict(datadir="/d/42898867", output_dir="/o", gap=7, image_hw=(192, 256))
    want = yaml.safe_load(open(bh.write_config(str(tmp_path / "a.yaml"), **args)))
    got = yaml.safe_load(open(blackbox.write_config(str(tmp_path / "b.yaml"), **args)))
    assert got == want
    (tmp_path / "h").mkdir()
    (tmp_path / "p").mkdir()
    wt, wp = bh.write_class_assets(str(tmp_path / "h"))
    gt, gp = blackbox.write_class_assets(str(tmp_path / "p"))
    assert open(gt).read() == open(wt).read()
    assert torch.equal(torch.load(gp, weights_only=True), torch.load(wp, weights_only=True))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_blackbox_corner_matchers_match_the_harness(seed):
    """``match_corner_sets`` and ``bounded_match_stats`` give the harness's
    answers on seeded corner sets: a permuted, jittered copy (exact regime),
    a copy with boxes missing and far-off strays (bounded regime), and a
    count mismatch the exact matcher refuses."""
    from tests import blackbox_harness as bh

    from boxfusion_tpu_torch.tools import blackbox

    rng = np.random.RandomState(seed)
    ref = (rng.uniform(-3, 3, (9, 1, 3)) + rng.uniform(-0.3, 0.3, (9, 8, 3))).astype(np.float32)
    ours = (ref[rng.permutation(9)] + rng.normal(0, 0.02, (9, 8, 3))).astype(np.float32)
    assert blackbox.match_corner_sets(ref, ours) == bh.match_corner_sets(ref, ours)
    partial = np.concatenate([ours[:6], ours[:2] + 5.0]).astype(np.float32)
    for a, b in ((ref, ours), (ref, partial), (partial, ref), (ref[:0], ours)):
        assert blackbox.bounded_match_stats(a, b) == bh.bounded_match_stats(a, b)
    with pytest.raises(AssertionError, match="world box count differs"):
        blackbox.match_corner_sets(ref, partial[:7])


def test_blackbox_load_corner_pickle_and_reference_checkpoint(tmp_path):
    """The save_box pickle reads back as the harness reads it; the random
    checkpoint is the port's CuTR state dict, with the committed fixture's
    keys, and loads into CuTR-192."""
    import pickle

    from tests import blackbox_harness as bh

    from boxfusion_tpu_torch.models.cutr.convert import load_torch_state_dict
    from boxfusion_tpu_torch.tools import blackbox

    rng = np.random.RandomState(3)
    path = tmp_path / "boxes.pkl"
    with open(path, "wb") as f:
        pickle.dump([[(i, rng.randn(8, 3), 0.5) for i in range(4)]], f)
    np.testing.assert_array_equal(blackbox.load_corner_pickle(str(path)), bh.load_corner_pickle(str(path)))
    ckpt = blackbox.build_reference_checkpoint(str(tmp_path / "rand.pth"))
    sd = torch.load(ckpt, weights_only=True)["model"]
    committed = torch.load(os.path.join(REPO, "tests/fixtures/cutr_trained_192_f16.pth"), weights_only=True)
    assert set(sd) == set(committed["model"])
    load_torch_state_dict(sd, device="cpu")


def test_blackbox_run_our_cli_on_the_cpu(tmp_path):
    """The port's half of the black-box comparison: the parity scene and
    config (the PST synthesized: its reference file is absent), the
    committed fixture, the host and the fused engine; each writes the eval
    pickles ``load_corner_pickle`` reads (the world; the host engine also
    the per-frame boxes) and prints its FPS."""
    import yaml

    from boxfusion_tpu_torch.tools import blackbox

    seq = tmp_path / blackbox.SEQ
    blackbox.write_scene(str(seq), n_frames=15, image_hw=(192, 256))
    class_txt, _ = blackbox.write_class_assets(str(tmp_path))
    fixture = os.path.join(REPO, "tests/fixtures/cutr_trained_192_f16.pth")
    worlds = {}
    for engine, extra in (("host", ("--class_txt", class_txt)), ("fused", ("--capacity", "64"))):
        out = tmp_path / f"{engine}_out"
        out.mkdir()
        cfg = blackbox.write_config(str(tmp_path / f"{engine}.yaml"), datadir=str(seq), output_dir=str(out), gap=7)
        data = yaml.safe_load(open(cfg))
        assert data["box_fusion"]["pst_path"] == os.path.join(blackbox.REF, "data", "pst_1024_0.tiff")
        data["box_fusion"]["pst_path"] = None
        yaml.safe_dump(data, open(cfg, "w"))
        r = blackbox.run_our_cli(cfg, str(seq), fixture, engine=engine, extra=extra, device="cpu")
        assert r["fps"] > 0 and "Average FPS" in r["stdout"]
        worlds[engine] = blackbox.load_corner_pickle(str(out / f"{blackbox.SEQ}_boxes.pkl"))
        if engine == "host":  # the device-resident engines export the world only
            assert blackbox.load_corner_pickle(str(out / "framewise_boxes.pkl")).shape[1:] == (8, 3)
    for w in worlds.values():
        assert w.shape[0] > 0 and w.shape[1:] == (8, 3) and np.isfinite(w).all()


def test_blackbox_reference_available_follows_ref(tmp_path, monkeypatch):
    from boxfusion_tpu_torch.tools import blackbox

    monkeypatch.setattr(blackbox, "REF", str(tmp_path))
    assert not blackbox.reference_available()
    assert str(tmp_path / "demo.py") in blackbox.reference_missing("x")
    (tmp_path / "demo.py").write_text("")
    assert blackbox.reference_available() and blackbox.reference_missing("x") is None


# --------------------------------------------------------- build_parity_fixture
def test_build_parity_fixture_one_short_stage(tmp_path):
    """One stage of 2 steps at dim 192 on the CPU: the export loads into
    CuTR-192 with ``load_torch_state_dict``, its keys are the committed
    fixture's, its tensors float32; the default ``--out`` is not the
    committed fixture, which the tool refuses to overwrite."""
    from boxfusion_tpu_torch.models.cutr import make_cutr
    from boxfusion_tpu_torch.models.cutr.convert import load_torch_state_dict, sniff_state_dict
    from boxfusion_tpu_torch.tools import build_parity_fixture as tool

    out = tmp_path / "out" / "fixture.pth"
    assert tool.main(["--device", "cpu", "--workdir", str(tmp_path / "work"), "--out", str(out)],
                     stages=((2, 1e-3),)) == 0
    sd = torch.load(out, weights_only=True)["model"]
    committed = torch.load(tool.COMMITTED, weights_only=True)["model"]
    assert set(sd) == set(committed) == set(make_cutr(192, device="cpu").state_dict())
    assert {v.dtype for v in sd.values()} == {torch.float32}
    assert sniff_state_dict(sd) == (192, True)
    load_torch_state_dict(sd, device="cpu")
    assert os.path.abspath(tool.FIXTURE) != os.path.abspath(tool.COMMITTED)
    assert tool.FIXTURE.endswith(os.path.join("tests", "fixtures", "cutr_trained_192.pth"))
    with pytest.raises(ValueError, match="refusing to overwrite"):
        tool.main(["--device", "cpu", "--workdir", str(tmp_path / "w2"), "--out", tool.COMMITTED], stages=((1, 1e-3),))
    assert not (tmp_path / "w2").exists()


# ----------------------------------------------------------- reference tools
@pytest.mark.parametrize("tool", ["run_blackbox_parity", "diagnose_parity_band", "profile_host_engine"])
def test_reference_tools_exit_2_without_the_reference(tool, tmp_path, monkeypatch, capsys):
    """Without ``REF/demo.py`` each prints one line naming the missing path
    and exits with status 2 before any work (its workdir is not made)."""
    import importlib

    from boxfusion_tpu_torch.tools import blackbox

    monkeypatch.setattr(blackbox, "REF", str(tmp_path / "reference"))
    mod = importlib.import_module(f"boxfusion_tpu_torch.tools.{tool}")
    work = tmp_path / "work"
    assert mod.main(["--device", "cpu", "--workdir", str(work)]) == 2
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and err[0].startswith(f"{tool}: ") and str(tmp_path / "reference" / "demo.py") in err[0]
    assert not work.exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main(["--workdir", str(work)])


def test_diagnose_parity_band_report_on_crafted_detections():
    """The band measurement of ``diagnose_parity_band`` on detections whose
    answer is known: three boxes matched across the stacks, one score
    straddling the 0.03 threshold inside the measured noise band, an
    unmatched stray; one realised flip, eligible."""
    from boxfusion_tpu_torch.tools.diagnose_parity_band import band_report, iou_xyxy

    boxes = np.array([[0, 0, 10, 10], [20, 20, 40, 30], [50, 0, 60, 40]], np.float64)
    ours = {"scores": np.array([0.9, 0.031, 0.5]), "boxes": boxes}
    ref = {"scores": np.array([0.9005, 0.5, 0.029, 0.2]),
           "boxes": np.concatenate([boxes[[0, 2, 1]] + 0.1, [[100, 100, 110, 110]]])}
    np.testing.assert_allclose(np.diag(iou_xyxy(boxes, boxes)), 1.0)
    out = band_report([ours], [ref])
    assert out["matched_detections"] == 3
    assert out["score_abs_delta"]["max"] == pytest.approx(0.002)
    assert out["flip_eligible_within_p95_band"] == 1 and out["realized_threshold_flips"] == 1
    assert out["verdict"].startswith("the selection-boundary band is real")


# ----------------------------------------------------------- profile_bench_real
def test_profile_bench_real_on_the_cpu(capsys):
    """At toy size: the per-keyframe split is printed and the synced run and
    the pipelined run end with the same world."""
    from boxfusion_tpu_torch.tools import profile_bench_real as tool

    assert tool.main(["--device", "cpu", "--dim", "192", "--size", "256", "--frames", "41",
                      "--clip-width", "64", "--clip-layers", "1", "--reps", "1"]) == 0
    out = capsys.readouterr().out
    assert "per-keyframe ms  [pack, shape key, upload+dispatch, device sync]" in out
    for row in ("first:", "kf 1-4:", "median:", "max   :", "total per kf (median):", "keyframes/s"):
        assert row in out
    with torch.inference_mode():
        res = tool.run("cpu", 192, 256, 41, 20, 64, 1, reps=1, verbose=False)
    assert res["keyframes"] == 3 and res["split_ms"].shape == (3, 4) and (res["split_ms"] >= 0).all()
    assert res["n_synced"] == res["n_pipelined"] > 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is present: the default device is usable")
@pytest.mark.parametrize("tool", ["profile_stress_ablate", "profile_clip_attn", "profile_bench_real",
                                  "build_parity_fixture"])
def test_tools_default_to_cuda_and_raise_without_it(tool, tmp_path):
    """No silent CPU fallback: without ``--device`` a tool wants a card."""
    import importlib

    mod = importlib.import_module(f"boxfusion_tpu_torch.tools.{tool}")
    argv = ["--workdir", str(tmp_path / "w"), "--out", str(tmp_path / "f.pth")] if tool == "build_parity_fixture" else []
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(argv)
    assert not (tmp_path / "w").exists()


def test_pos_embed_resize_trains_after_an_inference_pass():
    """The tools run inference and then training in one process
    (build_parity_fixture after the profilers): the cached bicubic resize
    matrices must not be inference tensors, or the training step cannot
    save them for backward."""
    from boxfusion_tpu_torch.models.cutr.layers import _bicubic, resize_pos_embed

    _bicubic.cache_clear()
    pos = torch.randn(1, 16, 8)
    with torch.inference_mode():
        want = resize_pos_embed(pos, 4, (6, 5))
    p = pos.clone().requires_grad_()
    got = resize_pos_embed(p, 4, (6, 5))
    got.sum().backward()
    assert torch.equal(got.detach(), want) and p.grad is not None and torch.isfinite(p.grad).all()
