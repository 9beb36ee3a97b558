"""The port's command-line entry point against the JAX package's, on the CPU.

Both CLIs run the synthetic sequence (oracle detections, host engine) from
the same small config, the port with ``--device cpu``.  ``framewise_boxes.pkl``
holds every observation as lifted to the world frame (no fusion): the same
count, the same class indices, corners within 1e-4.  ``synthetic_boxes.pkl``
holds the fused world boxes: the same count, corners within the engines'
5e-3 (PST fusion coordinates are chaotic across stacks).
"""
import os
import pickle

import numpy as np
import pytest
import torch
import yaml

from boxfusion_tpu import cli as jax_cli

from boxfusion_tpu_torch import cli

torch.set_num_threads(2)

OBS_TOL, WORLD_TOL = 1e-4, 5e-3


def _small_cfg(tmp_path, name, **overrides):
    """tests/test_cli.py:_small_cfg, writing to ``tmp_path/name``."""
    with open("config/ca1m.yaml") as f:
        raw = yaml.safe_load(f)
    raw["data"]["gap"] = 5
    raw["data"]["output_dir"] = str(tmp_path / name)
    raw["detection"]["score_thresh"] = 0.3
    raw["detection"]["uv_bound"] = False
    raw["detection"]["floor_mask"] = False
    raw["detection"]["compute_dtype"] = "float32"
    raw["box_fusion"]["pst_path"] = None
    raw["box_fusion"]["pst_size"] = 128
    raw["box_fusion"]["iters"] = 4
    raw["box_fusion"]["max_fusions_per_frame"] = 4
    raw["association"]["max_views"] = 5
    raw["vis"]["rerun"] = False
    for k, v in overrides.items():
        sect, _, key = k.partition(".")
        if key:
            raw[sect][key] = v
        else:
            raw[sect] = v
    p = tmp_path / f"{name}.yaml"
    p.write_text(yaml.safe_dump(raw))
    return str(p)


def _load(path):
    with open(path, "rb") as f:
        saved = pickle.load(f)
    assert len(saved) == 1
    idx = [int(e[0]) for e in saved[0]]
    corners = np.stack([np.asarray(e[1]) for e in saved[0]])
    return idx, corners


def test_cli_synthetic_matches_jax_cli(tmp_path, capsys):
    rc_j = jax_cli.main(["synthetic", "--config", _small_cfg(tmp_path, "jax", eval=True),
                         "--engine", "host"])
    rc_t = cli.main(["synthetic", "--config", _small_cfg(tmp_path, "torch", eval=True),
                     "--device", "cpu"])
    assert rc_j == 0 and rc_t == 0
    assert "Average FPS" in capsys.readouterr().out
    for name, tol in (("framewise_boxes.pkl", OBS_TOL), ("synthetic_boxes.pkl", WORLD_TOL)):
        want_idx, want = _load(tmp_path / "jax" / name)
        got_idx, got = _load(tmp_path / "torch" / name)
        assert got.shape == want.shape and got.shape[1:] == (8, 3) and len(got) >= 6
        assert got_idx == want_idx
        np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=name)


def _clip_assets(tmp_path):
    """A tiny open_clip-layout checkpoint, a class list and text features."""
    from tests.test_torch_clip import TINY, _open_clip_state_dict

    sd = _open_clip_state_dict(seed=21)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "clip.pt")
    names = [f"thing{i}" for i in range(9)]
    (tmp_path / "classes.txt").write_text("\n".join(names) + "\n")
    f = torch.from_numpy(np.random.RandomState(22).randn(9, TINY.embed_dim).astype(np.float32))
    torch.save(f, tmp_path / "feats.pt")
    return ["--clip-path", str(tmp_path / "clip.pt"), "--class_txt", str(tmp_path / "classes.txt"),
            "--class_features", str(tmp_path / "feats.pt")]


def test_cli_with_clip_labeling_matches_jax_cli(tmp_path, capsys):
    """``--clip-path``: both CLIs build the labeler from the same checkpoint,
    class list and text features; every observation gets the same class index."""
    assets = _clip_assets(tmp_path)
    over = {"box_fusion.clip_sim_coeff": 1.0, "detection.class_sim_thres": 0.0}
    assert jax_cli.main(["synthetic", "--config", _small_cfg(tmp_path, "jax", **over),
                         "--engine", "host", "--every-nth-frame", "2"] + assets) == 0
    assert cli.main(["synthetic", "--config", _small_cfg(tmp_path, "torch", **over),
                     "--device", "cpu", "--every-nth-frame", "2"] + assets) == 0
    assert "labeling disabled" not in capsys.readouterr().out
    want_idx, want = _load(tmp_path / "jax" / "framewise_boxes.pkl")
    got_idx, got = _load(tmp_path / "torch" / "framewise_boxes.pkl")
    assert got_idx == want_idx and len(got_idx) >= 6
    np.testing.assert_allclose(got, want, atol=OBS_TOL, rtol=0)
    # eval is off: no per-sequence pickle
    assert not (tmp_path / "torch" / "synthetic_boxes.pkl").exists()


def test_cli_skip_if_output_exists(tmp_path, capsys):
    """demo.py:434-436: an existing eval pickle short-circuits the run."""
    cfg = _small_cfg(tmp_path, "out", eval=True)
    os.makedirs(tmp_path / "out", exist_ok=True)
    (tmp_path / "out" / "42_boxes.pkl").write_bytes(b"x")
    assert cli.main(["ca1m", "--config", cfg, "--seq", "42"]) == 0  # no device is touched
    assert "already exist" in capsys.readouterr().out


@pytest.mark.parametrize("engine", ["device", "fused"])
def test_cli_refuses_engines_that_are_not_ported(tmp_path, capsys, engine):
    """Both device-resident engines parse with their flags; an engine that
    does not exist is an argparse error.  ``fused`` also runs: on the
    synthetic sequence (an oracle detector, no CuTR) it falls back to the
    device engine with the JAX CLI's message; on an on-disk CA-1M sequence it
    runs a random-init CuTR-192 in chunks of 2 and writes the eval pickle."""
    cfg = _small_cfg(tmp_path, "out")
    if engine == "fused":
        assert cli.main(["synthetic", "--config", cfg, "--engine", "fused", "--device", "cpu",
                         "--capacity", "48"]) == 0
        out = capsys.readouterr().out
        assert ("[cli] fused engine needs a CuTR detector; synthetic uses the oracle -- "
                "falling back to --engine device") in out
        assert "[cli] device engine: " in out

        from tests.test_dataprocess import _write_capture

        from boxfusion_tpu.data_process import convert_capture_to_slam

        slam = tmp_path / "slam" / "42898867"
        convert_capture_to_slam(str(_write_capture(tmp_path, n_frames=6)), str(slam))
        cfg = _small_cfg(tmp_path, "disk", eval=True, **{"data.datadir": str(slam), "cam.H": 64,
                                                          "cam.W": 48, "detection.score_thresh": 0.0})
        assert cli.main([str(slam), "--config", cfg, "--engine", "fused", "--chunk", "2",
                         "--dimension", "192", "--device", "cpu", "--capacity", "48"]) == 0
        out = capsys.readouterr().out
        assert "random-initialized CuTR" in out and "[cli] fused engine: " in out
        assert (tmp_path / "disk" / "42898867_boxes.pkl").exists()
    else:
        args = cli.build_argparser().parse_args(
            ["synthetic", "--config", cfg, "--engine", "device", "--capacity", "48",
             "--save-state", "s.pt", "--restore-state", "r.pt", "--restore-count", "30"])
        assert (args.engine, args.capacity, args.save_state, args.restore_state,
                args.restore_count, args.chunk) == ("device", 48, "s.pt", "r.pt", 30, 1)
    with pytest.raises(SystemExit) as e:
        cli.main(["synthetic", "--config", cfg, "--engine", engine + "x"])
    assert e.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


def test_cli_rerun_raises_and_names_the_roadmap(tmp_path, monkeypatch):
    """``vis.rerun`` was refused until the viewer was ported (ROADMAP.md
    A.11); it now runs, headless when the rerun SDK is absent
    (tests/test_torch_viz.py holds its logging against JAX's).  A missing
    config still raises."""
    from boxfusion_tpu_torch.utils import viz

    monkeypatch.setattr(viz, "HAS_RERUN", False)
    cfg = _small_cfg(tmp_path, "out", **{"vis.rerun": True})
    assert cli.main(["synthetic", "--config", cfg, "--device", "cpu"]) == 0
    assert (tmp_path / "out" / "framewise_boxes.pkl").exists()
    with pytest.raises(ValueError, match="Missing config"):
        cli.main(["synthetic", "--config", str(tmp_path / "nope.yaml")])


def test_cli_class_assets_without_clip_path(tmp_path, capsys):
    assets = _clip_assets(tmp_path)[2:]  # the class list and features, no --clip-path
    assert cli.main(["synthetic", "--config", _small_cfg(tmp_path, "out"), "--device", "cpu"]
                    + assets) == 0
    out = capsys.readouterr().out
    assert "class assets present but --clip-path not given" in out
    idx, _ = _load(tmp_path / "out" / "framewise_boxes.pkl")
    assert set(idx) == {0}  # every detection is "object", which the list lacks: index 0


def test_cli_default_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["synthetic", "--config", _small_cfg(tmp_path, "out")])


def test_cli_random_cutr_on_disk_ca1m(tmp_path, capsys):
    """A capture directory on disk -> the CA-1M reader -> a random-init
    CuTR-192 (no --model-path) -> the host engine -> the eval pickle."""
    from tests.test_dataprocess import _write_capture

    from boxfusion_tpu.data_process import convert_capture_to_slam

    cap = _write_capture(tmp_path, n_frames=6)
    slam = tmp_path / "slam" / "42898867"
    convert_capture_to_slam(str(cap), str(slam))
    # CA-1M convention: cam.H = width, cam.W = height (landscape 48x64)
    cfg = _small_cfg(tmp_path, "out", eval=True, **{"data.datadir": str(slam), "cam.H": 64,
                                                    "cam.W": 48, "detection.score_thresh": 0.0})
    assert cli.main([str(slam), "--config", cfg, "--dimension", "192", "--device", "cpu"]) == 0
    assert "random-initialized CuTR" in capsys.readouterr().out
    assert (tmp_path / "out" / "42898867_boxes.pkl").exists()
    assert (tmp_path / "out" / "framewise_boxes.pkl").exists()


def test_cli_validate_checkpoint(tmp_path, capsys):
    """--validate-checkpoint on the committed CuTR-192 fixture and a tiny CLIP
    checkpoint: one frame end to end, digests printed, exit 0."""
    cfg = _small_cfg(tmp_path, "out")
    rc = cli.main(["synthetic", "--config", cfg, "--device", "cpu", "--validate-checkpoint",
                   "--model-path", "tests/fixtures/cutr_trained_192_f16.pth"] + _clip_assets(tmp_path))
    out = capsys.readouterr().out
    assert rc == 0
    assert "CuTR dim=192 depth_model=True" in out and "CuTR forward:" in out
    assert "scores" in out and "sha=" in out and "clip_sims" in out and "[validate] OK" in out
    rc = cli.main(["synthetic", "--config", cfg, "--device", "cpu", "--validate-checkpoint",
                   "--model-path", str(tmp_path / "nope.pth")])
    assert rc == 1 and "checkpoint not found" in capsys.readouterr().err
