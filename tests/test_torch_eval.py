"""The port's evaluation package (boxfusion_tpu_torch/eval) on the CPU.

- ``match_detections``, ``average_precision_3d`` and the per-class mAP
  against ``boxfusion_tpu.eval.ap3d`` on seeded random corners: true
  positives and counts identical, AP / precision / recall / mAP within 1e-6
  (the two IoU blocks agree to float32 rounding; AP moves only if a match
  flips, which would fail the identity of the true positives first);
- ``evaluate_sequences`` (device and fused engines) and
  ``evaluate_sequences_batched`` (arrays; packed with labels) on 2-3 small
  synthetic sequences (the sizes of tests/test_eval.py), with the
  skip-if-exists resume and the reference-format pickles;
- the eval command line: ``--synthetic 1`` prints AP 1.0, and the flag
  validations of tests/test_eval.py.
"""
import os
import pickle

import numpy as np
import pytest
import torch

from boxfusion_tpu_torch.data.synthetic import OracleDetector, SyntheticSequence
from boxfusion_tpu_torch.eval import (
    average_precision_3d,
    average_precision_3d_per_class,
    evaluate_sequences,
    evaluate_sequences_batched,
    match_detections,
)
from boxfusion_tpu_torch.eval.__main__ import main as eval_main
from boxfusion_tpu_torch.geometry.boxes import box_corners
from boxfusion_tpu_torch.runtime import CuTRDetector
from tests.test_torch_fused import cfg_for, load_fixture_model, make_labeler

torch.set_num_threads(2)

AP_TOL = 1e-6


def _corners(xyzlhw, yaw=None):
    t = torch.as_tensor(np.asarray(xyzlhw, np.float32))
    yaw = np.zeros(len(t)) if yaw is None else yaw
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.zeros((len(t), 3, 3), np.float32)
    R[:, 0, 0], R[:, 0, 1], R[:, 1, 0], R[:, 1, 1], R[:, 2, 2] = c, -s, s, c, 1.0
    return box_corners(t, torch.as_tensor(R)).numpy()


def _random_sequences(seed, n_seq=3):
    """GT boxes and predictions near them (some far, some duplicates), with
    classes: matches at both thresholds, misses and false positives."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_seq):
        g = rng.randint(2, 7)
        gt = np.concatenate([rng.uniform(-3, 3, (g, 3)), rng.uniform(0.3, 1.2, (g, 3))], 1)
        gyaw = rng.uniform(-np.pi, np.pi, g)
        pick = rng.randint(0, g, g + 2)
        pred = gt[pick] + np.concatenate([rng.normal(0, 0.12, (len(pick), 3)),
                                          rng.normal(0, 0.08, (len(pick), 3))], 1)
        pred[:, 3:] = np.abs(pred[:, 3:]) + 0.05
        pred[-1, :3] += 10.0  # a false positive far from everything
        classes = np.array(["chair", "table", "lamp"])
        out.append(dict(
            pred_corners=_corners(pred, gyaw[pick] + rng.normal(0, 0.1, len(pick))),
            pred_scores=rng.uniform(0.1, 1.0, len(pick)).astype(np.float32),
            gt_corners=_corners(gt, gyaw),
            gt_classes=classes[rng.randint(0, 3, g)],
            pred_classes=classes[rng.randint(0, 3, len(pick))],
        ))
    return out


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("what", ["match", "ap", "map"])
def test_ap3d_matches_jax(seed, what):
    from boxfusion_tpu.eval import ap3d as jax_ap3d

    seqs = _random_sequences(seed)
    for thr in (0.25, 0.5):
        if what == "match":
            for s in seqs:
                tp, n_gt = match_detections(s["pred_corners"], s["pred_scores"], s["gt_corners"],
                                            thr, device="cpu")
                jtp, jn_gt = jax_ap3d.match_detections(s["pred_corners"], s["pred_scores"],
                                                       s["gt_corners"], thr)
                np.testing.assert_array_equal(tp, jtp)
                assert n_gt == jn_gt
        elif what == "ap":
            got = average_precision_3d(seqs, thr, device="cpu")
            want = jax_ap3d.average_precision_3d(seqs, thr)
            assert 0.0 < want["ap"] < 1.0
            assert (got["n_pred"], got["n_gt"]) == (want["n_pred"], want["n_gt"])
            for k in ("ap", "precision", "recall"):
                assert abs(got[k] - want[k]) <= AP_TOL, k
        else:
            got = average_precision_3d_per_class(seqs, thr, device="cpu")
            want = jax_ap3d.average_precision_3d_per_class(seqs, thr)
            assert abs(got["map"] - want["map"]) <= AP_TOL
            assert set(got["per_class"]) == set(want["per_class"])
            for c, m in want["per_class"].items():
                assert abs(got["per_class"][c]["ap"] - m["ap"]) <= AP_TOL, c


def test_summarize_adds_per_class_map_when_labeled():
    """_summarize computes per-class mAP when every entry carries classes."""
    from boxfusion_tpu_torch.eval.runner import _summarize

    gt = _corners([[0, 0, 0, 1, 1, 1], [3, 0, 0, 1, 1, 1]])
    entry = dict(video_id="a", fps=1.0, pred_corners=gt, pred_scores=np.array([0.9, 0.8]),
                 pred_classes=np.array(["chair", "table"]), gt_corners=gt,
                 gt_classes=np.array(["chair", "table"]))
    out = _summarize([entry], 1.0, gt_provider=lambda s: None, device="cpu")
    assert out["ap_0.25"]["ap"] > 0.99 and out["map_0.25"]["map"] > 0.99
    bare = {k: v for k, v in entry.items() if "classes" not in k}
    out2 = _summarize([bare], 1.0, gt_provider=lambda s: None, device="cpu")
    assert "map_0.25" not in out2 and "ap_0.25" in out2


def _eval_cfg():
    return cfg_for(**{"data.gap": 5})


def _pickled_corners(path):
    with open(path, "rb") as f:
        saved = pickle.load(f)
    return np.stack([np.asarray(e[1]) for e in saved[0]]) if saved[0] else np.zeros((0, 8, 3))


@pytest.mark.parametrize("fused", [False, True])
def test_evaluate_sequences(tmp_path, fused):
    """The fan-out on ``devices=["cpu"]``: the device engine with oracle
    detections (AP 1.0 against the scene's GT) or the fused engine with the
    fixture CuTR-192; one pickle per sequence; a second call skips them all."""
    seqs = [SyntheticSequence(n_frames=11 if fused else 15, n_boxes=3, seed=s, video_id=f"s{s}")
            for s in range(3 if fused else 2)]
    if fused:
        model = load_fixture_model()

        def factory(seq):
            return CuTRDetector(model, device="cpu")
    else:
        def factory(seq):
            return OracleDetector(seq, noise=0.0)

    def gt(seq):
        return box_corners(torch.as_tensor(seq.gt_xyzlhw), torch.as_tensor(seq.gt_R)).numpy()

    out = evaluate_sequences(_eval_cfg(), seqs, factory, gt_provider=gt, output_dir=str(tmp_path),
                             devices=["cpu"], capacity=64, fused=fused)
    assert [r["video_id"] for r in out["sequences"]] == [s.video_id for s in seqs]
    for r in out["sequences"]:
        corners = _pickled_corners(tmp_path / f"{r['video_id']}_boxes.pkl")
        np.testing.assert_allclose(corners, r["pred_corners"], atol=1e-6)
        assert r["fps"] > 0 and r["n_boxes"] == len(corners)
    if not fused:
        assert out["ap_0.25"]["ap"] > 0.99 and out["ap_0.50"]["ap"] > 0.99
    else:
        assert sum(r["n_boxes"] for r in out["sequences"]) > 0 and "ap_0.25" in out
    again = evaluate_sequences(_eval_cfg(), seqs, factory, output_dir=str(tmp_path),
                               devices=["cpu"], capacity=64, fused=fused)
    assert again["sequences"] == []


@pytest.mark.parametrize("packed", [False, True])
def test_evaluate_sequences_batched(tmp_path, packed):
    """--lanes 2 over 3 sequences (groups of 2 and a tail of 1), arrays, and
    packed with open-vocab labels (the worlds carry categories); pickles,
    per-lane fps, and the resume."""
    seqs = [SyntheticSequence(n_frames=6, n_boxes=3, seed=s, video_id=f"lane{s}") for s in range(3)]
    det = CuTRDetector(load_fixture_model(), device="cpu")
    labeler = make_labeler() if packed else None
    out = evaluate_sequences_batched(_eval_cfg(), seqs, det, lanes=2, output_dir=str(tmp_path),
                                     capacity=32, packed=packed, labeler=labeler, device="cpu")
    assert [r["video_id"] for r in out["sequences"]] == ["lane0", "lane1", "lane2"]
    assert all(r["fps"] > 0 for r in out["sequences"])
    assert any(r["n_boxes"] > 0 for r in out["sequences"])
    for r in out["sequences"]:
        assert (tmp_path / f"{r['video_id']}_boxes.pkl").exists()
        assert ("pred_classes" in r) == packed
    assert evaluate_sequences_batched(_eval_cfg(), seqs, det, lanes=2, output_dir=str(tmp_path),
                                      device="cpu")["sequences"] == []
    with pytest.raises(ValueError, match="lanes"):
        evaluate_sequences_batched(_eval_cfg(), seqs, det, lanes=0, device="cpu")


def test_eval_cli_synthetic_prints_ap(tmp_path, capsys):
    """The dataset-free self-evaluation: the oracle pipeline over one
    synthetic scene (60 frames, gap 20) recovers every GT box.  The small
    search (128 particles, 4 iterations) and capacity 64 keep it quick; at
    config/ca1m.yaml's own it takes ~30 s here and prints the same."""
    assert eval_main(["--config", _cfg_file(tmp_path, **{"data.gap": 20}), "--synthetic", "1",
                      "--device", "cpu", "--capacity", "64"]) == 0
    assert "AP@0.25 = 1.0000  AP@0.50 = 1.0000" in capsys.readouterr().out


def _slam_dir(tmp_path, n_frames=6):
    from tests.test_dataprocess import _write_capture

    from boxfusion_tpu.data_process import convert_capture_to_slam

    cap = _write_capture(tmp_path, n_frames=n_frames)
    slam = tmp_path / "slam" / "42898867"
    convert_capture_to_slam(str(cap), str(slam))
    return slam


def _cfg_file(tmp_path, **raw_over):
    import yaml

    with open("config/ca1m.yaml") as f:
        raw = yaml.safe_load(f)
    raw["data"]["gap"] = 5
    raw["detection"]["max_detections"] = 16
    raw["detection"]["compute_dtype"] = "float32"
    raw["box_fusion"]["pst_path"] = None
    raw["box_fusion"]["pst_size"] = 128
    raw["box_fusion"]["iters"] = 4
    raw["box_fusion"]["max_fusions_per_frame"] = 4
    raw["cam"]["H"] = 64  # CA-1M convention: cam.H = width (landscape 48x64)
    raw["cam"]["W"] = 48
    raw["vis"]["rerun"] = False
    for k, v in raw_over.items():
        sect, key = k.split(".")
        raw[sect][key] = v
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


@pytest.mark.parametrize("engine", ["device", "fused", "lanes"])
def test_eval_cli_real_gt_ap(tmp_path, capsys, engine):
    """--gt on real-format data: raw capture -> SLAM dir with
    after_filter_boxes.npy -> the eval CLI (random CuTR-192) computes and
    prints 3D AP and writes the pickle, on each engine."""
    slam = _slam_dir(tmp_path, n_frames=11)
    np.save(slam / "after_filter_boxes.npy",
            _corners([[0.0, 0.0, 1.5, 0.4, 0.4, 0.4], [0.5, 0.2, 2.0, 0.3, 0.3, 0.3]]))
    flags = {"device": [], "fused": ["--fused"], "lanes": ["--lanes", "2", "--packed"]}[engine]
    rc = eval_main(["--config", _cfg_file(tmp_path, **{"detection.score_thresh": 0.0}),
                    "--data-root", str(tmp_path / "slam"), "--dimension", "192", "--gt",
                    "--capacity", "32", "--device", "cpu", "--output-dir", str(tmp_path / "out")]
                   + flags)
    assert rc == 0
    out = capsys.readouterr().out
    assert "3D AP@0.25" in out and "[eval] 1 sequences" in out
    assert (tmp_path / "out" / "42898867_boxes.pkl").exists()


@pytest.mark.parametrize("case", ["video_ids", "gt_missing", "fused_lanes", "packed_alone",
                                  "synthetic_fused"])
def test_eval_cli_flag_validation(tmp_path, capsys, case):
    """The refusals of tests/test_eval.py: unknown --video-ids and a missing
    GT file exit 1 with a message before any model is built; conflicting
    flags are argparse errors (exit 2)."""
    if case in ("video_ids", "gt_missing"):
        _slam_dir(tmp_path, n_frames=3)
        extra = ["--video-ids", "nope"] if case == "video_ids" else ["--gt"]
        rc = eval_main(["--config", _cfg_file(tmp_path), "--data-root", str(tmp_path / "slam"),
                        "--dimension", "192", "--device", "cpu"] + extra)
        assert rc == 1
        assert ("nope" if case == "video_ids" else "filter-gt") in capsys.readouterr().err
        return
    extra = {"fused_lanes": ["--fused", "--lanes", "2"], "packed_alone": ["--packed"],
             "synthetic_fused": ["--synthetic", "1", "--fused"]}[case]
    with pytest.raises(SystemExit) as e:
        eval_main(["--config", "config/ca1m.yaml", "--data-root", str(tmp_path)] + extra)
    assert e.value.code == 2
    assert {"fused_lanes": "mutually exclusive", "packed_alone": "--packed requires",
            "synthetic_fused": "oracle"}[case] in capsys.readouterr().err
    assert not os.listdir(tmp_path)
