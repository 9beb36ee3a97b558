"""The port's data_process (and the readers it feeds) against the JAX
package's, on the CPU.

Every case of tests/test_dataprocess.py runs here on the port, with the
JAX test's own capture writer; its two checkpoint cases are the port's
tests/test_torch_checkpoint.py (test_params_round_trip,
test_pipeline_state_round_trip, test_narrow_or_absent_stats_restore_zero_padded).
Then the files that the JAX package's and the port's ``convert``,
``rotate`` and ``filter-gt`` write from one capture are held byte for byte.
"""
import json
import os
import struct

import numpy as np
import torch
from PIL import Image

from test_dataprocess import _write_capture

from boxfusion_tpu_torch.data_process import (
    classify_sequence_orientation,
    convert_capture_to_slam,
    filter_gt_boxes,
    read_ply_points,
)
from boxfusion_tpu_torch.data_process.gt_filter import frustum_culling_mask, proximity_mask
from boxfusion_tpu_torch.utils.config import load_config


def _ca1m_cfg(out, start=None):
    cfg = load_config("config/ca1m.yaml")
    cfg["data"]._data["datadir"] = str(out)
    if start is not None:
        cfg["data"]._data["start"] = start
    # CA-1M convention: cam.H = image width (short), cam.W = image height
    cfg["cam"]._data["H"] = 64
    cfg["cam"]._data["W"] = 48
    return cfg


def test_convert_capture_and_read(tmp_path):
    cap = _write_capture(tmp_path)
    out = tmp_path / "slam" / "42898867"
    stats = convert_capture_to_slam(str(cap), str(out))
    assert stats["frames"] == 3
    for name in ("all_poses.npy", "K_depth.txt", "instances.json"):
        assert (out / name).exists()

    from boxfusion_tpu_torch.data.readers import CA1MDataset

    frames = list(CA1MDataset(_ca1m_cfg(out)))
    assert len(frames) == 3
    f = frames[0]
    assert f.image.shape[2] == 3 and f.depth is not None
    assert f.K.shape == (3, 3) and f.gt_pose.shape == (4, 4)
    kind, v, h = classify_sequence_orientation(str(out))
    assert kind == "horizontal"


def test_scannet_reader(tmp_path):
    """Fake ScanNet frames dir, including the inf-pose fallback."""
    from boxfusion_tpu_torch.data.readers import ScannetDataset

    base = tmp_path / "scene0000_00" / "frames"
    for sub in ("color", "depth", "pose"):
        (base / sub).mkdir(parents=True)
    rng = np.random.RandomState(0)
    h, w = 48, 64
    for i in range(3):
        Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)).save(base / "color" / f"{i}.jpg")
        Image.fromarray((rng.rand(h, w) * 3000).astype(np.uint16)).save(base / "depth" / f"{i}.png")
        pose = np.eye(4)
        pose[:3, 3] = [0.05 * i, 0, 0]
        if i == 1:
            pose[0, 0] = np.inf  # invalid pose -> falls back to previous
        np.savetxt(base / "pose" / f"{i}.txt", pose)

    cfg = load_config("config/scannet.yaml")
    cfg["data"]._data["datadir"] = str(base)
    cfg["cam"]._data.update(dict(H=h, W=w, fx=50.0, fy=50.0, cx=w / 2, cy=h / 2))
    ds = ScannetDataset(cfg)
    frames = list(ds)
    assert len(frames) == 3 and ds.video_id == "scene0000_00"
    np.testing.assert_allclose(frames[1].gt_pose[:3, 3], frames[0].gt_pose[:3, 3])
    assert frames[0].image.shape == (h, w, 3) and frames[0].depth.shape == (h, w)
    assert np.isfinite(frames[0].depth).all()


def test_prep_cli(tmp_path, capsys):
    from boxfusion_tpu_torch.data_process.__main__ import main

    cap = _write_capture(tmp_path)
    out = tmp_path / "slam" / "42898867"
    assert main(["convert", str(cap), str(out)]) == 0
    assert (out / "all_poses.npy").exists()
    assert main(["classify", str(out)]) == 0
    assert "horizontal" in capsys.readouterr().out
    assert main(["rotate", str(out)]) == 0
    assert "rotated" in capsys.readouterr().out

    corners = np.array([[[x, y, z] for x in (-0.1, 0.1) for y in (-0.1, 0.1) for z in (0.9, 1.1)]],
                       np.float32)
    np.save(out / "gt_boxes.npy", corners)
    assert main(["filter-gt", str(out)]) == 0
    assert "1/1" in capsys.readouterr().out
    assert (out / "after_filter_boxes.npy").exists()


def test_ply_reader_roundtrip(tmp_path):
    pts = np.random.RandomState(0).randn(10, 3)
    ascii_ply = tmp_path / "a.ply"
    lines = ["ply", "format ascii 1.0", "element vertex 10", "property float x",
             "property float y", "property float z", "end_header"]
    lines += [" ".join(f"{v:.6f}" for v in p) for p in pts]
    ascii_ply.write_text("\n".join(lines) + "\n")
    np.testing.assert_allclose(read_ply_points(str(ascii_ply)), pts, atol=1e-5)

    bin_ply = tmp_path / "b.ply"
    with open(bin_ply, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\nelement vertex 10\n"
                b"property float x\nproperty float y\nproperty float z\nend_header\n")
        for p in pts:
            f.write(struct.pack("<fff", *p))
    np.testing.assert_allclose(read_ply_points(str(bin_ply)), pts, atol=1e-5)


def test_gt_filter_frustum_and_proximity():
    from boxfusion_tpu_torch.geometry.boxes import box_corners

    t = torch.tensor([[0, 0, 2.0, 0.5, 0.5, 0.5], [0, 0, -5.0, 0.5, 0.5, 0.5]])
    corners = box_corners(t, torch.eye(3).repeat(2, 1, 1)).numpy()
    K = np.array([[100.0, 0, 32], [0, 100.0, 32], [0, 0, 1]])
    poses = np.eye(4)[None]
    m = frustum_culling_mask(corners, K, poses, (64, 64))
    assert m[0] and not m[1]
    pts = corners[0] + 0.01
    pm = proximity_mask(corners, pts, threshold=0.1)
    assert pm[0] and not pm[1]
    kept, no_labels = filter_gt_boxes(corners, K, poses, (64, 64), gt_points=pts)
    assert kept.shape[0] == 1 and no_labels is None


def test_gt_filter_labels_lockstep(tmp_path):
    corners = np.stack([
        np.array([[x, y, z] for x in (-.2, .2) for y in (-.2, .2) for z in (1.8, 2.2)], np.float32),
        np.array([[x, y, z] for x in (-.2, .2) for y in (-.2, .2) for z in (-2.2, -1.8)], np.float32),
    ])
    K = np.array([[50.0, 0, 32], [0, 50.0, 24], [0, 0, 1]])
    out = tmp_path / "after_filter_boxes.npy"
    kept, labels = filter_gt_boxes(corners, K, np.eye(4)[None], (48, 64), save_path=str(out),
                                   labels=np.array(["chair", "table"]))
    assert kept.shape == (1, 8, 3) and list(labels) == ["chair"]
    assert np.load(out).shape == (1, 8, 3)
    assert list(np.load(tmp_path / "after_filter_labels.npy")) == ["chair"]


def _labelled_sequence(seq):
    (seq / "depth").mkdir(parents=True)
    Image.fromarray(np.zeros((48, 64), np.uint16)).save(seq / "depth" / "0.png")
    box = [[x, y, z] for x in (-.2, .2) for y in (-.2, .2) for z in (1.8, 2.2)]
    far = [[x, y, -z] for x, y, z in box]
    (seq / "instances.json").write_text(json.dumps([
        {"corners": box, "category": "chair"}, {"corners": far, "category": "table"},
    ]))
    np.savetxt(seq / "K_depth.txt", np.array([[50.0, 0, 32], [0, 50.0, 24], [0, 0, 1]]))
    np.save(seq / "all_poses.npy", np.eye(4)[None])


def test_gt_filter_cli_saves_labels_from_instances(tmp_path):
    from boxfusion_tpu_torch.data_process.__main__ import main as prep_main

    seq = tmp_path / "42898867"
    _labelled_sequence(seq)
    assert prep_main(["filter-gt", str(seq)]) == 0
    assert np.load(seq / "after_filter_boxes.npy").shape == (1, 8, 3)
    assert list(np.load(seq / "after_filter_labels.npy")) == ["chair"]


def test_ca1m_start_offset_aligns_per_frame_tables(tmp_path):
    from boxfusion_tpu_torch.data.readers import CA1MDataset

    cap = _write_capture(tmp_path, n_frames=4)
    out = tmp_path / "slam" / "42898867"
    convert_capture_to_slam(str(cap), str(out))
    n = 4
    K_all = np.tile(np.eye(3, dtype=np.float32)[None], (n, 1, 1))
    K_all[:, 0, 0] = 100.0 + np.arange(n)
    K_all[:, 1, 1] = 100.0 + np.arange(n)
    K_all[:, 0, 2] = 32.0
    K_all[:, 1, 2] = 24.0
    np.save(out / "K_all.npy", K_all)
    np.save(out / "K_scales.npy", 1.0 + np.arange(n, dtype=np.float32))

    full = list(CA1MDataset(_ca1m_cfg(out, start=0)))
    sliced = list(CA1MDataset(_ca1m_cfg(out, start=2)))
    assert len(full) == 4 and len(sliced) == 2
    np.testing.assert_array_equal(sliced[0].K, full[2].K)
    np.testing.assert_array_equal(sliced[0].depth, full[2].depth)
    assert not np.array_equal(sliced[0].K, full[0].K)


def test_write_ca1m_sequence_roundtrip(tmp_path):
    from boxfusion_tpu_torch.data.readers import CA1MDataset, write_ca1m_sequence
    from boxfusion_tpu_torch.data.synthetic import SyntheticSequence

    frames = list(SyntheticSequence(n_frames=4, n_boxes=3, image_hw=(48, 64), seed=3))
    out = tmp_path / "42898867"
    assert write_ca1m_sequence(frames, str(out)) == 4
    cfg = _ca1m_cfg(out, start=0)
    cfg["cam"]._data["png_depth_scale"] = 1000.0
    back = list(CA1MDataset(cfg))
    assert len(back) == 4
    for a, b in zip(frames, back):
        np.testing.assert_array_equal(a.image, b.image)
        np.testing.assert_allclose(a.depth, b.depth, atol=1.01e-3)
        np.testing.assert_allclose(a.K, b.K, rtol=1e-6)
        np.testing.assert_allclose(a.gt_pose, b.gt_pose, atol=1e-6)


def _tree_bytes(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_outputs_byte_identical_to_jax(tmp_path, capsys):
    """One capture through both packages' convert, rotate and filter-gt
    (from gt_boxes.npy and from labelled instances.json): every file they
    write is byte for byte the same, and so is what they print."""
    from boxfusion_tpu.data_process.__main__ import main as jax_main

    from boxfusion_tpu_torch.data_process.__main__ import main as port_main

    cap = _write_capture(tmp_path / "capture", n_frames=4)
    corners = np.array([[[x, y, z] for x in (-0.1, 0.1) for y in (-0.1, 0.1) for z in (0.9, 1.1)],
                        [[x, y, -z] for x in (-0.1, 0.1) for y in (-0.1, 0.1) for z in (0.9, 1.1)]],
                       np.float32)
    printed = {}
    for side, main in (("jax", jax_main), ("port", port_main)):
        out = tmp_path / side / "42898867"
        assert main(["convert", str(cap), str(out)]) == 0
        assert main(["classify", str(out)]) == 0
        assert main(["rotate", str(out)]) == 0
        np.save(out / "gt_boxes.npy", corners)
        assert main(["filter-gt", str(out)]) == 0
        labelled = tmp_path / side / "labelled"
        _labelled_sequence(labelled)
        assert main(["filter-gt", str(labelled), "--out", str(labelled / "kept.npy")]) == 0
        printed[side] = capsys.readouterr().out.replace(str(tmp_path / side), "<root>")
    jax_files, port_files = _tree_bytes(tmp_path / "jax"), _tree_bytes(tmp_path / "port")
    assert sorted(jax_files) == sorted(port_files)
    assert {"42898867/all_poses.npy", "42898867/after_filter_boxes.npy",
            "labelled/kept.npy", "labelled/after_filter_labels.npy"} <= set(port_files)
    for name in jax_files:
        assert jax_files[name] == port_files[name], name
    assert printed["jax"] == printed["port"]
