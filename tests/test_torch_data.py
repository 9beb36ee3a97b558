"""The port's data path against the JAX package's, on the CPU.

  * The CA-1M reader (a copy without the native decoder) on a sequence
    written to disk with the reader module's own writer: identical frames
    when both decode with PIL.
  * Frame packaging (pixel normalization, square pad, depth whitening) on
    the device the frame was uploaded to: within 1e-5 of the JAX program.
  * The geometry helpers no engine test reaches, on random inputs: 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import boxfusion_tpu.geometry as jgeo
from boxfusion_tpu.data.preprocess import Preprocessor as JaxPreprocessor
from boxfusion_tpu.data.readers import CA1MDataset as JaxCA1MDataset
from boxfusion_tpu.data.synthetic import SyntheticSequence as JaxSequence
from boxfusion_tpu.fusion.association import project_global_boxes_2d as jax_project_global
from boxfusion_tpu.fusion.association import project_observation_corners as jax_project_obs
from boxfusion_tpu.utils.config import load_config as jax_load_config

import boxfusion_tpu_torch.geometry as geo
from boxfusion_tpu_torch.data.preprocess import Preprocessor
from boxfusion_tpu_torch.data.readers import CA1MDataset, write_ca1m_sequence
from boxfusion_tpu_torch.data.synthetic import SyntheticSequence
from boxfusion_tpu_torch.fusion.association import project_global_boxes_2d, project_observation_corners
from boxfusion_tpu_torch.utils.config import load_config

torch.set_num_threads(2)


def test_ca1m_reader_roundtrip_matches_jax(tmp_path, monkeypatch):
    """Both readers on their PIL branch (each prefers its native C++
    decoder when that is built); tests/test_torch_native.py holds the two
    native branches to each other."""
    import boxfusion_tpu.data.readers as jax_readers
    import boxfusion_tpu_torch.data.readers as port_readers

    monkeypatch.setattr(jax_readers, "_native", lambda: None)
    monkeypatch.setattr(port_readers, "_native", lambda: None)
    frames = list(SyntheticSequence(n_frames=3, n_boxes=2, seed=0))
    assert write_ca1m_sequence(frames, str(tmp_path)) == 3
    overrides = {"data": {"datadir": str(tmp_path)}}
    got = list(CA1MDataset(load_config("config/ca1m.yaml", overrides)))
    want = list(JaxCA1MDataset(jax_load_config("config/ca1m.yaml", overrides)))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for field in ("image", "depth", "K", "K_depth", "T_gravity", "gt_pose"):
            np.testing.assert_array_equal(getattr(g, field), getattr(w, field), err_msg=field)
        assert (g.video_id, g.timestamp) == (w.video_id, w.timestamp)


@pytest.mark.parametrize("hw,depth_div", [((192, 256), 1), ((384, 512), 4)], ids=["r1", "r4"])
def test_preprocessor_matches_jax(hw, depth_div):
    seq = JaxSequence(n_frames=1, n_boxes=2, image_hw=hw, seed=0)
    fr = next(iter(seq))
    depth = fr.depth[::depth_div, ::depth_div].copy()
    depth[:3, :5] = 0.0  # invalid pixels
    want, wsq, wr = JaxPreprocessor()(fr.image, depth, fr.K, fr.T_gravity)
    got, gsq, gr = Preprocessor(device="cpu")(fr.image, depth, fr.K, fr.T_gravity)
    assert (gsq, gr) == (wsq, wr)
    for field in ("image", "depth", "K", "image_hw", "depth_params", "T_gravity"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   rtol=1e-5, atol=1e-5, err_msg=field)


def _rng_boxes(n=10, seed=0):
    rng = np.random.RandomState(seed)
    t = np.concatenate([rng.uniform(-1, 1, (n, 3)), rng.uniform(0.2, 0.8, (n, 3))], 1).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, (n, 3)).astype(np.float32)
    return t, ang


def _geometry_cases():
    t, ang = _rng_boxes()
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.1, 0.2, -3.0]
    K = np.array([[300.0, 0, 256], [0, 300.0, 192], [0, 0, 1]], np.float32)
    R = np.asarray(jgeo.euler_angles_to_matrix(jnp.asarray(ang), "XYZ"))
    corners = np.asarray(jgeo.box_corners(jnp.asarray(t), jnp.asarray(R)))
    boxes7 = np.concatenate([t, ang[:, :1]], 1)
    xyxy = np.sort(np.random.RandomState(1).uniform(0, 100, (10, 2, 2)), axis=1).reshape(10, 4)
    xyxy = xyxy[:, [0, 2, 1, 3]].astype(np.float32)
    depth = np.random.RandomState(2).uniform(0.5, 9.0, (6, 8)).astype(np.float32)
    return {
        "euler": ((ang, "XYZ"), jgeo.euler_angles_to_matrix, geo.euler_angles_to_matrix),
        "axis_angle": (("Y", ang[:, 0]), jgeo.axis_angle_rotation, geo.axis_angle_rotation),
        "rotate_in_axis": ((corners, ang[:, 1], 2), jgeo.rotation_3d_in_axis, geo.rotation_3d_in_axis),
        "yaw_corners": ((boxes7,), jgeo.yaw_box_corners, geo.yaw_box_corners),
        "to_world": ((t, R, np.tile(pose, (10, 1, 1))), jgeo.boxes_to_world, geo.boxes_to_world),
        "iou_2d": ((xyxy[0], xyxy), jgeo.iou_2d, geo.iou_2d),
        "unproject": ((depth, K, pose), jgeo.unproject_depth, geo.unproject_depth),
    }


GEOMETRY = ["axis_angle", "euler", "iou_2d", "rotate_in_axis", "to_world", "unproject", "yaw_corners"]


@pytest.mark.parametrize("name", GEOMETRY)
def test_geometry_helpers_match_jax(name):
    args, jax_fn, port_fn = _geometry_cases()[name]
    to_j = lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a
    to_t = lambda a: torch.tensor(a) if isinstance(a, np.ndarray) else a
    want = jax_fn(*map(to_j, args))
    got = port_fn(*map(to_t, args))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_box_corners_roundtrip():
    t, ang = _rng_boxes()
    R = geo.euler_angles_to_matrix(torch.tensor(ang), "ZYX")
    from boxfusion_tpu_torch.geometry.boxes import corners_to_params

    back_t, back_R = corners_to_params(geo.box_corners(torch.tensor(t), R))
    np.testing.assert_allclose(back_t.numpy(), t, atol=1e-5)
    np.testing.assert_allclose(back_R.numpy(), R.numpy(), atol=1e-5)


def test_association_projections_match_jax():
    t, ang = _rng_boxes()
    R = np.asarray(jgeo.euler_angles_to_matrix(jnp.asarray(ang), "XYZ"))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.1, 0.2, -3.0]
    K = np.array([[300.0, 0, 256], [0, 300.0, 192], [0, 0, 1]], np.float32)
    poses = np.tile(pose, (10, 1, 1))
    np.testing.assert_allclose(
        project_observation_corners(t, R, poses, K, 384.0, 512.0, device="cpu"),
        jax_project_obs(t, R, poses, K, 384.0, 512.0), rtol=1e-5, atol=1e-5,
    )
    np.testing.assert_allclose(
        project_global_boxes_2d(t, R, K, pose, 384.0, 512.0, device="cpu"),
        jax_project_global(t, R, K, pose, 384.0, 512.0), rtol=1e-5, atol=1e-5,
    )
