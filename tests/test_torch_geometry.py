"""The port's geometry against the JAX package's, on random boxes (CPU).

Bounds: corners and projections within 1e-5 (relative for pixel-scale
values); OBB IoU within 1e-4 (one lattice point of the 25^3 grid is
~6e-5 of a box); keep-or-merge decisions at the association's
``nms_threshold`` of 0.1 identical.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boxfusion_tpu.fusion.association import iou_block as jax_iou_block
from boxfusion_tpu.fusion.association import keyframe_geometry as jax_keyframe_geometry
from boxfusion_tpu.geometry.boxes import box_corners as jax_box_corners
from boxfusion_tpu.geometry.iou import obb_grid_iou as jax_obb_grid_iou
from boxfusion_tpu.geometry.projection import project_boxes_to_2d as jax_project_2d
from boxfusion_tpu.geometry.projection import project_corners_to_image as jax_project

from boxfusion_tpu_torch.fusion.association import iou_block, keyframe_geometry
from boxfusion_tpu_torch.geometry.boxes import box_corners
from boxfusion_tpu_torch.geometry.iou import obb_grid_iou
from boxfusion_tpu_torch.geometry.projection import project_boxes_to_2d, project_corners_to_image

torch.set_num_threads(2)

NMS_THRESHOLD = 0.1


def _yaw(angles):
    c, s = np.cos(angles), np.sin(angles)
    z, o = np.zeros_like(c), np.ones_like(c)
    return np.stack([c, -s, z, s, c, z, z, z, o], -1).reshape(-1, 3, 3).astype(np.float32)


def _boxes(n, seed):
    rng = np.random.RandomState(seed)
    xyzlhw = np.concatenate(
        [rng.uniform(-1.0, 1.0, (n, 3)), rng.uniform(0.2, 0.8, (n, 3))], 1
    ).astype(np.float32)
    return xyzlhw, _yaw(rng.uniform(-np.pi, np.pi, n))


def _scene(seed=0):
    """Old boxes, and new detections of half of them (jittered) plus strays."""
    rng = np.random.RandomState(seed + 100)
    old_t, old_R = _boxes(12, seed)
    new_t = np.concatenate([old_t[:6] + rng.normal(0, 0.05, (6, 6)), _boxes(4, seed + 1)[0]])
    new_t = new_t.astype(np.float32)
    new_R = np.concatenate([old_R[:6] @ _yaw(rng.normal(0, 0.1, 6)), _boxes(4, seed + 1)[1]])
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.2, -0.1, -3.0]
    K = np.array([[300.0, 0, 256], [0, 300.0, 192], [0, 0, 1]], np.float32)
    return old_t, old_R, new_t, new_R.astype(np.float32), pose, K


def test_box_corners_and_projections_match_jax():
    t, R = _boxes(20, 0)
    pose = _scene()[4]
    K = _scene()[5]
    want = np.asarray(jax_box_corners(jnp.asarray(t), jnp.asarray(R)))
    got = box_corners(torch.from_numpy(t), torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    poses = np.tile(pose[None], (20, 1, 1))
    want_uv = np.asarray(jax_project(jnp.asarray(want), jnp.asarray(poses), jnp.asarray(K), 384.0, 512.0))
    got_uv = project_corners_to_image(torch.from_numpy(got), torch.from_numpy(poses),
                                      torch.from_numpy(K), 384.0, 512.0).numpy()
    np.testing.assert_allclose(got_uv, want_uv, rtol=1e-5, atol=1e-5)

    want_2d = np.asarray(jax_project_2d(jnp.asarray(want), jnp.asarray(K), jnp.asarray(pose), 384.0, 512.0))
    got_2d = project_boxes_to_2d(torch.from_numpy(got), torch.from_numpy(K),
                                 torch.from_numpy(pose), 384.0, 512.0).numpy()
    np.testing.assert_allclose(got_2d, want_2d, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_keyframe_geometry_matches_jax(seed):
    """Gated IoU rows (gate + 25^3 lattice), observation corners and global
    2D projections; identical keep-or-merge decisions at 0.1."""
    old_t, old_R, new_t, new_R, pose, K = _scene(seed)
    all_t = np.concatenate([old_t, new_t])
    all_R = np.concatenate([old_R, new_R])
    poses = np.tile(pose[None], (len(new_t), 1, 1))
    want = jax_keyframe_geometry(new_t, new_R, poses, all_t, all_R, K, pose, 384.0, 512.0)
    got = keyframe_geometry(new_t, new_R, poses, all_t, all_R, K, pose, 384.0, 512.0, device="cpu")
    for name, g, w in zip(("corners2d", "iou_rows", "proj2d"), got, want):
        tol = 1e-4 if name == "iou_rows" else 1e-5
        np.testing.assert_allclose(g, w, rtol=1e-5 if name != "iou_rows" else 0, atol=tol, err_msg=name)
    rows_t, rows_j = got[1], want[1]
    assert (rows_j > NMS_THRESHOLD).sum() >= 6  # the scene does exercise merges
    np.testing.assert_array_equal(rows_t > NMS_THRESHOLD, rows_j > NMS_THRESHOLD)


def test_obb_grid_iou_and_block_match_jax():
    old_t, old_R, new_t, new_R, _, _ = _scene(3)
    ca = np.asarray(jax_box_corners(jnp.asarray(new_t), jnp.asarray(new_R)))
    cb = np.asarray(jax_box_corners(jnp.asarray(old_t), jnp.asarray(old_R)))
    for i in range(4):
        want = float(jax_obb_grid_iou(jnp.asarray(ca[i]), jnp.asarray(cb[i])))
        got = float(obb_grid_iou(torch.tensor(ca[i]), torch.tensor(cb[i])))
        assert got == pytest.approx(want, abs=1e-4)
    want = jax_iou_block(ca, cb)
    got = iou_block(ca, cb, device="cpu")
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got > NMS_THRESHOLD, want > NMS_THRESHOLD)


def _rotated_unit_boxes(n, spacing=0.4):
    """tests/test_geometry.py:231's scene: unit cubes 0.4 apart along x,
    each under a random rotation (scipy, seed i)."""
    from scipy.spatial.transform import Rotation

    signs = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                      [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], np.float64) / 2
    boxes = [(Rotation.random(random_state=i).as_matrix() @ signs.T).T + [i * spacing, 0, 0]
             for i in range(n)]
    return np.stack(boxes).astype(np.float32)


@pytest.mark.parametrize("n,valid,row_chunk", [
    (5, None, 8),                                    # the JAX package's own case
    (11, [1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 1], 4),     # N not a multiple of row_chunk, a mask
])
def test_pairwise_obb_iou_matches_jax(n, valid, row_chunk):
    """The (N, N) lattice OBB IoU against JAX's to 1e-6; the diagonal and
    every invalid row and column are 0."""
    from boxfusion_tpu.geometry.iou import pairwise_obb_iou as jax_pairwise_obb_iou
    from boxfusion_tpu_torch.geometry import pairwise_obb_iou

    corners = _rotated_unit_boxes(n)
    v = None if valid is None else np.asarray(valid, bool)
    want = np.asarray(jax_pairwise_obb_iou(jnp.asarray(corners), None if v is None else jnp.asarray(v),
                                           row_chunk=row_chunk))
    got = pairwise_obb_iou(torch.tensor(corners), None if v is None else torch.tensor(v),
                           row_chunk=row_chunk).numpy()
    assert got.shape == (n, n)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(np.diag(got), 0.0)
    assert (got[~np.eye(n, dtype=bool)] > 0).any()  # neighbours 0.4 apart overlap
    if v is not None:
        assert not got[~v].any() and not got[:, ~v].any()
