"""Dense math for spatial / correspondence association (torch).

Port of ``boxfusion_tpu/fusion/association.py``.  Capability target: the
*math* inside the reference's association hot spots (instances.py:22-125
greedy NMS IoUs, 333-369 corner projection, 670-717 global-box 2D
projection).  The greedy decision loop stays on the host
(fusion/manager.py); this module computes, in batches on the device:

  * gated OBB IoU rows between new detections and the global set, with the
    reference's vertex-containment gate and 25^3 grid-sampled volumetric
    IoU (geometry/iou.py);
  * world-corner projections into a view (clamped per-corner pixels for the
    fitness, tight xyxy for the correspondence pass).

PyTorch runs eagerly, so unlike the JAX version nothing is padded to
static bucket sizes.  Inputs and outputs are numpy; ``device`` says where
the math runs.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from boxfusion_tpu_torch.geometry.boxes import box_corners
from boxfusion_tpu_torch.geometry.iou import (
    MAX_GATED_PAIRS,
    gated_pair_iou,
    obb_grid_iou_pairs,
    obb_intersect_mask,
)
from boxfusion_tpu_torch.geometry.projection import (
    project_boxes_to_2d,
    project_corners_to_image,
)
from boxfusion_tpu_torch.utils.device import DeviceLike, resolve_device


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32), device=device)


def keyframe_geometry(
    new_t: np.ndarray,
    new_R: np.ndarray,
    new_poses: np.ndarray,
    all_t: np.ndarray,
    all_R: np.ndarray,
    K_depth: np.ndarray,
    cur_pose: np.ndarray,
    H: float,
    W: float,
    samples: int = 25,
    device: DeviceLike = None,
):
    """All association geometry for one keyframe.

    Observation corner projections, the new-vs-all gated OBB IoU rows (the
    shared gate -> first MAX_GATED_PAIRS -> pair-IoU sequence of
    geometry/iou.py), and the global boxes' 2D projections for the
    correspondence pass.

    Returns (corners2d (Nn, 8, 2), iou_rows (Nn, Na), proj2d_all (Na, 4)),
    all numpy.
    """
    dev = resolve_device(device)
    nn_, na = new_t.shape[0], all_t.shape[0]
    K = _f32(K_depth, dev)
    new_corners3d = box_corners(_f32(new_t, dev), _f32(new_R, dev))
    corners2d = project_corners_to_image(new_corners3d, _f32(new_poses, dev), K, H, W)
    all_corners3d = box_corners(_f32(all_t, dev), _f32(all_R, dev))

    pair_idx, vals, n_gated = gated_pair_iou(
        new_corners3d, torch.ones(nn_, dtype=torch.bool, device=dev),
        all_corners3d, torch.ones(na, dtype=torch.bool, device=dev),
        MAX_GATED_PAIRS, samples,
    )
    if n_gated > MAX_GATED_PAIRS:
        warnings.warn(
            f"{n_gated} gated IoU pairs exceed budget {MAX_GATED_PAIRS}; "
            "excess pairs treated as IoU 0"
        )
    rows = torch.zeros(nn_ * na, dtype=torch.float32, device=dev)
    rows[pair_idx] = vals
    proj2d = project_boxes_to_2d(all_corners3d, K, _f32(cur_pose, dev), H, W)
    return (
        corners2d.cpu().numpy(),
        rows.reshape(nn_, na).cpu().numpy(),
        proj2d.cpu().numpy(),
    )


def iou_block(
    corners_a: np.ndarray, corners_b: np.ndarray, samples: int = 25, device: DeviceLike = None
) -> np.ndarray:
    """(A, B) gated OBB IoU block (reference obb_iou semantics, instances.py:573-613).

    Args:
      corners_a: (A, 8, 3) world corners.  corners_b: (B, 8, 3).

    Returns:
      (A, B) numpy IoU matrix.
    """
    A, B = corners_a.shape[0], corners_b.shape[0]
    if A == 0 or B == 0:
        return np.zeros((A, B), np.float32)
    dev = resolve_device(device)
    ca = _f32(corners_a, dev)[:, None].expand(A, B, 8, 3).reshape(A * B, 8, 3)
    cb = _f32(corners_b, dev)[None].expand(A, B, 8, 3).reshape(A * B, 8, 3)
    # the lattice runs only on gated pairs: the gate forces 0 everywhere else
    gated = torch.nonzero(obb_intersect_mask(ca, cb)).reshape(-1)
    iou = torch.zeros(A * B, dtype=torch.float32, device=dev)
    iou[gated] = obb_grid_iou_pairs(ca[gated], cb[gated], samples)
    return iou.reshape(A, B).cpu().numpy()


def project_observation_corners(
    xyzlhw: np.ndarray, R: np.ndarray, cam_pose: np.ndarray, K: np.ndarray, H: float, W: float,
    device: DeviceLike = None,
) -> np.ndarray:
    """World boxes -> per-box clamped 2D corner pixels (instances.py:333-369).

    Args:
      xyzlhw: (N, 6); R: (N, 3, 3); cam_pose: (N, 4, 4) per-box view.

    Returns:
      (N, 8, 2) numpy.
    """
    if xyzlhw.shape[0] == 0:
        return np.zeros((0, 8, 2), np.float32)
    dev = resolve_device(device)
    corners = box_corners(_f32(xyzlhw, dev), _f32(R, dev))
    return project_corners_to_image(corners, _f32(cam_pose, dev), _f32(K, dev), H, W).cpu().numpy()


def project_global_boxes_2d(
    xyzlhw: np.ndarray, R: np.ndarray, K: np.ndarray, cam_pose: np.ndarray, H: float, W: float,
    device: DeviceLike = None,
) -> np.ndarray:
    """World boxes -> tight xyxy in one view (instances.py:670-717).

    Args:
      xyzlhw: (G, 6); R: (G, 3, 3); cam_pose: (4, 4) the current keyframe.

    Returns:
      (G, 4) numpy.
    """
    if xyzlhw.shape[0] == 0:
        return np.zeros((0, 4), np.float32)
    dev = resolve_device(device)
    corners = box_corners(_f32(xyzlhw, dev), _f32(R, dev))
    return project_boxes_to_2d(corners, _f32(K, dev), _f32(cam_pose, dev), H, W).cpu().numpy()
