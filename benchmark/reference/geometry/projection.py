"""Pinhole projection utilities (torch).

Port of ``boxfusion_tpu/geometry/projection.py``.  Parity targets:
  * Instances3D.project_3d_boxes (reference instances.py:333-369): world
    corners -> per-view clamped pixel corners.
  * Instances3D.project_3d_to_2d_box (reference instances.py:670-717):
    world corners -> tight 2D xyxy with z in (0, 8) validity.
  * tools/utils.unproject (reference tools/utils.py:245-287).
"""
from __future__ import annotations

import torch


def world_to_camera(points: torch.Tensor, cam_pose: torch.Tensor) -> torch.Tensor:
    """Transform world points into the camera frame given camera-to-world pose.

    Args:
      points: (..., P, 3) world points.
      cam_pose: (..., 4, 4) camera-to-world.

    Returns:
      (..., P, 3) camera-frame points: R^T (p - t).
    """
    rp = cam_pose[..., :3, :3]
    tp = cam_pose[..., :3, 3]
    return torch.einsum("...ji,...pj->...pi", rp, points - tp[..., None, :])


def project_points(points_cam: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pinhole projection of camera-frame points (no clamping).

    Args:
      points_cam: (..., P, 3).
      K: (3, 3) or broadcastable (..., 3, 3).

    Returns:
      (..., P, 2) pixel coordinates (u, v).
    """
    fx = K[..., 0, 0]
    fy = K[..., 1, 1]
    cx = K[..., 0, 2]
    cy = K[..., 1, 2]
    z = points_cam[..., 2]
    u = fx[..., None] * points_cam[..., 0] / z + cx[..., None]
    v = fy[..., None] * points_cam[..., 1] / z + cy[..., None]
    return torch.stack([u, v], dim=-1)


def project_corners_to_image(
    corners: torch.Tensor, cam_pose: torch.Tensor, K: torch.Tensor, H: float, W: float
) -> torch.Tensor:
    """World corners -> clamped pixel corners per view.

    Matches Instances3D.project_3d_boxes: u clamped to [0, W], v to [0, H].

    Args:
      corners: (..., 8, 3) world corners.
      cam_pose: (..., 4, 4) camera-to-world per box/view.
      K: (3, 3).

    Returns:
      (..., 8, 2) clamped pixel corners.
    """
    uv = project_points(world_to_camera(corners, cam_pose), K)
    u = torch.clamp(uv[..., 0], 0.0, float(W))
    v = torch.clamp(uv[..., 1], 0.0, float(H))
    return torch.stack([u, v], dim=-1)


def project_boxes_to_2d(
    corners: torch.Tensor,
    K: torch.Tensor,
    cam_pose: torch.Tensor,
    H: float,
    W: float,
    z_max: float = 8.0,
) -> torch.Tensor:
    """World corners -> tight xyxy 2D boxes in one view, with validity masking.

    Parity with Instances3D.project_3d_to_2d_box (instances.py:670-717): a
    corner participates when 0 < z < z_max; if a box has no corner with
    (z>0, in-bounds uv) OR no corner passing the z-window, its 2D box is
    all-zero.  Corner uv are clipped to the image before min/max.

    Args:
      corners: (N, 8, 3) world corners.
      K: (3, 3).
      cam_pose: (4, 4) camera-to-world for the single view.

    Returns:
      (N, 4) xyxy boxes.
    """
    cam = world_to_camera(corners, cam_pose[None])
    uv = project_points(cam, K)
    z = cam[..., 2]
    u, v = uv[..., 0], uv[..., 1]
    H, W = float(H), float(W)

    strict_valid = (z > 0) & (u > 0) & (u < W) & (v > 0) & (v < H)
    z_valid = (z > 0) & (z < z_max)

    u_c = torch.clamp(u, 0.0, W)
    v_c = torch.clamp(v, 0.0, H)

    big = 1e30
    x1 = torch.where(z_valid, u_c, big).amin(-1)
    y1 = torch.where(z_valid, v_c, big).amin(-1)
    x2 = torch.where(z_valid, u_c, -big).amax(-1)
    y2 = torch.where(z_valid, v_c, -big).amax(-1)
    box = torch.stack([x1, y1, x2, y2], dim=-1)

    ok = strict_valid.any(-1) & z_valid.any(-1)
    return torch.where(ok[:, None], box, 0.0)


