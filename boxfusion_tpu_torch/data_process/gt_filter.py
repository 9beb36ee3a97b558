"""GT box filtering: frustum culling + mesh-proximity check.

Capability target: data_process/filter_gt_boxes.py (reference 1-152):
  * a GT box survives frustum culling when >= 6 of its 8 corners project
    inside some frame (z in (near, far), uv in bounds), accumulated over
    all frames (filter_gt_boxes.py:24-68);
  * surviving boxes must have >= 4 corners within ``dist_threshold`` of the
    GT point cloud (scipy KDTree, filter_gt_boxes.py:75-93);
  * results are written as ``after_filter_boxes.npy``.

PLY point clouds are read with a built-in minimal parser (ascii or binary
little-endian), removing the open3d dependency.
"""
from __future__ import annotations

import os
import struct
from typing import Optional, Tuple

import numpy as np
from scipy.spatial import KDTree


def read_ply_points(path: str) -> np.ndarray:
    """Read vertex positions from an ascii or binary_little_endian PLY."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt = None
        n_vertex = 0
        props = []
        in_vertex = False
        while True:
            line = f.readline().strip()
            if line.startswith(b"format"):
                fmt = line.split()[1].decode()
            elif line.startswith(b"element"):
                parts = line.split()
                in_vertex = parts[1] == b"vertex"
                if in_vertex:
                    n_vertex = int(parts[2])
            elif line.startswith(b"property") and in_vertex:
                parts = line.split()
                props.append((parts[-1].decode(), parts[1].decode()))
            elif line == b"end_header":
                break

        type_map = {
            "float": ("f", 4), "float32": ("f", 4), "double": ("d", 8),
            "float64": ("d", 8), "uchar": ("B", 1), "uint8": ("B", 1),
            "char": ("b", 1), "int8": ("b", 1), "short": ("h", 2),
            "ushort": ("H", 2), "int": ("i", 4), "int32": ("i", 4),
            "uint": ("I", 4), "uint32": ("I", 4),
        }
        if fmt == "ascii":
            pts = []
            names = [p[0] for p in props]
            ix, iy, iz = names.index("x"), names.index("y"), names.index("z")
            for _ in range(n_vertex):
                vals = f.readline().split()
                pts.append((float(vals[ix]), float(vals[iy]), float(vals[iz])))
            return np.asarray(pts, np.float64)
        if fmt != "binary_little_endian":
            raise ValueError(f"unsupported PLY format {fmt}")

        fmt_str = "<" + "".join(type_map[t][0] for _, t in props)
        size = struct.calcsize(fmt_str)
        names = [p[0] for p in props]
        ix, iy, iz = names.index("x"), names.index("y"), names.index("z")
        raw = f.read(size * n_vertex)
        out = np.empty((n_vertex, 3), np.float64)
        for i, rec in enumerate(struct.iter_unpack(fmt_str, raw)):
            out[i] = (rec[ix], rec[iy], rec[iz])
        return out


def frustum_culling_mask(
    corners: np.ndarray,
    K: np.ndarray,
    poses: np.ndarray,
    image_hw: Tuple[int, int],
    near: float = 0.1,
    far: float = 100.0,
) -> np.ndarray:
    """(N,) keep mask: >= 6 corners visible in some frame, accumulated
    over frames (filter_gt_boxes.py:24-68)."""
    N = corners.shape[0]
    H, W = image_hw
    hom = np.concatenate([corners, np.ones((N, 8, 1))], axis=-1)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    bbox_mask = np.zeros((N, 8), bool)
    for pose in poses:
        cam = hom @ np.linalg.inv(pose).T
        x, y, z = cam[..., 0], cam[..., 1], cam[..., 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            u = (fx * x / z + cx).astype(np.int64)
            v = (fy * y / z + cy).astype(np.int64)
        valid = (z > near) & (z < far) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        bbox_mask |= valid
    return bbox_mask.sum(axis=1) >= 6


def proximity_mask(
    corners: np.ndarray, gt_points: np.ndarray, threshold: float = 0.1
) -> np.ndarray:
    """(N,) keep mask: >= 4 corners within threshold of the point cloud
    (filter_gt_boxes.py:75-93)."""
    tree = KDTree(gt_points)
    out = np.zeros(len(corners), bool)
    for i, box in enumerate(corners):
        dists, _ = tree.query(box, k=1)
        out[i] = np.sum(dists < threshold) >= 4
    return out


def filter_gt_boxes(
    corners: np.ndarray,
    K: np.ndarray,
    poses: np.ndarray,
    image_hw: Tuple[int, int],
    gt_points: Optional[np.ndarray] = None,
    near: float = 0.1,
    far: float = 100.0,
    dist_threshold: float = 0.1,
    save_path: Optional[str] = None,
    labels: Optional[np.ndarray] = None,
):
    """Full GT filter: frustum culling then mesh proximity.

    Args:
      corners: (N, 8, 3) world GT corners.
      poses: (M, 4, 4) camera-to-world.
      gt_points: optional (P, 3) mesh/point cloud; skip proximity if None.
      labels: optional (N,) per-box class labels, filtered in lockstep
        (beyond the reference, whose filter keeps only corners: enables
        per-class AP against the open-vocab labels the pipeline assigns).

    Returns:
      ``(corners, labels)`` -- (K, 8, 3) surviving corners and the surviving
      labels ((K,) array, or None when no labels were given).  ``save_path``
      writes the corners (after_filter_boxes.npy) and, with labels, a
      sibling after_filter_labels.npy.
    """
    keep = frustum_culling_mask(corners, K, poses, image_hw, near, far)
    visible = corners[keep]
    kept_labels = np.asarray(labels)[keep] if labels is not None else None
    if gt_points is not None and len(visible):
        prox = proximity_mask(visible, gt_points, dist_threshold)
        visible = visible[prox]
        if kept_labels is not None:
            kept_labels = kept_labels[prox]
    if save_path:
        np.save(save_path, visible)
        if kept_labels is not None:
            np.save(
                os.path.join(
                    os.path.dirname(save_path) or ".", "after_filter_labels.npy"
                ),
                kept_labels,
            )
    return visible, kept_labels
