"""Visualization: rerun logging of the online box stream (torch).

Port of ``boxfusion_tpu/utils/viz.py``.  Capability target: the rerun
Blueprint + per-frame logging of the reference (demo.py:34-65,174-197) and
``visualize_online_boxes`` (tools/utils.py:37-96), plus the box-mesh PLY
export (tools/utils.py:99-140, without the open3d dependency -- PLY is
written directly).  The GT point cloud is backprojected by the port's
``geometry.projection.unproject_depth`` on the CPU (float32).

All rerun calls are gated on the SDK being importable; without it the
functions are no-ops so the pipeline runs headless.
"""
from __future__ import annotations

import colorsys
from typing import Optional

import numpy as np

try:
    import rerun  # type: ignore

    HAS_RERUN = True
except Exception:  # pragma: no cover - rerun not installed in CI image
    rerun = None
    HAS_RERUN = False


def random_color_v2(t: float):
    """Hue-spread color ramp (reference color.py:100-107 equivalent)."""
    r, g, b = colorsys.hsv_to_rgb(t % 1.0, 0.85, 0.95)
    return [int(255 * r), int(255 * g), int(255 * b)]


def make_blueprint(is_depth_model: bool = True):
    """The reference's 3-pane viewer layout (demo.py:35-65): a World 3D view
    over an Image pane (with box overlays) and, for RGB-D, a Depth pane."""
    if not HAS_RERUN:
        return None
    import rerun.blueprint as rrb

    return rrb.Blueprint(
        rrb.Vertical(
            contents=[
                rrb.Horizontal(
                    contents=[
                        rrb.Spatial3DView(
                            name="World",
                            contents=[
                                "+ $origin/**",
                                "+ /device/wide/pred_instances/**",
                            ],
                            origin="/world",
                        )
                    ]
                ),
                rrb.Horizontal(
                    contents=(
                        [
                            rrb.Spatial2DView(
                                name="Image",
                                origin="/device/wide/image",
                                contents=[
                                    "+ $origin/**",
                                    "+ /device/wide/pred_instances/**",
                                ],
                            )
                        ]
                        + (
                            [rrb.Spatial2DView(name="Depth", origin="/device/wide/depth")]
                            if is_depth_model
                            else []
                        )
                    ),
                    name="Wide",
                ),
            ]
        )
    )


def init_recording(video_id: str, blueprint=None, is_depth_model: bool = True):
    _trajectory.clear()  # fresh polyline per recording (multi-sequence runs)
    if not HAS_RERUN:
        return None
    rec = rerun.new_recording(application_id=str(video_id), make_default=True)
    bp = blueprint if blueprint is not None else make_blueprint(is_depth_model)
    if bp is not None:
        rec.send_blueprint(bp, make_active=True)
    rerun.spawn()
    return rec


def log_gt_point_cloud(frame, max_depth: float = 10.0) -> None:
    """Backproject the frame's GT depth to a colored world point cloud
    (reference demo.py:121-127 via tools/utils.py:245-287) under /world/xyz,
    so predictions can be compared against the scene geometry."""
    if not HAS_RERUN or frame.depth is None:
        return
    import torch
    from PIL import Image

    from boxfusion_tpu_torch.geometry.projection import unproject_depth

    dh, dw = frame.depth.shape[:2]
    matched = np.asarray(Image.fromarray(frame.image).resize((dw, dh)))
    xyz, valid = unproject_depth(
        torch.as_tensor(np.asarray(frame.depth, np.float32)),
        torch.as_tensor(np.asarray(frame.K_depth, np.float32)),
        torch.as_tensor(np.asarray(frame.gt_pose, np.float32)),
        max_depth=max_depth,
    )
    v = np.asarray(valid)
    rerun.log(
        "/world/xyz",
        rerun.Points3D(
            positions=np.asarray(xyz)[v], colors=(matched[v] / 255.0)
        ),
    )


_trajectory: list = []


def log_frame(frame, pose: np.ndarray) -> None:
    """Log camera pose + image + depth + trajectory (demo.py:174-197)."""
    if not HAS_RERUN:
        return
    ts = getattr(frame, "timestamp", None)
    if ts is not None:
        rerun.set_time_seconds("pts", float(ts))  # demo.py:103
    _trajectory.append(np.asarray(pose[:3, 3], np.float32).copy())
    if len(_trajectory) > 1:
        rerun.log(
            "/device/trajectory",
            rerun.LineStrips3D([np.stack(_trajectory)], colors=[[0, 200, 255]]),
        )
    from scipy.spatial.transform import Rotation

    tf = rerun.Transform3D(
        translation=pose[:3, 3],
        rotation=rerun.Quaternion(xyzw=Rotation.from_matrix(pose[:3, :3]).as_quat()),
    )
    cam = rerun.Pinhole(
        image_from_camera=frame.K, resolution=(frame.image.shape[1], frame.image.shape[0])
    )
    rerun.log("/device/wide/image", tf)
    rerun.log("/device/wide/image", rerun.Image(frame.image).compress())
    rerun.log("/device/wide/image", cam)
    if frame.depth is not None:
        rerun.log("/device/wide/depth", rerun.DepthImage(frame.depth))


def visualize_online_boxes(
    world,
    prefix: str = "/device/wide",
    log_instances_name: str = "pred_instances",
    show_class: bool = False,
    show_label: bool = True,
) -> None:
    """Log the fused world box set (tools/utils.py:37-96).

    Accepts either the host engine's world object (``.arrays``/
    ``.categories``) or the device engine's exported dict
    (``runtime/device_state.py::export_world``)."""
    # emptiness first: an empty host WorldState has arrays == {} (no
    # "xyzlhw" key to index), an empty device export has zero-row arrays
    n = len(world["scores"]) if isinstance(world, dict) else len(world)
    if not HAS_RERUN or n == 0:
        return
    if isinstance(world, dict):
        xyzlhw, R = np.asarray(world["xyzlhw"]), np.asarray(world["R"])
        categories = world.get("categories")
    else:
        xyzlhw, R = world.arrays["xyzlhw"], world.arrays["R"]
        categories = getattr(world, "categories", None)
    from scipy.spatial.transform import Rotation

    centers = xyzlhw[:, :3]
    sizes = xyzlhw[:, 3:]
    quats = [
        rerun.Quaternion(xyzw=Rotation.from_matrix(R[i]).as_quat())
        for i in range(n)
    ]
    colors = [random_color_v2(i / n) for i in range(n)]
    labels = (
        list(categories) if show_class and categories is not None
        else [str(i) for i in range(n)]
    )
    rerun.log(
        f"{prefix}/{log_instances_name}",
        rerun.Boxes3D(
            centers=centers,
            sizes=sizes,
            quaternions=quats,
            colors=colors,
            labels=labels,
            show_labels=show_label,
        ),
    )


def boxes3d_to_ply(sizes, centers, colors, rotations, output_path: str) -> None:
    """Export boxes as a triangle mesh PLY (tools/utils.py:99-140), written
    directly (ascii PLY) instead of via open3d."""
    tmpl = np.array(
        [[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
         [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]],
        np.float64,
    )
    faces_tmpl = np.array(
        [[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
         [1, 2, 6], [1, 6, 5], [2, 3, 7], [2, 7, 6], [3, 0, 4], [3, 4, 7]],
        np.int32,
    )
    verts, faces, vcols = [], [], []
    for i in range(len(centers)):
        c = tmpl * (np.asarray(sizes[i]) / 2.0)
        c = c @ np.asarray(rotations[i]).T + np.asarray(centers[i])
        verts.append(c)
        faces.append(faces_tmpl + 8 * i)
        vcols.extend([colors[i]] * 8)
    # an empty box set writes a valid empty mesh instead of np.vstack([])
    # raising (short sequences can legitimately fuse zero boxes)
    v = np.vstack(verts) if verts else np.zeros((0, 3), np.float32)
    f = np.vstack(faces) if faces else np.zeros((0, 3), np.int32)
    with open(output_path, "w") as fh:
        fh.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(v)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            f"element face {len(f)}\n"
            "property list uchar int vertex_indices\nend_header\n"
        )
        for p, col in zip(v, vcols):
            fh.write(f"{p[0]} {p[1]} {p[2]} {int(col[0])} {int(col[1])} {int(col[2])}\n")
        for tri in f:
            fh.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n")
