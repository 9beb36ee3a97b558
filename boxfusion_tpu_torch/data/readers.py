"""Posed RGB-D sequence readers: ScanNetV2 and CA-1M (SLAM-style folders).

Capability target: ``ScannetDataset`` / ``CA1MDataset`` (reference
boxfusion/capture_stream.py:119-529).  Same on-disk layout, same per-frame
semantics:

  * ScanNet: ``color/*.jpg`` + 16-bit ``depth/*.png`` / png_depth_scale +
    per-frame ``pose/*.txt`` with inf-pose fallback to the last valid pose
    (capture_stream.py:157-178); fixed K from the config.
  * CA-1M: ``rgb/*.png`` + ``depth/*.png`` + ``all_poses.npy``; optional
    per-frame intrinsics ``K_all.npy`` and depth scales ``K_scales.npy``
    (capture_stream.py:339-350); the ceiling-facing first-camera pre-rotation
    (capture_stream.py:84-114,486-501).
  * Shared: color resized to the depth resolution, long side capped at 1024
    (capture_stream.py:116,205-206,255-260), orientation inferred from the
    pose z-row, image/depth/K/pose rotated to UPRIGHT, T_gravity computed,
    and the model-facing pose zeroed (RT = I) while the GT pose rides along
    (capture_stream.py:494-522).

I/O stays host-side (PIL + numpy; cv2 is not required); everything yielded
is a plain numpy ``Frame``.  A copy of ``boxfusion_tpu/data/readers.py``:
PNG / JPEG decode and resize take the port's native loader
(``boxfusion_tpu_torch/native``) when it builds, PIL otherwise.
"""
from __future__ import annotations

import dataclasses
import glob
import os
import re
from typing import Iterator, Optional, Tuple

import numpy as np
from PIL import Image

from boxfusion_tpu_torch.geometry.orientation import (
    ImageOrientation,
    check_first_camera,
    first_camera_to_upright,
    get_camera_to_gravity_transform,
    get_orientation,
    revert_first_camera,
    rotate_image,
    rotate_K,
    rotate_pose,
)

MAX_LONG_SIDE = 1024  # capture_stream.py:116


@dataclasses.dataclass
class Frame:
    """One posed RGB-D frame (all numpy, oriented UPRIGHT)."""

    image: np.ndarray          # (H, W, 3) uint8
    depth: Optional[np.ndarray]  # (Hd, Wd) float32 metric
    K: np.ndarray              # (3, 3) image intrinsics (oriented)
    K_depth: np.ndarray        # (3, 3) depth intrinsics (oriented)
    T_gravity: np.ndarray      # (3, 3)
    gt_pose: np.ndarray        # (4, 4) camera-to-world
    video_id: str
    timestamp: int


def _native():
    from boxfusion_tpu_torch.native import get_loader

    return get_loader()


def _resize_rgb(arr: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    if (arr.shape[1], arr.shape[0]) == tuple(size_wh):
        return arr
    nl = _native()
    if nl is not None and arr.dtype == np.uint8 and arr.ndim == 3:
        return nl.resize_rgb(arr, size_wh)
    return np.asarray(Image.fromarray(arr).resize(size_wh, Image.BILINEAR))


def _resize_depth(arr: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    if (arr.shape[1], arr.shape[0]) == tuple(size_wh):
        return arr
    nl = _native()
    if nl is not None:
        return nl.resize_f32(arr.astype(np.float32), size_wh)
    return np.asarray(
        Image.fromarray(arr.astype(np.float32), mode="F").resize(size_wh, Image.BILINEAR)
    )


def _load_rgb(path: str) -> np.ndarray:
    nl = _native()
    if nl is not None:
        with open(path, "rb") as f:
            data = f.read()
        try:
            if path.endswith((".jpg", ".jpeg")):
                return nl.decode_jpeg(data)
            arr = nl.decode_png(data)
            if arr.ndim == 3 and arr.dtype == np.uint8:
                return arr
        except ValueError:
            pass
    return np.asarray(Image.open(path).convert("RGB"))


def _load_depth_png(path: str, scale: float) -> np.ndarray:
    nl = _native()
    if nl is not None:
        with open(path, "rb") as f:
            data = f.read()
        try:
            return nl.decode_png(data).astype(np.float32) / scale
        except ValueError:
            pass
    return np.asarray(Image.open(path)).astype(np.float32) / scale


def _scale_K(K: np.ndarray, sx: float, sy: float) -> np.ndarray:
    out = K.astype(np.float32).copy()
    out[0, :] *= sx
    out[1, :] *= sy
    return out


class _PosedSequence:
    """Shared per-frame orientation / gravity logic of both readers."""

    def _finalize(self, image, depth, K, K_depth, pose, video_id, index, first_camera=False):
        pose = pose.astype(np.float32)
        rt = pose.copy()
        if first_camera:
            rt = first_camera_to_upright(rt)

        current = get_orientation(rt)
        target = ImageOrientation.UPRIGHT
        T_gravity = get_camera_to_gravity_transform(rt, current, target)

        size = (image.shape[1], image.shape[0])
        K = rotate_K(K, current, size, target)
        if depth is not None:
            dsize = (depth.shape[1], depth.shape[0])
            K_depth = rotate_K(K_depth, current, dsize, target)
        rt = rotate_pose(rt, current, target)
        if first_camera:
            rt = revert_first_camera(rt)

        image = np.ascontiguousarray(
            rotate_image(np.moveaxis(image, -1, 0), current, target).transpose(1, 2, 0)
        )
        if depth is not None:
            depth = np.ascontiguousarray(rotate_image(depth, current, target))

        return Frame(
            image=image,
            depth=depth,
            K=K.astype(np.float32),
            K_depth=K_depth.astype(np.float32),
            T_gravity=T_gravity.astype(np.float32),
            gt_pose=pose,  # GT keeps the *unoriented* pose (capture_stream.py:516)
            video_id=video_id,
            timestamp=index,
        )


class ScannetDataset(_PosedSequence):
    """ScanNetV2 frames directory (capture_stream.py:119-311)."""

    def __init__(self, cfg):
        self.cfg = cfg
        base = cfg["data"]["datadir"]
        start = int(cfg["data"]["start"])
        self.img_files = sorted(
            glob.glob(os.path.join(base, "color", "*.jpg")),
            key=lambda x: int(os.path.basename(x)[:-4]),
        )[start:]
        self.depth_files = sorted(
            glob.glob(os.path.join(base, "depth", "*.png")),
            key=lambda x: int(os.path.basename(x)[:-4]),
        )[start:]
        self.poses = self._load_poses(os.path.join(base, "pose"))[start:]

        cam = cfg["cam"]
        self.K = np.array(
            [[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]], [0, 0, 1]],
            np.float32,
        )
        self.size = (int(cam["W"]), int(cam["H"]))
        self.depth_scale = float(cam["png_depth_scale"])
        m = re.findall(r"scene\d{4}_\d{2}", base)
        self.video_id = m[0] if m else os.path.basename(base.rstrip("/"))

    @staticmethod
    def _load_poses(path):
        poses, last_valid = [], None
        for p in sorted(
            glob.glob(os.path.join(path, "*.txt")),
            key=lambda x: int(os.path.basename(x)[:-4]),
        ):
            c2w = np.loadtxt(p).reshape(4, 4)
            if not np.isinf(c2w).any():
                last_valid = c2w
            else:
                c2w = last_valid  # inf-pose fallback (capture_stream.py:170-174)
            poses.append(c2w)
        # leading inf poses (tracking lost at sequence start) have no "last
        # valid" to fall back to: backfill them with the FIRST valid pose so
        # iteration never yields None (identity if the whole sequence is inf).
        first_valid = next((p for p in poses if p is not None), np.eye(4))
        return [p if p is not None else first_valid for p in poses]

    def __len__(self):
        return len(self.img_files)

    def __iter__(self) -> Iterator[Frame]:
        for i in range(len(self.img_files)):
            image = _load_rgb(self.img_files[i])
            depth = _load_depth_png(self.depth_files[i], self.depth_scale)
            # color resized to depth resolution (capture_stream.py:205-206),
            # then both to the configured camera size.
            image = _resize_rgb(image, (depth.shape[1], depth.shape[0]))
            image = _resize_rgb(image, self.size)
            depth = _resize_depth(depth, self.size)
            K = K_depth = self.K
            if max(self.size) > MAX_LONG_SIDE:
                # cap the long side (capture_stream.py:116,255-260); depth and
                # its intrinsics must track the color resize or the square-pad
                # bucketing sees inconsistent resolutions.
                s = MAX_LONG_SIDE / max(self.size)
                new = (int(self.size[0] * s), int(self.size[1] * s))
                image = _resize_rgb(image, new)
                depth = _resize_depth(depth, new)
                K = _scale_K(K, new[0] / self.size[0], new[1] / self.size[1])
                K_depth = K
            yield self._finalize(
                image, depth, K, K_depth, self.poses[i], self.video_id, i
            )


class CA1MDataset(_PosedSequence):
    """CA-1M SLAM-style folder (capture_stream.py:315-529)."""

    def __init__(self, cfg):
        self.cfg = cfg
        base = cfg["data"]["datadir"]
        start = int(cfg["data"]["start"])
        self.img_files = sorted(
            glob.glob(os.path.join(base, "rgb", "*.png")),
            key=lambda x: int(os.path.basename(x)[:-4]),
        )[start:]
        self.depth_files = sorted(
            glob.glob(os.path.join(base, "depth", "*.png")),
            key=lambda x: int(os.path.basename(x)[:-4]),
        )[start:]
        self.poses = np.load(os.path.join(base, "all_poses.npy")).reshape(-1, 4, 4)[start:]

        self.K = np.loadtxt(os.path.join(base, "K_depth.txt")).reshape(3, 3).astype(np.float32)
        # per-frame tables MUST be sliced by the same start offset as the
        # frame lists above -- __iter__ indexes them with the post-slice i
        k_all = os.path.join(base, "K_all.npy")
        self.all_K = np.load(k_all)[start:] if os.path.exists(k_all) else None
        k_scales = os.path.join(base, "K_scales.npy")
        self.scales = np.load(k_scales)[start:] if os.path.exists(k_scales) else None

        cam = cfg["cam"]
        # portrait: height = cam.W (long), width = cam.H (short)
        # (capture_stream.py:359-360)
        self.size = (int(cam["H"]), int(cam["W"]))
        self.depth_scale = float(cam["png_depth_scale"])
        m = re.findall(r"\b4\d{7}\b", base)
        self.video_id = m[0] if m else os.path.basename(base.rstrip("/"))
        self._first_camera: Optional[bool] = None

    def __len__(self):
        return len(self.img_files)

    def __iter__(self) -> Iterator[Frame]:
        for i in range(len(self.img_files)):
            K = self.K
            if self.all_K is not None:
                a = self.all_K[i]
                K = np.array(
                    [[a[0, 0], 0, a[0, 2]], [0, a[1, 1], a[1, 2]], [0, 0, 1]], np.float32
                )
            image = _load_rgb(self.img_files[i])
            depth = _load_depth_png(self.depth_files[i], self.depth_scale)
            if self.scales is not None:
                depth = depth / float(self.scales[i])
            image = _resize_rgb(image, (depth.shape[1], depth.shape[0]))
            image = _resize_rgb(image, self.size)
            depth = _resize_depth(depth, self.size)
            K_depth = K
            if max(self.size) > MAX_LONG_SIDE:
                # cap the long side like the reference's CA-1M branch
                # (capture_stream.py:462-468); without it pick_square_pad
                # raises past the 1024 bucket instead of rescaling
                s = MAX_LONG_SIDE / max(self.size)
                new = (int(self.size[0] * s), int(self.size[1] * s))
                image = _resize_rgb(image, new)
                depth = _resize_depth(depth, new)
                K = _scale_K(K, new[0] / self.size[0], new[1] / self.size[1])
                K_depth = K

            pose = self.poses[i]
            if self._first_camera is None:
                self._first_camera = check_first_camera(pose)
            yield self._finalize(
                image, depth, K, K_depth, pose, self.video_id, i,
                first_camera=bool(self._first_camera),
            )


def write_ca1m_sequence(frames, outdir: str, depth_scale: float = 1000.0) -> int:
    """Serialize ``Frame``s to the CA-1M SLAM folder layout.

    The inverse of ``CA1MDataset``: writes ``rgb/<i>.png``, 16-bit
    ``depth/<i>.png`` (metric depth x ``depth_scale``), ``all_poses.npy``
    (stacked ``gt_pose``) and ``K_depth.txt`` -- the exact on-disk contract
    the reference's reader consumes (capture_stream.py:339-350).  Used to
    round-trip synthetic sequences through the real disk/decode path
    (bench.py's I/O-inclusive figure) and to materialize captures for the
    reference CLI.  Returns the number of frames written.
    """
    rgb_dir = os.path.join(outdir, "rgb")
    dep_dir = os.path.join(outdir, "depth")
    os.makedirs(rgb_dir, exist_ok=True)
    os.makedirs(dep_dir, exist_ok=True)
    poses = []
    n = 0
    for i, fr in enumerate(frames):
        Image.fromarray(fr.image).save(
            os.path.join(rgb_dir, f"{i}.png"), compress_level=1
        )
        # round-half-up, NaN->0: a plain uint16 cast would truncate (up to a
        # full depth-scale unit of error) and leave NaNs undefined
        d = np.nan_to_num(np.asarray(fr.depth, np.float32), nan=0.0)
        d16 = np.clip(np.floor(d * depth_scale + 0.5), 0, 65535).astype(np.uint16)
        Image.fromarray(d16).save(os.path.join(dep_dir, f"{i}.png"))
        poses.append(fr.gt_pose)
        if i == 0:
            np.savetxt(os.path.join(outdir, "K_depth.txt"), fr.K_depth)
        n += 1
    if n == 0:
        raise ValueError(
            f"write_ca1m_sequence: no frames to write to '{outdir}'"
        )
    np.save(os.path.join(outdir, "all_poses.npy"), np.stack(poses))
    return n


def get_dataset(cfg):
    """Dataset factory (reference tools/utils.py:290-300)."""
    name = str(cfg["dataset"]).lower()
    if name == "scannet":
        return ScannetDataset(cfg)
    if name in ("ca1m", "online"):
        return CA1MDataset(cfg)
    raise ValueError(f"Unknown dataset '{cfg['dataset']}'")
