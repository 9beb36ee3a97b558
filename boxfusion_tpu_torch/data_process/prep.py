"""Offline CA-1M data preparation.

Capability targets (reference data_process/):
  * ``ca1m_unzip.bash``: extract the per-sequence .tar archives;
  * ``process2slam.py``: re-layout raw captures
    (``ca1m-val-<seq>/<seq>/<frame>.wide/image.png``, ``.gt/depth.png``,
    ``.gt/RT.json``, ``.wide/T_gravity.json``, ``.gt/{image,depth}/K.json``)
    into the SLAM-style folders the online readers consume:
    ``rgb/<i>.png``, ``depth/<i>.png``, ``all_poses.npy``, ``T_gravity.npy``,
    ``K_rgb.txt``, ``K_depth.txt``, plus the GT ``instances.json`` copy
    (process2slam_gtbox.py);
  * ``check_img.py``: classify sequences portrait vs landscape by majority
    of depth-map aspect ratios;
  * ``rot_img.py``: rotate the minority-orientation frames upright.

All PIL/numpy -- no cv2/open3d required.
"""
from __future__ import annotations

import json
import os
import shutil
import tarfile
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image


def extract_archives(root: str, out_dir: Optional[str] = None) -> List[str]:
    """Extract every ``*.tar`` under root (ca1m_unzip.bash equivalent)."""
    out_dir = out_dir or root
    done = []
    for name in sorted(os.listdir(root)):
        if not name.endswith(".tar"):
            continue
        dest = os.path.join(out_dir, name[: -len(".tar")])
        os.makedirs(dest, exist_ok=True)
        with tarfile.open(os.path.join(root, name)) as tf:
            tf.extractall(dest, filter="data")
        done.append(dest)
    return done


def _read_json_matrix(path: str) -> np.ndarray:
    with open(path) as f:
        return np.asarray(json.load(f), dtype=np.float64)


def convert_capture_to_slam(capture_dir: str, target_dir: str) -> Dict[str, int]:
    """One raw capture sequence -> SLAM layout (process2slam.py parity).

    Args:
      capture_dir: the ``<seq>`` directory holding ``<frame>.wide`` /
        ``<frame>.gt`` subdirs and ``world.gt/instances.json``.
      target_dir: output sequence directory.

    Returns:
      dict(frames=..., skipped=...).
    """
    os.makedirs(os.path.join(target_dir, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(target_dir, "depth"), exist_ok=True)

    # numeric ids must sort temporally ('2' < '10'), lexicographic otherwise
    frame_ids = sorted(
        {n.split(".")[0] for n in os.listdir(capture_dir) if "world" not in n},
        key=lambda f: (0, int(f)) if f.isdigit() else (1, f),
    )

    poses, gravities, k_rgb, k_depth = [], [], [], []
    count, skipped = 0, 0
    for fid in frame_ids:
        wide = os.path.join(capture_dir, fid + ".wide")
        gt = os.path.join(capture_dir, fid + ".gt")
        rgb_p = os.path.join(wide, "image.png")
        depth_p = os.path.join(gt, "depth.png")
        if not (os.path.exists(rgb_p) and os.path.exists(depth_p)):
            skipped += 1
            continue

        poses.append(_read_json_matrix(os.path.join(gt, "RT.json")))
        gravities.append(_read_json_matrix(os.path.join(wide, "T_gravity.json")))
        k_rgb.append(_read_json_matrix(os.path.join(gt, "image", "K.json")))
        k_depth.append(_read_json_matrix(os.path.join(gt, "depth", "K.json")))

        shutil.copy2(rgb_p, os.path.join(target_dir, "rgb", f"{count}.png"))
        shutil.copy2(depth_p, os.path.join(target_dir, "depth", f"{count}.png"))
        count += 1

    if not poses:
        raise ValueError(
            f"no frames with both rgb and depth found in {capture_dir} "
            f"({skipped} skipped)"
        )
    np.save(os.path.join(target_dir, "all_poses.npy"), np.stack(poses))
    np.save(os.path.join(target_dir, "T_gravity.npy"), np.stack(gravities))
    np.savetxt(os.path.join(target_dir, "K_rgb.txt"), np.mean(k_rgb, axis=0))
    np.savetxt(os.path.join(target_dir, "K_depth.txt"), np.mean(k_depth, axis=0))

    gt_ins = os.path.join(capture_dir, "world.gt", "instances.json")
    if os.path.exists(gt_ins):
        shutil.copy2(gt_ins, os.path.join(target_dir, "instances.json"))

    return dict(frames=count, skipped=skipped)


def classify_sequence_orientation(seq_dir: str) -> Tuple[str, int, int]:
    """Majority portrait-vs-landscape vote over depth maps (check_img.py).

    Returns ("vertical"|"horizontal", v_count, h_count)."""
    depth_dir = os.path.join(seq_dir, "depth")
    v = h = 0
    for name in os.listdir(depth_dir):
        with Image.open(os.path.join(depth_dir, name)) as im:
            w, hh = im.size
        if hh > w:
            v += 1
        else:
            h += 1
    return ("vertical" if v > h else "horizontal"), v, h


def rotate_sequence_upright(seq_dir: str) -> int:
    """Rotate minority-orientation rgb/depth frames by 90 degrees toward the
    majority orientation (rot_img.py parity).  Returns the number of
    rotated frames."""
    kind, v, h = classify_sequence_orientation(seq_dir)
    want_portrait = kind == "vertical"
    rotated = 0
    for sub in ("rgb", "depth"):
        d = os.path.join(seq_dir, sub)
        if not os.path.isdir(d):
            continue
        for name in os.listdir(d):
            p = os.path.join(d, name)
            with Image.open(p) as im:
                w, hh = im.size
                is_portrait = hh > w
                if is_portrait != want_portrait:
                    im.transpose(Image.ROTATE_90).save(p)
                    rotated += 1
    return rotated
