"""Result persistence: reference-compatible pickle outputs.

Copy of ``boxfusion_tpu/utils/io.py`` (numpy and pickle only).

Capability target: ``save_box`` / ``load_data`` (reference
tools/utils.py:322-340) and the demo's eval outputs (demo.py:368-387):
per-sequence ``<video_id>_boxes.pkl`` = [[(class_idx, corners (8, 3),
feature), ...]] and ``framewise_boxes.pkl`` over all per-frame observations.
"""
from __future__ import annotations

import os
import pickle
from typing import List

import numpy as np


def save_box(data, filename: str) -> None:
    with open(filename, "wb") as f:
        pickle.dump(data, f, protocol=pickle.HIGHEST_PROTOCOL)
    print(f"Results successfully saved to {filename}")


def load_data(filename: str):
    with open(filename, "rb") as f:
        return pickle.load(f)


def post_process(boxes: np.ndarray, threshold: float = 0.3) -> np.ndarray:
    """Drop boxes with any extent below threshold (tools/utils.py:302-317,
    applied to ScanNet outputs)."""
    rng = boxes.max(axis=1) - boxes.min(axis=1)
    return boxes[(rng >= threshold).all(axis=1)]


def save_eval_pickle(corners: np.ndarray, output_dir: str, video_id: str,
                     dataset: str = "CA1M") -> str:
    """THE writer of the reference's `<video_id>_boxes.pkl` format
    (demo.py:368-381: one frame entry of (class 0, corners (8,3), score 1.0)
    tuples, ScanNet small-box post-filter) -- every producer must route
    through here so the format cannot drift between them."""
    os.makedirs(output_dir, exist_ok=True)
    if str(dataset).lower() == "scannet":
        corners = post_process(corners)
    save_list = [[(int(0), corners[n], 1.0) for n in range(corners.shape[0])]]
    path = os.path.join(output_dir, f"{video_id}_boxes.pkl")
    save_box(save_list, path)
    return path


def save_world_boxes(world, class_list: List[str], output_dir: str, video_id: str,
                     dataset: str = "CA1M") -> str:
    """Persist the fused world set in the reference's eval pickle format."""
    return save_eval_pickle(world.corners(), output_dir, video_id, dataset)


def save_framewise_boxes(obs, features, class_list: List[str],
                         output_dir: str) -> str:
    """Persist all per-frame observations (demo.py:382-387).

    Classes come from the observation store's own per-row categories --
    the world's (compacted) category list would misalign after removals."""
    os.makedirs(output_dir, exist_ok=True)
    from boxfusion_tpu_torch.runtime.pipeline import _corners_np

    corners = _corners_np(obs.xyzlhw, obs.R)
    categories = getattr(obs, "categories", [])
    idx = [class_list.index(c) if c in class_list else 0 for c in categories]
    feats = features if features is not None else [1.0] * len(corners)
    save_list = [[(idx[n] if n < len(idx) else 0, corners[n],
                   feats[n] if n < len(feats) else 1.0)
                  for n in range(corners.shape[0])]]
    path = os.path.join(output_dir, "framewise_boxes.pkl")
    save_box(save_list, path)
    return path
