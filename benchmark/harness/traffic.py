"""The one traffic generator: scans of a posed RGB-D stream, made from the seed.

A frozen copy of the synthetic scene of ``data/synthetic.py:
SyntheticSequence`` (a ring of cameras orbiting a room, noise images, depth
about 2.5 m), widened to what a traffic file asks for: the frame size, the
keyframe gap, the frames per scan and the scans in the cycle.  Only the
frames the engine reads (the keyframes) are made; the others are counted.

Every seed gives the same sizes, the same keyframe pattern and the same
orbit; the seed only changes the content: where on the orbit a scan starts,
the pixels and the depth.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class Frame:
    """One posed RGB-D frame, with the attributes the engine reads."""

    image: np.ndarray      # (H, W, 3) uint8
    depth: np.ndarray      # (H, W) float32 metres, on the depth-scale grid
    K: np.ndarray          # (3, 3)
    K_depth: np.ndarray    # (3, 3)
    T_gravity: np.ndarray  # (3, 3)
    gt_pose: np.ndarray    # (4, 4) camera-to-world
    video_id: str
    timestamp: int


@dataclasses.dataclass
class Scan:
    """One scan: ``n_frames`` stream frames, of which ``frames`` (keyed by
    stream index) are the keyframes."""

    n_frames: int
    frames: dict

    @property
    def keyframes(self) -> List[int]:
        return sorted(self.frames)


def keyframe_indices(n_frames: int, gap: int) -> List[int]:
    """The engine's keyframes: every ``gap``-th frame and the last one
    (``DevicePipeline.run``, after the reference's demo.py)."""
    return sorted({i for i in range(n_frames) if i % gap == 0} | {n_frames - 1})


def _look_at_pose(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Upright camera-to-world pose (y down, z forward) in a z-up world."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    down = np.array([0.0, 0.0, -1.0])
    right = np.cross(down, fwd)
    n = np.linalg.norm(right)
    right = np.array([1.0, 0.0, 0.0]) if n < 1e-6 else right / n
    down_o = np.cross(fwd, right)
    P = np.eye(4, dtype=np.float32)
    P[:3, :3] = np.stack([right, down_o, fwd], axis=1)
    P[:3, 3] = eye
    return P


def make_scan(traffic: dict, seed: int, index: int) -> Scan:
    """Scan ``index`` of the cycle for ``seed``."""
    h, w = traffic["frame_hw"]
    n_frames, gap = int(traffic["frames_per_scan"]), int(traffic["gap"])
    depth_scale = float(traffic["depth_scale"])
    lo, hi = traffic["depth_m"]
    rng = np.random.default_rng([int(seed), int(index)])
    radius, height = float(traffic["orbit_radius_m"]), float(traffic["orbit_height_m"])
    phase = rng.uniform(0.0, 2.0 * np.pi)
    sweep = float(traffic["orbit_sweep_deg"]) * np.pi / 180.0
    target = np.array([0.0, 0.0, 0.7])
    f = 0.9 * max(h, w)
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    frames = {}
    for i in keyframe_indices(n_frames, gap):
        ang = phase + sweep * i / n_frames
        eye = np.array([radius * np.cos(ang), radius * np.sin(ang), height])
        image = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        depth = rng.uniform(lo, hi, (h, w))
        # on the depth-scale grid, so the engine's u16 transport is lossless
        depth = (np.round(depth * depth_scale) / depth_scale).astype(np.float32)
        frames[i] = Frame(image=image, depth=depth, K=K, K_depth=K,
                          T_gravity=np.eye(3, dtype=np.float32),
                          gt_pose=_look_at_pose(eye, target), video_id=f"scan{index}", timestamp=i)
    return Scan(n_frames=n_frames, frames=frames)


def make_scans(traffic: dict, seed: int) -> List[Scan]:
    """The cycle of scans a run streams, in order."""
    return [make_scan(traffic, seed, i) for i in range(int(traffic["scans"]))]
