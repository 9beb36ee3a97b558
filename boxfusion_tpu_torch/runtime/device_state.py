"""Device-resident world state for the online pipeline (torch).

Port of ``boxfusion_tpu/runtime/device_state.py``.  The whole keyframe update
-- filters -> association -> manager bookkeeping -> PST fusion -- is a
function ``(DeviceState, detections) -> DeviceState`` over tensors that stay
on one device (runtime/device_step.py).

All state is fixed-capacity and slot-packed: valid world slots are
``[0, n)``; fusion lists are ``(G, V)`` int32 padded with ``PAD_ID`` so the
reference's "sorted list" semantics become plain sorts; the observation
store is an append-only ``(M, ...)`` bank indexed by init_id (the
reference's ever-growing ``per_frame_ins``, demo.py:254).

``state_to_numpy`` / ``state_from_numpy`` give and take the
``{field: ndarray}`` tree that the JAX package's snapshot code builds from
its own DeviceState, so a state can cross between the two packages.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from boxfusion_tpu_torch.utils.device import DeviceLike, resolve_device

PAD_ID = 2**30  # fusion-list padding (sorts after any real id)
STATS_WIDTH = 8  # len of DeviceState.stats (see the field's counter list)

STATS_NAMES = (
    "dropped_world_capacity",
    "dropped_obs_capacity",
    "truncated_gated_pairs",
    "keyframes",
    "label_overflow",
    # fusion-list merges dropping members past max_views (the reference's
    # Python lists are unbounded there)
    "truncated_fusion_members",
    # eligible fusion slots pushed past max_fusions, counted once per
    # (keyframe, slot) occurrence: deferral pressure, not distinct objects
    "deferred_fusions",
    # the JAX package's unrolled-engine NMS budgets hit; the port never
    # writes it, and a snapshot from the JAX package may carry a count here
    "nms_budget_exhausted",
)


@dataclasses.dataclass
class DeviceState:
    """Fixed-capacity world + manager + observation state (all on one device)."""

    # world set (slots [0, n) valid)
    xyzlhw: torch.Tensor      # (G, 6)
    R: torch.Tensor           # (G, 3, 3)
    scores: torch.Tensor      # (G,)
    category: torch.Tensor    # (G,) int32
    pred_boxes: torch.Tensor  # (G, 4) xyxy
    init_id: torch.Tensor     # (G,) int32 -> observation index
    frame_id: torch.Tensor    # (G,) int32
    valid_num: torch.Tensor   # (G,) float32
    n: torch.Tensor           # () int32
    iou: torch.Tensor         # (G, G) cached pairwise OBB IoU

    # fusion manager (box_manager.py:13-17 equivalents)
    flist: torch.Tensor       # (G, V) int32, PAD_ID padded, ascending
    fcount: torch.Tensor      # (G,) int32
    fflag: torch.Tensor       # (G,) bool
    already: torch.Tensor     # (G, V) last fused member list per slot
    already_valid: torch.Tensor  # (G,) bool

    # observation store (append-only)
    obs_pose: torch.Tensor    # (M, 4, 4)
    obs_xyzlhw: torch.Tensor  # (M, 6)
    obs_R: torch.Tensor       # (M, 3, 3)
    obs_score: torch.Tensor   # (M,)
    obs_corners2d: torch.Tensor  # (M, 8, 2)
    obs_n: torch.Tensor       # () int32

    # no-silent-caps counters, cumulative over the sequence (STATS_NAMES):
    # [0] detections dropped because the world set was full,
    # [1] detections dropped because the observation bank was full,
    # [2] containment-gated IoU pairs truncated by max_gated_pairs,
    # [3] keyframes processed,
    # [4] detections past the CLIP label budget,
    # [5] fusion-list members dropped past max_views,
    # [6] eligible fusion slots deferred past max_fusions,
    # [7] the JAX package's unrolled-NMS budget exhaustions (never written
    #     here; kept so that snapshots cross between the packages).
    stats: torch.Tensor       # (STATS_WIDTH,) int32

    @property
    def capacity(self) -> int:
        return self.xyzlhw.shape[0]

    @property
    def max_views(self) -> int:
        return self.flist.shape[1]

    @property
    def obs_capacity(self) -> int:
        return self.obs_pose.shape[0]

    @property
    def device(self) -> torch.device:
        return self.xyzlhw.device


FIELD_NAMES = tuple(f.name for f in dataclasses.fields(DeviceState))


def init_state(capacity: int = 512, max_views: int = 10, obs_capacity: int = 4096,
               device: DeviceLike = None) -> DeviceState:
    G, V, M = capacity, max_views, obs_capacity
    dev = resolve_device(device)
    f32, i32 = torch.float32, torch.int32

    def zeros(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def unit_boxes(n):
        x = zeros(n, 6)
        x[:, 3:] = 1.0
        return x

    def eyes(n, d):
        return torch.eye(d, dtype=f32, device=dev).repeat(n, 1, 1)

    return DeviceState(
        xyzlhw=unit_boxes(G),
        R=eyes(G, 3),
        scores=zeros(G),
        category=zeros(G, dtype=i32),
        pred_boxes=zeros(G, 4),
        init_id=zeros(G, dtype=i32),
        frame_id=zeros(G, dtype=i32),
        valid_num=zeros(G),
        n=zeros(dtype=i32),
        iou=zeros(G, G),
        flist=torch.full((G, V), PAD_ID, dtype=i32, device=dev),
        fcount=zeros(G, dtype=i32),
        fflag=zeros(G, dtype=torch.bool),
        already=torch.full((G, V), PAD_ID, dtype=i32, device=dev),
        already_valid=zeros(G, dtype=torch.bool),
        obs_pose=eyes(M, 4),
        obs_xyzlhw=unit_boxes(M),
        obs_R=eyes(M, 3),
        obs_score=zeros(M),
        obs_corners2d=zeros(M, 8, 2),
        obs_n=zeros(dtype=i32),
        stats=zeros(STATS_WIDTH, dtype=i32),
    )


def state_to_numpy(state: DeviceState) -> Dict[str, np.ndarray]:
    """``{field: ndarray}``, the tree of the JAX package's state snapshots."""
    return {name: getattr(state, name).detach().cpu().numpy() for name in FIELD_NAMES}


def state_from_numpy(tree: Dict[str, np.ndarray], device: DeviceLike = None) -> DeviceState:
    """A DeviceState on ``device`` from a ``{field: ndarray}`` tree, with each
    field in its own dtype.  An absent or narrower ``stats`` is zero-padded
    to STATS_WIDTH (counters were added over time)."""
    dev = resolve_device(device)
    template = init_state(1, 1, 1, device="cpu")
    stats = np.asarray(tree.get("stats", np.zeros(0, np.int32)), np.int32)
    if stats.shape[0] < STATS_WIDTH:
        stats = np.pad(stats, (0, STATS_WIDTH - stats.shape[0]))
    tree = dict(tree, stats=stats)
    return DeviceState(**{
        name: torch.as_tensor(np.array(tree[name]), dtype=getattr(template, name).dtype).to(dev)
        for name in FIELD_NAMES
    })


def export_world(state: DeviceState, class_list=None) -> Dict[str, np.ndarray]:
    """Pull the packed world set to host numpy (end-of-sequence sync)."""
    n = int(state.n)

    def host(x):
        return x[:n].cpu().numpy()

    stats = state.stats.cpu().numpy()
    out = {
        "xyzlhw": host(state.xyzlhw),
        "R": host(state.R),
        "scores": host(state.scores),
        "category": host(state.category),
        "pred_boxes": host(state.pred_boxes),
        "init_id": host(state.init_id),
        "frame_id": host(state.frame_id),
        "valid_num": host(state.valid_num),
        "fusion_flag": host(state.fflag),
        "fusion_list": [[int(x) for x in row if x != PAD_ID] for row in host(state.flist)],
        "stats": {name: int(stats[i]) for i, name in enumerate(STATS_NAMES)},
    }
    if class_list is not None:
        out["categories"] = [class_list[int(c)] for c in out["category"]]
    return out
