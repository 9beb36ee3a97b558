"""The device-resident keyframe update (torch).

Port of ``boxfusion_tpu/runtime/device_step.py``.  One function per
keyframe, ``keyframe_step(state, detections, ...) -> DeviceState``, over
fixed-shape tensors that stay on the state's device:

  * detection filters (score / uv-bound / floor / max-size,
    reference demo.py:138-148, box_manager.py:217-245);
  * camera->world lift + observation corner projection (demo.py:216-221);
  * the two-phase gated pairwise OBB IoU cache refresh;
  * greedy score-ordered 3D NMS with the manager's fusion-list bookkeeping
    (instances.py:22-101 + box_manager.py:40-88), faithful to the sequential
    reference semantics, including keep-swaps;
  * the small-object 2D correspondence pass (instances.py:411-490 +
    box_manager.py:90-129);
  * world-set compaction (stable-order mask sort == the reference's sorted
    keep lists);
  * batched multi-view PST fusion (box_fusion.py:622-724) and the IoU cache
    refresh for moved boxes.

What eager PyTorch changes.  The JAX step is one compiled program: its
``while_loop`` and ``cond`` predicates stay on the device and the host only
enqueues.  Here a loop that stops early or a stage that is skipped needs its
predicate on the host, and each such read waits for the device.  The step
reads once per keyframe for its stage gates (new detections? first frame?),
once per gated-IoU refresh (the gated pair count, so that the lattice runs on
gated pairs only) and once for "did a new box survive".  The NMS picks with
their records and the correspondence hits run on one thread block each
(``ops/step_kernel.py``): on a card each stage is one launch and pays no
read, neither per NMS survivor nor for the count of correspondence hits.  On
the CPU their plain twins read once per NMS survivor (its suppressed count
and whether any box remains) and once for the count of hits, and the PST
search once per iteration (fusion/optimizer.py).

``utils/device.py:host_reads`` counts and times the reads, each named by its
site (``step.gate``, ``iou.gated``, ``step.go``, ``meta``; ``nms`` and
``correspond`` in the step kernels' twins, ``fuse.done`` in the
optimizer's).  Given a ``timings`` dict, the step adds the host-clock
seconds of its loops to it (``step.nms``, ``step.correspond``,
``step.fuse``; ``utils/profiling.span``, a ``boxfusion.`` span each under a
profiler).  No state tensor passed in is written: each stage clones what it
updates.  Row indices that come from the device (argmax picks) are kept as
1-element index tensors, because indexing with a 0-d tensor is itself a
host read.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

from boxfusion_tpu_torch.fusion.optimizer import PSTOptConfig, init_opt_params, optimize_boxes
from boxfusion_tpu_torch.geometry.boxes import box_corners
from boxfusion_tpu_torch.geometry.iou import MAX_GATED_PAIRS, gated_pair_iou
from boxfusion_tpu_torch.geometry.projection import (
    project_boxes_to_2d,
    project_corners_to_image,
)
from boxfusion_tpu_torch.ops import step_kernel
from boxfusion_tpu_torch.runtime.device_state import PAD_ID, DeviceState
from boxfusion_tpu_torch.utils.device import host_reads
from boxfusion_tpu_torch.utils.profiling import span

_NEG = -1e30


def _argmax_score_desc(scores, mask):
    """(1,) index of the max masked score, ties broken by LARGER index.

    Matches the reference's ``scores.argsort()[::-1]`` ordering
    (instances.py:52): a reversed stable ascending sort puts the later index
    first among equal scores.
    """
    s = torch.where(mask, scores, _NEG)
    slot = torch.arange(s.shape[0], device=s.device)
    # the keys slot + 1 are distinct, so the maximum is unique
    return torch.argmax(torch.where(s == s.max(), slot + 1, 0)).reshape(1)


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Static per-run configuration (mirrors the YAML, utils/config.py)."""

    score_thresh: float = 0.4
    uv_bound: bool = True
    uv_bound_value: float = 0.9
    floor_mask: bool = True
    floor_ratio: float = 15.0
    size_max_thres: float = 0.0
    nms_threshold: float = 0.1
    small_threshold: float = 0.2
    small_size: float = 0.5
    rotation_gap: float = 30.0
    translation_gap: float = 0.8
    fusion_use: bool = True
    max_fusions: int = 16
    # the shared gate -> first-k -> pair-IoU budget (geometry/iou.py::
    # gated_pair_iou); same default as the host engine's MAX_GATED_PAIRS
    max_gated_pairs: int = MAX_GATED_PAIRS
    grid_samples: int = 25
    check_valid: bool = False  # drop never-re-observed boxes (box_manager.py:151-166)
    gap: int = 20
    opt: PSTOptConfig = PSTOptConfig()


# ---------------------------------------------------------------------------
# small helpers
# ---------------------------------------------------------------------------

def _pose_differs(poses_m, pose_ref, cfg: StepConfig):
    """(V, 4, 4) vs (4, 4) -> (V,) bool (box_manager.py:168-186)."""
    baseline = torch.linalg.norm(poses_m[:, :3, 3] - pose_ref[:3, 3], dim=-1)
    # float32 (TF32 is off package-wide): angle gates need full rotations
    r_rel = torch.einsum("ij,vkj->vik", pose_ref[:3, :3], poses_m[:, :3, :3])
    tr = torch.clamp((r_rel.diagonal(dim1=1, dim2=2).sum(-1) - 1) / 2, -1.0, 1.0)
    ang = torch.arccos(tr) * (180.0 / math.pi)
    return (baseline > cfg.translation_gap) | (ang > cfg.rotation_gap)


def _insert_sorted(row, count, value):
    """Insert into a PAD_ID-padded ascending row (at ``count``, clamped to
    the last slot as ``dynamic_update_slice`` clamps)."""
    at = count.clamp(max=row.shape[0] - 1).long().reshape(1)
    return torch.sort(row.scatter(0, at, value.to(row.dtype).reshape(1))).values


def _merge_sorted(row_a, count_a, row_b, count_b, max_views):
    merged = torch.sort(torch.cat([row_a, row_b])).values[:max_views]
    return merged, torch.clamp(count_a + count_b, max=max_views)


# ---------------------------------------------------------------------------
# greedy NMS + record (instances.py:22-101, box_manager.py:40-88)
# ---------------------------------------------------------------------------

def _record_core(flist, fcount, fflag, keep, i, j, extra, obs_pose, init_id, cfg: StepConfig):
    """Process one suppressed/merged box j against survivor i -- the shared
    bookkeeping of record (box_manager.py:48-87) and record_corr
    (box_manager.py:90-129).  ``extra`` is the center-distance escape hatch
    of record (box_manager.py:53-55); record_corr passes False.

    ``i`` and ``j`` are (1,) index tensors.  Writes rows i and j of the small
    mutable field set (flist/fcount/fflag/keep) IN PLACE -- the callers own
    these tensors -- and returns the truncated-member count.
    """
    V = flist.shape[1]
    obs_cap = obs_pose.shape[0]
    view = torch.arange(V, device=flist.device)
    row_i, row_j = flist[i][0], flist[j][0]
    cnt_i, cnt_j = fcount[i][0], fcount[j][0]
    id_i, id_j = init_id[i], init_id[j]  # (1,)
    is_single = cnt_j == 1

    def members_differ(row, count, pose_ref):
        idx = row.clamp(0, obs_cap - 1).long()
        differs = _pose_differs(obs_pose[idx], pose_ref, cfg) | extra
        return torch.where(view < count, differs, True).all()

    # case A: j is a fresh observation -> maybe append its init_id to i's list
    pose_j = obs_pose[id_j.clamp(0, obs_cap - 1).long()][0]
    differ_a = members_differ(row_i, cnt_i, pose_j)
    apply_a = is_single & differ_a & (cnt_i < 5)
    row_a = _insert_sorted(row_i, cnt_i, id_j)

    # case B: j is a multi-view box -> maybe merge its list into i's
    pose_i = obs_pose[id_i.clamp(0, obs_cap - 1).long()][0]
    differ_b = members_differ(row_j, cnt_j, pose_i)
    mergeable = differ_b & (cnt_j < 5)
    apply_b = (~is_single) & mergeable
    swap_b = (~is_single) & (~mergeable)

    row_b, count_b = _merge_sorted(row_i, cnt_i, row_j, cnt_j, V)
    # no-silent-caps: a case-B merge of two lists can exceed the V-slot row
    # and _merge_sorted keeps only the V smallest obs ids; the reference's
    # Python lists are unbounded here (box_manager.py:59-77), so surface the
    # dropped-member count (stats[5]) instead of silently diverging.
    trunc = torch.where(apply_b, torch.clamp(cnt_i + cnt_j - V, min=0), 0).to(torch.int32)

    new_row = torch.where(apply_a, row_a, torch.where(apply_b, row_b, row_i))
    new_count = torch.where(apply_a, cnt_i + 1, torch.where(apply_b, count_b, cnt_i))

    # keep-swap (box_manager.py:79-83): old multi-view box wins over cur.
    keep_i, keep_j = keep[i][0], keep[j][0]
    do_swap = swap_b & keep_i
    new_keep_i = keep_i & ~do_swap
    new_keep_j = keep_j | do_swap
    new_flag_i = fflag[i][0] | ((~is_single) & fflag[j][0])

    flist[i] = new_row[None]
    fcount[i] = new_count.to(fcount.dtype).reshape(1)
    keep[i] = new_keep_i.reshape(1)
    keep[j] = new_keep_j.reshape(1)
    fflag[i] = new_flag_i.reshape(1)
    return trunc


def _center_far(xyzlhw, i, j):
    return torch.linalg.norm(xyzlhw[i][0, :3] - xyzlhw[j][0, :3]) > 0.5


def _contested(state: DeviceState, cfg: StepConfig):
    """(contested, isolated) slot masks of the cached overlap graph.

    Exact shortcut: a box whose cached IoU against every other alive box is
    <= threshold can neither suppress nor be suppressed, and greedy NMS
    never mutates it (keep=True, no valid_num/success/record changes), so it
    is kept without a loop iteration.  Removing it from the score order
    cannot change any other decision because all its pair IoUs fail the
    threshold.  This bounds the serial loop to the overlap graph (~the new
    detections and their neighbours) instead of the whole world set.
    The cache may be ASYMMETRIC when max_gated_pairs truncation drops one
    direction of a pair (_gated_iou_rows), so a box counts as contested if
    its row OR its column has any above-threshold entry.
    """
    G = state.capacity
    slot_valid = torch.arange(G, device=state.device) < state.n
    pair_on = (state.iou > cfg.nms_threshold) & slot_valid[None, :] & slot_valid[:, None]
    contested = pair_on.any(1) | pair_on.any(0)
    return contested, slot_valid & ~contested


def _with_stat(stats, index: int, amount):
    stats = stats.clone()
    stats[index] += amount
    return stats


def _nms_greedy(state: DeviceState, cfg: StepConfig):
    """Greedy score-ordered NMS over the packed world set.

    The overlap graph (``_contested``) is vectorised; the picks and their
    records run in ``ops/step_kernel.py:nms_greedy``: one launch on a card,
    and on the CPU its twin, with one host read per survivor pick (how many
    boxes it suppressed, and whether any box remains).

    Returns (state, keep (G,), success (G,))."""
    contested, isolated = _contested(state, cfg)
    keep, success, flist, fcount, fflag, valid_num, trunc = step_kernel.nms_greedy(
        state.scores, state.iou, contested, isolated, state.flist, state.fcount, state.fflag,
        state.valid_num, state.xyzlhw, state.obs_pose, state.init_id, cfg,
    )
    state = dataclasses.replace(
        state, flist=flist, fcount=fcount, fflag=fflag, valid_num=valid_num,
        stats=_with_stat(state.stats, 5, trunc),
    )
    return state, keep, success


# ---------------------------------------------------------------------------
# correspondence pass (instances.py:411-490, box_manager.py:90-129)
# ---------------------------------------------------------------------------

def _iou2d_rows(boxes_a, boxes_b):
    """(A, B) IoU of every xyxy box of ``boxes_a`` against every one of
    ``boxes_b``: geometry/iou.py::iou_2d (instances.py:643-668), row by row."""
    a, b = boxes_a[:, None, :], boxes_b[None, :, :]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    iw = torch.clamp(torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0]), min=0.0)
    ih = torch.clamp(torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1]), min=0.0)
    inter = iw * ih
    return inter / (area_a + area_b - inter + 1e-6)


def _corr_plan(state, keep, success, n_before, proj2d, cfg: StepConfig):
    """Everything of the correspondence pass that does not depend on its
    order, for all slots at once: (todo, best, new_wins).

    The pass walks the small NEW kept boxes in ascending slot order and
    matches each against the 2D projections of the kept globals.  The
    candidate set, the 2D boxes and the scores are fixed at entry
    (instances.py:424), so a box's best match, whether it is a hit and who
    wins are too; only the manager bookkeeping of a hit reads what earlier
    hits wrote.  ``todo`` marks the pending boxes that hit -- a miss changes
    nothing -- and the sequential part runs over those alone.
    """
    G = state.capacity
    slot = torch.arange(G, device=state.device)
    max_dim = state.xyzlhw[:, 3:].amax(-1)
    global_keep = keep & (slot < n_before)
    small_dims_g = max_dim < (cfg.small_size + 0.1)
    pending = (
        keep
        & (slot >= n_before)
        & (max_dim <= cfg.small_size)
        & ~success
        & (slot < state.n)
    )
    iou = _iou2d_rows(state.pred_boxes, proj2d)
    # where (not multiply) so NaNs from degenerate projections of masked
    # slots cannot leak into the argmax
    iou = torch.where((global_keep & small_dims_g)[None, :], iou, 0.0)
    best_iou = iou.amax(1)
    best = torch.where(iou == best_iou[:, None], slot[None, :], G).amin(1)  # the first maximum
    todo = pending & global_keep.any() & (best_iou > cfg.small_threshold)
    new_wins = state.scores[best] < state.scores
    return todo, best, new_wins


def _corr_body(todo, best, new_wins, flist, fcount, fflag, keep, valid_num, obs_pose, init_id,
               cfg: StepConfig):
    """One hit, the lowest slot still to do: the lower-scoring of the pair is
    merged into the other (record_corr, box_manager.py:90-129: the record
    bookkeeping with a pose-only gate, and the keep-substitute semantics of
    box_manager.py:122-123).  Both outcomes are one body: ``cur`` wins,
    ``other`` is dropped.  Writes its tensor arguments in place; returns the
    truncated-member count."""
    G = todo.shape[0]
    slot = torch.arange(G, device=todo.device)
    s = torch.argmin(torch.where(todo, slot, G + 1)).reshape(1)
    todo[s] = False
    b = best[s]
    wins = new_wins[s]
    cur = torch.where(wins, s, b)
    other = torch.where(wins, b, s)
    keep[other] = False
    valid_num[cur] = valid_num[cur] + 1.0
    no_extra = torch.zeros((), dtype=torch.bool, device=todo.device)
    return _record_core(flist, fcount, fflag, keep, cur, other, no_extra, obs_pose, init_id, cfg)


def _correspondence(state, keep, success, n_before, proj2d, cfg: StepConfig):
    """The plan is vectorised; the hits run in
    ``ops/step_kernel.py:correspond_hits``: one launch on a card, and on the
    CPU its twin, with one host read (how many pending boxes hit)."""
    todo, best, new_wins = _corr_plan(state, keep, success, n_before, proj2d, cfg)
    keep, flist, fcount, fflag, valid_num, trunc = step_kernel.correspond_hits(
        todo, best, new_wins, keep, state.flist, state.fcount, state.fflag, state.valid_num,
        state.obs_pose, state.init_id, cfg,
    )
    state = dataclasses.replace(
        state, flist=flist, fcount=fcount, fflag=fflag, valid_num=valid_num,
        stats=_with_stat(state.stats, 5, trunc),
    )
    return state, keep


# ---------------------------------------------------------------------------
# compaction
# ---------------------------------------------------------------------------

def _compact(state: DeviceState, keep) -> DeviceState:
    G = state.capacity
    keep = keep & (torch.arange(G, device=state.device) < state.n)
    # kept slots first, order stable (sorted as integers: no backend sorts bool)
    order = torch.argsort((~keep).to(torch.int8), stable=True)
    new_n = keep.sum().to(torch.int32)

    def g(x):
        return x[order]

    return dataclasses.replace(
        state,
        xyzlhw=g(state.xyzlhw),
        R=g(state.R),
        scores=g(state.scores),
        category=g(state.category),
        pred_boxes=g(state.pred_boxes),
        init_id=g(state.init_id),
        frame_id=g(state.frame_id),
        valid_num=g(state.valid_num),
        n=new_n,
        iou=state.iou[order][:, order],
        flist=g(state.flist),
        fcount=g(state.fcount),
        fflag=g(state.fflag),
        already=g(state.already),
        already_valid=g(state.already_valid),
    )


# ---------------------------------------------------------------------------
# gated pairwise IoU rows
# ---------------------------------------------------------------------------

def _gated_iou_rows(corners_q, mask_q, corners_all, mask_all, cfg: StepConfig):
    """(Q, A) IoU rows via the SHARED gate -> first-k -> pair-IoU sequence
    (geometry/iou.py::gated_pair_iou -- one implementation for both engines).

    Returns (rows, truncated): ``truncated`` counts gated pairs beyond the
    ``max_gated_pairs`` budget whose IoU was therefore NOT computed (their
    row entries stay 0) -- surfaced by the pipeline instead of silently
    weakening NMS on very dense scenes.  The step pays one host read here
    (the gated count) and runs the lattice on the gated pairs only."""
    Q = corners_q.shape[0]
    A = corners_all.shape[0]
    pair_idx, vals, n_gated = gated_pair_iou(
        corners_q, mask_q, corners_all, mask_all,
        cfg.max_gated_pairs, cfg.grid_samples, read_site="iou.gated",
    )
    truncated = max(n_gated - min(cfg.max_gated_pairs, Q * A), 0)
    rows = torch.zeros(Q * A, dtype=torch.float32, device=corners_q.device)
    rows[pair_idx] = vals
    return rows.reshape(Q, A), truncated


# ---------------------------------------------------------------------------
# fusion (box_fusion.py:622-724)
# ---------------------------------------------------------------------------

def _fuse_device(state: DeviceState, pst, K_img, H, W, cfg: StepConfig):
    """Fuse up to ``max_fusions`` eligible slots and refresh their IoU rows.
    With no eligible slot the state comes back as it was."""
    G = state.capacity
    V = state.max_views
    F = cfg.max_fusions
    dev = state.device
    slot = torch.arange(G, device=dev)

    same_as_already = state.already_valid & (state.flist == state.already).all(-1)
    eligible = (state.fcount >= 3) & (slot < state.n) & ~same_as_already

    # the first F eligible slots: a stable sort keeps ascending-index ties
    cand = torch.sort(eligible.to(torch.int8), descending=True, stable=True).indices[:F]
    active = eligible[cand]
    # no-silent-caps: eligible slots beyond max_fusions are deferred to a
    # later keyframe (they only fuse then if that keyframe has new kept
    # boxes) -- count them (stats[6]) so eval stats never claim full
    # fusion coverage when slots were skipped
    deferred = torch.clamp(eligible.sum() - F, min=0)
    stats = _with_stat(state.stats, 6, deferred)

    rows = state.flist[cand]  # (F, V)
    vmask = (torch.arange(V, device=dev)[None] < state.fcount[cand][:, None]) & active[:, None]
    obs_idx = rows.clamp(0, state.obs_capacity - 1).long()

    mem_box = state.obs_xyzlhw[obs_idx]  # (F, V, 6)
    mem_R = state.obs_R[obs_idx]
    mem_score = state.obs_score[obs_idx]
    mem_pose = state.obs_pose[obs_idx]
    mem_corners = state.obs_corners2d[obs_idx]

    init_x, init_R = init_opt_params(mem_box, mem_R, mem_score, vmask.to(torch.float32))
    fused, updated = optimize_boxes(
        init_x, init_R, pst, mem_pose, mem_corners, vmask.to(torch.float32), active,
        K_img, H, W, cfg.opt, device=dev,
    )

    # write back under the `updated` mask (box_fusion.py:716-724: only the
    # tensor moves; the rotation stays the global box's own R); cand is unique
    upd = torch.zeros(G, dtype=torch.bool, device=dev)
    upd[cand] = updated
    xyzlhw = state.xyzlhw.clone()
    xyzlhw[cand] = torch.where(updated[:, None], fused, xyzlhw[cand])

    fflag = state.fflag | upd
    already = torch.where(upd[:, None], state.flist, state.already)
    already_valid = state.already_valid | upd

    # refresh IoU cache rows for moved boxes
    corners_all = box_corners(xyzlhw, state.R)
    rows_iou, truncated = _gated_iou_rows(corners_all[cand], updated, corners_all, slot < state.n, cfg)
    stats[2] += truncated
    rows_full = torch.zeros((G, G), dtype=torch.float32, device=dev)
    rows_full[cand] = torch.where(updated[:, None], rows_iou, 0.0)
    iou = torch.where(upd[:, None], rows_full, state.iou)
    iou = torch.where(upd[None, :], rows_full.T, iou)
    iou.fill_diagonal_(0.0)
    return dataclasses.replace(
        state, xyzlhw=xyzlhw, fflag=fflag, already=already, already_valid=already_valid,
        stats=stats, iou=iou,
    )


# ---------------------------------------------------------------------------
# detection filters + append
# ---------------------------------------------------------------------------

def _filter_mask(det, image_hw, cfg: StepConfig):
    """demo.py:138-148 + box_manager.py:217-245, vectorized.  ``image_hw``
    is the (H, W) pair on the host."""
    h, w = np.float32(image_hw[0]), np.float32(image_hw[1])
    m = det["scores"] >= cfg.score_thresh
    if cfg.uv_bound:
        # in float32, as the JAX package computes it: 0.1 * 640 floors to 64
        # there and to 63 in float64
        margin = np.float32(1.0 - cfg.uv_bound_value)
        gap_w = float(np.floor(margin * w))
        gap_h = float(np.floor(margin * h))
        u, v = det["proj_xy"][:, 0], det["proj_xy"][:, 1]
        m = m & (u > gap_w) & (u < (float(w) - gap_w)) & (v > gap_h) & (v < (float(h) - gap_h))
    dims = det["boxes3d"][:, 3:]
    if cfg.floor_mask:
        srt = torch.sort(dims, dim=1).values
        mn, second, mx = srt[:, 0], srt[:, 1], srt[:, 2]
        floor = (mx / mn > cfg.floor_ratio) | (
            (mx / mn > cfg.floor_ratio / 2)
            & (mx / second > cfg.floor_ratio / 2)
            & (second / mn < 2.0)
            & (second < 0.15)
            & (mn < 0.15)
        )
        m = m & ~floor
    if cfg.size_max_thres > 0:
        m = m & ~(dims.amax(1) > cfg.size_max_thres)
    return m


def _append_block(buf, block, start, count):
    """``buf`` with rows [start, start + count) taken from ``block[:count]``.

    ``start`` and ``count`` are 0-d tensors.  Written as a gather per buffer
    row instead of a scatter, so that no index can leave the buffer: the JAX
    package's dynamic_update_slice clamps its start near a full buffer and
    needs a merge to survive that; here a row past the end simply does not
    exist, and a block wider than the buffer lands its first rows only."""
    src = torch.arange(buf.shape[0], device=buf.device) - start
    take = (src >= 0) & (src < count)
    rows = block.to(buf.dtype)[src.clamp(0, block.shape[0] - 1)]
    return torch.where(take.reshape((-1,) + (1,) * (buf.dim() - 1)), rows, buf)


def _append_detections(state: DeviceState, det, mask, pose, K_depth, image_hw, frame_idx):
    """Pack the surviving detections, lift to world, append to the
    observation store + world set (demo.py:216-254).

    Appends are clamped to the remaining world/observation capacity: a full
    buffer drops the lowest-priority new detections (counted in stats[0] /
    stats[1]) and never overwrites a live row.  Only the k surviving rows
    are written; slots at and past ``n`` are not state."""
    K = mask.shape[0]
    dev = state.device
    order = torch.argsort((~mask).to(torch.int8), stable=True)
    k_want = mask.sum().to(torch.int32)
    k_world = torch.minimum(k_want, state.capacity - state.n)
    k = torch.minimum(k_world, state.obs_capacity - state.obs_n)
    # no-silent-caps: count what the fixed capacities dropped
    stats = state.stats.clone()
    stats[0] += k_want - k_world
    stats[1] += k_world - k

    def pick(x):
        return x[order]

    boxes3d = pick(det["boxes3d"])
    R_cam = pick(det["R"])
    scores = pick(det["scores"])
    boxes2d = pick(det["pred_boxes"])
    category = (pick(det["category"]) if "category" in det
                else torch.zeros(K, dtype=torch.int32, device=dev))

    rp = pose[:3, :3]
    t = pose[:3, 3]
    # world lift is coordinate math: float32, TF32 off package-wide
    centers_w = boxes3d[:, :3] @ rp.T + t
    xyzlhw_w = torch.cat([centers_w, boxes3d[:, 3:]], dim=1)
    R_w = torch.einsum("ij,njk->nik", rp, R_cam)

    corners3d = box_corners(xyzlhw_w, R_w)
    poses_rep = pose[None].expand(K, 4, 4)
    corners2d = project_corners_to_image(corners3d, poses_rep, K_depth, image_hw[0], image_hw[1])

    obs_ids = state.obs_n + torch.arange(K, dtype=torch.int32, device=dev)

    def obs(buf, block):
        return _append_block(buf, block, state.obs_n, k)

    def world(buf, block):
        return _append_block(buf, block, state.n, k)

    V = state.max_views
    new_flist = torch.full((K, V), PAD_ID, dtype=torch.int32, device=dev)
    new_flist[:, 0] = obs_ids
    pad_rows = torch.full((K, V), PAD_ID, dtype=torch.int32, device=dev)
    state = dataclasses.replace(
        state,
        obs_pose=obs(state.obs_pose, poses_rep),
        obs_xyzlhw=obs(state.obs_xyzlhw, xyzlhw_w),
        obs_R=obs(state.obs_R, R_w),
        obs_score=obs(state.obs_score, scores),
        obs_corners2d=obs(state.obs_corners2d, corners2d),
        obs_n=state.obs_n + k,
        xyzlhw=world(state.xyzlhw, xyzlhw_w),
        R=world(state.R, R_w),
        scores=world(state.scores, scores),
        category=world(state.category, category),
        pred_boxes=world(state.pred_boxes, boxes2d),
        init_id=world(state.init_id, obs_ids),
        frame_id=world(state.frame_id, torch.full((K,), int(frame_idx), dtype=torch.int32, device=dev)),
        valid_num=world(state.valid_num, torch.zeros(K, device=dev)),
        flist=world(state.flist, new_flist),
        fcount=world(state.fcount, torch.ones(K, dtype=torch.int32, device=dev)),
        fflag=world(state.fflag, torch.zeros(K, dtype=torch.bool, device=dev)),
        already=world(state.already, pad_rows),
        already_valid=world(state.already_valid, torch.zeros(K, dtype=torch.bool, device=dev)),
        n=state.n + k,
        stats=stats,
    )
    return state, k


# ---------------------------------------------------------------------------
# the keyframe step
# ---------------------------------------------------------------------------

def _keyframe_step_impl(
    state: DeviceState,
    det: dict,
    pst: torch.Tensor,
    pose: torch.Tensor,
    K_img: torch.Tensor,
    K_depth: torch.Tensor,
    image_hw,
    frame_idx: int,
    cfg: StepConfig,
    timings: Optional[Dict[str, float]] = None,
) -> DeviceState:
    """One keyframe: filters -> append -> NMS -> correspondence -> fusion.

    Args:
      det: detector output dict (tensors on the state's device, fixed K
        rows): scores, pred_boxes, boxes3d (camera frame), R, proj_xy
        [, category].
      pose: (4, 4) camera-to-world of this keyframe.
      K_img / K_depth: (3, 3) intrinsics.
      image_hw: the actual (H, W) and frame_idx: the frame counter, both on
        the host (they come from the frame, not from the device).
      timings: optional; host-clock seconds of "step.nms", "step.correspond"
        and "step.fuse" are added to it.
    """
    G = state.capacity
    dev = state.device
    H, W = float(image_hw[0]), float(image_hw[1])
    state = dataclasses.replace(state, stats=_with_stat(state.stats, 3, 1))
    mask = _filter_mask(det, (H, W), cfg)
    n_before = state.n
    state, k_new = _append_detections(state, det, mask, pose, K_depth, (H, W), frame_idx)

    # Stage gates: no new detection ends the keyframe here.
    k_host, n_host = host_reads.read(torch.stack([k_new, n_before]), "step.gate")
    if k_host == 0:
        return state

    slot = torch.arange(G, device=dev)
    mask_all = slot < state.n
    is_new = (slot >= n_before) & mask_all

    corners_all = box_corners(state.xyzlhw, state.R)

    # IoU cache rows for the new slots (two-phase gated).  The new slots are
    # a CONTIGUOUS window of at most kmax rows starting at n_before
    # (_append_detections), so the containment gate runs on a (kmax, G) slice
    # instead of the full (G, G), with identical results: gated pairs can only
    # come from is_new query rows, and their row-major order (hence the
    # max_gated_pairs selection) is preserved within the slice.  With no new
    # row the refresh leaves the cache as it is.
    kq = min(int(det["scores"].shape[0]), G)
    window = torch.clamp(n_before, max=G - kq) + torch.arange(kq, device=dev)
    rows_q, truncated = _gated_iou_rows(
        corners_all[window], is_new[window], corners_all, mask_all, cfg
    )
    rows = torch.zeros((G, G), dtype=rows_q.dtype, device=dev)
    rows[window] = rows_q
    iou = torch.where(is_new[:, None], rows, state.iou)
    iou = torch.where(is_new[None, :] & ~is_new[:, None], rows.T, iou)
    iou.fill_diagonal_(0.0)
    state = dataclasses.replace(state, iou=iou, stats=_with_stat(state.stats, 2, truncated))

    if n_host == 0:  # first frame: nothing to associate with
        return state

    with span("step.nms", timings):
        state, keep, success = _nms_greedy(state, cfg)

    with span("step.correspond", timings):
        # 2D projections of the pre-NMS global set for correspondence
        proj2d = project_boxes_to_2d(corners_all, K_depth, pose, H, W)

        # The reference runs correspondence, the stale drop and fusion only
        # when a new box survived NMS (demo.py:270-298 `if len(cur_keep_idx) > 0`).
        go = host_reads.read((keep & is_new).any(), "step.go")
        if go:
            state, keep = _correspondence(state, keep, success, n_before, proj2d, cfg)
        state = _compact(state, keep)

        if cfg.check_valid and go:
            # drop boxes never re-observed within one keyframe gap
            # (box_manager.py:151-166; gated by box_fusion.check_valid)
            alive = slot < state.n
            stale = alive & (state.valid_num == 0) & (state.frame_id < frame_idx - cfg.gap)
            state = _compact(state, alive & ~stale)

    if cfg.fusion_use and go:
        with span("step.fuse", timings):
            state = _fuse_device(state, pst, K_img, H, W, cfg)
    return state


@torch.inference_mode()
def keyframe_step(
    state: DeviceState,
    det: dict,
    pst: torch.Tensor,
    pose,
    K_img,
    K_depth,
    image_hw,
    frame_idx,
    cfg: StepConfig = StepConfig(),
) -> DeviceState:
    """Unpacked-argument entry point (see ``_keyframe_step_impl``).  ``pose``
    and the intrinsics may be arrays or tensors; ``image_hw`` and
    ``frame_idx`` are read on the host."""
    dev = state.device

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    hw = _host_array(image_hw)
    return _keyframe_step_impl(
        state, det, f32(pst), f32(pose), f32(K_img), f32(K_depth),
        (float(hw[0]), float(hw[1])), int(_host_array(frame_idx)), cfg,
    )


# Packed host->device transfer boundary: a keyframe's detections and frame
# metadata travel as (K, 23) packed detections and a (37,) metadata vector,
# one upload instead of ten small ones.
DET_PACK_WIDTH = 23  # scores 1 | pred_boxes 4 | boxes3d 6 | R 9 | proj_xy 2 | category 1
META_WIDTH = 37  # pose 16 | K_img 9 | K_depth 9 | image_hw 2 | frame_idx 1


def _host_array(x) -> np.ndarray:
    """``x`` as a numpy array on the host.  The metadata comes from the frame
    and is normally a host array; a tensor on the card costs one counted read."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            with host_reads.waiting("meta"):
                return x.detach().cpu().numpy()
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _split_meta(meta_host: np.ndarray, meta_dev: torch.Tensor):
    """(pose, K_img, K_depth) on the device; ((H, W), frame_idx) on the host."""
    pose = meta_dev[:16].reshape(4, 4)
    K_img = meta_dev[16:25].reshape(3, 3)
    K_depth = meta_dev[25:34].reshape(3, 3)
    image_hw = (float(meta_host[34]), float(meta_host[35]))
    return pose, K_img, K_depth, image_hw, int(meta_host[36])


def _unpack_detections(packed: torch.Tensor) -> dict:
    return dict(
        scores=packed[:, 0],
        pred_boxes=packed[:, 1:5],
        boxes3d=packed[:, 5:11],
        R=packed[:, 11:20].reshape(-1, 3, 3),
        proj_xy=packed[:, 20:22],
        category=packed[:, 22].to(torch.int32),
    )


def pad_detections(det: dict, kmax: int) -> dict:
    """Pad/truncate detector top-k rows to the fixed budget ``kmax``.

    Accepts single-frame ``(N, ...)`` or batched ``(B, N, ...)`` detection
    dicts (the row axis is scores' last axis).  Padded rows get score -1e9
    (below any filter), benign unit dims (downstream IoU math divides by
    volumes), zeroed geometry, and category 0 when the detector provides
    none (the labeler overwrites categories on the labeled path).
    """
    scores = det["scores"]
    axis = scores.dim() - 1
    k = min(int(scores.shape[axis]), kmax)
    lead = tuple(scores.shape[:axis])

    def pad(x, fill=0.0):
        x = x.narrow(axis, 0, k)
        if k < kmax:
            shape = list(x.shape)
            shape[axis] = kmax - k
            x = torch.cat([x, x.new_full(shape, fill)], dim=axis)
        return x

    boxes3d = pad(det["boxes3d"])
    if k < kmax:
        boxes3d = boxes3d.clone()
        boxes3d[..., k:, 3:] = 1.0
    cat = det.get("category")
    if cat is None:
        cat = torch.zeros(lead + (k,), dtype=torch.int32, device=scores.device)
    proj = det.get("proj_xy")
    if proj is None:
        proj = torch.zeros(lead + (k, 2), dtype=scores.dtype, device=scores.device)
    return dict(
        scores=pad(scores, -1e9),
        pred_boxes=pad(det["pred_boxes"]),
        boxes3d=boxes3d,
        R=pad(det["R"]),
        proj_xy=pad(proj),
        category=pad(cat, 0).to(torch.int32),
    )


@torch.inference_mode()
def keyframe_step_devdet(
    state: DeviceState,
    det: dict,
    meta,
    pst: torch.Tensor,
    cfg: StepConfig = StepConfig(),
    kmax: int = 100,
    timings: Optional[Dict[str, float]] = None,
) -> DeviceState:
    """``keyframe_step`` taking DEVICE-resident detector outputs directly.

    The path for the real CuTR pipeline: the detector's top-k tensors never
    leave the device; only the (37,) metadata vector (a host array, built
    from the frame) is uploaded per keyframe.  The rows are padded or
    truncated to ``kmax``.  ``timings``: as in ``_keyframe_step_impl``.
    """
    dev = state.device
    det = pad_detections({k: v.to(dev) for k, v in det.items()}, kmax)
    det = {k: (v if k == "category" else v.to(torch.float32)) for k, v in det.items()}
    meta_host = np.asarray(_host_array(meta), np.float32)
    pose, K_img, K_depth, image_hw, frame_idx = _split_meta(
        meta_host, torch.from_numpy(meta_host).to(dev)
    )
    return _keyframe_step_impl(state, det, pst, pose, K_img, K_depth, image_hw, frame_idx, cfg,
                               timings)


@torch.inference_mode()
def keyframe_step_packed(
    state: DeviceState,
    buf,
    pst: torch.Tensor,
    cfg: StepConfig = StepConfig(),
    timings: Optional[Dict[str, float]] = None,
) -> DeviceState:
    """``keyframe_step`` with a ONE-array transfer boundary.

    ``buf`` is (K * DET_PACK_WIDTH + META_WIDTH,) float32 on the host: the
    packed detections followed by the metadata vector, uploaded once.
    ``timings``: as in ``_keyframe_step_impl``.
    """
    dev = state.device
    buf_host = np.ascontiguousarray(_host_array(buf), np.float32)
    kmax = (buf_host.shape[0] - META_WIDTH) // DET_PACK_WIDTH
    buf_dev = torch.from_numpy(buf_host).to(dev)
    det = _unpack_detections(buf_dev[: kmax * DET_PACK_WIDTH].reshape(kmax, DET_PACK_WIDTH))
    pose, K_img, K_depth, image_hw, frame_idx = _split_meta(
        buf_host[kmax * DET_PACK_WIDTH:], buf_dev[kmax * DET_PACK_WIDTH:]
    )
    return _keyframe_step_impl(state, det, pst, pose, K_img, K_depth, image_hw, frame_idx, cfg,
                               timings)
