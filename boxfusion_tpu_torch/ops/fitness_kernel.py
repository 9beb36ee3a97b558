"""The multi-view fitness kernel: CUDA for Hopper, with its plain twin.

``fitness_cells`` replaces the TPU kernel ``boxfusion_tpu/ops/fitness_kernel.py:
fitness_cells_pallas`` (body ``_fitness_cell_body``).  One cell is one
(object x view); for each PST particle of a cell it returns |1 - IoU| of the
candidate's projected hull against the observed polygon, times the view
mask.  On a CUDA tensor it launches ``csrc/fitness_kernel.cu`` (built with
nvcc at first use, ops/build.py) and counts the launch in
``fitness_cells.launches``; on a CPU tensor it runs
``fitness_cells_reference``, the same arithmetic in PyTorch ops.  There is
no other path: a CUDA tensor launches the kernel or raises.

The observed polygon of each view is prepared once, outside the kernel, by
``prepare_observed`` (hull, half-planes compacted to 12 slots, area).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from boxfusion_tpu_torch.ops import build

_PAIR_I, _PAIR_J = np.triu_indices(8, k=1)
N_OBS_PLANES = 12  # >= 8 distinct hull edges, with margin for collinears

# Batcher odd-even merge sort network for 8 elements (19 comparators).
SORT_NET = [
    (0, 1), (2, 3), (4, 5), (6, 7),
    (0, 2), (1, 3), (4, 6), (5, 7),
    (1, 2), (5, 6),
    (0, 4), (1, 5), (2, 6), (3, 7),
    (2, 4), (3, 5),
    (1, 2), (3, 4), (5, 6),
]

_EPS = 1e-9

# float32 operations per live particle-cell, counted from csrc/fitness_kernel.cu
# (add, sub, mul, div, abs, neg, min, max, compare and select count one each):
#   A) every one of the 28 pairs: ex, ey (2); per corner k: du, dv (2),
#      side s (3), |du|,|dv| max (3), running smin/smax/mrel (3, none at
#      k = 0) -> 85; me (3), tol (3), nondeg (4), nonneg/nonpos (3)   = 100
#      a VALID pair adds: 8 flag tests (16), normal (2), offset (4),
#      8 observed-hull sides (32), their max |.| (15), threshold (2),
#      8 Liang-Barsky edge updates (8 x 8 = 64)                       = 135
#   B) anchor/centroid over 7 vertices (42), cx/cy (3), 8 keys (96)  = 141
#   C) 19 comparators x (1 compare + 6 selects)                       = 133
#   D) shoelace area                                                  = 34
#   E) 12 observed planes x (8 sides (32), max |.| (15), threshold (3),
#      validity test (1))                                             = 612
#      a VALID observed plane adds 8 Liang-Barsky updates             = 64
#   F) two boundary integrals, 8 edges x 16                           = 256
#   G) IoU and error                                                  = 10
OPS_PER_LIVE_PARTICLE = 28 * 100 + 141 + 133 + 34 + 612 + 256 + 10
OPS_PER_VALID_PAIR = 135
OPS_PER_VALID_OBS_PLANE = 64


def prepare_observed(obs_corners: torch.Tensor) -> dict:
    """Per-view constants for the kernel: centred hull, planes, area.

    Args:
      obs_corners: (V, 8, 2) observed projected corners.

    Returns:
      dict(center (V, 2), hull (V, 8, 2), planes (V, 12, 3) [nx, ny, d],
           pvalid (V, 12), area (V,)) -- hull/planes in centred coords.
    """
    from boxfusion_tpu_torch.fusion.kernel import prepare_polygon

    center = obs_corners.mean(1)
    hull, (n, d, valid), area = prepare_polygon(obs_corners - center[:, None])
    # compact the 28 candidate planes to 12 slots, valid ones first.  A
    # stable descending sort keeps the lowest indices among ties, as
    # jax.lax.top_k does (torch.topk promises no order among ties).
    idx = torch.sort(valid.to(torch.int32), dim=1, descending=True, stable=True).indices
    idx = idx[:, :N_OBS_PLANES]
    planes = torch.cat(
        [torch.gather(n, 1, idx[..., None].expand(-1, -1, 2)), torch.gather(d, 1, idx)[..., None]],
        dim=-1,
    )
    pvalid = torch.gather(valid, 1, idx).to(torch.float32)
    return dict(center=center, hull=hull, planes=planes, pvalid=pvalid, area=area)


def _candidate_planes(u: torch.Tensor, v: torch.Tensor):
    """Stage A of the kernel for every (cell, pair, particle).

    Returns (nx, ny, d, valid, tol) of shape (C, 28, P) and the side values
    s of shape (C, 28, 8, P).
    """
    ui, vi = u[:, _PAIR_I], v[:, _PAIR_I]  # (C, 28, P)
    ex = u[:, _PAIR_J] - ui
    ey = v[:, _PAIR_J] - vi
    du = u[:, None] - ui[:, :, None]  # (C, 28, 8, P)
    dv = v[:, None] - vi[:, :, None]
    s = ex[:, :, None] * dv - ey[:, :, None] * du
    mrel = torch.maximum(du.abs(), dv.abs()).amax(2)
    me = torch.maximum(ex.abs(), ey.abs())
    tol = 2e-5 * mrel * me + _EPS
    nondeg = ex * ex + ey * ey > _EPS
    nonneg = s.amin(2) >= -tol
    nonpos = s.amax(2) <= tol
    valid = nondeg & (nonneg | nonpos)
    sign = torch.where(nonneg, 1.0, -1.0)
    nx = -ey * sign
    ny = ex * sign
    d = -(nx * ui + ny * vi)
    return nx, ny, d, valid, tol, s


def _clip_intervals(s: torch.Tensor, th: torch.Tensor, ok: torch.Tensor):
    """Liang-Barsky intervals of the 8 closed-polygon edges against planes.

    Args:
      s: (C, Q, 8, P) vertex sides per plane; th: (C, Q, P) inside threshold;
      ok: broadcastable to (C, Q, 1, P), which planes take part.

    Returns:
      (t0, t1, empty) of shape (C, 8, P).
    """
    sp, sq = s, torch.roll(s, -1, dims=2)
    th = th[:, :, None]
    in_p = sp >= th
    in_q = sq >= th
    denom = sp - sq
    denom = torch.where(denom.abs() < _EPS, _EPS, denom)
    tstar = (sp - th) / denom
    t0 = torch.clamp(torch.where(~in_p & in_q & ok, tstar, 0.0).amax(1), min=0.0)
    t1 = torch.clamp(torch.where(in_p & ~in_q & ok, tstar, 1.0).amin(1), max=1.0)
    empty = (~in_p & ~in_q & ok).any(1)
    return t0, t1, empty


def _edge_integral(px, py, t0, t1, empty, integral=None):
    """Sum over the 8 edges (in order) of cross(p(t0), p(t1)); px: (C, 8, P)."""
    exv = torch.roll(px, -1, dims=1) - px
    eyv = torch.roll(py, -1, dims=1) - py
    ax1 = px + t0 * exv
    ay1 = py + t0 * eyv
    bx1 = px + t1 * exv
    by1 = py + t1 * eyv
    contrib = torch.where(empty | (t0 >= t1), 0.0, ax1 * by1 - bx1 * ay1)
    for e in range(8):
        integral = contrib[:, e] if integral is None else integral + contrib[:, e]
    return integral


def fitness_cells_reference(u, v, hull, planes, pvalid, area, wmask) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: same arguments, same arithmetic.

    Vectorised over (cell, pair or plane, particle) instead of one thread
    per particle; sums over corners and edges keep the kernel's order.
    """
    nx, ny, d, valid, tol, s = _candidate_planes(u, v)

    # ---- B) hull-vertex flags, anchor, centroid, diamond key ----------------
    on_edge = (s.abs() <= tol[:, :, None]) & valid[:, :, None]
    flags = on_edge.any(1) | ~valid.any(1, keepdim=True)  # (C, 8, P)
    first = torch.argmax(flags.to(torch.uint8), dim=1, keepdim=True)
    ax = torch.gather(u, 1, first)
    ay = torch.gather(v, 1, first)
    cnt = flags.to(u.dtype).sum(1)
    wx = torch.where(flags, u, 0.0)
    wy = torch.where(flags, v, 0.0)
    sx, sy = wx[:, 0], wy[:, 0]
    for k in range(1, 8):
        sx = sx + wx[:, k]
        sy = sy + wy[:, k]
    cx = (sx / torch.clamp(cnt, min=1.0))[:, None]
    cy = (sy / torch.clamp(cnt, min=1.0))[:, None]
    px = torch.where(flags, u, ax)
    py = torch.where(flags, v, ay)
    dx = px - cx
    dy = py - cy
    r = dx.abs() + dy.abs()
    a = dx / torch.where(r < _EPS, 1.0, r)
    key = torch.where(dy >= 0, 1.0 - a, 3.0 + a)

    # ---- C) angular sort (Batcher network) --------------------------------
    key, px, py = list(key.unbind(1)), list(px.unbind(1)), list(py.unbind(1))
    for i, j in SORT_NET:
        sw = key[i] > key[j]
        for buf in (key, px, py):
            buf[i], buf[j] = torch.where(sw, buf[j], buf[i]), torch.where(sw, buf[i], buf[j])
    px, py = torch.stack(px, 1), torch.stack(py, 1)

    # ---- D) candidate hull area -------------------------------------------
    terms = px * torch.roll(py, -1, dims=1) - torch.roll(px, -1, dims=1) * py
    area_a = terms[:, 0]
    for k in range(1, 8):
        area_a = area_a + terms[:, k]
    area_a = area_a.abs() * 0.5

    # ---- E) candidate hull edges clipped by observed planes (inclusive) ----
    onx, ony, od = (planes[:, :, i, None, None] for i in range(3))  # (C, 12, 1, 1)
    sa = onx * px[:, None] + ony * py[:, None] + od  # (C, 12, 8, P)
    th_a = -(2e-5 * sa.abs().amax(2) + _EPS)
    t0, t1, empty = _clip_intervals(sa, th_a, (pvalid > 0.5)[:, :, None, None])
    integral = _edge_integral(px, py, t0, t1, empty)

    # ---- F) observed hull edges clipped by candidate planes (exclusive) ----
    ohx, ohy = hull[:, None, :, 0, None], hull[:, None, :, 1, None]  # (C, 1, 8, 1)
    sb = nx[:, :, None] * ohx + ny[:, :, None] * ohy + d[:, :, None]  # (C, 28, 8, P)
    th_b = 2e-5 * sb.abs().amax(2) + _EPS
    t0, t1, empty = _clip_intervals(sb, th_b, valid[:, :, None])
    P = u.shape[2]
    hx = hull[:, :, 0, None].expand(-1, -1, P)
    hy = hull[:, :, 1, None].expand(-1, -1, P)
    integral = _edge_integral(hx, hy, t0, t1, empty, integral)

    # ---- G) IoU + error ----------------------------------------------------
    inter = torch.clamp(integral * 0.5, min=0.0)
    inter = torch.minimum(inter, torch.minimum(area_a, area))
    union = area_a + area - inter
    iou = torch.where(union > 0, inter / (union + 1e-5), 0.0)
    # a masked cell is zero, as the kernel (which skips its body) writes
    return torch.where(wmask > 0, (1.0 - iou).abs() * wmask, 0.0)


def operation_count(u, v, pvalid, wmask) -> int:
    """float32 operations the kernel does on these inputs (live cells only).

    OPS_PER_LIVE_PARTICLE for every particle of a live cell, plus the work
    that only valid candidate planes and valid observed planes do.
    """
    live = wmask[:, 0] > 0
    P = u.shape[2]
    _, _, _, valid, _, _ = _candidate_planes(u[live], v[live])
    n_valid_obs = int((pvalid[live] > 0.5).sum()) * P
    return (
        int(live.sum()) * P * OPS_PER_LIVE_PARTICLE
        + int(valid.sum()) * OPS_PER_VALID_PAIR
        + n_valid_obs * OPS_PER_VALID_OBS_PLANE
    )


def _check_args(u, v, hull, planes, pvalid, area, wmask) -> None:
    if u.dim() != 3 or u.shape[1] != 8:
        raise ValueError(f"u must be (C, 8, P), got {tuple(u.shape)}")
    C, _, P = u.shape
    want = dict(
        v=(v, (C, 8, P)), hull=(hull, (C, 8, 2)), planes=(planes, (C, N_OBS_PLANES, 3)),
        pvalid=(pvalid, (C, N_OBS_PLANES)), area=(area, (C, 1)), wmask=(wmask, (C, 1)),
    )
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    for name, t in dict(u=u, **{k: t for k, (t, _) in want.items()}).items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if C > 65535:
        raise ValueError(f"at most 65535 cells per launch, got {C}")


def _launcher():
    fn = build.load("fitness_kernel").fitness_cells_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fitness_cells(u, v, hull, planes, pvalid, area, wmask) -> torch.Tensor:
    """Per-cell, per-particle fitness errors.

    Args:
      u, v: (C, 8, P) float32 candidate corner coordinates, centred per
        view, particle-minor.
      hull: (C, 8, 2) observed hull (centred); planes: (C, 12, 3);
      pvalid: (C, 12); area: (C, 1); wmask: (C, 1) view mask.

    Returns:
      (C, P) |1 - IoU| * wmask (0 for masked cells).  On a CUDA device the
      launch is asynchronous on the current stream.
    """
    _check_args(u, v, hull, planes, pvalid, area, wmask)
    if u.device.type == "cpu":
        return fitness_cells_reference(u, v, hull, planes, pvalid, area, wmask)
    if u.device.type != "cuda":
        raise ValueError(f"fitness_cells runs on cuda or cpu tensors, got {u.device}")
    C, _, P = u.shape
    out = torch.empty((C, P), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        rc = _launcher()(
            u.data_ptr(), v.data_ptr(), hull.data_ptr(), planes.data_ptr(),
            pvalid.data_ptr(), area.data_ptr(), wmask.data_ptr(), out.data_ptr(),
            C, P, torch.cuda.current_stream(u.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"fitness_cells kernel launch failed: cudaError_t {rc}")
    fitness_cells.launches += int(C > 0 and P > 0)  # the C entry launches nothing for no work
    return out


fitness_cells.launches = 0
