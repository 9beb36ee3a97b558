"""The multi-view fitness in PyTorch ops (a frozen copy of the port's
``fitness_cells_reference``).  One cell is one (object x view); for each PST
particle of a cell it gives |1 - IoU| of the candidate's projected hull
against the observed polygon, times the view mask.  The observed polygon of
each view is prepared once by ``prepare_observed`` (hull, half-planes
compacted to 12 slots, area).
"""
from __future__ import annotations

import numpy as np
import torch


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


def prepare_observed(obs_corners: torch.Tensor) -> dict:
    """Per-view constants for the kernel: centred hull, planes, area.

    Args:
      obs_corners: (V, 8, 2) observed projected corners.

    Returns:
      dict(center (V, 2), hull (V, 8, 2), planes (V, 12, 3) [nx, ny, d],
           pvalid (V, 12), area (V,)) -- hull/planes in centred coords.
    """
    from benchmark.reference.fusion.kernel import prepare_polygon

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
