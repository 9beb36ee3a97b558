"""Multi-view projected-box IoU fitness (torch).

Port of ``boxfusion_tpu/fusion/kernel.py``.  Capability target: the inline
CUDA kernel ``compute_iou_value`` of the original BoxFusion (reference
boxfusion/box_fusion.py:63-407).  Per (particle, view) cell:

  1. perturb the candidate box with ``PST[node] * search_size``
     (box_fusion.py:296-307, dims clamped >= 0.01);
  2. build 8 corners from the (l, h, w) template, rotate by the fixed box
     rotation, translate (310-331);
  3. project into the view with the camera pose + pinhole K, clamping uv to
     the image rectangle (347-360);
  4. take the 2D convex hulls of the projected points and of the observed
     box corners, intersect them and evaluate the projected IoU;
  5. average |1 - IoU| over the valid views (400-401, 454).

Convex hulls come from the *all-pairs half-plane test* (a pair (i, j) of
points is a hull edge iff every point lies on one side of the line through
it) and the intersection area from a Green's-theorem boundary integral of
each hull's edges clipped to the other's half-planes -- fixed shapes, no
heap, no data-dependent control flow.

Two implementations of ``multiview_fitness``:
  * ``impl="kernel"``: the observed polygons are prepared once per view
    (``ops.fitness_kernel.prepare_observed``) and every (object x view x
    particle) cell goes through ``ops.fitness_kernel.fitness_cells`` -- the
    hand-written CUDA kernel on a GPU tensor, its plain twin on a CPU
    tensor.  This is one iteration's fitness; the optimizer's main path
    runs the whole search in ``ops.pst_search`` on the same arithmetic;
  * ``impl="reference"``: the vectorised ``prepare_polygon`` path below
    (the JAX package's ``impl="xla"``), held against the JAX code in tests.
"""
from __future__ import annotations

import numpy as np
import torch

from boxfusion_tpu_torch.geometry.boxes import CORNER_SIGNS

_EPS = 1e-9

# All 28 unordered index pairs of 8 points (np.triu_indices order).
_PAIR_I, _PAIR_J = np.triu_indices(8, k=1)


def _pair_sides(pts: torch.Tensor):
    """Per candidate edge (all 28 point pairs): signed sides + tolerance.

    The single source of the side-sign geometry shared by
    ``_hull_halfplanes`` and ``_ordered_hull``.

    Args:
      pts: (..., 8, 2).

    Returns (pi (..., 28, 2), e (..., 28, 2), s (..., 28, 8), tol (..., 28, 1)).
    """
    pi = pts[..., _PAIR_I, :]
    e = pts[..., _PAIR_J, :] - pi
    # sides from point *differences* (cross(e, p - pi)) avoid the
    # cancellation of expanding n.p - n.pi at image-scale coordinates.
    rel = pts[..., None, :, :] - pi[..., :, None, :]  # (..., 28, 8, 2)
    s = e[..., :, None, 0] * rel[..., 1] - e[..., :, None, 1] * rel[..., 0]
    mag = rel.abs().amax(dim=(-2, -1)) * e.abs().amax(-1)  # (..., 28)
    tol = (2e-5 * mag + 1e-9)[..., None]
    return pi, e, s, tol


def _hull_halfplanes(pts: torch.Tensor):
    """Half-planes of the convex hull of 8 points.

    Returns normals (..., 28, 2), offsets (..., 28), valid (..., 28) such
    that a point x is inside the hull iff n.x + d >= -eps for every valid
    plane.
    """
    pi, e, s, tol = _pair_sides(pts)
    n = torch.stack([-e[..., 1], e[..., 0]], dim=-1)  # left normal of i->j
    all_nonneg = (s >= -tol).all(-1)
    all_nonpos = (s <= tol).all(-1)
    nondegenerate = e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1] > _EPS
    valid = nondegenerate & (all_nonneg | all_nonpos)
    sign = torch.where(all_nonneg, 1.0, -1.0)[..., None]
    n = n * sign
    d = -(n[..., 0] * pi[..., 0] + n[..., 1] * pi[..., 1])
    return n, d, valid


def _ordered_hull(pts: torch.Tensor) -> torch.Tensor:
    """Hull vertices of 8 points in angular order, padded to 8.

    Non-hull points are replaced by the first hull vertex (harmless repeats:
    zero-length edges contribute nothing to areas or clips).
    """
    _, _, s, tol = _pair_sides(pts)
    _, _, valid = _hull_halfplanes(pts)
    on_edge = (s.abs() <= tol) & valid[..., None]
    is_vertex = on_edge.any(-2)  # (..., 8)
    # a fully degenerate set (no valid edge) keeps all its points
    is_vertex = is_vertex | ~valid.any(-1, keepdim=True)

    first = torch.argmax(is_vertex.to(torch.uint8), dim=-1)  # first True
    anchor = torch.gather(pts, -2, first[..., None, None].expand(*first.shape, 1, 2))
    filled = torch.where(is_vertex[..., None], pts, anchor)

    total = torch.where(is_vertex[..., None], pts, 0.0).sum(-2)
    count = torch.clamp(is_vertex.sum(-1, keepdim=True), min=1).to(pts.dtype)
    center = total / count
    ang = torch.atan2(filled[..., 1] - center[..., None, 1], filled[..., 0] - center[..., None, 0])
    order = torch.argsort(ang, dim=-1, stable=True)
    return torch.gather(filled, -2, order[..., None].expand(*order.shape, 2))


def _signed_area_ccw(hull: torch.Tensor) -> torch.Tensor:
    """Signed shoelace sum (positive for CCW) over an 8-vertex closed hull."""
    nxt = torch.roll(hull, -1, dims=-2)
    return (hull[..., 0] * nxt[..., 1] - nxt[..., 0] * hull[..., 1]).sum(-1) / 2.0


def _clipped_boundary_integral(hull: torch.Tensor, planes, tol_sign: float) -> torch.Tensor:
    """Green's-theorem line integral of one polygon's edges clipped to the
    other polygon's half-planes.

    Each edge p->q of `hull` meets a convex region in one parameter interval
    [t0, t1] (Liang-Barsky against every half-plane); the clipped segment
    contributes cross(p(t0), p(t1)) to the closed boundary integral (= 2x
    the intersection area once both polygons' contributions are summed).
    `tol_sign` breaks ties on shared collinear boundaries: +1 (inclusive)
    for the first polygon, -1 (exclusive) for the second.

    Args:
      hull: (..., 8, 2).  planes: (n (..., 28, 2), d (..., 28), valid (..., 28)).

    Returns:
      (...,) integral.
    """
    n, d, valid = planes
    p = hull
    e = torch.roll(hull, -1, dims=-2) - hull  # (..., 8, 2)

    nx, ny = n[..., None, :, 0], n[..., None, :, 1]  # (..., 1, 28)
    sp = p[..., :, None, 0] * nx + p[..., :, None, 1] * ny + d[..., None, :]  # (..., 8, 28)
    se = e[..., :, None, 0] * nx + e[..., :, None, 1] * ny
    sq = sp + se

    tol = (2e-5 * sp.abs().amax(-2, keepdim=True) + 1e-9) * (-tol_sign)

    inside_p = sp >= tol
    inside_q = sq >= tol
    denom = torch.where(se.abs() < _EPS, _EPS, -se)  # sp - sq = -se
    t_star = (sp - tol) / denom

    valid = valid[..., None, :]
    entering = ~inside_p & inside_q & valid
    exiting = inside_p & ~inside_q & valid
    both_out = ~inside_p & ~inside_q & valid

    t0 = torch.where(entering, t_star, 0.0).amax(-1)
    t1 = torch.where(exiting, t_star, 1.0).amin(-1)
    empty = both_out.any(-1) | (t0 >= t1)

    a = p + t0[..., None] * e
    b = p + t1[..., None] * e
    contrib = a[..., 0] * b[..., 1] - b[..., 0] * a[..., 1]
    return torch.where(empty, 0.0, contrib).sum(-1)


def prepare_polygon(pts: torch.Tensor):
    """Hull + half-planes + area of 8-point sets (reusable across pairs).

    Args:
      pts: (..., 8, 2), pre-centered by the caller.

    Returns:
      (hull (..., 8, 2), planes (n, d, valid), area (...,)).
    """
    hull = _ordered_hull(pts)
    return hull, _hull_halfplanes(pts), _signed_area_ccw(hull).abs()


def prepared_polygon_iou(prep_a, prep_b) -> torch.Tensor:
    """IoU of two (broadcastable) `prepare_polygon` outputs."""
    hull_a, planes_a, area_a = prep_a
    hull_b, planes_b, area_b = prep_b
    inter2 = _clipped_boundary_integral(hull_a, planes_b, +1.0) + _clipped_boundary_integral(
        hull_b, planes_a, -1.0
    )
    inter = torch.clamp(inter2 / 2.0, min=0.0)
    # a convex intersection never exceeds either hull; clamp float noise.
    inter = torch.minimum(inter, torch.minimum(area_a, area_b))
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / (union + 1e-5), 0.0)


def convex_polygon_iou(pts_a: torch.Tensor, pts_b: torch.Tensor) -> torch.Tensor:
    """IoU of the convex hulls of two (..., 8, 2) point sets.

    Both sets are centred jointly: IoU is translation-invariant and small
    coordinates keep every float32 cross product well-conditioned.
    """
    center = 0.5 * (pts_a.mean(-2, keepdim=True) + pts_b.mean(-2, keepdim=True))
    return prepared_polygon_iou(prepare_polygon(pts_a - center), prepare_polygon(pts_b - center))


def perturb_candidates(xyzlhw: torch.Tensor, pst: torch.Tensor, search_size: torch.Tensor):
    """Candidate boxes: params + PST * search_size (box_fusion.py:296-307).

    Args:
      xyzlhw: (..., 6) current boxes (x, y, z, l, h, w).
      pst: (P, 6) particle table; row 0 is the identity particle.
      search_size: (..., 6) per-dof scales ([0:3] center, [3] l, [4] h, [5] w).

    Returns:
      (..., P, 6) perturbed boxes with dims clamped >= 0.01.
    """
    cand = xyzlhw[..., None, :] + pst * search_size[..., None, :]
    return torch.cat([cand[..., :3], torch.clamp(cand[..., 3:], min=0.01)], dim=-1)


def project_candidates(
    xyzlhw: torch.Tensor,
    R: torch.Tensor,
    pst: torch.Tensor,
    search_size: torch.Tensor,
    cam_poses: torch.Tensor,
    K: torch.Tensor,
    H: float,
    W: float,
) -> torch.Tensor:
    """Clamped image corners of every candidate box in every view.

    Args:
      xyzlhw: (N, 6); R: (N, 3, 3); pst: (P, 6); search_size: (N, 6);
      cam_poses: (N, V, 4, 4) camera-to-world; K: (3, 3); H, W: image bounds.

    Returns:
      (N, V, P, 8, 2) uv.
    """
    cand = perturb_candidates(xyzlhw, pst, search_size)  # (N, P, 6)
    # corners: template order l->X, h->Y, w->Z (box_fusion.py:310-319)
    signs = torch.as_tensor(CORNER_SIGNS, dtype=cand.dtype, device=cand.device)
    local = signs * (cand[..., None, 3:] * 0.5)  # (N, P, 8, 3)
    corners = torch.einsum("nij,npkj->npki", R, local) + cand[..., None, :3]

    # world -> camera via pose^-1 (box_fusion.py:347-354)
    rot = cam_poses[..., :3, :3]  # (N, V, 3, 3)
    t = cam_poses[..., :3, 3]  # (N, V, 3)
    rel = corners[:, None] - t[:, :, None, None]  # (N, V, P, 8, 3)
    cam = torch.einsum("nvji,nvpkj->nvpki", rot, rel)
    # guard z ~ 0 (padded view slots) against NaN; the clamp below bounds
    # the result like the reference's uv clamp (box_fusion.py:359-360).
    z = cam[..., 2]
    z = torch.where(z.abs() < 1e-9, 1e-9, z)
    u = torch.clamp(K[0, 0] * cam[..., 0] / z + K[0, 2], 0.0, float(W))
    v = torch.clamp(K[1, 1] * cam[..., 1] / z + K[1, 2], 0.0, float(H))
    return torch.stack([u, v], dim=-1)


def kernel_inputs(uv: torch.Tensor, prep: dict, view_mask: torch.Tensor):
    """Arguments of ``ops.fitness_kernel.fitness_cells`` for (N, V) cells.

    Args:
      uv: (N, V, P, 8, 2) candidate corners; prep: ``prepare_observed`` of
        the (N * V) observed polygons; view_mask: (N, V).

    Returns:
      (u, v, hull, planes, pvalid, area, wmask): u, v (N*V, 8, P) centred
      per view, particle-minor and contiguous; the rest per cell.
    """
    N, V, P = uv.shape[:3]
    uv_c = uv - prep["center"].reshape(N, V, 1, 1, 2)
    u = uv_c[..., 0].permute(0, 1, 3, 2).reshape(N * V, 8, P).contiguous()
    v = uv_c[..., 1].permute(0, 1, 3, 2).reshape(N * V, 8, P).contiguous()
    wmask = view_mask.reshape(N * V, 1).to(torch.float32)
    return (
        u, v, prep["hull"].contiguous(), prep["planes"].contiguous(),
        prep["pvalid"].contiguous(), prep["area"][:, None].contiguous(),
        wmask.contiguous(),
    )


def cell_fitness(uv: torch.Tensor, prep: dict, view_mask: torch.Tensor, cells) -> torch.Tensor:
    """Fitness of every particle from the per-cell errors of ``cells``
    (``fitness_cells`` or its plain twin): their sum over the live views,
    divided by (live views + 1e-6).

    Args:
      uv: (N, V, P, 8, 2) candidate corners; prep: ``prepare_observed`` of
        the (N * V) observed polygons; view_mask: (N, V).

    Returns:
      (N, P) fitness values (lower is better).
    """
    N, V, P = uv.shape[:3]
    live = view_mask > 0
    err = cells(*kernel_inputs(uv, prep, live))  # (N*V, P), view-masked
    return err.reshape(N, V, P).sum(1) / (live.sum(-1) + 1e-6)[:, None]


def multiview_fitness(
    xyzlhw: torch.Tensor,
    R: torch.Tensor,
    pst: torch.Tensor,
    search_size: torch.Tensor,
    cam_poses: torch.Tensor,
    obs_corners: torch.Tensor,
    view_mask: torch.Tensor,
    K: torch.Tensor,
    H: float,
    W: float,
    impl: str = "kernel",
    prep: dict | None = None,
) -> torch.Tensor:
    """Fitness of every PST particle: mean over views of |1 - projected IoU|.

    One ``evaluate_iou`` call of the reference (box_fusion.py:413-461) for a
    batch of N objects, with masked view slots instead of a dynamic count.
    Unbatched inputs (xyzlhw (6,), R (3, 3), ...) give a (P,) result.

    Args:
      xyzlhw: (N, 6), R: (N, 3, 3) fixed rotation of each candidate box.
      pst: (P, 6).  search_size: (N, 6).
      cam_poses: (N, V, 4, 4) camera-to-world per member view.
      obs_corners: (N, V, 8, 2) observed projected 2D corners per view.
      view_mask: (N, V) validity of each view slot.
      K: (3, 3); H, W: image bounds for uv clamping.
      impl: "kernel" (fitness_cells) or "reference" (prepare_polygon path).
      prep: optional ``prepare_observed(obs_corners.reshape(-1, 8, 2))`` for
        impl="kernel" -- constant across optimizer iterations.

    Returns:
      (N, P) fitness values (lower is better).
    """
    if xyzlhw.dim() == 1:
        out = multiview_fitness(
            xyzlhw[None], R[None], pst, search_size[None], cam_poses[None],
            obs_corners[None], view_mask[None], K, H, W, impl,
        )
        return out[0]

    uv = project_candidates(xyzlhw, R, pst, search_size, cam_poses, K, H, W)
    N, V, P = uv.shape[:3]

    if impl == "kernel":
        from boxfusion_tpu_torch.ops.fitness_kernel import fitness_cells, prepare_observed

        if prep is None:
            prep = prepare_observed(obs_corners.reshape(N * V, 8, 2))
        return cell_fitness(uv, prep, view_mask, fitness_cells)
    if impl != "reference":
        raise ValueError(f"impl must be 'kernel' or 'reference', got {impl!r}")

    # the observed polygon is shared by all particles of a view: prepare it
    # once per view, not per (particle, view)
    center_v = obs_corners.mean(-2)  # (N, V, 2)
    hull_b, (n_b, d_b, valid_b), area_b = prepare_polygon(obs_corners - center_v[..., None, :])
    prep_b = (hull_b[:, :, None], (n_b[:, :, None], d_b[:, :, None], valid_b[:, :, None]), area_b[:, :, None])
    prep_a = prepare_polygon(uv - center_v[:, :, None, None])  # over (N, V, P)
    iou = prepared_polygon_iou(prep_a, prep_b)  # (N, V, P)
    # where-mask (not multiply) so NaNs from padded view slots cannot leak
    err = torch.where(view_mask[..., None] > 0, (1.0 - iou).abs(), 0.0)
    return err.sum(1) / ((view_mask > 0).sum(-1) + 1e-6)[:, None]
