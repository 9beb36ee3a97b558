"""2D box IoU and oriented-3D-box (OBB) volumetric IoU (torch).

Port of ``boxfusion_tpu/geometry/iou.py``.  Parity targets in the reference:
  * Instances3D.IoU_2D_box (instances.py:643-668).
  * Instances3D.obb_iou (instances.py:573-613): a cheap vertex-containment
    intersection gate (check_intersection, instances.py:514-557, with edge
    midpoint augmentation) followed by a 25^3 grid-sampled volumetric IoU
    over the pair's joint AABB.

All containment tests are written as explicit f32 multiply-adds (no matmul),
so neither TF32 nor a library's reduction order can flip a corner-on-face
decision.
"""
from __future__ import annotations

import numpy as np
import torch

# Edge list used for midpoint augmentation (reference instances.py:493-512).
_AUG_EDGES = np.array(
    [
        [0, 1], [0, 4], [1, 5], [4, 5],
        [2, 3], [2, 6], [6, 7], [3, 7],
        [0, 3], [4, 7], [1, 2], [5, 6],
    ],
    dtype=np.int64,
)

GRID_SAMPLES_PER_AXIS = 25

# Budget for `gated_pair_iou`: gated pairs past it are scored 0 (the JAX
# package's MAX_GATED_PAIRS).
MAX_GATED_PAIRS = 1024


def iou_2d(box: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """IoU of one xyxy box against N xyxy boxes (instances.py:643-668)."""
    area_a = (box[2] - box[0]) * (box[3] - box[1])
    area_b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    iw = torch.clamp(torch.minimum(box[2], boxes[:, 2]) - torch.maximum(box[0], boxes[:, 0]), min=0.0)
    ih = torch.clamp(torch.minimum(box[3], boxes[:, 3]) - torch.maximum(box[1], boxes[:, 1]), min=0.0)
    inter = iw * ih
    return inter / (area_a + area_b - inter + 1e-6)


def _box_frame(corners: torch.Tensor):
    """(center, unit axes (rows), half dims) from template-ordered corners.

    Corners follow CORNER_SIGNS: v1-v0 spans local X (length l), v3-v0
    local Y (h), v4-v0 local Z (w).
    """
    center = corners.mean(-2)
    axes = torch.stack(
        [corners[..., j, :] - corners[..., 0, :] for j in (1, 3, 4)], dim=-2
    )  # (..., 3, 3) rows = axis vectors
    lens = torch.sqrt((axes * axes).sum(-1, keepdim=True))
    units = axes / torch.clamp(lens, min=1e-12)
    return center, units, lens[..., 0] * 0.5


def _project_on_axes(rel: torch.Tensor, units: torch.Tensor) -> torch.Tensor:
    """rel (..., P, 3) onto the 3 unit axes (..., 3, 3) -> (..., P, 3)."""
    u = units[..., None, :, :]  # (..., 1, 3 axes, 3 comps)
    r = rel[..., :, None, :]    # (..., P, 1, 3 comps)
    return r[..., 0] * u[..., 0] + r[..., 1] * u[..., 1] + r[..., 2] * u[..., 2]


def _points_in_box(points, center, units, half, eps=1e-6):
    """Whether each point lies inside the oriented box (all |proj| <= half+eps)."""
    proj = _project_on_axes(points - center[..., None, :], units)
    return (proj.abs() <= half[..., None, :] + eps).all(-1)


def _augment(corners: torch.Tensor) -> torch.Tensor:
    """Corners + 12 edge midpoints -> (..., 20, 3) (instances.py:493-512)."""
    e = torch.as_tensor(_AUG_EDGES, device=corners.device)
    mid = 0.5 * (corners[..., e[:, 0], :] + corners[..., e[:, 1], :])
    return torch.cat([corners, mid], dim=-2)


def obb_intersect_mask(corners_a: torch.Tensor, corners_b: torch.Tensor) -> torch.Tensor:
    """Cheap intersection gate: any augmented vertex of one box inside the other.

    Matches check_intersection (instances.py:514-557).  Broadcasts over the
    leading dims of both inputs.

    Args:
      corners_a, corners_b: (..., 8, 3).

    Returns:
      boolean (...,).
    """
    ca, ua, ha = _box_frame(corners_a)
    cb, ub, hb = _box_frame(corners_b)
    a_in_b = _points_in_box(_augment(corners_a), cb, ub, hb).any(-1)
    b_in_a = _points_in_box(_augment(corners_b), ca, ua, ha).any(-1)
    return a_in_b | b_in_a


def _lattice_fractions(samples: int, dtype, device) -> torch.Tensor:
    """jnp.linspace(0, 1, samples) in float32: i / (samples - 1), exact ends."""
    return torch.arange(samples, dtype=dtype, device=device) / float(samples - 1)


def obb_grid_iou_pairs(
    corners_a: torch.Tensor,
    corners_b: torch.Tensor,
    samples_per_axis: int = GRID_SAMPLES_PER_AXIS,
) -> torch.Tensor:
    """Grid-sampled volumetric IoU over N (a, b) pairs, without the gate.

    Samples a samples^3 lattice over each pair's joint AABB and counts the
    lattice points inside each box and in both (instances.py:573-613).

    Args:
      corners_a, corners_b: (N, 8, 3) world corners (template layout).

    Returns:
      (N,) IoU values.
    """
    allc = torch.cat([corners_a, corners_b], dim=1)  # (N, 16, 3)
    lo = allc.amin(1)
    hi = allc.amax(1)
    t = _lattice_fractions(samples_per_axis, corners_a.dtype, corners_a.device)

    def coord(axis, shape):
        span = (hi[:, axis] - lo[:, axis])[:, None]
        return (lo[:, axis][:, None] + t[None] * span).reshape(shape)

    n = corners_a.shape[0]
    px = coord(0, (n, -1, 1, 1))
    py = coord(1, (n, 1, -1, 1))
    pz = coord(2, (n, 1, 1, -1))

    def in_box(corners):
        c, u, h = _box_frame(corners)
        rx = px - c[:, 0].reshape(n, 1, 1, 1)
        ry = py - c[:, 1].reshape(n, 1, 1, 1)
        rz = pz - c[:, 2].reshape(n, 1, 1, 1)
        ins = None
        for j in range(3):
            pj = (
                rx * u[:, j, 0].reshape(n, 1, 1, 1)
                + ry * u[:, j, 1].reshape(n, 1, 1, 1)
                + rz * u[:, j, 2].reshape(n, 1, 1, 1)
            )
            ok = pj.abs() <= (h[:, j] + 1e-6).reshape(n, 1, 1, 1)
            ins = ok if ins is None else ins & ok
        return ins

    in_a = in_box(corners_a)
    in_b = in_box(corners_b)
    n_a = in_a.sum((1, 2, 3)).float()
    n_b = in_b.sum((1, 2, 3)).float()
    n_ab = (in_a & in_b).sum((1, 2, 3)).float()
    return n_ab / (n_a + n_b - n_ab + 1e-6)


def obb_grid_iou(
    corners_a: torch.Tensor,
    corners_b: torch.Tensor,
    samples_per_axis: int = GRID_SAMPLES_PER_AXIS,
) -> torch.Tensor:
    """Gated grid-sampled volumetric IoU of two oriented boxes (8, 3) each.

    IoU = 0 when the cheap containment gate fails, exactly as the reference.
    """
    iou = obb_grid_iou_pairs(corners_a[None], corners_b[None], samples_per_axis)[0]
    return torch.where(obb_intersect_mask(corners_a, corners_b), iou, 0.0)


def gated_pair_iou(
    corners_q: torch.Tensor,
    mask_q: torch.Tensor,
    corners_all: torch.Tensor,
    mask_all: torch.Tensor,
    max_pairs: int = MAX_GATED_PAIRS,
    samples_per_axis: int = GRID_SAMPLES_PER_AXIS,
    static_pairs: bool = False,
):
    """(Q x A) gated pairwise OBB IoU under a fixed pair budget.

    The one implementation of the reference's obb_iou call-site semantics
    (instances.py:573-613: the containment gate forces IoU = 0, grid IoU
    otherwise), shared by the host engine (fusion/association.py) and the
    device engine (runtime/device_step.py): the cheap gate runs densely over
    all (Q x A) pairs of valid boxes, then the 25^3 lattice IoU runs only on
    the first `max_pairs` gated pairs in row-major order -- the pairs the JAX
    package's ``top_k`` over the 0/1 gate selects.  Gated pairs beyond the
    budget are scored 0; the caller reports ``n_gated - max_pairs``.

    Args:
      corners_q: (Q, 8, 3) query world corners; mask_q: (Q,) validity.
      corners_all: (A, 8, 3); mask_all: (A,).
      static_pairs: False reads the gated count to the host (one
        device-to-host read) and runs the lattice on the gated pairs only.
        True reads nothing: the lattice runs on min(max_pairs, Q * A) pairs,
        gated ones first, the others scored 0, and ``n_gated`` stays a tensor.

    Returns:
      (pair_idx (k,) int64 flat row-major indices into Q*A, vals (k,) IoUs,
      n_gated: int, or a 0-d int32 tensor with ``static_pairs``).
    """
    A = corners_all.shape[0]
    gate = obb_intersect_mask(corners_q[:, None], corners_all[None])  # (Q, A)
    flat = (gate & mask_q.bool()[:, None] & mask_all.bool()[None]).reshape(-1)
    if static_pairs:
        k = min(max_pairs, flat.shape[0])
        n_gated = flat.sum().to(torch.int32)
        # stable: gated pairs first, each group in ascending flat index
        pair_idx = torch.sort(flat.to(torch.int8), descending=True, stable=True).indices[:k]
    else:
        flat_idx = torch.nonzero(flat).reshape(-1)
        n_gated = int(flat_idx.numel())
        pair_idx = flat_idx[:max_pairs]
    if pair_idx.shape[0] == 0:
        return pair_idx, corners_q.new_zeros(0), n_gated
    vals = obb_grid_iou_pairs(
        corners_q[pair_idx // A], corners_all[pair_idx % A], samples_per_axis
    )
    if static_pairs:
        vals = torch.where(flat[pair_idx], vals, 0.0)
    return pair_idx, vals, n_gated


def pairwise_obb_iou(
    corners: torch.Tensor,
    valid: torch.Tensor | None = None,
    samples_per_axis: int = GRID_SAMPLES_PER_AXIS,
    row_chunk: int = 8,
) -> torch.Tensor:
    """Full (N, N) OBB IoU matrix (the gated lattice IoU of every pair).

    Computed ``row_chunk`` rows at a time, which bounds the live sample
    tensors to (row_chunk * N, S, S, S) booleans.  Invalid rows / columns
    (per ``valid``) and the diagonal get IoU 0.

    Args:
      corners: (N, 8, 3).
      valid: optional (N,) mask.

    Returns:
      (N, N) IoU matrix (symmetric up to sampling).
    """
    n = corners.shape[0]
    rows = []
    for r0 in range(0, n, row_chunk):
        m = min(row_chunk, n - r0)
        a = corners[r0:r0 + m, None].expand(m, n, 8, 3).reshape(-1, 8, 3)
        b = corners[None].expand(m, n, 8, 3).reshape(-1, 8, 3)
        iou = obb_grid_iou_pairs(a, b, samples_per_axis)
        rows.append(torch.where(obb_intersect_mask(a, b), iou, 0.0).reshape(m, n))
    mat = torch.cat(rows) if rows else corners.new_zeros((0, 0))
    keep = ~torch.eye(n, dtype=torch.bool, device=corners.device)
    if valid is not None:
        v = valid.to(torch.bool)
        keep = keep & v[:, None] & v[None, :]
    return torch.where(keep, mat, 0.0)
