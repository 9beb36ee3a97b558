"""DETR-style set losses for CuTR training / fine-tuning (PyTorch).

Port of ``boxfusion_tpu/train/loss.py``.  The reference is inference-only
(SURVEY.md section 1: "no training loop"); this module supervises the
model's own output heads (foreground logits, 2D boxes, projected centers, z,
dims, yaw pose) with a set-matching criterion.

Matching is the JAX package's greedy assignment (its ``lax.scan`` over the
padded GT slots becomes a Python loop over the G slots): for each GT in
order, the cheapest query not yet taken, ties to the lowest index.  Every
step stays on the device; nothing is read back to the host.

Both functions also take a leading batch dimension, so a training step
scores a whole batch with G launches of the loop instead of B * G.
"""
from __future__ import annotations

from typing import Dict

import torch


def greedy_match(cost: torch.Tensor, gt_mask: torch.Tensor) -> torch.Tensor:
    """Greedy assignment: for each GT (in order), the cheapest free query.

    Args:
      cost: (..., Q, G) pairwise cost.
      gt_mask: (..., G) valid GT slots.

    Returns:
      (..., G) int64 query index per GT (undefined where gt_mask is False).
    """
    Q, G = cost.shape[-2:]
    gt_mask = gt_mask.bool()
    taken = torch.zeros(cost.shape[:-1], dtype=torch.bool, device=cost.device)
    queries = torch.arange(Q, device=cost.device)
    assign = []
    for g in range(G):
        c = cost[..., g] + torch.where(taken, 1e9, 0.0)
        q = torch.argmin(c, dim=-1)  # the first index among ties, as jnp.argmin
        taken = taken | ((queries == q[..., None]) & gt_mask[..., g, None])
        assign.append(q)
    return torch.stack(assign, dim=-1)


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with ``jnp.abs``'s gradient at 0 (+1; ``torch.abs`` gives 0).  A
    yaw-only pose has exact 0 / 1 entries, which meet an identity target
    exactly."""
    return torch.where(x >= 0, x, -x)


def _take(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """x[b, q[b, g]] for (B, Q, ...) x and (B, G) q."""
    idx = q.reshape(q.shape + (1,) * (x.dim() - 2))
    return torch.take_along_dim(x, idx, dim=1)


def detection_loss(
    pred: Dict[str, torch.Tensor],
    targets: Dict[str, torch.Tensor],
    image_size: float,
) -> Dict[str, torch.Tensor]:
    """Set loss for one image, or for each image of a batch.

    Args:
      pred: dict with logits (Q, 2), boxes cxcywh (Q, 4), proj_xy (Q, 2),
        z_scaled (Q, 1), dims (Q, 3), pose (Q, 3, 3); or each with a leading
        batch dimension B.
      targets: dict with boxes2d cxcywh (G, 4), proj_xy (G, 2), z (G, 1),
        dims (G, 3), pose (G, 3, 3), mask (G,); with B leading where pred
        has it.
      image_size: normalization scale for 2D quantities.

    Returns:
      dict of losses (cls, box2d, center, z, dims, pose, total): scalars, or
      (B,) per image.
    """
    batched = pred["logits"].dim() == 3
    if not batched:
        pred = {k: v[None] for k, v in pred.items()}
        targets = {k: v[None] for k, v in targets.items()}
    logits = pred["logits"]
    boxes = pred["boxes"] / image_size
    gt_boxes = targets["boxes2d"] / image_size
    gt_mask = targets["mask"].to(logits.dtype)

    cost = -torch.sigmoid(logits[..., 0:1]) + _abs(boxes[:, :, None] - gt_boxes[:, None]).sum(-1)
    q = greedy_match(cost.detach(), gt_mask)  # (B, G); the assignment carries no gradient

    def l1(a, b):
        return _abs(a - b).sum(-1)

    n = torch.clamp(gt_mask.sum(-1), min=1.0)
    box_l = (l1(_take(boxes, q), gt_boxes) * gt_mask).sum(-1) / n
    ctr_l = (l1(_take(pred["proj_xy"], q) / image_size, targets["proj_xy"] / image_size)
             * gt_mask).sum(-1) / n
    z_l = (l1(_take(pred["z_scaled"], q), targets["z"]) * gt_mask).sum(-1) / n
    dims_l = (l1(_take(pred["dims"], q), targets["dims"]) * gt_mask).sum(-1) / n
    pose_l = (_abs(_take(pred["pose"], q) - targets["pose"]).sum((-1, -2)) * gt_mask).sum(-1) / n

    # foreground BCE: matched queries are positives on class 0
    # (JAX: zeros(Q).at[q].max(mask))
    pos = torch.zeros(logits.shape[:2], dtype=logits.dtype, device=logits.device)
    pos = pos.scatter_reduce(1, q, gt_mask, reduce="amax")
    cls_target = torch.stack([pos, torch.zeros_like(pos)], dim=-1)
    cls_l = (
        # torch.maximum splits the gradient at a tie as jnp.maximum does
        torch.maximum(logits, torch.zeros_like(logits)) - logits * cls_target
        + torch.log1p(torch.exp(-_abs(logits)))
    ).sum(-1).mean(-1)

    total = 2.0 * cls_l + 5.0 * box_l + 2.0 * ctr_l + z_l + dims_l + pose_l
    out = dict(cls=cls_l, box2d=box_l, center=ctr_l, z=z_l, dims=dims_l, pose=pose_l, total=total)
    return out if batched else {k: v[0] for k, v in out.items()}
