"""3D average precision over oriented boxes.

Port of ``boxfusion_tpu/eval/ap3d.py`` (numpy, with the port's IoU block).
The reference never released its evaluation code (its README lists it as a
TODO; SURVEY.md section 6) -- this module supplies it: standard
detection-style AP at a 3D IoU threshold (AP@0.25 / AP@0.5), with the OBB
IoU computed by the same device kernel the pipeline uses
(geometry/iou.py's containment-gated 25^3 grid IoU), so evaluation and
association agree on geometry.  The IoU runs on ``device`` (default the
card; ``device="cpu"`` asks for the plain path).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from boxfusion_tpu_torch.fusion.association import iou_block
from boxfusion_tpu_torch.utils.device import DeviceLike


def match_detections(
    pred_corners: np.ndarray,
    pred_scores: np.ndarray,
    gt_corners: np.ndarray,
    iou_thresh: float = 0.25,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, int]:
    """Greedy score-descending matching of detections to GT boxes.

    Args:
      pred_corners: (P, 8, 3); pred_scores: (P,); gt_corners: (G, 8, 3).

    Returns:
      (tp (P,) bool aligned with score-descending order, n_gt).
    """
    order = np.argsort(-pred_scores, kind="stable")
    P, G = len(pred_corners), len(gt_corners)
    tp = np.zeros(P, bool)
    if P == 0 or G == 0:
        return tp, G

    iou = iou_block(pred_corners[order], gt_corners, device=device)  # (P, G)
    taken = np.zeros(G, bool)
    for r in range(P):
        row = np.where(taken, -1.0, iou[r])
        g = int(np.argmax(row))
        if row[g] >= iou_thresh:
            tp[r] = True
            taken[g] = True
    return tp, G


def average_precision_3d(
    per_sequence: Sequence[Dict[str, np.ndarray]],
    iou_thresh: float = 0.25,
    device: DeviceLike = None,
) -> Dict[str, float]:
    """Dataset-level AP.

    Args:
      per_sequence: list of dicts with keys ``pred_corners`` (P, 8, 3),
        ``pred_scores`` (P,), ``gt_corners`` (G, 8, 3).

    Returns:
      dict(ap, precision, recall, n_pred, n_gt) at the threshold.
    """
    all_tp: List[np.ndarray] = []
    all_scores: List[np.ndarray] = []
    n_gt = 0
    for seq in per_sequence:
        tp, g = match_detections(
            np.asarray(seq["pred_corners"], np.float32),
            np.asarray(seq["pred_scores"], np.float32),
            np.asarray(seq["gt_corners"], np.float32),
            iou_thresh,
            device,
        )
        order = np.argsort(-np.asarray(seq["pred_scores"]), kind="stable")
        all_tp.append(tp)
        all_scores.append(np.asarray(seq["pred_scores"])[order])
        n_gt += g

    if not all_tp or n_gt == 0:
        return dict(ap=0.0, precision=0.0, recall=0.0, n_pred=0, n_gt=n_gt)

    tp = np.concatenate(all_tp)
    scores = np.concatenate(all_scores)
    order = np.argsort(-scores, kind="stable")
    tp = tp[order]

    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(~tp)
    recall = cum_tp / n_gt
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1)

    # COCO-style 101-point interpolation
    ap = 0.0
    for t in np.linspace(0, 1, 101):
        mask = recall >= t
        ap += (precision[mask].max() if mask.any() else 0.0) / 101.0

    return dict(
        ap=float(ap),
        precision=float(precision[-1]) if len(precision) else 0.0,
        recall=float(recall[-1]) if len(recall) else 0.0,
        n_pred=int(len(tp)),
        n_gt=int(n_gt),
    )


def average_precision_3d_per_class(
    per_sequence: Sequence[Dict[str, np.ndarray]],
    iou_thresh: float = 0.25,
    device: DeviceLike = None,
) -> Dict:
    """Per-class AP + mAP (detections only match GT of their own class).

    Args:
      per_sequence: like ``average_precision_3d`` plus ``pred_classes`` (P,)
        and ``gt_classes`` (G,) -- ints or strings (e.g. the open-vocab
        category labels the pipeline assigns via CLIP).

    Returns:
      dict(map, per_class={cls: ap-metrics}); classes with no GT anywhere
      are reported but excluded from the mean.
    """
    classes: set = set()
    for seq in per_sequence:
        classes.update(np.asarray(seq["gt_classes"]).tolist())
        classes.update(np.asarray(seq["pred_classes"]).tolist())
    per_class = {}
    for c in sorted(classes, key=str):
        filtered = []
        for seq in per_sequence:
            pm = np.asarray(seq["pred_classes"]) == c
            gm = np.asarray(seq["gt_classes"]) == c
            filtered.append(
                dict(
                    pred_corners=np.asarray(seq["pred_corners"], np.float32)[pm],
                    pred_scores=np.asarray(seq["pred_scores"], np.float32)[pm],
                    gt_corners=np.asarray(seq["gt_corners"], np.float32)[gm],
                )
            )
        per_class[c] = average_precision_3d(filtered, iou_thresh, device)
    with_gt = [m["ap"] for m in per_class.values() if m["n_gt"] > 0]
    return dict(
        map=float(np.mean(with_gt)) if with_gt else 0.0,
        per_class=per_class,
    )
