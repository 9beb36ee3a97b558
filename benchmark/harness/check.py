"""Whether what the timed path produced is correct.

The window's records are judged after the window has closed and the program
has been freed, stage by stage, against the plain reference
(``benchmark/reference/engine.py``), given the same frames and the same
weights from the seed:

* detect, on the sampled keyframes, ``check_label_keyframes`` more drawn
  from the seed and the keyframe with the most live rows: ``det_enc_logit``,
  the widest gap of CuTR's encoder logits, over the reference's spread of
  them; for each live row of the program's, its distance to the nearest row
  of the reference's, the decoder taking the proposals in the program's
  order (1 is 0.01 of score, 2 px of a 2D box edge, 0.02 m of a 3D box
  parameter or 0.02 of a rotation entry, whichever is largest):
  ``det_row`` the widest, ``det_row_median`` the median (a keyframe's, the
  widest over keyframes); and the other way round, ``det_miss``: the share
  of the reference's live rows, pooled over the judged keyframes, that no
  live row of the program's lies within ``MATCH_RADIUS`` of, so that a
  program that drops detections (a truncated top-k, a lowered class logit,
  a raised score filter, no live row at all) is not correct
  (``det_miss_worst``, the worst keyframe's share, is logged beside it).
* label, on the same keyframes: for each live row, the gap by which the
  class the program gave it lies below the reference's best class for the
  crop of the program's own box (CLIP's 100 x cosine, the background column
  included): ``label_sim`` the widest, ``label_sim_mean`` the mean;
  ``label_score``, the widest gap of a row's boosted score against the
  reference's score for the program's class.  The label bucket must cover
  the live rows (up to the budget), and rows past it must keep the
  background class and their raw score; either fault reads ``FAULT``.
* the keyframe step, at the positions drawn from the seed: the step from the
  program's own state before the keyframe, with the program's labelled rows,
  against the program's state after it.  ``step_mismatch`` counts the
  elements of the state that differ, the exported world of the first scan
  included, except the boxes the PST search fused and their IoU rows;
  those are judged by ``fusion_fit``: the widest gap by which the
  program's fused box's fitness (the mean 1 - IoU over its views, lower is
  better) lies above that of the reference's search from the same start.
* the PST search, on searches of the window drawn from the seed (and the
  one with the most objects): ``fusion_fit`` again, from the search's own
  inputs as the step handed them over; ``fusion_start`` is what a search
  that returned its start would read.

A cell's limits file names the numbers it compares; the others are read and
logged.

The reference can only follow the step from the program's own state: the
PST search is chaotic (a 2e-7 change of a start has moved a box 0.27 m), so
two worlds built keyframe by keyframe part within a few keyframes.
"""
from __future__ import annotations

import random
from typing import Dict, List, Set, Tuple

import numpy as np
import torch

# the distance units of ``det_row``
ROW_UNITS = dict(score=0.01, box2d_px=2.0, box3d=0.02, R=0.02)
# how near (in those units) a live row of the program's must lie to a live
# row of the reference's for ``det_miss`` to count that row as found
MATCH_RADIUS = 1.0
# the reading of a number that cannot be measured because the output is malformed
FAULT = 1e9


def sample_positions(traffic: dict, seed: int, scans) -> Set[Tuple[int, int]]:
    """Positions (scan ordinal, keyframe index) whose states the window
    keeps: ``traffic["check_keyframes"]`` drawn from the seed among the
    first scan's keyframes after its first, and the first scan's last."""
    keys = scans[0].keyframes
    rng = random.Random(int(seed))
    picks = rng.sample(keys[1:-1], min(int(traffic["check_keyframes"]), len(keys) - 2))
    return {(0, i) for i in picks} | {(0, keys[-1])}


def _row_distances(a, rows_a, b, rows_b) -> torch.Tensor:
    """(A, B) distances, in ``ROW_UNITS``, between the rows ``rows_a`` of
    detections ``a`` and the rows ``rows_b`` of ``b``: the largest of the
    score's, the 2D box's, the 3D box's and the rotation's."""
    def gap(key, unit):
        x, y = a[key][rows_a], b[key][rows_b]
        return (x[:, None] - y[None]).abs().reshape(x.shape[0], y.shape[0], -1).amax(-1) / unit

    return torch.stack([gap("scores", ROW_UNITS["score"]), gap("pred_boxes", ROW_UNITS["box2d_px"]),
                        gap("boxes3d", ROW_UNITS["box3d"]), gap("R", ROW_UNITS["R"])]).amax(0)


def _det_gaps(det, ref) -> Dict[str, float]:
    e_p, e_r = det["enc_logits"].float(), ref["enc_logits"].float()
    enc = float((e_p - e_r).abs().max() / e_r.std().clamp(min=1e-12))
    live = det["scores"] >= ref["thresh"]
    ref_live = ref["scores"] >= ref["thresh"]
    every = torch.ones_like(ref_live)
    n_ref = int(ref_live.sum())
    gaps = dict(det_enc_logit=enc, det_row=0.0, det_row_median=0.0, missed_rows=float(n_ref),
                ref_live_rows=float(n_ref))
    if bool(live.any()):
        d = _row_distances(det, live, ref, every).min(dim=1).values
        gaps.update(det_row=float(d.max()), det_row_median=float(d.median()))
        if n_ref:
            found = _row_distances(ref, ref_live, det, live).min(dim=1).values <= MATCH_RADIUS
            gaps["missed_rows"] = float(n_ref - int(found.sum()))
    gaps["det_miss_worst"] = gaps["missed_rows"] / n_ref if n_ref else 0.0
    return gaps


def _label_gaps(engine, det, label, norm_image, hw) -> Dict[str, float]:
    """The program's label outputs against the reference's similarities of
    the crops of the program's own rows."""
    scores = det["scores"]
    raw_ok = scores >= engine.raw_thresh
    n_live = int(raw_ok.sum())
    C = engine.n_classes
    if label is None:  # the program ran no tower: every row must be background at its raw score
        label = dict(b=0, new_scores=torch.where(raw_ok, scores, -1e9),
                     categories=torch.full(scores.shape, C, dtype=torch.int32, device=scores.device))
    cats = label["categories"].long()
    new = label["new_scores"]
    sims = engine.similarities(norm_image, det["pred_boxes"][:n_live], hw)  # live rows are a prefix
    best = sims.max(dim=-1).values
    got = sims.gather(1, cats[:n_live, None].clamp(max=C))[:, 0]
    gap = best - got
    sim_gap = float(gap.max()) if n_live else 0.0
    sim_mean = float(gap.mean()) if n_live else 0.0
    b = int(label["b"])
    boost = torch.where(cats[:n_live] == C, torch.tensor(-1e9, device=scores.device),
                        scores[:n_live] + engine.coeff * got / 100.0)
    # live rows past the bucket are not labelled: background class, raw score
    past = torch.arange(n_live, device=scores.device) >= b
    want = torch.where(past, scores[:n_live], boost)
    score_gap = float((new[:n_live] - want).abs().max()) if n_live else 0.0
    # the bucket must cover every live row the budget allows, and rows past
    # it keep the background class
    if b < min(n_live, engine.budget) or bool(((cats[:n_live] != C) & past).any()):
        sim_gap = FAULT
    return dict(label_sim=sim_gap, label_score=score_gap, label_sim_mean=sim_mean)


def _differing(a, b) -> int:
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.shape != b.shape:
        return max(a.numel(), b.numel())
    return int((a.cpu() != b.cpu()).sum())


def _step_gaps(engine, rec, frame, export=None) -> Dict[str, float]:
    from benchmark.reference.runtime.device_state import FIELD_NAMES, DeviceState, export_world

    before = DeviceState(**{f: getattr(rec.state_before, f) for f in FIELD_NAMES})
    after = DeviceState(**{f: getattr(rec.state_after, f) for f in FIELD_NAMES})
    label = rec.label
    if label is None:
        s = rec.det["scores"]
        masked = torch.where(s >= engine.raw_thresh, s, -1e9)
        label = dict(b=0, new_scores=masked,
                     categories=torch.full(s.shape, engine.n_classes, dtype=torch.int32, device=s.device),
                     overflow=(masked > -1e8).sum().to(torch.int32))
    record: dict = {}
    ref = engine.step(before, engine.step_input(rec.det, label), label["overflow"], frame, rec.count,
                      record=record)
    G = ref.capacity
    fused = torch.zeros(G, dtype=torch.bool, device=ref.xyzlhw.device)
    fit_gap, n_fused = 0.0, 0
    if record and bool(record["updated"].any()):
        slots = record["cand"][record["updated"]]
        fused[slots] = True
        sel = record["updated"]
        gaps = (_fitness(engine, after.xyzlhw[slots].to(ref.xyzlhw.device), record, sel)
                - _fitness(engine, ref.xyzlhw[slots], record, sel))
        fit_gap = float(gaps.max())
        n_fused = int(slots.numel())
    mismatch = 0
    for f in FIELD_NAMES:
        a, r = getattr(after, f), getattr(ref, f)
        if f == "xyzlhw":
            a, r = a[~fused.to(a.device)], r[~fused]
        elif f == "iou":
            keep = ~fused
            a, r = a[keep.to(a.device)][:, keep.to(a.device)], r[keep][:, keep]
        mismatch += _differing(a, r)
    if export is not None:
        want = export_world(after)
        for k, v in want.items():
            got = export.get(k)
            if k == "stats":
                mismatch += sum(int(got.get(n) != c) for n, c in v.items())
            elif k == "fusion_list":
                mismatch += int(got != v)
            else:
                mismatch += _differing(got, v)
    return dict(step_mismatch=float(mismatch), fusion_fit=fit_gap, judged_fusions=float(n_fused))


def _fitness(engine, boxes, rec, sel):
    from benchmark.reference.fusion.kernel import multiview_fitness

    return multiview_fitness(boxes, rec["init_R"][sel], engine.pst[:1], torch.zeros_like(boxes), rec["poses"][sel],
                             rec["corners"][sel], rec["vmask"][sel].to(torch.float32), rec["K"], rec["H"],
                             rec["W"])[:, 0]


def _search_gap(engine, rec) -> Tuple[float, float, int]:
    """(the widest fitness gap of the program's result over the reference
    search's from the same inputs, the gap a search that returned its start
    would read, objects judged)"""
    from benchmark.reference.fusion.optimizer import optimize_boxes

    with engine._precision():
        ref_fused, ref_updated = optimize_boxes(rec["init_x"], rec["init_R"], engine.pst, rec["poses"],
                                                rec["corners"], rec["vmask"], rec["active"], rec["K"], rec["H"],
                                                rec["W"], engine.step_cfg.opt, device=engine.device)
    sel = rec["active"].bool()
    if not bool(sel.any()):
        return 0.0, 0.0, 0
    prog = torch.where(rec["updated"][:, None], rec["fused"], rec["init_x"])[sel]
    ref = torch.where(ref_updated[:, None], ref_fused, rec["init_x"])[sel]
    ref_fit = _fitness(engine, ref, rec, sel)
    gaps = _fitness(engine, prog, rec, sel) - ref_fit
    start = _fitness(engine, rec["init_x"][sel], rec, sel) - ref_fit
    return float(gaps.max()), float(start.max()), int(sel.sum())


def sample_searches(searches, traffic: dict, seed: int) -> List[dict]:
    """``traffic["check_searches"]`` searches drawn from the seed among those
    with an object, and the one with the most objects."""
    live = [s for s in searches if bool(s["active"].any())]
    if not live:
        return []
    rng = random.Random(int(seed) + 1)
    picks = rng.sample(live, min(int(traffic["check_searches"]), len(live)))
    biggest = max(live, key=lambda s: int(s["active"].sum()))
    return picks + ([biggest] if all(p is not biggest for p in picks) else [])


def sample_keyframes(records, traffic: dict, seed: int) -> List:
    """``traffic["check_label_keyframes"]`` keyframes of the window drawn
    from the seed, whose detections and labels are judged besides those of
    the sampled steps."""
    rng = random.Random(int(seed) + 2)
    return rng.sample(list(records), min(int(traffic["check_label_keyframes"]), len(records)))


def judge(records, exports, scans, engine, capture: Set[Tuple[int, int]], searches=(),
          extra=()) -> Dict[str, float]:
    """The worst reading of each compared number over the judged keyframes
    (``det_miss`` pooled over them)."""
    worst: Dict[str, float] = dict(det_enc_logit=0.0, det_row=0.0, det_row_median=0.0, det_miss=0.0,
                                   det_miss_worst=0.0, missed_rows=0.0, ref_live_rows=0.0, label_sim=0.0,
                                   label_score=0.0, label_sim_mean=0.0, step_mismatch=0.0, fusion_fit=0.0,
                                   fusion_start=0.0, judged_keyframes=0.0, judged_steps=0.0,
                                   judged_fusions=0.0)
    for rec in searches:
        gap, start, n = _search_gap(engine, rec)
        worst["fusion_fit"] = max(worst["fusion_fit"], gap)
        worst["fusion_start"] = max(worst["fusion_start"], start)
        worst["judged_fusions"] += n
    by_pos = {(r.scan, r.index): r for r in records}
    chosen: List = [by_pos[p] for p in sorted(capture) if p in by_pos]
    live = sorted(records, key=lambda r: -int((r.det["scores"] >= engine.raw_thresh).sum()))
    chosen += [r for r in live[:1] + list(extra) if all(r is not c for c in chosen)]
    last = max(scans[0].keyframes)
    for rec in chosen:
        frame = scans[rec.scan % len(scans)].frames[rec.index]
        ref = engine.detect(frame, rank_from=rec.det["enc_logits"].to(engine.device))
        ref["thresh"] = engine.raw_thresh
        gaps = _det_gaps(rec.det, ref)
        batch_image = engine.batch(frame).image[0]
        gaps.update(_label_gaps(engine, rec.det, rec.label, batch_image, frame.image.shape[:2]))
        if rec.state_before is not None and rec.state_after is not None:
            export = exports.get(0) if (rec.scan, rec.index) == (0, last) else None
            gaps.update(_step_gaps(engine, rec, frame, export))
            worst["judged_steps"] += 1
        worst["judged_keyframes"] += 1
        for k in ("judged_fusions", "missed_rows", "ref_live_rows"):
            worst[k] += gaps.pop(k, 0.0)
        for k, v in gaps.items():
            worst[k] = max(worst[k], v)
    worst["det_miss"] = worst["missed_rows"] / worst["ref_live_rows"] if worst["ref_live_rows"] else 0.0
    return worst


def verdict(readings: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {name: {value, limit}}): every number at or under its limit."""
    checks = {k: dict(value=readings[k], limit=limits[k]) for k in limits}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok and readings.get("judged_steps", 0) >= 1, checks
