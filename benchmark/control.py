"""The control of ``correct``, and the readings the limits were set from.

    python3 benchmark/control.py --workload <cell> --control-seeds 1 2 3 \\
        [--program-seeds 4 5 6 ... --seconds 10]
    python3 benchmark/control.py --workload <cell> --fit-lift

The control is the plain reference put in the program's place and computed
one precision below what the configuration states: the detector and the
labeler's tower in float8 (e4m3, one scale per tensor; the configuration
states bfloat16), the keyframe step's products in TF32 (float32 with TF32
off), the PST search's boxes and fitness values held in bfloat16 (float32
arithmetic).  It drives the first scan
of the cell's traffic from an empty world, as the engine would, and is
judged by ``check.judge`` against the float32 reference exactly as a run of
the program is.  ``--program-seeds`` runs the program itself (``run_cell``
for ``--seconds``) on each seed in the same process.  One JSON line per
reading.  ``--fit-lift`` prints the class-bias lift that gives the
traffic's ``live_target`` live rows with the configuration's weights
(``weights.fit_lift``), which the traffic file keeps under
``class_bias_lift``.  The benchmark's own runs never run the control.
"""
import argparse
import json
import math
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def control_records(engine, scans, capture):
    """The control engine over the first scan: records shaped as the
    window's, states kept at ``capture``, the scan's export and every PST
    search's inputs and results."""
    from benchmark.harness.probes import _Patch
    from benchmark.harness.window import KeyframeRecord
    from benchmark.reference.runtime.device_state import export_world

    searches = []

    def recorded(fn):
        def call(init_xyzlhw, init_R, pst, cam_poses, obs_corners, view_mask, obj_mask, K, H, W, cfg, device=None):
            fused, updated = fn(init_xyzlhw, init_R, pst, cam_poses, obs_corners, view_mask, obj_mask, K, H, W,
                                cfg, device=device)
            searches.append(dict(init_x=init_xyzlhw, init_R=init_R, poses=cam_poses, corners=obs_corners,
                                 vmask=view_mask, active=obj_mask, K=K, H=H, W=W, fused=fused, updated=updated))
            return fused, updated
        return call

    scan = scans[0]
    state = engine.init_state()
    records = []
    with _Patch("benchmark.reference.runtime.device_step", "optimize_boxes", recorded):
        for i in scan.keyframes:
            frame = scan.frames[i]
            rec = KeyframeRecord(scan=0, index=i, count=i)
            keep = (0, i) in capture
            if keep:
                rec.state_before = state
            state, det, label = engine.process_keyframe(state, frame, i)
            rec.det = {k: det[k] for k in ("scores", "pred_boxes", "boxes3d", "R", "proj_xy", "enc_logits")}
            rec.label = label if label["b"] > 0 else None
            if keep:
                rec.state_after = state
            records.append(rec)
    return records, {0: export_world(state)}, searches


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--program-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--fit-lift", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    import benchmark.run as run
    from benchmark.harness import check, traffic as traffic_mod, weights
    from benchmark.harness.spec import load_cell
    from benchmark.reference.engine import ReferenceEngine
    from benchmark.reference.models.cutr.layers import FP8

    cell = load_cell(args.workload)
    dev = torch.device(args.device)
    if args.fit_lift:
        lift, live = weights.fit_lift(cell.config, cell.families, cell.traffic, dev)
        print(json.dumps(dict(kind="lift", workload=args.workload, config=cell.config["name"], lift=lift,
                              live_rows_per_keyframe=live)), flush=True)
    traffic = dict(cell.traffic, class_bias_lift=weights.lift_for(cell.config, cell.traffic))
    for seed in args.program_seeds:
        result = run.run_cell(cell, seed, args.seconds, False, dev)
        print(json.dumps(dict(kind="program", workload=args.workload, seed=seed, correct=result["correct"],
                              attempted=result["attempted"], metrics=result["metrics"],
                              readings=result["readings"])), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    for seed in args.control_seeds:
        scans = traffic_mod.make_scans(cell.traffic, seed)
        capture = check.sample_positions(cell.traffic, seed, scans)
        control = ReferenceEngine(cell.config, cell.families, traffic, dev, detector_dtype=FP8,
                                  tower_dtype=FP8, tf32=True, search_dtype=torch.bfloat16)
        records, exports, searches = control_records(control, scans, capture)
        del control
        reference = ReferenceEngine(cell.config, cell.families, traffic, dev)
        readings = check.judge(records, exports, scans, reference, capture,
                               check.sample_searches(searches, cell.traffic, seed),
                               check.sample_keyframes(records, cell.traffic, seed))
        correct, checks = check.verdict(readings, cell.limits)
        print(json.dumps(dict(kind="control", workload=args.workload, seed=seed, correct=correct,
                              readings={k: (v if math.isfinite(v) else None) for k, v in readings.items()})),
              flush=True)
        del reference, records
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
