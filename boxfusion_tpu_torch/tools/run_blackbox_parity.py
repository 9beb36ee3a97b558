"""Same-host black-box CLI parity with the original BoxFusion, and both FPS.

Port of ``tools/run_blackbox_parity.py``.  Runs the reference's own
``demo.py`` (on the CPU, stubs from ``blackbox``) and the port's CLI (host
engine, then the fused engine, on ``--device``) on one synthetic
CA-1M-layout sequence with one shared checkpoint, each twice (the second,
warm run's FPS is the steady figure); compares the eval pickles and writes
the record as JSON to ``--out``.

Checkpoint regimes: the committed trained fixture
(``tests/fixtures/cutr_trained_192_f16.pth``) by default, so the comparison
is deterministic; ``--ckpt`` another trained ``.pth``; ``--trained`` trains
one on the scene with the port's trainer (``--steps``); ``--random`` seeded
random weights (parity is then statistical: near-tie selections differ).

Needs the original BoxFusion at ``blackbox.REF``; without it the tool prints
one line naming the missing path and exits with status 2 before any work.

    python -m boxfusion_tpu_torch.tools.run_blackbox_parity [--trained | --ckpt X.pth | --random]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

from boxfusion_tpu_torch.tools import blackbox
from boxfusion_tpu_torch.tools.common import REPO
from boxfusion_tpu_torch.utils.device import resolve_device

GAP = 7
N_FRAMES = 36
HW = (192, 256)
SEQ = blackbox.SEQ
FIXTURE = os.path.join(REPO, "tests", "fixtures", "cutr_trained_192_f16.pth")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="where the port's CLI runs (the reference: the CPU)")
    ap.add_argument("--trained", action="store_true",
                    help="train a checkpoint on the scene (the deterministic regime)")
    ap.add_argument("--ckpt", default=FIXTURE if os.path.exists(FIXTURE) else None,
                    help="an existing trained .pth (default: the committed fixture)")
    ap.add_argument("--random", action="store_true", help="seeded random weights even when the fixture exists")
    ap.add_argument("--steps", type=int, default=350)
    ap.add_argument("--dim", type=int, default=192, help="CuTR width for --trained")
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "blackbox_parity"))
    ap.add_argument("--out", default=None, help="the record's JSON (default: <workdir>/REF_PARITY.json)")
    ap.add_argument("--keep", action="store_true", help="reuse an existing workdir (a trained checkpoint too)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    missing = blackbox.reference_missing("run_blackbox_parity")
    if missing:
        print(missing, file=sys.stderr)
        return 2

    if not args.keep and os.path.isdir(args.workdir):
        shutil.rmtree(args.workdir)
    os.makedirs(args.workdir, exist_ok=True)
    root = args.workdir
    out_path = args.out or os.path.join(root, "REF_PARITY.json")
    seqdir = os.path.join(root, SEQ)
    if not os.path.isdir(seqdir):
        blackbox.write_scene(seqdir, n_frames=N_FRAMES, image_hw=HW)
    class_txt, class_pt = blackbox.write_class_assets(root)

    if args.random:
        args.ckpt = None
    if args.ckpt:
        ckpt = args.ckpt
        args.trained = True  # deterministic-regime labeling and the exact matcher
    elif args.trained:
        ckpt = os.path.join(root, "cutr_trained.pth")
        train_cfg = blackbox.write_config(os.path.join(root, "train.yaml"), datadir=seqdir,
                                          output_dir=os.path.join(root, "unused"), gap=GAP, image_hw=HW)
        if not os.path.exists(ckpt):
            t0 = time.perf_counter()
            blackbox.build_trained_checkpoint(ckpt, seqdir, train_cfg, steps=args.steps, dim=args.dim,
                                              device=dev)
            print(f"[tool] trained {args.steps} steps in {time.perf_counter() - t0:.0f}s", file=sys.stderr)
    else:
        ckpt = blackbox.build_reference_checkpoint(os.path.join(root, "cutr_rand.pth"))

    # three pipelines on one scene: the reference entry point, the port's
    # reference-shaped host engine, and its fused engine
    results, fps = {}, {}
    for side in ("ref", "ours", "ours_fused"):
        out_dir = os.path.join(root, f"{side}_out")
        for run in ("cold", "warm"):
            shutil.rmtree(out_dir, ignore_errors=True)
            os.makedirs(out_dir)
            if side == "ref":
                cfg = blackbox.write_config(os.path.join(root, "ref.yaml"), datadir=os.path.join(root, "_base/"),
                                            output_dir=out_dir, gap=GAP, image_hw=HW)
                r = blackbox.run_reference_demo(cfg, SEQ, ckpt, class_txt, class_pt)
            else:
                cfg = blackbox.write_config(os.path.join(root, f"{side}.yaml"), datadir=seqdir,
                                            output_dir=out_dir, gap=GAP, image_hw=HW)
                if side == "ours":
                    r = blackbox.run_our_cli(cfg, seqdir, ckpt, engine="host", extra=("--class_txt", class_txt),
                                             device=dev)
                else:
                    r = blackbox.run_our_cli(cfg, seqdir, ckpt, engine="fused", extra=("--capacity", "256"),
                                             device=dev)
            fps[f"{side}_{run}"] = r["fps"]
            print(f"[tool] {side} {run}: {r['fps']} fps", file=sys.stderr)
        results[side] = out_dir

    corners = lambda side, name: blackbox.load_corner_pickle(os.path.join(results[side], name))
    world_ref, world_our = corners("ref", f"{SEQ}_boxes.pkl"), corners("ours", f"{SEQ}_boxes.pkl")
    world_fused = corners("ours_fused", f"{SEQ}_boxes.pkl")
    fw_ref, fw_our = corners("ref", "framewise_boxes.pkl"), corners("ours", "framewise_boxes.pkl")

    record = {
        "protocol": {
            "scene": {"frames": N_FRAMES, "gap": GAP, "image_hw": list(HW), "seq": SEQ},
            "checkpoint": (args.ckpt or f"trained({args.steps} steps, dim {args.dim})")
                          if args.trained else "seeded-random(dim 192)",
            "reference_entry": f"{blackbox.REF}/demo.py (CPU, IO/viz stubs)",
            "ours_entry": f"boxfusion_tpu_torch.cli --engine host|fused ({dev})",
            "fps_source": "each side's own 'Average FPS' print (reference demo.py:363-366)",
        },
        "fps": fps,
        "vs_reference": fps["ours_fused_warm"] / fps["ref_warm"] if fps.get("ref_warm") else None,
        "vs_reference_host_engine": fps["ours_warm"] / fps["ref_warm"] if fps.get("ref_warm") else None,
        "world": blackbox.bounded_match_stats(world_ref, world_our),
        "world_fused_engine": blackbox.bounded_match_stats(world_ref, world_fused),
        "framewise": blackbox.bounded_match_stats(fw_ref, fw_our),
        "deterministic_regime": bool(args.trained),
    }
    if args.trained:
        try:
            pairs, err = blackbox.match_corner_sets(world_ref, world_our)
            record["world"]["exact_match"] = {"pairs": len(pairs), "max_corner_err": err}
        except AssertionError as e:
            record["world"]["exact_match"] = {"failed": str(e)[:500]}

    with open(out_path, "w") as f:
        json.dump(record, f, indent=2)
    print(json.dumps(record, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
