"""Multi-sequence evaluation CLI: stream many sequences, print 3D AP.

Port of ``boxfusion_tpu/eval/__main__.py``.  Capability target: the
reference's batch-eval workflow (one demo.py run per val.txt sequence with
skip-if-exists resume, demo.py:434-436) as one command:

  python -m boxfusion_tpu_torch.eval --config config/ca1m.yaml \\
      --data-root /data/ca1m --seq-list data/val.txt \\
      --model-path cutr_rgbd.pth --output-dir out/

Sequences fan out over every CUDA device (``--device`` names one device
instead; ``--device cpu`` asks for the plain PyTorch path).  ``--fused``
runs the fused engine; ``--lanes N [--packed]`` runs N sequences in
lockstep on one device (runtime/batched.py).

Plus a dataset-free self-evaluation mode that the reference cannot offer
(its eval code is unreleased, reference README.md:23): ``--synthetic N``
runs the oracle pipeline over N synthetic scenes with closed-form GT and
reports 3D AP@0.25 / AP@0.5 -- the end-to-end proof that the evaluator,
fan-out runner, and pipeline agree:

  python -m boxfusion_tpu_torch.eval --config config/ca1m.yaml --synthetic 5
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _run_synthetic(cfg, n_seqs: int, capacity: int, devices) -> int:
    """Oracle pipeline vs synthetic GT over ``n_seqs`` sequences -> AP."""
    import torch

    from boxfusion_tpu_torch.data.synthetic import OracleDetector, SyntheticSequence
    from boxfusion_tpu_torch.eval.runner import evaluate_sequences
    from boxfusion_tpu_torch.geometry.boxes import box_corners

    # the oracle scene defines its own filter profile: no uv/floor rejection
    # (its GT boxes may sit near image borders) and the synthesized PST.
    cfg["detection"]._data["score_thresh"] = 0.3
    cfg["detection"]._data["uv_bound"] = False
    cfg["detection"]._data["floor_mask"] = False
    cfg["box_fusion"]._data["pst_path"] = None

    seqs = [
        SyntheticSequence(n_frames=60, n_boxes=6, seed=s, video_id=f"synth{s}")
        for s in range(n_seqs)
    ]

    def gt_provider(seq):
        return box_corners(torch.as_tensor(seq.gt_xyzlhw, dtype=torch.float32),
                           torch.as_tensor(seq.gt_R, dtype=torch.float32)).numpy()

    out = evaluate_sequences(
        cfg,
        seqs,
        detector_factory=lambda s: OracleDetector(s, noise=0.02, seed=1),
        gt_provider=gt_provider,
        capacity=capacity,
        devices=devices,
    )
    print(
        f"[eval] synthetic self-eval over {n_seqs} sequences: "
        f"AP@0.25 = {out['ap_0.25']['ap']:.4f}  "
        f"AP@0.50 = {out['ap_0.50']['ap']:.4f}  "
        f"(mean FPS {out['mean_fps']:.2f})"
    )
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="boxfusion-tpu-torch-eval", description=__doc__)
    p.add_argument("--config", required=True)
    p.add_argument("--data-root", default=None, help="directory of sequence dirs")
    p.add_argument("--seq-list", default=None, help="txt file of sequence ids (val.txt)")
    p.add_argument("--model-path", default=None)
    p.add_argument("--dimension", default=768, type=int)
    p.add_argument("--output-dir", default=None)
    p.add_argument("--capacity", default=512, type=int)
    p.add_argument("--device", default=None,
                   help="the one torch device to run on (default: every CUDA "
                   "device, sequences round-robin; raises without one)")
    p.add_argument(
        "--synthetic", default=0, type=int, metavar="N",
        help="dataset-free mode: oracle pipeline over N synthetic GT scenes -> AP",
    )
    p.add_argument(
        "--fused", action="store_true",
        help="fused keyframe engine (one upload per keyframe, then packaging, "
        "detection, labeling, association and fusion on the device)",
    )
    p.add_argument(
        "--lanes", default=None, type=int, metavar="N",
        help="single-device batched mode: run N sequences in lockstep through "
        "one pipeline (one (N, ...) CuTR forward a round; sequences must share "
        "one resolution bucket). Mutually exclusive with --fused.",
    )
    p.add_argument(
        "--packed", action="store_true",
        help="with --lanes: packed byte transport, ONE (N, L) upload per "
        "keyframe round",
    )
    p.add_argument(
        "--gt", action="store_true",
        help="score 3D AP@0.25/0.5 against each sequence's "
        "after_filter_boxes.npy (the GT-filter output, reference "
        "data_process/filter_gt_boxes.py:144-152) -- the real-data "
        "equivalent of --synthetic's closed-form AP",
    )
    p.add_argument("--clip-path", default=None,
                   help="CLIP weights: enables open-vocab labeling in-eval")
    p.add_argument("--class_txt", default="./data/panoptic_categories_nomerge.txt")
    p.add_argument("--class_features", default="./data/class_features.pt")
    p.add_argument(
        "--video-ids", nargs="+", default=None,
        help="subset of sequence ids to run (reference demo.py:403)",
    )
    args = p.parse_args(argv)

    from boxfusion_tpu_torch.data import get_dataset
    from boxfusion_tpu_torch.eval.runner import evaluate_sequences
    from boxfusion_tpu_torch.utils.config import load_config

    cfg = load_config(args.config)
    devices = None if args.device is None else [args.device]

    if args.fused and args.lanes is not None:
        p.error("--fused and --lanes are mutually exclusive")
    if args.lanes is not None and args.lanes < 1:
        p.error(f"--lanes must be >= 1 (got {args.lanes})")
    if args.packed and args.lanes is None:
        p.error("--packed requires --lanes N")
    if args.synthetic:
        if args.fused or args.lanes is not None:
            p.error(
                "--fused/--lanes need a CuTR detector; --synthetic uses the "
                "oracle detector (drop the flag, or run on real data)"
            )
        return _run_synthetic(cfg, args.synthetic, args.capacity, devices)
    if not args.data_root:
        p.error("--data-root is required unless --synthetic N is given")

    if args.seq_list:
        from boxfusion_tpu_torch.utils.config import read_lines

        seq_ids = read_lines(args.seq_list)
    else:
        seq_ids = sorted(
            d for d in os.listdir(args.data_root)
            if os.path.isdir(os.path.join(args.data_root, d))
        )
    if args.video_ids:
        wanted = set(map(str, args.video_ids))
        seq_ids = [s for s in seq_ids if str(s) in wanted]
        missing = wanted - set(map(str, seq_ids))
        if missing:
            source = f"--seq-list {args.seq_list}" if args.seq_list else "--data-root"
            print(f"[eval] --video-ids not in {source}: {sorted(missing)}", file=sys.stderr)
            return 1
    if not seq_ids:
        print("[eval] no sequences found", file=sys.stderr)
        return 1

    def make_seq(seq_id):
        c = load_config(args.config)
        c["data"]["datadir"] = os.path.join(args.data_root, str(seq_id))
        ds = get_dataset(c)
        ds.video_id = str(seq_id)
        return ds

    # real-data GT: (K, 8, 3) world corners from the offline GT filter
    # (same file layout the reference's filter_gt_boxes.py writes)
    gt_provider = None
    if args.gt:
        missing = [
            s for s in seq_ids
            if not os.path.exists(os.path.join(args.data_root, str(s), "after_filter_boxes.npy"))
        ]
        if missing:
            print(
                f"[eval] --gt: after_filter_boxes.npy missing for {len(missing)} "
                f"sequence(s) (first: {missing[0]}); produce it with "
                "python -m boxfusion_tpu.data_process filter-gt",
                file=sys.stderr,
            )
            return 1

        def gt_provider(seq):
            base = seq.cfg["data"]["datadir"]
            path = os.path.join(base, "after_filter_boxes.npy")
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"--gt: {path} not found; produce it with "
                    "python -m boxfusion_tpu.data_process filter-gt"
                )
            corners = np.load(path).astype(np.float32)
            if corners.ndim != 3 or corners.shape[1:] != (8, 3):
                raise ValueError(f"--gt: {path} has shape {corners.shape}, expected (K, 8, 3)")
            # class labels (written by gt-filter when instances.json carries
            # categories) enable per-class mAP against the open-vocab labels
            lbl_path = os.path.join(base, "after_filter_labels.npy")
            if os.path.exists(lbl_path):
                labels = np.load(lbl_path, allow_pickle=False)
                if len(labels) != len(corners):
                    raise ValueError(
                        f"--gt: {lbl_path} has {len(labels)} labels for {len(corners)} boxes"
                    )
                return dict(corners=corners, classes=labels)
            return corners

    from types import SimpleNamespace

    import torch

    from boxfusion_tpu_torch.cli import _build_cutr_detector, _build_labeler
    from boxfusion_tpu_torch.eval.runner import resolve_devices
    from boxfusion_tpu_torch.runtime import CuTRDetector

    # open-vocab labeling (same assets/flags as the main CLI, demo.py:458-461).
    # Requires explicit --clip-path: asset presence alone must not silently
    # enable a RANDOM image tower against real text features (every box
    # would sink into the background column and AP would read 0).
    labeler = None
    if args.clip_path:
        try:
            labeler = _build_labeler(args, cfg)
        except Exception as e:  # noqa: BLE001
            print(f"[eval] open-vocab labeling disabled: {e}")
    elif os.path.exists(args.class_features) and os.path.exists(args.class_txt):
        print("[eval] class assets present but --clip-path not given; "
              "open-vocab labeling disabled")
    if labeler is not None and args.lanes is not None and not args.packed:
        p.error("labeling with --lanes requires --packed (the label stage runs "
                "on the packed round)")

    devices = resolve_devices(devices)
    # export_image: the device engine's label path crops the device image
    export_image = labeler is not None and args.lanes is None and not args.fused
    det0 = _build_cutr_detector(
        SimpleNamespace(model_path=args.model_path, dimension=args.dimension,
                        device=devices[0]),
        cfg, device_output=True, export_image=export_image,
    )
    # one copy of the weights per device; the runner calls the factory with
    # the sequence's device current
    models = {devices[0]: det0.model}

    def detector_factory(seq):
        dev = (torch.device("cuda", torch.cuda.current_device())
               if devices[0].type == "cuda" else devices[0])
        if dev not in models:
            import copy

            models[dev] = copy.deepcopy(det0.model).to(dev)
        return CuTRDetector(models[dev], device=dev, device_output=True,
                            export_image=export_image)

    if args.lanes is not None:
        from boxfusion_tpu_torch.eval.runner import evaluate_sequences_batched

        out = evaluate_sequences_batched(
            cfg,
            (make_seq(s) for s in seq_ids),
            detector=det0,
            lanes=args.lanes,
            output_dir=args.output_dir,
            capacity=args.capacity,
            packed=args.packed,
            depth_scale=float(cfg["cam"]["png_depth_scale"]),
            labeler=labeler,
            gt_provider=gt_provider,
            device=devices[0],
        )
    else:
        out = evaluate_sequences(
            cfg,
            (make_seq(s) for s in seq_ids),  # lazy: one dataset at a time
            detector_factory=detector_factory,
            output_dir=args.output_dir,
            capacity=args.capacity,
            fused=args.fused,
            depth_scale=float(cfg["cam"]["png_depth_scale"]),
            labeler=labeler,
            gt_provider=gt_provider,
            devices=devices,
        )
    print(
        f"[eval] {len(out['sequences'])} sequences in {out['wall_s']:.1f}s, "
        f"mean FPS {out['mean_fps']:.2f}"
    )
    if "ap_0.25" in out:
        print(
            f"[eval] 3D AP@0.25 = {out['ap_0.25']['ap']:.4f}  "
            f"AP@0.50 = {out['ap_0.50']['ap']:.4f}  "
            f"(n_pred {out['ap_0.25']['n_pred']}, n_gt {out['ap_0.25']['n_gt']})"
        )
    if "map_0.25" in out:
        n_cls = sum(1 for m in out["map_0.25"]["per_class"].values() if m["n_gt"] > 0)
        print(
            f"[eval] per-class mAP@0.25 = {out['map_0.25']['map']:.4f} "
            f"over {n_cls} classes with GT"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
