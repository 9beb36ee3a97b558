"""Command-line entry point: run online detection + fusion on a sequence.

Port of ``boxfusion_tpu/cli.py``.  Capability target: the
reference's ``demo.py`` entry point (demo.py:389-467): same positional
dataset argument and flags, same config handling (including --seq datadir
rewriting, demo.py:416-431, and the skip-if-output-exists early exit,
demo.py:434-436).

Usage:
  python -m boxfusion_tpu_torch.cli ca1m --config config/ca1m.yaml \
      --model-path cutr_rgbd.pth --seq 42898867
  python -m boxfusion_tpu_torch.cli synthetic --config config/ca1m.yaml
  python -m boxfusion_tpu_torch.cli synthetic --config config/ca1m.yaml \
      --engine device --capacity 48
  python -m boxfusion_tpu_torch.cli ca1m --config config/ca1m.yaml \
      --engine fused --chunk 8

Everything runs on ``--device`` (default: the GPU; the run raises if there is
none -- ``--device cpu`` asks for the plain PyTorch path).  ``--engine host``
mirrors the reference's host bookkeeping; ``--engine device`` keeps the world,
the manager's lists and the observation bank on the device
(runtime/device_pipeline.py) and can snapshot and resume them
(``--save-state`` / ``--restore-state`` / ``--restore-count``).  ``--engine
fused`` is the device engine with one upload per keyframe, from which the
device packages, detects, labels, associates and fuses
(runtime/fused.py); ``--chunk N`` sends N keyframes per upload.  It needs a
CuTR detector: the ``synthetic`` sequence, whose detector is an oracle,
falls back to the device engine and says so.
"""
from __future__ import annotations

import argparse
import itertools
import os
import sys

import numpy as np

from boxfusion_tpu_torch.utils.config import load_config


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="boxfusion_tpu_torch online demo")
    p.add_argument(
        "dataset_path",
        help="Dataset kind/path: 'ca1m', 'scannet', 'synthetic', or a data dir",
    )
    p.add_argument("--model-path", default=None, help="CuTR checkpoint (.pth)")
    p.add_argument("--config", required=True, type=str)
    p.add_argument("--clip-path", default=None, type=str, help="CLIP weights for labeling")
    p.add_argument("--seq", default=None, type=str)
    p.add_argument("--class_txt", default="./data/panoptic_categories_nomerge.txt")
    p.add_argument("--class_features", default="./data/class_features.pt")
    p.add_argument("--every-nth-frame", default=None, type=int)
    p.add_argument("--device", default=None,
                   help="torch device of every stage (default: cuda; raises without one)")
    p.add_argument("--dimension", default=768, type=int, help="ViT width if random init")
    p.add_argument(
        "--engine",
        default="host",
        choices=["host", "device", "fused"],
        help="'fused' uploads each keyframe as one packed buffer and packages, "
        "detects, labels, associates and fuses it on the device "
        "(runtime/fused.py); 'device' keeps association/fusion state on the "
        "device, with a separate detector pass; 'host' mirrors the "
        "reference's host bookkeeping",
    )
    p.add_argument("--verbose", action="store_true")
    p.add_argument(
        "--capacity", default=512, type=int,
        help="world-state slots for the device/fused engines (capacity "
        "overflow drops lowest-priority detections, counted in stats)",
    )
    p.add_argument(
        "--chunk", default=1, type=int,
        help="fused engine: N consecutive keyframes per upload (identical "
        "decisions, N keyframes of result latency; 1 = lowest-latency live "
        "mode)",
    )
    p.add_argument(
        "--save-state", default=None, metavar="PATH",
        help="device/fused engines: snapshot the full pipeline state after "
        "the run (resume a partially-streamed sequence with --restore-state)",
    )
    p.add_argument(
        "--restore-state", default=None, metavar="PATH",
        help="device/fused engines: restore a pipeline snapshot before "
        "streaming (pair with --restore-count for the frame counter)",
    )
    p.add_argument("--restore-count", default=0, type=int,
                   help="frame counter to resume from with --restore-state")
    p.add_argument(
        "--validate-checkpoint", action="store_true",
        help="real-weights readiness check: load --model-path (and "
        "--clip-path if given), run ONE frame end to end, print activation "
        "digests + timing, exit (reference demo.py:441-446, "
        "tools/utils.py:342-353)",
    )
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    if not os.path.exists(args.config):
        raise ValueError("Missing config path")
    cfg = load_config(args.config)

    if cfg["vis"]["rerun"]:
        raise NotImplementedError(
            "vis.rerun is set, but the rerun viewer (utils/viz.py) is not part of "
            "boxfusion_tpu_torch yet (ROADMAP.md section A.11); set vis.rerun to False"
        )

    if args.validate_checkpoint:
        return _validate_checkpoint(args, cfg)

    # --seq rewrites the datadir like the reference (demo.py:416-431): the
    # bundled example dir is left alone; otherwise the sequence is a SIBLING
    # directory of the configured one (robust to a missing trailing slash,
    # which the reference's double-dirname silently mishandles).
    if args.seq and args.dataset_path.lower() == "ca1m":
        base = cfg["data"]["datadir"]
        if "example" not in base:
            cfg["data"]["datadir"] = os.path.join(
                os.path.dirname(base.rstrip("/")), args.seq + "/"
            )

    # a directory path as the positional argument selects it as the datadir
    # (dataset kind still comes from the config), per the help string
    if args.dataset_path.lower() not in ("ca1m", "scannet", "synthetic") and os.path.isdir(
        args.dataset_path
    ):
        cfg["data"]["datadir"] = args.dataset_path

    out_dir = cfg["data"]["output_dir"]
    if (
        args.seq
        and out_dir
        and cfg["eval"]
        and os.path.exists(os.path.join(out_dir, args.seq + "_boxes.pkl"))
    ):
        print("Results for boxes already exist, skip evaluation")
        return 0

    # labeling requires explicit CLIP weights: asset presence alone must not
    # silently enable a RANDOM image tower against real text features
    wants_label = bool(args.clip_path)
    if not wants_label and os.path.exists(args.class_features) and os.path.exists(
        args.class_txt
    ):
        print(
            "[cli] class assets present but --clip-path not given; "
            "open-vocab labeling disabled"
        )

    # dataset
    if args.dataset_path.lower() == "synthetic":
        from boxfusion_tpu_torch.data.synthetic import OracleDetector, SyntheticSequence

        # the advertised dataset-free demo must not require the reference's
        # PST asset: fall back to the synthesized table when it is absent
        # (real datasets keep the hard error -- a typo'd path should not
        # silently change the optimizer's search distribution)
        pst = cfg["box_fusion"]["pst_path"]
        if pst and not os.path.exists(str(pst)):
            print(f"[cli] PST file {pst} absent; synthesizing the particle table")
            cfg["box_fusion"]._data["pst_path"] = None

        dataset = SyntheticSequence(n_frames=60, n_boxes=6)
        detector = OracleDetector(dataset, noise=0.02)
    else:
        from boxfusion_tpu_torch.data import get_dataset

        if args.dataset_path.lower() in ("ca1m", "scannet"):
            cfg._data["dataset"] = (
                "scannet" if args.dataset_path.lower() == "scannet" else "CA1M"
            )
        dataset = get_dataset(cfg)
        # the device engine keeps detections on the device end to end; with
        # open-vocab labeling it also exports the device image so CLIP
        # crops/similarity stay there (runtime/device_pipeline.py)
        device_output = args.engine == "device"
        detector = _build_cutr_detector(
            args, cfg, device_output=device_output,
            export_image=device_output and wants_label,
        )

    if args.every_nth_frame:
        video_id = getattr(dataset, "video_id", None)
        dataset = itertools.islice(iter(dataset), 0, None, args.every_nth_frame)
        if video_id is not None:
            # islice drops the dataset attributes; keep the id for the save
            dataset = _NamedIter(dataset, video_id)

    labeler = None
    if wants_label:
        try:
            labeler = _build_labeler(args, cfg)
        except Exception as e:  # noqa: BLE001
            print(f"[cli] open-vocab labeling disabled: {e}")

    if args.chunk > 1 and args.engine != "fused":
        print(f"[cli] --chunk {args.chunk} only groups uploads on the fused "
              f"engine; --engine {args.engine} ignores it")

    if args.engine in ("device", "fused"):
        return _run_device_engine(args, cfg, dataset, detector, labeler, out_dir)

    from boxfusion_tpu_torch.runtime import OnlinePipeline

    pipe = OnlinePipeline(cfg, detector, labeler=labeler, device=args.device)
    world = pipe.run(dataset, verbose=args.verbose)

    if out_dir:
        from boxfusion_tpu_torch.utils.io import save_framewise_boxes, save_world_boxes

        class_list = _load_class_list(args.class_txt)
        video_id = getattr(dataset, "video_id", "sequence")
        if cfg["eval"]:
            save_world_boxes(world, class_list, out_dir, video_id, cfg["dataset"])
        save_framewise_boxes(pipe.obs, None, class_list, out_dir)
    return 0


def _run_device_engine(args, cfg, dataset, detector, labeler, out_dir) -> int:
    from boxfusion_tpu_torch.runtime import DevicePipeline, FusedDevicePipeline

    engine_used = args.engine
    if args.engine == "fused" and args.dataset_path.lower() == "synthetic":
        print("[cli] fused engine needs a CuTR detector; synthetic "
              "uses the oracle -- falling back to --engine device")
        engine_used = "device"
    if engine_used == "fused":
        pipe = FusedDevicePipeline(
            cfg, detector, labeler=labeler, capacity=args.capacity,
            depth_scale=float(cfg["cam"]["png_depth_scale"]), device=args.device,
            chunk=args.chunk,
        )
    else:
        pipe = DevicePipeline(cfg, detector, labeler=labeler, capacity=args.capacity,
                              device=args.device)
    if args.restore_state:
        pipe.restore_state(args.restore_state, count=args.restore_count)
        if args.restore_count:
            # continue where the saved run stopped: frames [0, restore_count)
            # were already streamed into the snapshot -- re-streaming them
            # would duplicate their observations
            dataset = _NamedIter(
                itertools.islice(iter(dataset), args.restore_count, None),
                getattr(dataset, "video_id", "sequence"),
            )
        print(f"[cli] resumed pipeline state from {args.restore_state} "
              f"(frame {args.restore_count})")
    out = pipe.run(dataset)
    if args.save_state:
        pipe.save_state(args.save_state)
        print(f"[cli] saved pipeline state to {args.save_state} (frame {pipe.count})")
    print(f"[cli] {engine_used} engine: {len(out['scores'])} world boxes")
    if out_dir and cfg["eval"]:
        import torch

        from boxfusion_tpu_torch.geometry.boxes import box_corners
        from boxfusion_tpu_torch.utils.io import save_eval_pickle

        corners = box_corners(torch.as_tensor(out["xyzlhw"]), torch.as_tensor(out["R"])).numpy()
        path = save_eval_pickle(
            corners, out_dir, getattr(dataset, "video_id", "sequence"), cfg["dataset"]
        )
        print(f"[cli] saved {path}")
    return 0


class _NamedIter:
    """Iterator wrapper preserving ``video_id`` through islice and friends."""

    def __init__(self, it, video_id):
        self._it = it
        self.video_id = video_id

    def __iter__(self):
        return iter(self._it)


def _load_class_list(path: str):
    if os.path.exists(path):
        from boxfusion_tpu_torch.utils.config import read_lines

        return read_lines(path)
    return ["object"]


def _build_labeler(args, cfg):
    from boxfusion_tpu_torch.models.clip import CLIPConfig, build_labeler

    # the checkpoint defines the tower; the config lends its compute dtype
    return build_labeler(
        args.clip_path,
        args.class_txt,
        args.class_features,
        sim_thres=float(cfg["detection"]["class_sim_thres"]),
        cfg=CLIPConfig(dtype=str(cfg["detection"]["compute_dtype"])),
        device=args.device,
    )


def _digest(name: str, arr) -> str:
    """One printable activation digest line: shape + stats + a short hash
    of the float32 bytes rounded to 1e-4 (stable across runs on one
    backend; comparable across machines at stats level)."""
    import hashlib

    a = np.asarray(arr, np.float32)
    h = hashlib.sha256(np.round(a, 4).tobytes()).hexdigest()[:12]
    return (
        f"  {name:<12} shape={list(a.shape)} mean={a.mean():+.5f} "
        f"std={a.std():.5f} min={a.min():+.4f} max={a.max():+.4f} sha={h}"
    )


def _validate_checkpoint(args, cfg) -> int:
    """--validate-checkpoint: load real weights, run one frame, print
    activation digests + timing.

    Mirrors the reference's primary mode -- demo.py:441-446 loads
    cutr_rgbd.pth and sniffs the ViT width from
    backbone.0.patch_embed.proj.weight; tools/utils.py:342-353 loads the
    CLIP tower -- so that the day those assets are at hand, one command
    proves the full load -> forward path.
    """
    import time

    import torch

    if not args.model_path or not os.path.exists(args.model_path):
        print(
            f"--validate-checkpoint: checkpoint not found: {args.model_path!r}",
            file=sys.stderr,
        )
        return 1

    from boxfusion_tpu_torch.models.cutr.convert import load_torch_state_dict
    from boxfusion_tpu_torch.runtime import CuTRDetector
    from boxfusion_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    t0 = time.perf_counter()
    model = load_torch_state_dict(
        torch.load(args.model_path, map_location="cpu", weights_only=True),
        device=device, dtype=str(cfg["detection"]["compute_dtype"]),
    )
    t_load = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    print(
        f"[validate] {args.model_path}: CuTR dim={model.cfg.embed_dim} "
        f"depth_model={model.cfg.depth_model} params={n_params/1e6:.1f}M "
        f"(loaded in {t_load:.1f}s)"
    )
    detector = CuTRDetector(model, device=device)

    # one real frame if the configured datadir is present, synthetic otherwise
    try:
        from boxfusion_tpu_torch.data import get_dataset

        frame = next(iter(get_dataset(cfg)))
        src = cfg["data"]["datadir"]
    except Exception:  # noqa: BLE001
        from boxfusion_tpu_torch.data.synthetic import SyntheticSequence

        frame = next(iter(SyntheticSequence(n_frames=1, n_boxes=4, seed=0)))
        src = "synthetic (configured datadir not present)"
    print(f"[validate] frame source: {src}")

    det = detector(frame)  # first call: kernel and library warm-up
    t1 = time.perf_counter()
    det = detector(frame)  # ends in a device-to-host read
    t_fwd = (time.perf_counter() - t1) * 1e3
    print(f"[validate] CuTR forward: {t_fwd:.1f} ms (second call)")
    for k in ("scores", "pred_boxes", "boxes3d", "R", "proj_xy"):
        if k in det:
            print(_digest(k, det[k]))

    if args.clip_path:
        labeler = _build_labeler(args, cfg)
        boxes = np.asarray(det["pred_boxes"])[:8]
        t2 = time.perf_counter()
        cats, feats, sims = labeler(np.asarray(frame.image), boxes)
        t_clip = (time.perf_counter() - t2) * 1e3
        print(f"[validate] CLIP label pass ({len(boxes)} crops): {t_clip:.1f} ms")
        print(_digest("clip_feats", feats))
        print(_digest("clip_sims", np.asarray(sims, np.float32)))
        print(f"[validate] labels: {list(cats)[:8]}")

    print("[validate] OK")
    return 0


def _build_cutr_detector(args, cfg, device_output: bool = False, export_image: bool = False):
    import torch

    from boxfusion_tpu_torch.models.cutr import make_cutr
    from boxfusion_tpu_torch.runtime import CuTRDetector

    dtype = str(cfg["detection"]["compute_dtype"])
    if args.model_path and os.path.exists(args.model_path):
        from boxfusion_tpu_torch.models.cutr.convert import load_torch_state_dict

        model = load_torch_state_dict(
            torch.load(args.model_path, map_location="cpu", weights_only=True),
            device=args.device, dtype=dtype,
        )
        if not model.cfg.depth_model:
            print("[cli] RGB-only CuTR checkpoint detected (no depth patch embed)")
    else:
        print("[cli] no checkpoint given: using random-initialized CuTR")
        model = make_cutr(dimension=args.dimension, depth_model=True, device=args.device,
                          seed=0, dtype=dtype)
    return CuTRDetector(model, device=args.device, device_output=device_output,
                        export_image=export_image)


if __name__ == "__main__":
    sys.exit(main())
