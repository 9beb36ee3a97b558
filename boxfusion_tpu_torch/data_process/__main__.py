"""Offline data-prep command line.

Capability target: the reference's standalone prep scripts
(data_process/ca1m_unzip.bash, check_img.py, rot_img.py, process2slam.py,
process2slam_gtbox.py, filter_gt_boxes.py) as one subcommand tool:

  python -m boxfusion_tpu_torch.data_process extract  <root> [--out DIR]
  python -m boxfusion_tpu_torch.data_process convert  <capture_dir> <target_dir>
  python -m boxfusion_tpu_torch.data_process classify <seq_dir>
  python -m boxfusion_tpu_torch.data_process rotate   <seq_dir>
  python -m boxfusion_tpu_torch.data_process filter-gt <seq_dir> [--ply mesh.ply]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="boxfusion-tpu-prep", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("extract", help="extract CA-1M tar archives (ca1m_unzip.bash)")
    s.add_argument("root")
    s.add_argument("--out", default=None)

    s = sub.add_parser("convert", help="capture -> SLAM-style folders (process2slam.py)")
    s.add_argument("capture_dir")
    s.add_argument("target_dir")

    s = sub.add_parser("classify", help="portrait/landscape vote (check_img.py)")
    s.add_argument("seq_dir")

    s = sub.add_parser("rotate", help="rotate minority-orientation frames (rot_img.py)")
    s.add_argument("seq_dir")

    s = sub.add_parser(
        "filter-gt", help="frustum + proximity GT box filter (filter_gt_boxes.py)"
    )
    s.add_argument(
        "seq_dir",
        help="SLAM-style dir with instances.json (or gt_boxes.npy), "
        "K_depth.txt and all_poses.npy (or pose/)",
    )
    s.add_argument("--ply", default=None, help="mesh/point-cloud .ply for proximity check")
    s.add_argument("--dist-threshold", type=float, default=0.1)
    s.add_argument("--out", default=None, help="output .npy (default: after_filter_boxes.npy)")

    args = p.parse_args(argv)

    if args.cmd == "extract":
        from boxfusion_tpu_torch.data_process.prep import extract_archives

        for d in extract_archives(args.root, args.out):
            print(d)
    elif args.cmd == "convert":
        from boxfusion_tpu_torch.data_process.prep import convert_capture_to_slam

        stats = convert_capture_to_slam(args.capture_dir, args.target_dir)
        print(stats)
    elif args.cmd == "classify":
        from boxfusion_tpu_torch.data_process.prep import classify_sequence_orientation

        kind, v, h = classify_sequence_orientation(args.seq_dir)
        print(f"{kind} (portrait={v} landscape={h})")
    elif args.cmd == "rotate":
        from boxfusion_tpu_torch.data_process.prep import rotate_sequence_upright

        print(f"rotated {rotate_sequence_upright(args.seq_dir)} frames")
    elif args.cmd == "filter-gt":
        from boxfusion_tpu_torch.data_process.gt_filter import filter_gt_boxes, read_ply_points

        seq = args.seq_dir
        gt_npy = os.path.join(seq, "gt_boxes.npy")
        labels = None
        if os.path.exists(gt_npy):
            corners = np.load(gt_npy)
        else:
            import json

            with open(os.path.join(seq, "instances.json")) as f:
                instances = json.load(f)
            corners = np.asarray(
                [ins["corners"] for ins in instances], np.float32
            )
            # CA-1M GT instances carry a category label; keep it in lockstep
            # with the corners when present (enables per-class eval AP)
            n_with_cat = sum("category" in ins for ins in instances)
            if instances and n_with_cat == len(instances):
                labels = np.asarray([str(ins["category"]) for ins in instances])
            elif 0 < n_with_cat < len(instances):
                print(
                    f"WARNING: {len(instances) - n_with_cat}/{len(instances)} "
                    "GT instances lack a 'category' key; labeling the missing "
                    "ones 'unknown' (per-class eval AP groups them there)",
                    file=sys.stderr,
                )
                labels = np.asarray(
                    [str(ins.get("category", "unknown")) for ins in instances]
                )
        K = np.loadtxt(os.path.join(seq, "K_depth.txt")).reshape(3, 3)
        all_poses = os.path.join(seq, "all_poses.npy")
        if os.path.exists(all_poses):
            poses = np.load(all_poses).reshape(-1, 4, 4)
        else:
            pose_dir = os.path.join(seq, "pose")
            poses = np.stack(
                [
                    np.loadtxt(os.path.join(pose_dir, f)).reshape(4, 4)
                    for f in sorted(os.listdir(pose_dir))
                ]
            )
        import glob

        depths = sorted(glob.glob(os.path.join(seq, "depth", "*")))
        from PIL import Image

        with Image.open(depths[0]) as im:
            image_hw = (im.size[1], im.size[0])
        pts = read_ply_points(args.ply) if args.ply else None
        out = args.out or os.path.join(seq, "after_filter_boxes.npy")
        kept, _ = filter_gt_boxes(
            corners, K, poses, image_hw, gt_points=pts,
            dist_threshold=args.dist_threshold, save_path=out, labels=labels,
        )
        print(f"{len(kept)}/{len(corners)} GT boxes kept -> {out}"
              + (" (+labels)" if labels is not None else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
