"""The training loop: ``python -m boxfusion_tpu_torch.train``.

Port of ``boxfusion_tpu/train/__main__.py``.  The reference ships no trainer
(inference-only release; its README lists training/eval as unreleased,
README.md:23); the JAX package's trainer is one train step sharded over a
(dp, fsdp, tp) mesh, warmup + cosine learning rate and parameter
checkpoints.  Here the step is ``train/step.py``'s (autograd + AdamW), its
parameters and moments sharded over a ``torch.distributed`` mesh
(``parallel/mesh.py``), one process per device: started by ``torchrun`` it
joins the group, otherwise it makes a group of one rank.

Data: the synthetic oracle-supervised workload by default -- frames
rendered by ``SyntheticSequence`` with targets derived from its
closed-form GT boxes through the same camera model the detector predicts
in (camera-frame center/dims/pose + projected 2D boxes).  ``--data-root``
switches to a real CA-1M-layout sequence dir: frames come from the CA-1M
reader and targets from the sequence's world-corner GT
(``after_filter_boxes.npy``, the data_process filter-gt output),
transformed per keyframe into the model's prediction frame.  The epoch is
held on the device; each step draws its batch there.

Run (on a CUDA device unless --device names another; B must be divisible
by the mesh's dp*fsdp):

    python -m boxfusion_tpu_torch.train --steps 200 --batch 8 --dim 192

    python -m boxfusion_tpu_torch.train --steps 4 --batch 2 --device cpu

    torchrun --nproc-per-node 4 -m boxfusion_tpu_torch.train --batch 8
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np


def _frame_targets(seq, frame, G: int) -> dict:
    """Closed-form supervision for one synthetic frame.

    Uses the oracle's noise-free detection of the sequence GT
    (data/synthetic.py:107-170) and converts to the loss's target layout
    (train/loss.py:detection_loss): cxcywh 2D boxes, camera-frame
    proj_xy/z/dims/pose, padded to G slots with a validity mask.
    """
    from boxfusion_tpu_torch.data.synthetic import OracleDetector

    det = OracleDetector(seq, noise=0.0)(frame)
    n = min(len(det["scores"]), G)
    boxes2d = np.zeros((G, 4), np.float32)
    proj_xy = np.zeros((G, 2), np.float32)
    z = np.full((G, 1), 1.0, np.float32)
    dims = np.full((G, 3), 0.1, np.float32)
    pose = np.tile(np.eye(3, dtype=np.float32)[None], (G, 1, 1))
    mask = np.zeros((G,), np.float32)
    if n:
        xyxy = det["pred_boxes"][:n]
        boxes2d[:n, :2] = (xyxy[:, :2] + xyxy[:, 2:]) * 0.5
        boxes2d[:n, 2:] = xyxy[:, 2:] - xyxy[:, :2]
        proj_xy[:n] = det["proj_xy"][:n]
        z[:n, 0] = det["boxes3d"][:n, 2]
        # the supervised head emits dims as (w, h, l); exported boxes3d is
        # LHW (model.py reorders with (2, 1, 0) at inference) -- targets
        # must be in the HEAD's order or the loss swaps length and width
        dims[:n] = det["boxes3d"][:n, 3:][:, (2, 1, 0)]
        pose[:n] = det["R"][:n]  # synthetic T_gravity is identity, so the
        # exported R equals the head's pre-gravity output
        mask[:n] = 1.0
    return dict(boxes2d=boxes2d, proj_xy=proj_xy, z=z, dims=dims, pose=pose, mask=mask)


def _targets_from_world_corners(corners_world: np.ndarray, frame, G: int) -> dict:
    """Supervision for one real posed frame from world-corner GT.

    ``corners_world`` is the (K, 8, 3) layout of
    ``after_filter_boxes.npy`` (data_process/gt_filter.py; reference
    filter_gt_boxes.py:144-153).  Boxes are moved to the camera frame,
    visibility-filtered with the oracle's thresholds (center z in
    (0.3, 8.0) and projected center in-bounds), and converted to the
    loss's target layout -- pose gravity-aligned exactly like the model's
    own outputs (models/cutr/model.py, reference
    cubify_transformer.py:991-992).
    """
    import torch

    from boxfusion_tpu_torch.geometry.boxes import corners_to_params

    P = np.asarray(frame.gt_pose, np.float32)
    Rp, t = P[:3, :3], P[:3, 3]
    cam = (corners_world.astype(np.float32) - t) @ Rp  # R^T (c - t) per corner

    xyzlhw, R_cam = (a.numpy() for a in corners_to_params(torch.from_numpy(np.ascontiguousarray(cam))))
    K = np.asarray(frame.K, np.float32)
    h, w = frame.image.shape[:2]
    z = xyzlhw[:, 2]
    u = K[0, 0] * xyzlhw[:, 0] / np.maximum(z, 1e-6) + K[0, 2]
    v = K[1, 1] * xyzlhw[:, 1] / np.maximum(z, 1e-6) + K[1, 2]
    visible = (z > 0.3) & (z < 8.0) & (u > 0) & (u < w) & (v > 0) & (v < h)

    cam_v = cam[visible]
    xyzlhw, R_cam = xyzlhw[visible], R_cam[visible]
    u, v, z = u[visible], v[visible], z[visible]
    n = min(len(xyzlhw), G)

    boxes2d = np.zeros((G, 4), np.float32)
    proj_xy = np.zeros((G, 2), np.float32)
    z_t = np.full((G, 1), 1.0, np.float32)
    dims = np.full((G, 3), 0.1, np.float32)
    pose = np.tile(np.eye(3, dtype=np.float32)[None], (G, 1, 1))
    mask = np.zeros((G,), np.float32)
    if n:
        cz = np.maximum(cam_v[:n, :, 2], 1e-6)
        cu = np.clip(K[0, 0] * cam_v[:n, :, 0] / cz + K[0, 2], 0, w)
        cv = np.clip(K[1, 1] * cam_v[:n, :, 1] / cz + K[1, 2], 0, h)
        x0, x1 = cu.min(-1), cu.max(-1)
        y0, y1 = cv.min(-1), cv.max(-1)
        boxes2d[:n] = np.stack(
            [(x0 + x1) * 0.5, (y0 + y1) * 0.5, x1 - x0, y1 - y0], -1
        )
        proj_xy[:n] = np.stack([u[:n], v[:n]], -1)
        z_t[:n, 0] = z[:n]
        # head dims order is (w, h, l); corners_to_params returns (l, h, w)
        dims[:n] = xyzlhw[:n, 3:][:, (2, 1, 0)]
        # inference exports R = T_gravity @ pose_head (model.py, reference
        # cubify_transformer.py:991-992), so the HEAD's target for a
        # camera-frame GT rotation is T_gravity^T @ R_cam -- supervising
        # with Tg @ R_cam would make a converged model export Tg^2 @ R_cam
        Tg = np.asarray(frame.T_gravity, np.float32)
        pose[:n] = np.einsum("ji,gjk->gik", Tg, R_cam[:n])
        mask[:n] = 1.0
    return dict(boxes2d=boxes2d, proj_xy=proj_xy, z=z_t, dims=dims,
                pose=pose, mask=mask)


def _prepare(frame, depth_ratio: int, prep):
    """One frame through the preprocessor (on the host)."""
    depth = frame.depth
    if depth_ratio > 1 and depth is not None:
        depth = depth[::depth_ratio, ::depth_ratio]
    fb, _, _ = prep(frame.image, depth, frame.K, frame.T_gravity)
    return fb


def _build_dataset_ca1m(args):
    """Real-data epoch: a CA-1M-layout sequence dir + world-corner GT.

    Mirrors ``_build_dataset``'s return contract; frames share the
    sequence's single resolution bucket so stacking is shape-safe.
    """
    from boxfusion_tpu_torch.data import get_dataset
    from boxfusion_tpu_torch.data.preprocess import Preprocessor
    from boxfusion_tpu_torch.utils.config import load_config

    cfg = load_config(args.train_config)
    cfg["data"]["datadir"] = args.data_root
    gt_path = os.path.join(args.data_root, args.gt_file)
    corners = np.load(gt_path)
    if corners.ndim != 3 or corners.shape[1:] != (8, 3):
        raise SystemExit(
            f"{gt_path}: expected (K, 8, 3) world corners "
            f"(after_filter_boxes.npy layout), got {corners.shape}"
        )
    gap = args.gap if args.gap else int(cfg["data"]["gap"])

    prep = Preprocessor(device="cpu")
    frames, targets = [], []
    for i, frame in enumerate(get_dataset(cfg)):
        if i % gap:
            continue
        frames.append(_prepare(frame, args.depth_ratio, prep))
        targets.append(_targets_from_world_corners(corners, frame, args.n_boxes))
    if not frames:
        raise SystemExit(f"no keyframes read from {args.data_root} (gap {gap})")
    return frames, targets


def _build_dataset(args):
    """Materialize the epoch: (per-frame FrameBatch on the host, targets).

    Returns (frames: list of per-frame FrameBatch, targets: list of
    per-frame target dicts).  Frames share one pad bucket (constant synthetic
    resolution) so stacking is shape-safe.
    """
    from boxfusion_tpu_torch.data.preprocess import Preprocessor
    from boxfusion_tpu_torch.data.synthetic import SyntheticSequence

    h = int(args.image_size * 3 / 4)
    w = int(args.image_size)
    prep = Preprocessor(device="cpu")
    frames, targets = [], []
    for s in range(args.n_sequences):
        seq = SyntheticSequence(
            n_frames=args.frames_per_seq, n_boxes=args.n_boxes,
            image_hw=(h, w), seed=args.seed + s,
        )
        for frame in seq:
            frames.append(_prepare(frame, args.depth_ratio, prep))
            targets.append(_frame_targets(seq, frame, args.n_boxes))
    return frames, targets


def stack_frames(frames, device):
    """Per-frame FrameBatches (batch 1 each) as one FrameBatch on ``device``."""
    import torch

    return dataclasses.replace(frames[0], **{
        f.name: torch.cat([getattr(fb, f.name) for fb in frames]).to(device)
        for f in dataclasses.fields(frames[0]) if getattr(frames[0], f.name) is not None
    })


def stack_targets(targets, device) -> dict:
    import torch

    return {k: torch.from_numpy(np.stack([t[k] for t in targets])).to(device) for k in targets[0]}


def take(tree, idx):
    """Rows ``idx`` of every tensor of a FrameBatch or a target dict."""
    if isinstance(tree, dict):
        return {k: v[idx] for k, v in tree.items()}
    return dataclasses.replace(tree, **{
        f.name: getattr(tree, f.name)[idx]
        for f in dataclasses.fields(tree) if getattr(tree, f.name) is not None
    })


def load_resume(path: str, dim: int, device):
    """The model to warm-start from: the reference's ``.pth`` / ``.pt``
    layout (fine-tune), else a checkpoint this trainer wrote."""
    import torch

    from boxfusion_tpu_torch.models.cutr import make_cutr
    from boxfusion_tpu_torch.models.cutr.convert import load_torch_state_dict, sniff_state_dict
    from boxfusion_tpu_torch.utils.checkpoint import restore_params

    if path.endswith((".pth", ".pt")):
        # fine-tune from the reference's torch checkpoint (demo.py:441)
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if "model" in sd and not isinstance(sd["model"], torch.Tensor):
            sd = sd["model"]
        ckpt_dim, ckpt_depth = sniff_state_dict(sd)
        if not ckpt_depth:
            raise SystemExit(
                "--resume checkpoint is an RGB-only CuTR; the training "
                "loop currently targets the RGB-D model"
            )
        if ckpt_dim != dim:
            raise SystemExit(
                f"--resume checkpoint is dim {ckpt_dim} but --dim is "
                f"{dim}; pass --dim {ckpt_dim}"
            )
        return load_torch_state_dict(sd, device=device)
    return restore_params(path, template=make_cutr(dim, depth_model=True, device=device))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--dim", type=int, default=192)
    ap.add_argument("--image-size", type=int, default=256)
    ap.add_argument("--depth-ratio", type=int, default=4, choices=(1, 2, 4))
    ap.add_argument("--n-sequences", type=int, default=2)
    ap.add_argument("--frames-per-seq", type=int, default=8)
    ap.add_argument("--n-boxes", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--weight-decay", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-root", type=str, default=None,
                    help="train on a real CA-1M-layout sequence dir (with "
                         "world-corner GT, see --gt-file) instead of the "
                         "synthetic oracle workload")
    ap.add_argument("--train-config", type=str, default="config/ca1m.yaml",
                    help="dataset config for --data-root mode")
    ap.add_argument("--gt-file", type=str, default="after_filter_boxes.npy",
                    help="GT world corners (K, 8, 3) inside --data-root "
                         "(data_process filter-gt output)")
    ap.add_argument("--gap", type=int, default=0,
                    help="keyframe stride for --data-root mode (0 = config)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", type=str, default=None,
                    help="params to warm-start from: a checkpoint this "
                         "trainer wrote, or the reference's cutr_rgbd.pth "
                         "(fine-tune)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default cuda; raises without one); "
                         "'cpu' runs the plain PyTorch path")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from boxfusion_tpu_torch.parallel.mesh import init_process_group
    from boxfusion_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda":
        if device.index is None:  # one process per device: torchrun's LOCAL_RANK picks it
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", torch.cuda.current_device())))
        torch.cuda.set_device(device)
    made_group = init_process_group(device.type)
    try:
        _train(args, device)
    finally:
        if made_group:
            dist.destroy_process_group()


def _train(args, device) -> None:
    import torch.distributed as dist

    from boxfusion_tpu_torch.models.cutr import make_cutr
    from boxfusion_tpu_torch.parallel import make_mesh, shard_train_step
    from boxfusion_tpu_torch.parallel.mesh import data_ranks, gathered_state_dict, mesh_shape
    from boxfusion_tpu_torch.train.step import (
        init_train_state,
        make_train_step,
        warmup_cosine_decay_schedule,
    )
    from boxfusion_tpu_torch.utils.checkpoint import save_params

    mesh = make_mesh()
    dp_total = data_ranks(mesh)
    if args.batch % dp_total:
        raise SystemExit(
            f"--batch {args.batch} must be divisible by dp*fsdp={dp_total} "
            f"(mesh {mesh_shape(mesh)})"
        )

    print(f"mesh {mesh_shape(mesh)} | batch {args.batch} | dim {args.dim}")
    if args.data_root:
        frames, targets = _build_dataset_ca1m(args)
    else:
        frames, targets = _build_dataset(args)
    n_frames = len(frames)
    print(f"dataset: {n_frames} frames, {args.n_boxes} GT slots/frame")
    frames = stack_frames(frames, device)
    targets = stack_targets(targets, device)

    if args.resume:
        model = load_resume(args.resume, args.dim, device)
        print(f"resumed params from {args.resume}")
    else:
        model = make_cutr(dimension=args.dim, depth_model=True, device=device, seed=args.seed)
    schedule = warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=args.lr, warmup_steps=args.warmup,
        decay_steps=max(args.steps, args.warmup + 1), end_value=args.lr * 0.01,
    )
    train_step, opt = make_train_step(model, learning_rate=schedule, weight_decay=args.weight_decay)
    state = init_train_state(model, opt)

    # sample with replacement exactly like the training loop: slicing
    # frames[:batch] on a short dataset would build an undersized example
    ex_idx = np.arange(args.batch) % n_frames
    step_fn, state, _, _ = shard_train_step(train_step, mesh, state, take(frames, ex_idx),
                                            take(targets, ex_idx))

    rng = np.random.RandomState(args.seed + 99)
    t0 = time.perf_counter()
    t_first = None
    loss = float("nan")
    for step in range(1, args.steps + 1):
        idx = rng.choice(n_frames, size=args.batch, replace=n_frames < args.batch)
        state, metrics = step_fn(state, take(frames, idx), take(targets, idx))
        if step == 1:
            loss = float(metrics["loss"])  # waits for the first step (warm-up, kept out of the rate)
            t_first = time.perf_counter()
        if step % args.log_every == 0 or step == args.steps:
            loss = float(metrics["loss"])  # sync point, intentionally sparse
            t_last = time.perf_counter()
            dt = t_last - t0
            print(
                f"step {step:6d} | loss {loss:9.4f} | lr {schedule(step):.2e} "
                f"| {step / dt:6.2f} steps/s"
            )
        if args.ckpt_dir and (step % args.ckpt_every == 0 or step == args.steps):
            path = f"{args.ckpt_dir}/step_{step:07d}"
            params = gathered_state_dict(state.model)  # a collective: every rank gathers
            if dist.get_rank() == 0:
                save_params(path, params)
                print(f"saved {path}")
    if args.steps > 1:
        rate = (args.steps - 1) / (t_last - t_first)
        print(f"steps 2-{args.steps}: {rate:.3f} steps/s")
    if not np.isfinite(loss):
        raise RuntimeError(f"training diverged: loss={loss}")


if __name__ == "__main__":
    main()
