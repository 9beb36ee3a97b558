"""Online per-frame pipeline: detect -> associate -> fuse -> world box set.

Port of the host engine ``boxfusion_tpu/runtime/pipeline.py:OnlinePipeline``.
Capability target: the ``run()`` state machine of the reference driver
(reference demo.py:33-387): per-keyframe detection, score/uv/floor/size
filters (demo.py:138-148), open-vocab labeling + CLIP score boost
(demo.py:161-171), camera->world lift + corner projection (demo.py:216-221),
STEP1 spatial association (demo.py:262), STEP2 small-object correspondence
(demo.py:273-289), manager updates and multi-view PST fusion
(demo.py:292-305).

Division of labor:
  * dense math (model forward, CLIP crops and tower, pairwise OBB IoU, box
    projections, the whole PST optimization across all fusable objects)
    runs on the device;
  * sequential greedy decisions (NMS order, fusion-list surgery) run in
    numpy on the host -- microseconds for the few hundred boxes per
    keyframe;
  * the pairwise IoU matrix is cached across keyframes and only the rows of
    new or fusion-moved boxes are recomputed.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from boxfusion_tpu_torch.data.readers import Frame
from boxfusion_tpu_torch.fusion import (
    BoxManager,
    PSTOptConfig,
    correspondence_association,
    iou_block,
    keyframe_geometry,
    load_pst,
    nms_3d,
    optimize_boxes,
)
from boxfusion_tpu_torch.geometry.boxes import CORNER_SIGNS
from boxfusion_tpu_torch.models.clip.head import scale_boxes
from boxfusion_tpu_torch.runtime.stream import iter_with_last
from boxfusion_tpu_torch.utils.device import DeviceLike, resolve_device


def _corners_np(xyzlhw: np.ndarray, R: np.ndarray) -> np.ndarray:
    half = xyzlhw[:, 3:] * 0.5
    local = CORNER_SIGNS[None] * half[:, None, :]
    return np.einsum("nij,nkj->nki", R, local) + xyzlhw[:, None, :3]


@dataclasses.dataclass
class WorldState:
    """The persistent world-frame box set (the reference's ``all_pred_box``)."""

    arrays: Dict[str, np.ndarray]
    categories: List[str]
    iou: np.ndarray  # (N, N) cached pairwise OBB IoU

    @staticmethod
    def empty() -> "WorldState":
        return WorldState(arrays={}, categories=[], iou=np.zeros((0, 0), np.float32))

    def __len__(self) -> int:
        return len(self.categories)

    def select(self, idx: np.ndarray) -> None:
        self.arrays = {k: v[idx] for k, v in self.arrays.items()}
        self.categories = [self.categories[int(i)] for i in idx]
        self.iou = self.iou[np.ix_(idx, idx)]

    def concat(self, new: Dict[str, np.ndarray], categories: List[str]) -> int:
        """Appends new rows; expands the IoU cache with zeros (filled later)."""
        n_old = len(self)
        if n_old == 0:
            self.arrays = {k: np.array(v) for k, v in new.items()}
        else:
            self.arrays = {
                k: np.concatenate([self.arrays[k], new[k]], axis=0) for k in self.arrays
            }
        self.categories = self.categories + list(categories)
        n = len(self)
        iou = np.zeros((n, n), np.float32)
        iou[:n_old, :n_old] = self.iou
        self.iou = iou
        return n_old

    def corners(self) -> np.ndarray:
        return _corners_np(self.arrays["xyzlhw"], self.arrays["R"])


class ObservationStore:
    """Per-frame observation bank (the reference's ever-growing
    ``per_frame_ins``, demo.py:254), indexed by init_id."""

    def __init__(self):
        self.cam_pose = np.zeros((0, 4, 4), np.float32)
        self.xyzlhw = np.zeros((0, 6), np.float32)
        self.R = np.zeros((0, 3, 3), np.float32)
        self.scores = np.zeros((0,), np.float32)
        self.corners2d = np.zeros((0, 8, 2), np.float32)
        # per-observation open-vocab label, recorded at append time: the
        # world's category list is compacted on box removal, so indexing it
        # by observation id would misalign after the first NMS drop.
        self.categories: list = []

    def __len__(self):
        return len(self.scores)

    def append(self, cam_pose, xyzlhw, R, scores, corners2d, categories=None):
        self.cam_pose = np.concatenate([self.cam_pose, cam_pose], 0)
        self.xyzlhw = np.concatenate([self.xyzlhw, xyzlhw], 0)
        self.R = np.concatenate([self.R, R], 0)
        self.scores = np.concatenate([self.scores, scores], 0)
        self.corners2d = np.concatenate([self.corners2d, corners2d], 0)
        self.categories += list(categories) if categories is not None else (
            ["object"] * len(scores)
        )


class OnlinePipeline:
    """The online reconstruction-free detection+fusion loop (host engine).

    Args:
      cfg: a Config (utils/config.py).
      detector: Frame -> dict of numpy detections (CuTRDetector or an oracle).
      labeler: optional open-vocab labeler: (image, boxes2d) ->
        (categories list[str], features (N, F), sims (N,)); without one every
        detection is labeled "object".
      device: where association geometry and fusion run (default "cuda";
        raises if there is none).

    ``timings`` accumulates host-clock seconds per stage: "detect" (the
    detector call, which ends in a device-to-host copy), "label" (the
    labeler call, which ends in one), "geometry" and "fusion" (each ends in
    one).
    """

    def __init__(self, cfg, detector: Callable, labeler: Optional[Callable] = None,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.detector = detector
        self.labeler = labeler
        self.device = resolve_device(device)
        self.manager = BoxManager(cfg)
        self.world = WorldState.empty()
        self.obs = ObservationStore()
        self.box_count = 0
        self.count = 0
        self.kf_poses: Dict[int, np.ndarray] = {}
        bf = cfg["box_fusion"]
        self.pst = load_pst(bf["pst_path"] if "pst_path" in bf else None, int(bf["pst_size"]))
        ro = bf["random_opt"]
        self.opt_cfg = PSTOptConfig(
            iters=int(bf["iters"]),
            center_init_size=float(ro["center_init_size"]),
            center_scaling_coefficient=float(ro["center_scaling_coefficient"]),
            shape_init_size=float(ro["shape_init_size"]),
            shape_scaling_coefficient=float(ro["shape_scaling_coefficient"]),
        )
        self.max_views = int(cfg["association"]["max_views"])
        self.max_fusions = int(bf["max_fusions_per_frame"])
        self.timings: Dict[str, float] = {}

    def _time(self, stage: str, t0: float) -> None:
        self.timings[stage] = self.timings.get(stage, 0.0) + time.perf_counter() - t0

    # -- filters (demo.py:138-148) -------------------------------------------
    def _filter_detections(self, det: Dict[str, np.ndarray], image_hw) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        h, w = image_hw
        mask = det["scores"] >= float(cfg["detection"]["score_thresh"])
        det = {k: v[mask] for k, v in det.items()}
        if cfg["detection"]["uv_bound"]:
            m = BoxManager.check_uv_bounds(
                det["proj_xy"], w, h, ratio=float(cfg["detection"]["uv_bound_value"])
            )
            det = {k: v[m] for k, v in det.items()}
        if cfg["detection"]["floor_mask"]:
            m = BoxManager.check_floor_mask(
                det["boxes3d"], ratio=float(cfg["detection"]["floor_ratio"])
            )
            det = {k: v[~m] for k, v in det.items()}
        if cfg["detection"]["size_max_thres"]:
            m = BoxManager.check_large_mask(
                det["boxes3d"], thres=float(cfg["detection"]["size_max_thres"])
            )
            det = {k: v[~m] for k, v in det.items()}
        return det

    # -- one keyframe ----------------------------------------------------------
    def process_keyframe(self, frame: Frame) -> None:
        cfg = self.cfg
        count = self.count
        h, w = frame.image.shape[:2]
        pose = frame.gt_pose.astype(np.float32)
        self.kf_poses[count] = pose

        t0 = time.perf_counter()
        det = self.detector(frame)
        self._time("detect", t0)
        det = self._filter_detections(det, (h, w))

        # open-vocab labeling + CLIP score boost (demo.py:161-171)
        if self.labeler is not None and len(det["scores"]) > 0:
            t0 = time.perf_counter()
            boxes = scale_boxes(
                det["pred_boxes"], h, w, scale=float(cfg["detection"]["scale_box"])
            )
            categories, features, sims = self.labeler(frame.image, boxes)
            self._time("label", t0)
            det["scores"] = det["scores"] + (
                float(cfg["box_fusion"]["clip_sim_coeff"]) * sims / 100.0
            )
            keep = np.asarray([c != "" for c in categories])
            det = {k: v[keep] for k, v in det.items()}
            categories = [c for c in categories if c != ""]
            features = features[keep]
        else:
            categories = ["object"] * len(det["scores"])
            features = np.zeros((len(det["scores"]), 0), np.float32)

        n_new = len(det["scores"])
        if n_new == 0:
            self.manager.num_record[count] = self.box_count
            return

        # lift to world (demo.py:216-221)
        Rp, t = pose[:3, :3], pose[:3, 3]
        centers_w = det["boxes3d"][:, :3] @ Rp.T + t
        xyzlhw_w = np.concatenate([centers_w, det["boxes3d"][:, 3:]], 1).astype(np.float32)
        R_w = np.einsum("ij,njk->nik", Rp, det["R"]).astype(np.float32)
        cam_pose = np.tile(pose[None], (n_new, 1, 1))

        # one device round trip for all the keyframe's association geometry
        t0 = time.perf_counter()
        n_old = len(self.world)
        if n_old:
            all_t = np.concatenate([self.world.arrays["xyzlhw"], xyzlhw_w], 0)
            all_R = np.concatenate([self.world.arrays["R"], R_w], 0)
        else:
            all_t, all_R = xyzlhw_w, R_w
        corners2d, iou_rows, proj2d_all = keyframe_geometry(
            xyzlhw_w, R_w, cam_pose, all_t, all_R,
            frame.K_depth, pose, float(h), float(w), device=self.device,
        )
        self._time("geometry", t0)

        init_id = self.box_count + np.arange(n_new)
        new_rows = dict(
            xyzlhw=xyzlhw_w,
            R=R_w,
            scores=det["scores"].astype(np.float32),
            pred_classes=det["pred_classes"],
            pred_boxes=det["pred_boxes"].astype(np.float32),
            pred_logits=det["pred_logits"].astype(np.float32),
            proj_xy=det["proj_xy"].astype(np.float32),
            object_desc=det["object_desc"].astype(np.float32),
            cam_pose=cam_pose,
            frame_id=np.full(n_new, count, np.int64),
            init_id=init_id,
            valid_num=np.zeros(n_new, np.float32),
            features=features,
        )

        self.obs.append(cam_pose, xyzlhw_w, R_w, new_rows["scores"], corners2d, categories)
        self.box_count += n_new
        self.manager.num_record[count] = self.box_count

        if len(self.world) == 0:
            self.manager.init_new_predictions(n_new, 0)
            self.world.concat(new_rows, categories)
            self.world.iou = iou_rows
            np.fill_diagonal(self.world.iou, 0.0)
            return

        self.manager.init_new_predictions(n_new, len(self.obs) - n_new)
        n_before = self.world.concat(new_rows, categories)

        # refresh IoU cache rows for the new boxes
        self.world.iou[n_before:, :] = iou_rows
        self.world.iou[:, n_before:] = iou_rows.T
        self.world.iou[np.arange(len(self.world)), np.arange(len(self.world))] = 0.0

        # STEP 1: spatial association (demo.py:262)
        arr = self.world.arrays
        keep, success = nms_3d(
            arr["valid_num"],
            self.manager,
            self.world.iou,
            arr["scores"],
            arr["init_id"],
            self.obs.cam_pose,
            arr["xyzlhw"][:, 3:],
            arr["xyzlhw"][:, :3],  # corner mean == center (symmetric template)
            iou_threshold=float(cfg["box_fusion"]["nms_threshold"]),
        )

        cur_keep_idx = [int(i) - n_before for i in keep if i >= n_before]
        cur_success_nms = [int(i) - n_before for i in success if i >= n_before]
        keep_idx = np.asarray(keep)

        if len(cur_keep_idx) > 0:
            # STEP 2: small-object correspondence (demo.py:273-289), on the
            # projections from the geometry call (boxes have not moved since)
            global_keep_idx = keep_idx[keep_idx < n_before]
            keep_idx = correspondence_association(
                cfg,
                self.manager,
                cur_keep_idx,
                cur_success_nms,
                keep_idx,
                n_before,
                new_rows["xyzlhw"][:, 3:],
                new_rows["pred_boxes"],
                new_rows["scores"],
                arr["scores"],
                arr["xyzlhw"][:, 3:],
                proj2d_all[global_keep_idx],
                arr["valid_num"],
                arr["init_id"],
                self.obs.cam_pose,
                threshold=float(cfg["association"]["small_threshold"]),
            )
            self.world.select(keep_idx)
            self.manager.update(keep_idx)

            if cfg["box_fusion"]["check_valid"]:
                keep2 = self.manager.check_valid_num(
                    self.world.arrays["frame_id"],
                    self.world.arrays["valid_num"],
                    count,
                    int(cfg["data"]["gap"]),
                )
                self.world.select(keep2)

            if cfg["box_fusion"]["use"]:
                self._fuse(frame, (h, w))
        else:
            self.world.select(keep_idx)
            self.manager.update(keep_idx)

    # -- multi-view fusion (demo.py:305 -> box_fusion.py:622-724) -------------
    def _fuse(self, frame: Frame, image_hw) -> None:
        h, w = image_hw
        cand = [
            i
            for i in range(len(self.world))
            if len(self.manager.fusion_list[i]) >= 3
            and not self.manager.check_if_fusion(self.manager.fusion_list[i])
        ]
        if not cand:
            return
        cand = cand[: self.max_fusions]

        V = self.max_views
        # a fixed object batch (max_fusions_per_frame): one kernel launch
        # shape for the whole run, inactive slots masked
        n = self.max_fusions
        init_x = np.zeros((n, 6), np.float32)
        init_R = np.zeros((n, 3, 3), np.float32)
        poses = np.tile(np.eye(4, dtype=np.float32), (n, V, 1, 1))
        corners = np.zeros((n, V, 8, 2), np.float32)
        vmask = np.zeros((n, V), np.float32)
        obj_mask = np.zeros(n, bool)
        obj_mask[: len(cand)] = True
        init_x[:, 3:] = 1.0  # benign dims for inactive slots

        for a, i in enumerate(cand):
            fusion_idx = self.manager.fusion_list[i][:V]
            m = len(fusion_idx)
            init_x[a], init_R[a] = _init_opt_params_np(
                self.obs.xyzlhw[fusion_idx], self.obs.R[fusion_idx], self.obs.scores[fusion_idx]
            )
            poses[a, :m] = self.obs.cam_pose[fusion_idx]
            corners[a, :m] = self.obs.corners2d[fusion_idx]
            vmask[a, :m] = 1.0

        t0 = time.perf_counter()
        fused, updated = optimize_boxes(
            init_x, init_R, self.pst, poses, corners, vmask, obj_mask,
            frame.K, float(h), float(w), self.opt_cfg, device=self.device,
        )
        fused = fused.cpu().numpy()
        updated = updated.cpu().numpy()
        self._time("fusion", t0)

        changed = []
        for a, i in enumerate(cand):
            if updated[a]:
                # only xyzlhw moves; the box keeps its own R although the
                # optimizer ran under the best member's (reference
                # box_fusion.py:716-724 writes .tensor[i] only)
                self.world.arrays["xyzlhw"][i] = fused[a]
                self.manager.update_fusion_flag(i)
                self.manager.add_fusion_ind(self.manager.fusion_list[i])
                changed.append(i)

        if changed:
            all_corners = self.world.corners()
            block = iou_block(all_corners[changed], all_corners, device=self.device)
            for r, i in enumerate(changed):
                self.world.iou[i, :] = block[r]
                self.world.iou[:, i] = block[r]
                self.world.iou[i, i] = 0.0

    # -- driver ---------------------------------------------------------------
    def run(
        self,
        dataset,
        gap: Optional[int] = None,
        verbose: bool = False,
        on_frame=None,
        on_keyframe=None,
        warmup: bool = True,
    ):
        """Run the full online loop over a dataset of Frames.

        Args:
          on_frame: optional ``(frame) -> None`` hook, called for every frame.
          on_keyframe: optional ``(world) -> None`` hook, called after each
            keyframe update.
          warmup: run one throwaway detector call on the first frame BEFORE
            the timed loop (sized datasets only), as the JAX engine does.  A
            stateful detector (the noisy oracle draws from its RNG on every
            call) sees one extra call.

        Returns the final WorldState; prints the end-to-end FPS like the
        reference (demo.py:363-366).
        """
        gap = int(self.cfg["data"]["gap"]) if gap is None else gap
        if warmup and hasattr(dataset, "__len__") and len(dataset):
            self.detector(next(iter(dataset)))
        start = time.perf_counter()
        # the last frame is always a keyframe (reference demo.py:200)
        for frame, is_last in iter_with_last(dataset):
            if on_frame is not None:
                on_frame(frame)
            if self.count % gap == 0 or is_last:
                self.process_keyframe(frame)
                if on_keyframe is not None:
                    on_keyframe(self.world)
                if verbose:
                    print(
                        f"frame {self.count}: {len(self.world)} world boxes, "
                        f"{self.box_count} observations"
                    )
            self.count += 1
        duration = time.perf_counter() - start
        self.fps = self.count / max(duration, 1e-9)
        print(f"Cost: {duration:.2f} s Average FPS: {self.fps:.2f}")
        return self.world


def _init_opt_params_np(box_3d: np.ndarray, R: np.ndarray, scores: np.ndarray):
    """numpy mirror of init_opt_params (box_fusion.py:566-600)."""
    best = int(np.argmax(scores))
    mean_xyz = box_3d[:, :3].mean(axis=0)
    sorted_idx = np.argsort(box_3d[best, 3:])
    get_indices = np.argsort(sorted_idx)
    dims_sorted = np.sort(box_3d[:, 3:], axis=1)[:, get_indices]
    return (
        np.concatenate([mean_xyz, dims_sorted.mean(axis=0)]).astype(np.float32),
        R[best].astype(np.float32),
    )
