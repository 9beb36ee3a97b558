"""The plain reference of one configuration: its stages, and an engine of them.

Built from the copies beside this file (plain PyTorch, no kernel of the
program: attention, fitness and the PST search run their plain forms), the
detector and the image tower as the configuration's families build them
(``benchmark/families/``), with weights made by the benchmark from the
configuration's ``weight_seed`` (``benchmark.harness.weights``, which the
program under test is handed too).  Each stage follows the
program's semantics as the benchmark pins them:

* ``detect``: the frame through the transport's uint16 depth, the packaging
  into the pad bucket and the detector's forward.  ``rank_from`` makes the
  decoder take the proposals in another run's order (CuTR's query
  embeddings follow the rank, so two runs that rank two near-tied proposals
  apart would otherwise compare different rows).
* ``similarities``: the image tower's scores (100 x cosine against the
  class features) of the crops of given boxes, cut and normalised as the
  labeler family cuts them, with the background column.
* ``label``: the label stage over a keyframe's detections (raw score filter,
  the label bucket, the boost), as the engine runs it.
* ``step``: the keyframe step (filters, append, NMS, correspondence, PST
  fusion) from a given state.

The reference runs in float32 with TF32 off.  ``ReferenceEngine(...,
detector_dtype=FP8, tower_dtype=FP8, tf32=True, search_dtype=torch.bfloat16)``
is the control: the same stages one precision below what the configuration
states (the detector and the tower state bfloat16; the step's products
float32 with TF32 off; the PST search float32 arithmetic, with no product
that TF32 would touch).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from benchmark.reference.data.preprocess import (
    PIXEL_MEAN_U8,
    PIXEL_STD_U8,
    package_frame,
    resolve_pad_and_ratio,
)
from benchmark.reference.fusion.optimizer import PSTOptConfig
from benchmark.reference.fusion.pst import synthesize_pst
from benchmark.reference.models.clip.head import scale_boxes
from benchmark.reference.runtime import device_step
from benchmark.reference.runtime.device_state import init_state

_DET_KEYS = ("scores", "pred_boxes", "boxes3d", "R", "proj_xy")


def label_buckets_for(budget: int) -> tuple:
    """Ascending crop-count buckets ending at ``budget`` (the engine's)."""
    return (0,) + tuple(b for b in (32, 64, 96, 112) if b < budget) + (budget,)


def step_config(settings: dict, labelled: bool) -> device_step.StepConfig:
    """The keyframe step's configuration from the settings; with a labeler
    the step's own score filter is off (the label stage applied it).  The
    reference is the port's ``loops`` engine, which ``engine: auto`` selects;
    a configuration that asks for another engine is refused."""
    bf, det, assoc = settings["box_fusion"], settings["detection"], settings["association"]
    if assoc.get("engine", "auto") not in ("auto", "loops"):
        raise ValueError(f"the reference runs the loops engine; the configuration asks for {assoc['engine']!r}")
    ro = bf["random_opt"]
    cfg = device_step.StepConfig(
        score_thresh=float(det["score_thresh"]), uv_bound=bool(det["uv_bound"]),
        uv_bound_value=float(det["uv_bound_value"]), floor_mask=bool(det["floor_mask"]),
        floor_ratio=float(det["floor_ratio"]), size_max_thres=float(det["size_max_thres"] or 0.0),
        nms_threshold=float(bf["nms_threshold"]), small_threshold=float(assoc["small_threshold"]),
        small_size=float(bf["small_size"]), rotation_gap=float(assoc["rotation_gap"]),
        translation_gap=float(assoc["translation_gap"]), fusion_use=bool(bf["use"]),
        max_fusions=int(bf["max_fusions_per_frame"]), check_valid=bool(bf["check_valid"]),
        gap=int(settings["data"]["gap"]),
        opt=PSTOptConfig(
            iters=int(bf["iters"]), center_init_size=float(ro["center_init_size"]),
            center_scaling_coefficient=float(ro["center_scaling_coefficient"]),
            shape_init_size=float(ro["shape_init_size"]),
            shape_scaling_coefficient=float(ro["shape_scaling_coefficient"]),
        ),
    )
    return dataclasses.replace(cfg, score_thresh=-1e8) if labelled else cfg


class ReferenceEngine:
    """The reference stages of one configuration."""

    def __init__(self, config: dict, families, traffic: dict, device: torch.device,
                 detector_dtype: torch.dtype = torch.float32,
                 tower_dtype: torch.dtype = torch.float32, tf32: bool = False, build_tower: bool = True,
                 search_dtype: Optional[torch.dtype] = None):
        from benchmark.harness import weights

        self.config, self.families, self.device, self.tf32 = config, families, device, tf32
        self.settings = config["settings"]
        det, lab = config["detector"], config["labeler"]
        seed = int(config["weight_seed"])
        self.detector = families.detector.reference(det, detector_dtype, device)
        weights.fill(self.detector, families.detector.table(self.detector, traffic["class_bias_lift"]), seed,
                     device)
        self.tower, self.tower_dtype = None, tower_dtype
        if build_tower:
            self.tower = families.labeler.reference(lab, tower_dtype, device)
            weights.fill(self.tower, families.labeler.table(self.tower), seed + 2, device)
        tf = weights.text_features(lab["n_classes"], lab["embed_dim"], seed, device)
        # the labeler normalises its features on the host, in float32
        tf = tf.cpu().numpy()
        self.text = torch.from_numpy(tf / np.linalg.norm(tf, axis=-1, keepdims=True)).to(device)
        self.n_classes = int(lab["n_classes"])
        self.sim_thres = float(lab["sim_thres"])
        self.depth_scale = float(config["depth_scale"])
        bf = self.settings["box_fusion"]
        self.pst = torch.from_numpy(synthesize_pst(int(bf["pst_size"]))).to(device)
        self.step_cfg = step_config(self.settings, labelled=True)
        if search_dtype is not None:
            self.step_cfg = dataclasses.replace(
                self.step_cfg, opt=dataclasses.replace(self.step_cfg.opt, round_to=search_dtype))
        d = self.settings["detection"]
        self.raw_thresh = float(d["score_thresh"])
        self.budget = int(d["max_label_boxes"])
        self.kmax = int(d["max_detections"])
        self.scale_box = float(d["scale_box"])
        self.coeff = float(bf["clip_sim_coeff"])
        self.bucketing = bool(d.get("label_bucketing", True))

    def _precision(self):
        return _Precision(self.tf32)

    # -- detect ---------------------------------------------------------
    def batch(self, frame):
        """The frame as the engine packages it: depth through the uint16
        transport at the configuration's depth scale."""
        dev = self.device
        scale = np.float32(self.depth_scale)
        d = np.asarray(frame.depth, np.float32) * scale + np.float32(0.5)
        d_u16 = np.clip(d, 0, 65535).astype(np.uint16)
        depth = torch.from_numpy(d_u16.astype(np.int32)).to(dev).to(torch.float32) / torch.tensor(
            scale, device=dev)
        image = torch.from_numpy(np.ascontiguousarray(frame.image)).to(dev)
        square, ratio = resolve_pad_and_ratio(frame.image, frame.depth)
        return package_frame(image, depth, torch.from_numpy(np.asarray(frame.K, np.float32)).to(dev),
                             torch.from_numpy(np.asarray(frame.T_gravity, np.float32)).to(dev),
                             square, ratio)

    @torch.inference_mode()
    def detect(self, frame, rank_from: Optional[torch.Tensor] = None) -> dict:
        """The detector's rows for one frame (batch axis dropped) and its
        encoder logits (``enc_logits``, batch kept)."""
        with self._precision():
            batch = self.batch(frame)
            out = self.detector(batch, rank_from=rank_from)
        det = {k: out[k][0].to(torch.float32) for k in _DET_KEYS}
        det["enc_logits"] = out["enc_logits"]
        det["image"] = batch.image[0]
        return det

    # -- label ----------------------------------------------------------
    def _images(self, norm_image: torch.Tensor) -> torch.Tensor:
        dev = norm_image.device
        return (norm_image * torch.as_tensor(PIXEL_STD_U8, device=dev)
                + torch.as_tensor(PIXEL_MEAN_U8, device=dev))

    @torch.inference_mode()
    def similarities(self, norm_image: torch.Tensor, boxes: torch.Tensor, hw) -> torch.Tensor:
        """(N, n_classes + 1) scores of the crops of ``boxes`` (xyxy, before
        the label scale), the last column the background's."""
        if boxes.shape[0] == 0:
            return torch.zeros((0, self.n_classes + 1), device=self.device)
        with self._precision():
            crops = self.families.labeler.crops(
                self.config["labeler"], self._images(norm_image),
                scale_boxes(boxes.to(torch.float32), hw[0], hw[1], self.scale_box), self.tower_dtype)
            feats = self.tower(crops)
            feats = feats / torch.linalg.norm(feats, dim=-1, keepdim=True)
            sims = 100.0 * (feats @ self.text.T)
        return torch.cat([sims, sims.new_full((sims.shape[0], 1), self.sim_thres)], dim=-1)

    @torch.inference_mode()
    def label(self, det: dict, norm_image: torch.Tensor, hw) -> dict:
        """The label stage over one keyframe's rows, as the engine runs it:
        ``b`` crops (the label bucket), ``new_scores``, ``categories`` and
        ``overflow``."""
        scores = det["scores"]
        raw_ok = scores >= self.raw_thresh
        masked = torch.where(raw_ok, scores, -1e9)
        budget = min(self.budget, int(scores.shape[0]))
        b = budget
        if self.bucketing:
            live = int(raw_ok.sum())
            b = next(x for x in label_buckets_for(budget) if x >= min(live, budget))
        categories = torch.full(scores.shape, self.n_classes, dtype=torch.int32, device=scores.device)
        new_scores = masked.clone()
        if b > 0:
            scored = self.similarities(norm_image, det["pred_boxes"][:b], hw)
            best = torch.argmax(scored, dim=-1)
            boosted = masked[:b] + self.coeff * scored.max(dim=-1).values / 100.0
            new_scores[:b] = torch.where(best == self.n_classes, -1e9, boosted)
            categories[:b] = best.to(torch.int32)
        overflow = (masked[b:] > -1e8).sum().to(torch.int32)
        return dict(b=b, new_scores=new_scores, categories=categories, overflow=overflow)

    def step_input(self, det: dict, label: dict) -> dict:
        """What the keyframe step takes after the label stage."""
        raw_ok = det["scores"] >= self.raw_thresh
        rows = {k: det[k].to(torch.float32) for k in _DET_KEYS}
        rows["scores"] = torch.where(raw_ok, label["new_scores"], -1e9)
        rows["category"] = label["categories"]
        return device_step.pad_detections(rows, self.kmax)

    # -- step -----------------------------------------------------------
    def init_state(self):
        assoc = self.settings["association"]
        return init_state(capacity=int(self.config["capacity"]), max_views=int(assoc["max_views"]),
                          obs_capacity=int(assoc["max_observations"]), device=self.device)

    @torch.inference_mode()
    def step(self, state, det_in: dict, overflow, frame, frame_idx: int, record: Optional[dict] = None):
        """One keyframe step from ``state`` (the label overflow first folds
        into its stats, as the engine does)."""
        dev = self.device
        stats = state.stats.clone()
        stats[4] += overflow.to(stats.dtype)
        state = dataclasses.replace(state, stats=stats)

        def t(x):
            return torch.from_numpy(np.asarray(x, np.float32)).to(dev)

        h, w = frame.image.shape[:2]
        with self._precision():
            return device_step._keyframe_step_impl(
                state, det_in, self.pst, t(frame.gt_pose), t(frame.K), t(frame.K_depth),
                (float(h), float(w)), int(frame_idx), self.step_cfg, record=record)

    def process_keyframe(self, state, frame, frame_idx: int):
        """The whole keyframe, as the engine runs it.  Returns (state, the
        rows of the detector, the label stage's outputs)."""
        det = self.detect(frame)
        label = self.label(det, det["image"], frame.image.shape[:2])
        state = self.step(state, self.step_input(det, label), label["overflow"], frame, frame_idx)
        return state, det, label


class _Precision:
    """TF32 on or off for float32 products inside the block (the control
    runs the float32 stages in TF32); restored afterwards."""

    def __init__(self, tf32: bool):
        self.tf32 = tf32

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
