"""Host shell for the device-resident online pipeline (torch).

Port of ``boxfusion_tpu/runtime/device_pipeline.py``.  The host decodes
frames, runs the detector and enqueues ``keyframe_step`` -- the world, the
manager's lists and the observation bank stay on the device from the first
keyframe to ``export_world`` at the end of the sequence.  The numpy
``OnlinePipeline`` (pipeline.py) keeps the reference-shaped host logic for
debugging and parity tests.

What the step still asks of the host is counted: ``DevicePipeline.host_reads``
is the number of device-to-host reads its keyframe steps made to steer loops
and stage gates (runtime/device_step.py says which; the ``"unrolled"`` engine
makes none).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from boxfusion_tpu_torch.fusion import load_pst
from boxfusion_tpu_torch.fusion.optimizer import PSTOptConfig
from boxfusion_tpu_torch.runtime import device_step
from boxfusion_tpu_torch.runtime.device_state import export_world, init_state
from boxfusion_tpu_torch.runtime.device_step import DET_PACK_WIDTH, META_WIDTH, StepConfig
from boxfusion_tpu_torch.utils.device import DeviceLike, host_reads, resolve_device

_DET_KEYS = ("scores", "pred_boxes", "boxes3d", "R", "proj_xy", "category")

# box_fusion.fitness_impl: the JAX package's names for its two fitness paths,
# and this package's own
_FITNESS_IMPL = {"auto": "kernel", "pallas": "kernel", "kernel": "kernel",
                 "xla": "reference", "reference": "reference"}


def resolve_engine(cfg) -> str:
    """Resolve association.engine: "auto" -> "loops".

    "loops" reads its loop predicates on the host and stops early;
    "unrolled" runs budgeted masked bodies and reads nothing
    (runtime/device_step.py).  PERF.md keeps their times on the card."""
    engine = str(cfg["association"]["engine"]) if "engine" in cfg["association"] else "auto"
    if engine == "auto":
        engine = "loops"
    if engine not in ("loops", "unrolled"):
        raise ValueError(f"association.engine must be auto|loops|unrolled, got {engine}")
    return engine


def pack_meta(frame, count: int) -> np.ndarray:
    """Pack a frame's (pose, K_img, K_depth, image_hw, frame_idx) into the
    (META_WIDTH,) f32 transfer vector every keyframe engine consumes --
    layout must match the unpacking in device_step.py (META_WIDTH)."""
    h, w = frame.image.shape[:2]
    meta = np.empty(META_WIDTH, np.float32)
    meta[:16] = np.asarray(frame.gt_pose, np.float32).ravel()
    meta[16:25] = np.asarray(frame.K, np.float32).ravel()
    meta[25:34] = np.asarray(frame.K_depth, np.float32).ravel()
    meta[34:36] = (float(h), float(w))
    meta[36] = float(count)
    return meta


def step_config_from(cfg) -> StepConfig:
    bf = cfg["box_fusion"]
    ro = bf["random_opt"]
    det = cfg["detection"]
    assoc = cfg["association"]
    engine = resolve_engine(cfg)
    fitness_impl = str(bf["fitness_impl"]) if "fitness_impl" in bf else "auto"
    if fitness_impl not in _FITNESS_IMPL:
        raise ValueError(f"box_fusion.fitness_impl must be one of {sorted(_FITNESS_IMPL)}, "
                         f"got {fitness_impl}")
    budgets = {k: int(assoc[k]) for k in ("max_nms_sweeps", "max_nms_records") if k in assoc}
    return StepConfig(
        score_thresh=float(det["score_thresh"]),
        uv_bound=bool(det["uv_bound"]),
        uv_bound_value=float(det["uv_bound_value"]),
        floor_mask=bool(det["floor_mask"]),
        floor_ratio=float(det["floor_ratio"]),
        size_max_thres=float(det["size_max_thres"] or 0.0),
        nms_threshold=float(bf["nms_threshold"]),
        small_threshold=float(assoc["small_threshold"]),
        small_size=float(bf["small_size"]),
        rotation_gap=float(assoc["rotation_gap"]),
        translation_gap=float(assoc["translation_gap"]),
        fusion_use=bool(bf["use"]),
        max_fusions=int(bf["max_fusions_per_frame"]),
        check_valid=bool(bf["check_valid"]),
        gap=int(cfg["data"]["gap"]),
        engine=engine,
        **budgets,
        opt=PSTOptConfig(
            iters=int(bf["iters"]),
            center_init_size=float(ro["center_init_size"]),
            center_scaling_coefficient=float(ro["center_scaling_coefficient"]),
            shape_init_size=float(ro["shape_init_size"]),
            shape_scaling_coefficient=float(ro["shape_scaling_coefficient"]),
            unroll=engine == "unrolled",
            fitness_impl=_FITNESS_IMPL[fitness_impl],
        ),
    )


class DevicePipeline:
    """Online detection + fusion with device-resident state.

    Args:
      cfg: a Config (utils/config.py).
      detector: Frame -> dict of detections.  May return tensors (kept on
        the device) or numpy arrays (uploaded once).
      labeler: optional open-vocab labeler (models/clip/head.py).
      capacity: world slots.
      device: where the state lives and the step runs (default "cuda";
        raises if there is none).

    ``timings`` accumulates host-clock seconds per stage: "detect" (the
    detector call), "label" (the labeler call) and "step" (the keyframe
    step, its host reads included); ``host_reads`` counts those reads.

    No worker thread.  The JAX class hands uploads and the step to a
    one-thread executor, because a blocking upload there costs the caller
    milliseconds while the step itself is one enqueue.  Here the step is
    hundreds of small launches issued from Python, and so is the detector
    pass: two threads of that kind only take turns on the interpreter lock
    (on an H100 the detector pass read 198 ms per keyframe beside a worker
    against 50 ms alone, PERF.md).  So the step runs in the caller's thread.
    What callers of the JAX class rely on is kept: a failure inside a step
    does not escape from the call that ran it but surfaces at the next
    ``process_keyframe`` or ``flush``, and ``flush`` is the point after which
    ``self.state`` may be read.
    """

    def __init__(self, cfg, detector: Callable, labeler: Optional[Callable] = None,
                 capacity: int = 512, device: DeviceLike = None):
        self.cfg = cfg
        self.detector = detector
        self.labeler = labeler
        self.device = resolve_device(device)
        self.class_list = None
        self.step_cfg = step_config_from(cfg)
        if labeler is not None:
            # The reference filters RAW scores before CLIP labeling and keeps
            # the boosted scores afterwards even if the (possibly negative)
            # boost drops them under the threshold (demo.py:138-148 then
            # 161-171).  With a labeler, process_keyframe applies the raw
            # filter itself (scores -> -1e9), so the device step's score
            # filter must not re-test the boosted values.
            self.step_cfg = dataclasses.replace(self.step_cfg, score_thresh=-1e8)
        self.state = init_state(
            capacity=capacity,
            max_views=int(cfg["association"]["max_views"]),
            obs_capacity=int(cfg["association"]["max_observations"]),
            device=self.device,
        )
        bf = cfg["box_fusion"]
        self.pst = torch.as_tensor(
            load_pst(bf["pst_path"] if "pst_path" in bf else None, int(bf["pst_size"])),
            dtype=torch.float32,
        ).to(self.device)
        self.count = 0
        self.host_reads = 0
        self.timings: Dict[str, float] = {}
        self._step_error = None
        self._label_overflow = torch.zeros((), dtype=torch.int32, device=self.device)

    def _time(self, stage: str, t0: float) -> None:
        self.timings[stage] = self.timings.get(stage, 0.0) + time.perf_counter() - t0

    def _run_step(self, step, *args, stage: Optional[str] = "step") -> None:
        """``self.state = step(self.state, *args)``, its host reads counted,
        its host-clock time added to ``timings[stage]`` (``stage=None``: the
        step times its own stages), a failure held back for the next call."""
        t0 = time.perf_counter()
        reads0 = host_reads.count
        try:
            self.state = step(self.state, *args)
        except Exception as e:  # surfaced at the next process_keyframe or flush
            self._step_error = e
        finally:
            self.host_reads += host_reads.count - reads0
            if stage is not None:
                self._time(stage, t0)

    def _raise_step_error(self) -> None:
        if self._step_error is not None:
            err, self._step_error = self._step_error, None
            raise RuntimeError("an earlier device keyframe step failed") from err

    def reset(self) -> None:
        """Fresh sequence state on the same device, same capacities."""
        self.flush()
        self.state = init_state(
            capacity=self.state.capacity,
            max_views=self.state.max_views,
            obs_capacity=self.state.obs_capacity,
            device=self.device,
        )
        self.count = 0
        self.host_reads = 0
        self.timings = {}
        self._label_overflow = torch.zeros((), dtype=torch.int32, device=self.device)

    def flush(self) -> None:
        """Every keyframe step so far has been issued (a failure of one is
        re-raised here); device work may still be in flight, in stream
        order.  After it ``self.state`` may be read."""
        self._raise_step_error()

    @torch.inference_mode()
    def process_keyframe(self, frame) -> None:
        self._raise_step_error()
        t0 = time.perf_counter()
        det = self.detector(frame)
        self._time("detect", t0)
        image_dev = det.pop("image_dev", None)
        det = {k: v for k, v in det.items() if k in _DET_KEYS}
        kmax = int(self.cfg["detection"]["max_detections"])

        # device-resident path: detector outputs that are already tensors
        # feed the step directly -- nothing is read back, nothing is packed
        # on the host; only the (37,) metadata vector is uploaded.  Open-vocab
        # labeling joins this path when the detector exports the device
        # image: CLIP crops + similarity + score boost all run on the device
        # (models/clip/head.py::label_boost_device).
        device_label = (
            self.labeler is not None
            and image_dev is not None
            and hasattr(self.labeler, "label_boost_device")
        )
        if (self.labeler is None or device_label) and all(
            isinstance(v, torch.Tensor) for v in det.values()
        ):
            if device_label:
                t0 = time.perf_counter()
                if self.class_list is None:
                    self.class_list = list(self.labeler.class_list) + [""]
                h0, w0 = frame.image.shape[:2]
                # raw-score filter BEFORE labeling (demo.py:138-148): masked
                # rows score -1e9, never enter the label budget, and stay
                # dropped by the step (whose score filter is bypassed, see
                # __init__).
                raw_ok = det["scores"] >= float(self.cfg["detection"]["score_thresh"])
                masked = torch.where(raw_ok, det["scores"], -1e9)
                new_scores, categories, _, overflow = self.labeler.label_boost_device(
                    image_dev,
                    det["pred_boxes"],
                    masked,
                    (h0, w0),
                    float(self.cfg["detection"]["scale_box"]),
                    float(self.cfg["box_fusion"]["clip_sim_coeff"]),
                    budget=int(self.cfg["detection"]["max_label_boxes"]),
                )
                det["scores"] = torch.where(raw_ok.to(new_scores.device), new_scores, -1e9)
                det["category"] = categories
                # no-silent-caps: count live detections past the label budget
                # (a device scalar; reported in run()'s summary)
                self._label_overflow = self._label_overflow + overflow.to(self.device)
                self._time("label", t0)
            meta = pack_meta(frame, self.count)
            self._run_step(device_step.keyframe_step_devdet, det, meta, self.pst,
                           self.step_cfg, kmax)
            return

        det = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
               for k, v in det.items()}

        # open-vocab labeling + CLIP score boost (demo.py:161-171): label
        # crops, boost scores, drop background; category ids ride into the
        # device state.
        if self.labeler is not None and det["scores"].shape[0] > 0:
            from boxfusion_tpu_torch.models.clip.head import scale_boxes

            t0 = time.perf_counter()
            h0, w0 = frame.image.shape[:2]
            boxes = scale_boxes(
                det["pred_boxes"], h0, w0,
                scale=float(self.cfg["detection"]["scale_box"]),
            )
            categories, _, sims = self.labeler(frame.image, boxes)
            if self.class_list is None:
                self.class_list = list(self.labeler.class_list) + [""]
            cat_idx = np.asarray(
                [self.class_list.index(c) if c in self.class_list else 0 for c in categories],
                np.int32,
            )
            # raw-score filter BEFORE the boost (demo.py:138-148 then 161-171)
            raw_ok = det["scores"] >= float(self.cfg["detection"]["score_thresh"])
            det["scores"] = det["scores"] + (
                float(self.cfg["box_fusion"]["clip_sim_coeff"]) * np.asarray(sims) / 100.0
            ).astype(np.float32)
            background = np.asarray([c == "" for c in categories])
            det["scores"] = np.where(
                background | ~raw_ok, -1e9, det["scores"]
            ).astype(np.float32)
            det["category"] = cat_idx
            self._time("label", t0)
        # pack into the one-array transfer format (device_step.py).  Padded
        # rows score -1e9 and are dropped by the score filter on the device;
        # their dims are 1.0 so downstream geometry stays benign.
        n = min(int(det["scores"].shape[0]), kmax)
        buf = np.zeros(kmax * DET_PACK_WIDTH + META_WIDTH, np.float32)
        packed = buf[: kmax * DET_PACK_WIDTH].reshape(kmax, DET_PACK_WIDTH)
        meta = buf[kmax * DET_PACK_WIDTH:]
        packed[:, 0] = -1e9
        packed[:, 8:11] = 1.0
        packed[:n, 0] = det["scores"][:n]
        packed[:n, 1:5] = det["pred_boxes"][:n]
        packed[:n, 5:11] = det["boxes3d"][:n]
        packed[:n, 11:20] = det["R"][:n].reshape(n, 9)
        if "proj_xy" in det:
            packed[:n, 20:22] = det["proj_xy"][:n]
        if "category" in det:
            packed[:n, 22] = det["category"][:n]

        meta[:] = pack_meta(frame, self.count)
        self._run_step(device_step.keyframe_step_packed, buf, self.pst, self.step_cfg)

    def _synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def save_state(self, path: str) -> None:
        """Snapshot the full device state mid-sequence (resume later)."""
        from boxfusion_tpu_torch.utils.checkpoint import save_pipeline_state

        self.flush()
        save_pipeline_state(path, self.state)

    def restore_state(self, path: str, count: int = 0) -> None:
        from boxfusion_tpu_torch.utils.checkpoint import restore_pipeline_state

        self.flush()
        self.state = restore_pipeline_state(path, device=self.device)
        self.count = count

    def run(self, dataset, gap: Optional[int] = None, verbose: bool = False,
            export: bool = True):
        """Stream ``dataset``; returns the exported world (or None).

        ``export=False`` skips the end-of-sequence readback of the world
        (timed back-to-back runs export once, at the very end)."""
        from boxfusion_tpu_torch.runtime.stream import iter_with_last

        gap = int(self.cfg["data"]["gap"]) if gap is None else gap
        start = time.time()
        # last frame is always a keyframe (reference demo.py:200:
        # ``count % gap == 0 or count == len(dataset)-1``)
        for frame, is_last in iter_with_last(dataset):
            if self.count % gap == 0 or is_last:
                self.process_keyframe(frame)
            self.count += 1
        self.flush()
        self._synchronize()
        duration = time.time() - start
        self.fps = self.count / max(duration, 1e-9)
        print(f"Cost: {duration:.2f} s Average FPS: {self.fps:.2f}")
        if not export:
            return None
        world = export_world(self.state, class_list=self.class_list)
        st = world["stats"]
        # two overflow sources: the per-call counter of the device-label path
        # and stats[4] of the state (a restored snapshot may carry one)
        overflow = int(self._label_overflow) + st["label_overflow"]
        st["label_overflow"] = overflow
        if overflow:
            print(
                f"[boxfusion-tpu] WARNING: {overflow} detections exceeded the "
                "CLIP label budget (detection.max_label_boxes) and were left "
                "unboosted with the background label; raise the budget to "
                "label every box like the reference."
            )
        if st["dropped_world_capacity"] or st["dropped_obs_capacity"]:
            print(
                "[boxfusion-tpu] WARNING: capacity overflow dropped "
                f"{st['dropped_world_capacity']} detections (world set full) and "
                f"{st['dropped_obs_capacity']} (observation bank full); raise "
                "DevicePipeline(capacity=...) / association.max_observations."
            )
        if st["truncated_gated_pairs"]:
            print(
                f"[boxfusion-tpu] WARNING: {st['truncated_gated_pairs']} gated "
                "IoU pairs exceeded max_gated_pairs and were scored 0; NMS may "
                "under-merge on very dense scenes (raise StepConfig.max_gated_pairs)."
            )
        if st.get("nms_budget_exhausted"):
            print(
                f"[boxfusion-tpu] WARNING: {st['nms_budget_exhausted']} unrolled-"
                "NMS sweep/record budget exhaustions; association decisions may "
                "diverge from the reference on this sequence (raise "
                "association.max_nms_sweeps / max_nms_records)."
            )
        return world
