"""Batched multi-sequence pipeline: N sequences in lockstep on ONE device
(torch).

Port of ``boxfusion_tpu/runtime/batched.py``.  The device fan-out
(eval/runner.py) spreads sequences across devices; this module batches them
on one: each keyframe ROUND runs the CuTR forward once on an (N, ...) batch
and, with a labeler, the CLIP tower once over all N lanes' crops, then steps
each lane's own ``DeviceState``.

What differs from the JAX module: JAX steps the N stacked states as ONE
``jax.vmap``-ed program with a ``lax.cond`` per lane.  The port's keyframe
step is eager and reads loop predicates back to the host
(runtime/device_step.py), which ``torch.vmap`` cannot run, so the port keeps
a list of per-lane states and steps the active lanes one after another; the
host reads of a round are then about N times the device engine's per
keyframe (``host_reads`` counts them).  No program cache exists to share
(eager PyTorch compiles nothing).

Decision parity: each lane sees its own state, detections and metadata, so
a lane's exported world matches a single-sequence ``DevicePipeline`` run of
the same frames (tests/test_torch_batched.py), up to the rounding of the
batched forward.  Lanes may have different lengths: exhausted lanes go
inactive and their state is left as it is while live lanes keep stepping.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from boxfusion_tpu_torch.data.preprocess import (
    Preprocessor,
    package_frame,
    resolve_pad_and_ratio,
)
from boxfusion_tpu_torch.fusion import load_pst
from boxfusion_tpu_torch.models.cutr.model import FrameBatch
from boxfusion_tpu_torch.runtime.device_pipeline import pack_meta, step_config_from
from boxfusion_tpu_torch.runtime.device_state import export_world, init_state
from boxfusion_tpu_torch.runtime.device_step import _with_stat
from boxfusion_tpu_torch.runtime.fused import (
    _detections,
    _step,
    fused_meta_host,
    label_boost_core,
    pack_fused_buffer,
    unpack_fused_buffer,
    upload,
)
from boxfusion_tpu_torch.utils.device import DeviceLike, host_reads, resolve_device


def _stack(batches: Sequence[FrameBatch]) -> FrameBatch:
    """Concatenate batches of one along the batch axis."""
    return FrameBatch(**{
        f.name: (None if getattr(batches[0], f.name) is None
                 else torch.cat([getattr(b, f.name) for b in batches]))
        for f in dataclasses.fields(FrameBatch)
    })


class BatchedPipeline:
    """Run N posed RGB-D sequences in lockstep on one device.

    Args:
      cfg: a Config (utils/config.py).
      detector: a ``CuTRDetector`` -- its model is applied to the stacked
        (N, ...) FrameBatch directly (the per-frame call path is bypassed,
        like ``FusedDevicePipeline``); it must live on ``device``.
      n_lanes: number of concurrent sequences.
      capacity: world slots per lane.
      transport: "arrays" (each lane's frame uploaded and packaged apart) or
        "packed" (the fused engine's byte buffers, ONE (N, L) upload a round).
      labeler: open-vocab labeling, "packed" only: one tower call a round
        over the N lanes' ``max_label_boxes`` crops each.
      device: where the states live and every stage runs (default "cuda").

    ``host_reads`` counts the steps' device-to-host reads over the last
    ``run``; ``keyframes_per_s`` and ``lane_fps`` are its rates.
    """

    def __init__(self, cfg, detector, n_lanes: int, capacity: int = 512,
                 transport: str = "arrays", depth_mode: str = "u16",
                 depth_scale: float = 1000.0, labeler=None, device: DeviceLike = None):
        if transport not in ("arrays", "packed"):
            raise ValueError(f"transport must be arrays|packed, got {transport}")
        if depth_mode not in ("u16", "f32"):
            raise ValueError(f"depth_mode must be u16|f32, got {depth_mode}")
        if labeler is not None and transport != "packed":
            raise ValueError(
                "open-vocab labeling runs on the packed round; use "
                "transport='packed' with a labeler"
            )
        self.cfg = cfg
        self.detector = detector
        self.labeler = labeler
        self.device = resolve_device(device)
        self.n_lanes = int(n_lanes)
        self.capacity = int(capacity)
        self.transport = transport
        self.depth_mode = depth_mode
        self.depth_scale = float(depth_scale)
        self.step_cfg = step_config_from(cfg)
        self.class_list = None
        if labeler is not None:
            # raw-score filter runs before CLIP; the step must not re-test
            # the boosted scores (device_pipeline.py)
            self.step_cfg = dataclasses.replace(self.step_cfg, score_thresh=-1e8)
            self.class_list = list(labeler.class_list) + [""]
        self.kmax = int(cfg["detection"]["max_detections"])
        self.reset()
        bf = cfg["box_fusion"]
        self.pst = torch.as_tensor(
            load_pst(bf["pst_path"] if "pst_path" in bf else None, int(bf["pst_size"])),
            dtype=torch.float32,
        ).to(self.device)
        self._pre = Preprocessor(detector.buckets, device=self.device)
        self.host_reads = 0
        self.label_batch = 0  # crops in the last round's tower call

    def reset(self) -> None:
        """Fresh per-lane world states (one instance serves many groups)."""
        self.states = [
            init_state(
                capacity=self.capacity,
                max_views=int(self.cfg["association"]["max_views"]),
                obs_capacity=int(self.cfg["association"]["max_observations"]),
                device=self.device,
            )
            for _ in range(self.n_lanes)
        ]

    def _forward(self, stacked: FrameBatch) -> dict:
        model = self.detector.model
        model_dev = next(model.parameters()).device
        if model_dev != self.states[0].device:
            raise ValueError(f"the detector's model is on {model_dev}, the lanes on "
                             f"{self.states[0].device}")
        return model(stacked)

    def _step_lanes(self, dets: List[Optional[dict]], metas, metas_host, overflow=None) -> None:
        """Step every active lane (``dets[i]`` not None) in lane order."""
        reads0 = host_reads.count
        try:
            for i, det in enumerate(dets):
                if det is None:
                    continue
                state = self.states[i]
                if overflow is not None:
                    state = dataclasses.replace(state, stats=_with_stat(state.stats, 4, overflow[i]))
                self.states[i] = _step(state, det, metas[i], metas_host[i], self.pst,
                                       self.step_cfg, self.kmax)
        finally:
            self.host_reads += host_reads.count - reads0

    def _process_keyframes_packed(self, frames, counts, live) -> None:
        """Packed round: ONE (N, L) uint8 upload, the lanes unpacked and
        packaged on the device, one (N, ...) forward, one tower call."""
        keys = set()
        bufs: List[Optional[np.ndarray]] = [None] * self.n_lanes
        for i in live:
            f = frames[i]
            if f.depth is None:
                raise ValueError(
                    "packed transport requires depth frames (the buffer "
                    "layout carries a depth plane); use transport='arrays'"
                )
            square, ratio = resolve_pad_and_ratio(f.image, f.depth, self.detector.buckets)
            keys.add((square, ratio, f.image.shape[:2], f.depth.shape[:2]))
            bufs[i] = pack_fused_buffer(f, counts[i], self.depth_mode, self.depth_scale)
        if len(keys) != 1:
            raise ValueError(
                f"batched lanes must share one shape bucket, got {sorted(keys)} "
                "-- group sequences of equal resolution per BatchedPipeline"
            )
        square, ratio, (h, w), (dh, dw) = keys.pop()
        # dead lanes replicate the first live lane's input (kept inactive):
        # the CuTR batch and the label batch keep their N
        first = bufs[live[0]]
        stacked = np.stack([b if b is not None else first for b in bufs])
        metas_host = [fused_meta_host(b) for b in stacked]
        dev_bufs = upload(stacked, self.device)
        depth_model = self.detector.model.cfg.depth_model
        batches, metas = [], []
        for buf in dev_bufs:
            image_u8, depth, meta = unpack_fused_buffer(buf, h=h, w=w, dh=dh, dw=dw,
                                                        depth_mode=self.depth_mode)
            batches.append(package_frame(image_u8, depth if depth_model else None,
                                         meta[16:25].reshape(3, 3), meta[37:46].reshape(3, 3),
                                         square, ratio))
            metas.append(meta)
        batch = _stack(batches)
        out = self._forward(batch)
        dets = [_detections(out, i) for i in range(self.n_lanes)]
        overflow = None
        if self.labeler is not None:
            # the fused engine's label stage at the full budget, all lanes
            # in one tower call (JAX: label_boost_core vmapped over the lanes)
            det_cfg = self.cfg["detection"]
            budget = min(int(det_cfg["max_label_boxes"]), int(out["scores"].shape[1]))
            dets, overflow = label_boost_core(
                self.labeler, dets, batch.image, [(float(m[34]), float(m[35])) for m in metas_host],
                label_budget=budget, scale_box=float(det_cfg["scale_box"]),
                clip_coeff=float(self.cfg["box_fusion"]["clip_sim_coeff"]),
                raw_score_thresh=float(det_cfg["score_thresh"]),
            )
            self.label_batch = self.n_lanes * budget
        self._step_lanes([d if frames[i] is not None else None for i, d in enumerate(dets)],
                         metas, metas_host, overflow)

    @torch.inference_mode()
    def process_keyframes(self, frames: Sequence[Optional[object]],
                          counts: Sequence[int]) -> None:
        """One lockstep keyframe round.

        Args:
          frames: per-lane Frame or None (lane exhausted / not at keyframe).
          counts: per-lane frame counters (the reference's ``count``).
        """
        live = [i for i, f in enumerate(frames) if f is not None]
        if not live:
            return
        if self.transport == "packed":
            return self._process_keyframes_packed(frames, counts, live)
        batches, keys = {}, set()
        metas_host = [None] * self.n_lanes
        for i in live:
            b, square, ratio = self._pre(frames[i].image, frames[i].depth, frames[i].K,
                                         frames[i].T_gravity)
            keys.add((square, ratio, frames[i].image.shape[:2], frames[i].depth.shape[:2]))
            batches[i] = b
            metas_host[i] = pack_meta(frames[i], counts[i])
        if len(keys) != 1:
            raise ValueError(
                f"batched lanes must share one shape bucket, got {sorted(keys)} "
                "-- group sequences of equal resolution per BatchedPipeline"
            )
        # dead lanes replicate the first live batch (kept inactive below)
        first = batches[live[0]]
        out = self._forward(_stack([batches.get(i, first) for i in range(self.n_lanes)]))
        metas = [None if m is None else torch.from_numpy(m).to(self.device) for m in metas_host]
        self._step_lanes([_detections(out, i) if i in batches else None
                          for i in range(self.n_lanes)], metas, metas_host)

    def run(self, sequences: Sequence, gap: Optional[int] = None,
            export: bool = True) -> Optional[List[dict]]:
        """Stream up to N sequences in lockstep.

        Fewer than ``n_lanes`` sequences is fine (a tail group): the spare
        lanes stay inactive and the batch keeps its N.

        With ``export=True`` returns one world dict per given sequence.
        With ``export=False`` returns None and leaves the final lane states
        on the device (read later via ``export_worlds``).
        """
        from boxfusion_tpu_torch.runtime.stream import iter_with_last

        gap = int(self.cfg["data"]["gap"]) if gap is None else gap
        if len(sequences) > self.n_lanes:
            raise ValueError(f"{len(sequences)} sequences > {self.n_lanes} lanes")
        self.n_run = len(sequences)
        self.host_reads = 0
        iters: List[Optional[object]] = [iter_with_last(s) for s in sequences]
        iters += [None] * (self.n_lanes - len(iters))  # spare lanes inactive
        counts = [0] * self.n_lanes
        start = time.time()
        total = rounds = 0
        while True:
            round_frames: List[Optional[object]] = [None] * self.n_lanes
            alive = False
            for i, it in enumerate(iters):
                if it is None:
                    continue
                advanced = False
                # advance lane i to its next keyframe (gap frames; the final
                # frame is always a keyframe, reference demo.py:200)
                while True:
                    try:
                        f, is_last = next(it)
                    except StopIteration:
                        iters[i] = None
                        break
                    advanced = True
                    if counts[i] % gap == 0 or is_last:
                        round_frames[i] = f
                        counts[i] += 1
                        if is_last:
                            iters[i] = None
                        break
                    counts[i] += 1
                alive = alive or advanced
            if not alive:
                break
            self.process_keyframes(round_frames, [c - 1 for c in counts])
            n_kf = sum(f is not None for f in round_frames)
            total += n_kf
            rounds += n_kf > 0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dur = time.time() - start
        self.keyframes = total
        self.rounds = rounds
        self.keyframes_per_s = total / max(dur, 1e-9)
        # per-lane frames/s over the shared group wall-clock: comparable to
        # the per-sequence fps the device fan-out records (runner.py)
        self.lane_fps = [c / max(dur, 1e-9) for c in counts[: self.n_run]]
        print(f"Batched: {total} keyframes over {self.n_run} lanes in "
              f"{dur:.2f} s ({self.keyframes_per_s:.2f} kf/s, "
              f"{self.host_reads / max(rounds, 1):.1f} host reads a round)")
        return self.export_worlds() if export else None

    def export_worlds(self, n: Optional[int] = None) -> List[dict]:
        """Read back the first ``n`` lanes' world sets (default: the lanes
        the last ``run`` call actually streamed)."""
        n = getattr(self, "n_run", self.n_lanes) if n is None else n
        return [export_world(self.states[i], class_list=self.class_list) for i in range(n)]
