"""The fused keyframe path: one upload per keyframe, then detect + label +
associate + fuse on the device (torch).

Port of ``boxfusion_tpu/runtime/fused.py``.  A keyframe travels to the
device as ONE packed byte buffer (pixels, depth and metadata) and everything
after the upload -- pixel packaging, the CuTR forward, open-vocab CLIP
labeling and the keyframe association/fusion step -- runs on the device from
that buffer.  With ``chunk > 1`` consecutive keyframes share one upload of
their stacked buffers.

Transfer format (one flat uint8 buffer, the JAX package's byte for byte):

  [ image u8 (H*W*3) | depth u16-LE (Hd*Wd*2) | meta f32-LE (48*4) ]

Depth rides as uint16 millimetres (lossless for CA-1M/ScanNet sources,
whose on-disk depth IS u16 at ``depth_scale``; mode "f32" is bit-exact for
synthetic float depth) -- halving the dominant upload vs float32.

What differs from the JAX module, and why:

* No program cache.  JAX traces one jitted program per (shape bucket,
  config) key and caches it (``_PROGRAM_CACHE``, ``make_fused_*_fn``);
  eager PyTorch has nothing to trace, so ``fused_keyframe`` is the one body,
  called with the shape key ``(h, w, dh, dw, square, ratio)``.
* The label bucket is chosen on the host.  JAX picks it with ``lax.switch``
  on the device; eager PyTorch must know the crop batch size before it
  launches the tower, so the live count is read back (one counted read,
  ``utils/device.py:host_reads``) and only the chosen bucket runs.
* The chunk is a loop, not a ``lax.scan``: one host-to-device copy of the
  stacked ``(chunk, L)`` buffer, then the body over its rows in frame order.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from boxfusion_tpu_torch.data.preprocess import (
    PIXEL_MEAN_U8,
    PIXEL_STD_U8,
    package_frame,
    resolve_pad_and_ratio,
)
from boxfusion_tpu_torch.runtime.device_pipeline import DevicePipeline
from boxfusion_tpu_torch.runtime.device_step import (
    _keyframe_step_impl,
    _with_stat,
    pad_detections,
)
from boxfusion_tpu_torch.utils.device import DeviceLike, host_reads

# pose 16 | K_img 9 | K_depth 9 | image_hw 2 | frame_idx 1  (= device_step
# META layout, device_step.py:736) | T_gravity 9 | depth_scale 1 | pad 1
FUSED_META_WIDTH = 48

_DET_KEEP = ("scores", "pred_boxes", "boxes3d", "R", "proj_xy")


def pack_fused_buffer(frame, count: int, depth_mode: str,
                      depth_scale: float, scratch=None) -> np.ndarray:
    """Pack one frame into the flat uint8 transfer buffer (module docstring
    layout).  Shared by the B=1 fused engine and the batched packed
    transport so the byte layout has exactly one definition.

    ``scratch``: optional (dh, dw) float32 workspace for the u16 depth
    conversion.  Packing is the dominant per-keyframe HOST cost at gap=1
    (~0.45 ms of the chunked path's ~1.1 ms); out-of-place temporaries in
    the conversion are ~30% of it, so steady-state callers
    (FusedDevicePipeline) pass a reused buffer.  NOT thread-safe to share
    one scratch across concurrent packers."""
    h, w = frame.image.shape[:2]
    dh, dw = frame.depth.shape[:2]
    n_img = h * w * 3
    n_dep = dh * dw * (2 if depth_mode == "u16" else 4)
    buf = np.empty(n_img + n_dep + FUSED_META_WIDTH * 4, np.uint8)
    buf[:n_img] = np.ascontiguousarray(frame.image, np.uint8).reshape(-1)
    if depth_mode == "u16":
        # f32 throughout: scale+round-half-up+clip (a float64 detour here
        # measurably costs host time per keyframe; f32 holds every integer
        # to 2^24 so the 0..65535 result is exact).  In-place into scratch,
        # casting directly into the buffer's u16 view, saves two
        # temporaries vs the naive expression (measured 0.50 -> 0.36 ms).
        if scratch is None or scratch.shape != (dh, dw):
            scratch = np.empty((dh, dw), np.float32)
        # copy-assign FIRST so the ufunc loop below runs in f32 regardless
        # of the source dtype (np.multiply with out= picks the loop from the
        # INPUT dtypes -- a float64 depth would silently compute in f64);
        # the reshape also accepts a trailing singleton channel (dh, dw, 1)
        scratch[...] = np.asarray(frame.depth).reshape(dh, dw)
        np.multiply(scratch, np.float32(depth_scale), out=scratch)
        np.add(scratch, np.float32(0.5), out=scratch)
        np.clip(scratch, 0, 65535, out=scratch)
        out = buf[n_img : n_img + n_dep].view("<u2").reshape(dh, dw)
        out[...] = scratch  # trunc(x + 0.5) == round-half-up for x >= 0
    else:
        d = np.asarray(frame.depth, "<f4")
        buf[n_img : n_img + n_dep] = d.reshape(-1).view(np.uint8)
    meta = np.zeros(FUSED_META_WIDTH, "<f4")
    meta[:16] = np.asarray(frame.gt_pose, np.float32).ravel()
    meta[16:25] = np.asarray(frame.K, np.float32).ravel()
    meta[25:34] = np.asarray(frame.K_depth, np.float32).ravel()
    meta[34:36] = (float(h), float(w))
    meta[36] = float(count)
    meta[37:46] = np.asarray(frame.T_gravity, np.float32).ravel()
    meta[46] = depth_scale
    buf[n_img + n_dep :] = meta.view(np.uint8)
    return buf


def fused_meta_host(buf: np.ndarray) -> np.ndarray:
    """The (48,) float32 metadata block of a packed host buffer."""
    return np.frombuffer(buf[-FUSED_META_WIDTH * 4:].tobytes(), "<f4")


def _as_dtype(raw: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Reinterpret a uint8 run as ``dtype``.  ``Tensor.view(dtype)`` needs
    the run to start at a multiple of the new item size, which a plane of
    the buffer need not (the depth plane starts at h*w*3, odd for an odd
    width); a copy into fresh, aligned storage comes first where needed."""
    if raw.storage_offset() % torch.empty((), dtype=dtype).element_size():
        raw = raw.clone()
    return raw.view(dtype)


def unpack_fused_buffer(buf: torch.Tensor, *, h: int, w: int, dh: int, dw: int,
                        depth_mode: str):
    """Device-side inverse of ``pack_fused_buffer`` (one frame).

    ``buf`` is the packed uint8 tensor, on the device.  Returns (image_u8
    (h, w, 3), metric depth (dh, dw) float32, meta (48,) float32); the u16
    -> float32 conversion and the division by ``meta[46]`` run in float32,
    as in JAX.
    """
    n_img = h * w * 3
    n_dep = dh * dw * (2 if depth_mode == "u16" else 4)
    image_u8 = buf[:n_img].reshape(h, w, 3)
    meta = _as_dtype(buf[n_img + n_dep:], torch.float32)
    d_raw = buf[n_img:n_img + n_dep]
    if depth_mode == "u16":
        # uint16 through int16: the low 16 bits of the widened value
        depth = (_as_dtype(d_raw, torch.int16).to(torch.int32) & 0xFFFF).to(torch.float32)
        depth = depth.reshape(dh, dw) / meta[46]  # depth_scale (units per metre)
    else:
        depth = _as_dtype(d_raw, torch.float32).reshape(dh, dw)
    return image_u8, depth, meta


def label_buckets_for(budget: int) -> tuple:
    """Ascending crop-count buckets ending at ``budget``.

    0 skips CLIP entirely on empty keyframes; intermediate multiples of 32
    bound the wasted crops at < 32; the extra 112 step splits the top band
    of a 128 budget, where the live counts of busy scenes concentrate."""
    return (0,) + tuple(b for b in (32, 64, 96, 112) if b < budget) + (budget,)


def label_boost_core(
    labeler, dets, norm_images, image_hws, *, label_budget, scale_box,
    clip_coeff, raw_score_thresh, bucketed: bool = False,
):
    """Open-vocab labeling of N frames' detections, with ONE tower call.

    The single shared implementation of the reference's per-keyframe label
    stage (demo.py:138-171): raw-score filter BEFORE CLIP, top-``budget``
    boost, background drop (scores sunk to -1e9 so the step's score filter
    removes them).  The fused engine calls it with one frame, the batched
    engine with its N lanes (JAX vmaps the one-frame function over the
    lanes; here the lanes' crops share one tower call, and a lane's result
    is that of a call on it alone, up to the rounding of the tower's
    products at another batch).

    Args:
      dets: N per-frame detection dicts ("scores" (K,) score-sorted,
        "pred_boxes" (K, 4) xyxy).
      norm_images: (N, H, W, 3) preprocessor-normalized images;
        de-normalization to 0..255 happens here.
      image_hws: N actual (H, W) pairs, on the host.

    ``bucketed=True``: instead of always cropping the full ``label_budget``,
    read the largest live (raw-score-passing) row count of the N frames
    back -- one counted host read -- and label the smallest bucket that
    covers it (``label_buckets_for``): a 69-detection keyframe at budget 100
    pays 96 crops.  Decision-identical: detections are score-sorted, so live
    rows are a prefix; rows past the live count are score-masked to -1e9 and
    dropped by the step's score filter whether or not they were cropped.

    Returns ``(dets', overflow (N,))`` where overflow counts each frame's
    live rows past the label budget (folded into stats[4] by the callers)."""
    dev = norm_images.device
    images = (norm_images * torch.as_tensor(PIXEL_STD_U8, device=dev)
              + torch.as_tensor(PIXEL_MEAN_U8, device=dev))
    scores = torch.stack([d["scores"] for d in dets])
    boxes = torch.stack([d["pred_boxes"] for d in dets])
    raw_ok = scores >= raw_score_thresh
    masked = torch.where(raw_ok, scores, -1e9)
    budget = min(int(label_budget), int(boxes.shape[1]))
    b = budget
    if bucketed:
        live = host_reads.read(raw_ok.sum(dim=-1).max())
        b = next(x for x in label_buckets_for(budget) if x >= min(live, budget))
    if b == 0:
        # no live rows: raw scores stand, every row is background --
        # label_boost_lanes at budget 0, minus the 0-crop tower
        n_classes = labeler.text_features.shape[0]
        new_scores = masked
        categories = torch.full(masked.shape, n_classes, dtype=torch.int32, device=dev)
        overflow = (masked > -1e8).sum(dim=-1).to(torch.int32)
    else:
        new_scores, categories, _, overflow = labeler.label_boost_lanes(
            images, boxes, masked, image_hws, float(scale_box), float(clip_coeff), budget=b,
        )
    new_scores = torch.where(raw_ok, new_scores.to(dev), -1e9)
    categories = categories.to(dev)
    dets = [dict(d, scores=new_scores[i], category=categories[i]) for i, d in enumerate(dets)]
    return dets, overflow.to(dev)


def _detections(out: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    """Lane ``i`` of a CuTR output, the keys the step takes, float32."""
    return {k: out[k][i].to(torch.float32) for k in _DET_KEEP}


def _step(state, det, meta, meta_host, pst, step_cfg, kmax: int):
    """pad/truncate to the step's static detection budget, then the step;
    pose and intrinsics from the device meta, (H, W) and the frame counter
    from the host copy of it (no read)."""
    det = pad_detections(det, kmax)
    return _keyframe_step_impl(
        state, det, pst, meta[:16].reshape(4, 4), meta[16:25].reshape(3, 3),
        meta[25:34].reshape(3, 3), (float(meta_host[34]), float(meta_host[35])),
        int(meta_host[36]), step_cfg,
    )


def fused_keyframe(
    state, buf: torch.Tensor, meta_host: np.ndarray, shape_key: tuple, *, model, pst,
    step_cfg, kmax: int, depth_mode: str = "u16", labeler=None, label_budget: int = 32,
    scale_box: float = 1.5, clip_coeff: float = 0.0, raw_score_thresh: float = 0.0,
    label_bucketing: bool = True, timings: Optional[Dict[str, float]] = None,
):
    """One keyframe from its packed buffer on the device: unpack, package,
    CuTR forward, [label], pad, keyframe step.  Returns the new state.

    ``shape_key`` is ``(h, w, dh, dw, square, ratio)``: the buffer's planes
    and the pad bucket (the key on which the JAX package caches one compiled
    program; here it only sizes the unpack and the packaging).
    ``meta_host`` is the host copy of the buffer's metadata.  ``model`` is
    called directly on the packaged batch, bypassing ``CuTRDetector``'s call
    path, as the JAX program does.  The CLIP label-budget overflow folds
    into ``state.stats[4]`` here, not into the pipeline's own counter.
    ``timings`` (optional) accumulates host-clock seconds of "detect",
    "label" and "step".
    """
    h, w, dh, dw, square, ratio = shape_key
    t0 = time.perf_counter()
    image_u8, depth, meta = unpack_fused_buffer(buf, h=h, w=w, dh=dh, dw=dw,
                                                depth_mode=depth_mode)
    batch = package_frame(image_u8, depth if model.cfg.depth_model else None,
                          meta[16:25].reshape(3, 3), meta[37:46].reshape(3, 3), square, ratio)
    det = _detections(model(batch), 0)
    t1 = time.perf_counter()
    if labeler is not None:
        # the step's own score filter is bypassed (DevicePipeline.__init__)
        (det,), overflow = label_boost_core(
            labeler, [det], batch.image, [(float(meta_host[34]), float(meta_host[35]))],
            label_budget=label_budget, scale_box=scale_box, clip_coeff=clip_coeff,
            raw_score_thresh=raw_score_thresh, bucketed=label_bucketing,
        )
        state = dataclasses.replace(state, stats=_with_stat(state.stats, 4, overflow[0]))
    t2 = time.perf_counter()
    state = _step(state, det, meta, meta_host, pst, step_cfg, kmax)
    if timings is not None:
        for stage, dt in (("detect", t1 - t0), ("label", t2 - t1),
                          ("step", time.perf_counter() - t2)):
            if stage != "label" or labeler is not None:
                timings[stage] = timings.get(stage, 0.0) + dt
    return state


def upload(buf: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host-to-device copy of a packed buffer (or a stack of them).
    On a CUDA device the copy goes through pinned memory and does not wait
    for the work already queued on the card."""
    t = torch.from_numpy(buf)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class FusedDevicePipeline(DevicePipeline):
    """DevicePipeline whose keyframe is ONE upload, then device work only.

    Takes a ``CuTRDetector`` for its model; the detector's own per-call
    path is bypassed (``fused_keyframe`` calls the model on the packaged
    batch).  Open-vocab labeling joins the keyframe when a labeler is given
    (``label_boost_core``, in label buckets when
    ``detection.label_bucketing`` is on).  The model must live on the
    pipeline's device.

    ``chunk > 1``: consecutive same-shape keyframes are buffered and go up
    in ONE copy of their stacked buffers, then run in frame order --
    identical decisions, ``chunk`` keyframes of result latency.  A shape
    change, a depth-less frame, ``flush``, ``reset`` and ``restore_state``
    end a partial chunk (the first two and ``flush`` run it through the
    per-frame path; the last two drop it: it belongs to the replaced
    timeline).

    ``timings`` holds "detect" (unpack + packaging + forward), "label" and
    "step", on the host clock; a failure of a keyframe is held back and
    raised at the next ``process_keyframe`` or ``flush``, as in
    ``DevicePipeline``.
    """

    def __init__(
        self,
        cfg,
        detector,
        labeler=None,
        capacity: int = 512,
        depth_mode: str = "u16",
        depth_scale: float = 1000.0,
        device: DeviceLike = None,
        chunk: int = 1,
    ):
        super().__init__(cfg, detector, labeler, capacity, device=device)
        if depth_mode not in ("u16", "f32"):
            raise ValueError(f"depth_mode must be u16|f32, got {depth_mode}")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.depth_mode = depth_mode
        self.depth_scale = float(depth_scale)
        self.chunk = int(chunk)
        self._pending: list = []  # [(shape-key, packed host buffer)] awaiting a chunk
        self._pack_scratch: Optional[np.ndarray] = None
        self.class_list = (
            list(labeler.class_list) + [""] if labeler is not None else None
        )

    def _fused_kw(self) -> dict:
        det_cfg = self.cfg["detection"]
        model = self.detector.model
        model_dev = next(model.parameters()).device
        if model_dev != self.state.device:
            raise ValueError(
                f"the detector's model is on {model_dev}, the pipeline on "
                f"{self.state.device}: the fused keyframe runs the model on the "
                "pipeline's device"
            )
        return dict(
            model=model, pst=self.pst, step_cfg=self.step_cfg,
            kmax=int(det_cfg["max_detections"]), depth_mode=self.depth_mode,
            labeler=self.labeler, label_budget=int(det_cfg["max_label_boxes"]),
            scale_box=float(det_cfg["scale_box"]),
            clip_coeff=float(self.cfg["box_fusion"]["clip_sim_coeff"]),
            raw_score_thresh=float(det_cfg["score_thresh"]),
            label_bucketing=bool(det_cfg.get("label_bucketing", True)),
            timings=self.timings,
        )

    def _pack_buffer(self, frame) -> np.ndarray:
        dh, dw = frame.depth.shape[:2]
        if self._pack_scratch is None or self._pack_scratch.shape != (dh, dw):
            self._pack_scratch = np.empty((dh, dw), np.float32)
        return pack_fused_buffer(frame, self.count, self.depth_mode,
                                 self.depth_scale, scratch=self._pack_scratch)

    def _fused_rows(self, state, bufs, metas, shape_key):
        """The body over the rows of an uploaded (rows, L) stack, in order."""
        kw = self._fused_kw()
        for buf, meta_host in zip(bufs, metas):
            state = fused_keyframe(state, buf, meta_host, shape_key, **kw)
        return state

    def _dispatch(self, group) -> None:
        """One upload of the group's stacked buffers, then its keyframes."""
        bufs = np.stack([b for _, b in group])
        metas = [fused_meta_host(b) for _, b in group]
        self._run_step(self._fused_rows, upload(bufs, self.device), metas, group[0][0],
                       stage=None)

    @torch.inference_mode()
    def process_keyframe(self, frame) -> None:
        self._raise_step_error()
        if frame.depth is None:
            # depth-less frames (rgb-only capture) take the parent's path;
            # the fused buffer layout assumes a depth plane.  Pending chunked
            # keyframes must run first to keep state order.
            if self._pending:
                self._flush_pending()
            return super().process_keyframe(frame)
        depth = frame.depth if self.detector.model.cfg.depth_model else None
        square, ratio = resolve_pad_and_ratio(frame.image, depth, self.detector.buckets)
        h, w = frame.image.shape[:2]
        dh, dw = frame.depth.shape[:2]
        shape_key = (h, w, dh, dw, square, ratio)
        buf = self._pack_buffer(frame)
        if self.chunk == 1:
            self._dispatch([(shape_key, buf)])
            return
        # chunked: group consecutive same-shape keyframes; a shape-bucket
        # change flushes the partial group (per-frame path) so state order
        # is preserved
        if self._pending and self._pending[0][0] != shape_key:
            self._flush_pending()
        self._pending.append((shape_key, buf))
        if len(self._pending) == self.chunk:
            group, self._pending = self._pending, []
            self._dispatch(group)

    def _flush_pending(self) -> None:
        """Run a partial chunk through the per-frame path (decision order
        unchanged; only the last < chunk keyframes pay one upload each)."""
        group, self._pending = self._pending, []
        for item in group:
            self._dispatch([item])

    def flush(self) -> None:
        if self._pending:
            with torch.inference_mode():
                self._flush_pending()
        super().flush()

    def reset(self) -> None:
        self._pending.clear()
        super().reset()

    def restore_state(self, path: str, count: int = 0) -> None:
        # keyframes buffered pre-restore belong to the replaced timeline;
        # running them on top of the restored state would corrupt it
        self._pending.clear()
        super().restore_state(path, count)
