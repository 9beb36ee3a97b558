"""Open-vocabulary labeling head: CLIP crops vs precomputed text features.

Port of ``boxfusion_tpu/models/clip/head.py``.  Capability target: the
reference's per-keyframe labeling path (tools/utils.py:355-494 +
demo.py:161-171):

  * ``scale_boxes`` x1.5 around fixed centers (tools/utils.py:355-381);
  * crop each detection, resize to 224x224 (zero-size crops -> black,
    tools/utils.py:395), batch-encode with CLIP;
  * cosine scores ``100 * img @ text.T`` against the precomputed class
    features, with an appended "background" column at ``sim_thres`` so
    low-similarity boxes get the empty label and are dropped
    (tools/utils.py:478-494).

Crop + resize is one batched pass on the device: per box and per axis a
224 x size interpolation matrix, contracted with the image by two matrix
products (the construction of ``jax.image.scale_and_translate`` with
``method="bilinear", antialias=False``, which is neither ``F.interpolate``
nor ``F.grid_sample``: triangle-kernel weights at half-pixel centres,
normalised over the in-bounds taps, zero where the sample falls outside the
input).  The similarity product runs in full float32 (the package turns
TF32 off at import): label argmax ties need it.
"""
from __future__ import annotations

from typing import List, Mapping, Optional, Tuple

import numpy as np
import torch

from boxfusion_tpu_torch.models.clip.model import (
    CLIP_IMAGE_MEAN,
    CLIP_IMAGE_STD,
    CLIPConfig,
    CLIPImageTower,
    init_clip_weights,
)
from boxfusion_tpu_torch.utils.device import DeviceLike, resolve_device

CROP = 224
_F32_EPS = float(np.finfo(np.float32).eps)


def scale_boxes(boxes, H, W, scale: float = 1.2):
    """Scale xyxy boxes about their centers, clipped to the image
    (tools/utils.py:355-381).  Works on numpy arrays or torch tensors."""
    cx = (boxes[:, 0] + boxes[:, 2]) / 2
    cy = (boxes[:, 1] + boxes[:, 3]) / 2
    w = (boxes[:, 2] - boxes[:, 0]) * scale
    h = (boxes[:, 3] - boxes[:, 1]) * scale
    cols = [(cx - w / 2, W), (cy - h / 2, H), (cx + w / 2, W), (cy + h / 2, H)]
    if isinstance(boxes, torch.Tensor):
        def clip(x, hi):
            hi = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
            return torch.minimum(torch.clamp(x, min=0), hi)

        return torch.stack([clip(x, hi) for x, hi in cols], dim=1)
    return np.stack([np.clip(x, 0, hi) for x, hi in cols], axis=1)


def _interp_matrix(in_size: int, scale: torch.Tensor, translation: torch.Tensor) -> torch.Tensor:
    """(N, 224, in_size) bilinear weights of ``out = scale * in + translation``.

    Row a of box n holds the weights of output pixel a over the input pixels:
    the triangle kernel around the sample position (half-pixel centres),
    normalised over the taps that exist, and all zero when the sample lies
    outside the input."""
    dev = scale.device
    inv = 1.0 / scale
    out_pos = torch.arange(CROP, dtype=torch.float32, device=dev)
    sample = (out_pos[None] + 0.5) * inv[:, None] - translation[:, None] * inv[:, None] - 0.5
    taps = torch.arange(in_size, dtype=torch.float32, device=dev)
    w = torch.clamp(1.0 - (sample[:, :, None] - taps[None, None, :]).abs(), min=0.0)
    total = w.sum(-1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _F32_EPS, w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, :, None], w, 0.0)


def batched_crop_resize(image: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Crop + bilinear-resize every box to 224x224 in one batched device pass.

    Args:
      image: (H, W, 3) float tensor in [0, 255] (float32, or bfloat16 for a
        bfloat16 tower: the interpolation then runs in bfloat16).
      boxes: (N, 4) xyxy float tensor on the image's device.  Degenerate
        boxes produce black crops (tools/utils.py:395).

    Returns:
      (N, 224, 224, 3) crops in the image's dtype.
    """
    H, W, C = image.shape
    boxes = boxes.to(torch.float32)
    # integer crop bounds like the reference's array slicing
    x1, y1, x2, y2 = (torch.floor(boxes[:, i]) for i in range(4))
    w, h = x2 - x1, y2 - y1
    ok = (w > 0) & (h > 0)
    sw = CROP / torch.clamp(w, min=1.0)
    sh = CROP / torch.clamp(h, min=1.0)
    mh = _interp_matrix(H, sh, -y1 * sh).to(image.dtype)  # (N, 224, H)
    mw = _interp_matrix(W, sw, -x1 * sw).to(image.dtype)  # (N, 224, W)
    N = boxes.shape[0]
    rows = (mh @ image.reshape(H, W * C)).reshape(N, CROP, W, C)    # rows resized
    out = torch.einsum("nbw,nawc->nabc", mw, rows)                  # then columns
    return torch.where(ok[:, None, None, None], out, 0.0)


def _crop_normalize(image: torch.Tensor, boxes: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Crop + resize + CLIP-normalize in the tower's compute dtype.

    With a bfloat16 tower the image is cast to bfloat16 BEFORE the
    interpolation (the two matrix products then run in bfloat16; the pixel
    error stays below the bfloat16 tower's own rounding).  float32 towers
    (all CPU parity tests) keep the exact float32 path."""
    if dtype == torch.bfloat16:
        image = image.to(torch.bfloat16)
    crops = batched_crop_resize(image, boxes)
    dt, dev = crops.dtype, crops.device
    mean = torch.as_tensor(CLIP_IMAGE_MEAN, dtype=dt, device=dev)
    std = torch.as_tensor(CLIP_IMAGE_STD, dtype=dt, device=dev)
    return (crops / 255.0 - mean) / std


class OpenVocabLabeler:
    """Callable: (image, boxes xyxy) -> (categories, features, sims).

    Args:
      class_list, text_features: the class names and their (n_classes, dim)
        text embeddings (normalised here).
      image_params: a state dict of the image tower (``convert.py``), or None
        (then call ``init_random`` or ``set_tower``).
      cfg: the tower's CLIPConfig.
      sim_thres: similarity of the appended "background" column.
      max_boxes: most crops in one tower call of ``__call__``.
      device: default "cuda" (raises if there is none).
    """

    def __init__(
        self,
        class_list: List[str],
        text_features: np.ndarray,
        image_params: Optional[Mapping[str, torch.Tensor]] = None,
        cfg: Optional[CLIPConfig] = None,
        sim_thres: float = 0.0,
        max_boxes: int = 128,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.class_list = np.asarray(list(class_list))
        tf = np.asarray(text_features, np.float32)
        if tf.ndim != 2:
            raise ValueError(
                f"text_features must be (n_classes, dim), got shape {tf.shape} "
                "(the reference ships data/class_features.pt as [473, 1024], "
                "tools/utils.py:342-353)"
            )
        if len(self.class_list) != tf.shape[0]:
            raise ValueError(
                f"class list has {len(self.class_list)} entries but "
                f"text_features has {tf.shape[0]} rows -- the class txt and "
                "precomputed features must pair up (demo.py:460-461)"
            )
        self.text_features = tf / np.linalg.norm(tf, axis=-1, keepdims=True)
        self._tf = torch.from_numpy(self.text_features).to(self.device)
        self.sim_thres = float(sim_thres)
        self.max_boxes = int(max_boxes)
        self.cfg = cfg or CLIPConfig()
        self.tower: Optional[CLIPImageTower] = None  # built once it has weights
        if image_params is not None:
            tower = CLIPImageTower(self.cfg)
            tower.load_state_dict(image_params, strict=True)
            self.set_tower(tower)

    def set_tower(self, tower: CLIPImageTower) -> "OpenVocabLabeler":
        """Use ``tower`` (and its config), e.g. one loaded from a checkpoint."""
        self.tower, self.cfg = tower.to(self.device).eval(), tower.cfg
        return self

    def init_random(self, seed: int = 0) -> "OpenVocabLabeler":
        """Random weights from a ``torch.Generator`` (the whole compute path
        without real CLIP weights).  The numbers are not the JAX package's for
        the same seed; tests carry weights across with ``convert.py``."""
        tower = CLIPImageTower(self.cfg)
        init_clip_weights(tower, torch.Generator().manual_seed(seed))
        return self.set_tower(tower)

    def _encode(self, image: torch.Tensor, boxes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._encode_crops(_crop_normalize(image, boxes, self.cfg.dtype))

    def _encode_crops(self, crops: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.tower is None:
            raise RuntimeError("the labeler has no image-tower weights: pass image_params, "
                               "call init_random() or set_tower()")
        feats = self.tower(crops)
        feats = feats / torch.linalg.norm(feats, dim=-1, keepdim=True)
        return feats, 100.0 * (feats @ self._tf.T)  # full float32

    @torch.inference_mode()
    def label_boost_device(self, image, boxes_xyxy, scores, hw, scale: float, coeff: float,
                           budget: int = 32):
        """Device-resident label + score boost over the top-``budget`` rows:
        tensors in, tensors out, no device-to-host read.

        ``boxes_xyxy`` / ``scores`` are the detector's top-k outputs (sorted
        by score descending, so a prefix IS the top-``budget``); ``hw``
        is the actual (H, W) of the unpadded image (the crops' clip bound);
        ``scale`` the reference's x1.5 box scaling (demo.py:165).  Mirrors
        the host path (demo.py:161-171): CLIP-label each crop, boost scores by
        ``coeff * max_sim / 100``, and sink below-``sim_thres`` (background)
        rows to -1e9 so a score filter drops them.  Rows beyond the budget
        keep their raw score and get the background index ``n_classes`` (the
        empty label), NOT class 0, which is a real category; ``overflow``
        counts live rows past the budget so callers can surface the
        truncation.

        Returns (new_scores (N,), categories (N,) int32, feats (budget, D),
        overflow () int32).
        """
        dev = self.device
        image = torch.as_tensor(image, dtype=torch.float32, device=dev)
        out = self.label_boost_lanes(image[None], torch.as_tensor(boxes_xyxy)[None],
                                     torch.as_tensor(scores)[None], [hw], scale, coeff, budget)
        return tuple(x[0] for x in out)

    @torch.inference_mode()
    def label_boost_lanes(self, images, boxes_xyxy, scores, hws, scale: float, coeff: float,
                          budget: int = 32):
        """``label_boost_device`` for N frames at once, with ONE tower call
        over all N x ``budget`` crops (the batched engine's label stage).

        Args:
          images: (N, H, W, 3) in [0, 255], or a sequence of N such images.
          boxes_xyxy: (N, K, 4); scores: (N, K), each row score-sorted.
          hws: N actual (H, W) pairs, on the host.

        Rows do not interact in the tower, so lane i's results are those of
        ``label_boost_device`` on lane i alone, up to the rounding of a
        matrix product at another batch size.

        Returns (new_scores (N, K), categories (N, K) int32, feats
        (N, budget, D), overflow (N,) int32).
        """
        dev = self.device
        f32 = torch.float32
        boxes_xyxy = torch.as_tensor(boxes_xyxy, dtype=f32, device=dev)
        scores = torch.as_tensor(scores, dtype=f32, device=dev)
        n, k = scores.shape
        budget = min(int(budget), int(k))
        n_classes = self._tf.shape[0]
        crops = torch.cat([
            _crop_normalize(torch.as_tensor(images[i], dtype=f32, device=dev),
                            scale_boxes(boxes_xyxy[i, :budget], hws[i][0], hws[i][1], float(scale)),
                            self.cfg.dtype)
            for i in range(n)
        ])
        feats, sims = self._encode_crops(crops)  # sims: (n * budget, C)
        sims = sims.reshape(n, budget, n_classes)

        # background column at sim_thres (tools/utils.py:488-494)
        scored = torch.cat([sims, sims.new_full((n, budget, 1), self.sim_thres)], dim=-1)
        best = torch.argmax(scored, dim=-1)  # the first maximum among ties
        max_values = scored.max(dim=-1).values
        background = best == n_classes

        boosted = scores[:, :budget] + float(coeff) * max_values / 100.0
        boosted = torch.where(background, -1e9, boosted)
        new_scores = scores.clone()
        new_scores[:, :budget] = boosted
        categories = torch.full((n, k), n_classes, dtype=torch.int32, device=dev)
        categories[:, :budget] = best.to(torch.int32)
        overflow = (scores[:, budget:] > -1e8).sum(dim=-1).to(torch.int32)
        return new_scores, categories, feats.reshape(n, budget, -1), overflow

    @torch.inference_mode()
    def __call__(self, image: np.ndarray, boxes: np.ndarray):
        """Label ``boxes`` (N, 4) xyxy of ``image`` (H, W, 3) in [0, 255].

        Only the live rows run: the JAX package pads the boxes to
        ``max_boxes`` for one static compiled shape, rows do not interact, so
        here the N boxes go through as they are, at most ``max_boxes`` per
        tower call.  Ends in one device-to-host read.

        Returns (categories list[str] with "" for background, features (N, D),
        the winning similarity per row (N,)).
        """
        n = boxes.shape[0]
        if n == 0:
            return [], np.zeros((0, self.text_features.shape[1]), np.float32), np.zeros(0)
        image_t = torch.as_tensor(np.asarray(image, np.float32)).to(self.device)
        boxes_t = torch.as_tensor(np.asarray(boxes, np.float32)).to(self.device)
        parts = [self._encode(image_t, boxes_t[i:i + self.max_boxes])
                 for i in range(0, n, self.max_boxes)]
        feats = torch.cat([p[0] for p in parts]).cpu().numpy()
        sims = torch.cat([p[1] for p in parts]).cpu().numpy()

        # background column at sim_thres (tools/utils.py:488-494)
        scores = np.concatenate([sims, np.full((n, 1), self.sim_thres, np.float32)], 1)
        classes = np.concatenate([self.class_list, [""]])
        best = scores.argmax(axis=-1)
        return list(classes[best]), feats, scores.max(axis=-1)


def load_class_features(path: str) -> np.ndarray:
    """Load the precomputed text features (.pt via torch, or .npy)."""
    if path.endswith(".npy"):
        return np.load(path)
    t = torch.load(path, map_location="cpu", weights_only=True)
    return t.float().numpy()


def build_labeler(
    clip_path: Optional[str],
    class_txt: str,
    class_features: str,
    sim_thres: float = 0.0,
    allow_random: bool = False,
    cfg: Optional[CLIPConfig] = None,
    device: DeviceLike = None,
) -> OpenVocabLabeler:
    """Assemble the labeler from the reference's assets (demo.py:458-461).

    ``clip_path`` is required: a random-weight image tower scored against
    REAL text features produces meaningless similarities (with a high
    ``sim_thres`` every detection silently sinks into the background
    column).  ``allow_random=True`` opts into the random tower for
    synthetic smoke runs only (``cfg`` then sizes the tower; with real
    weights the checkpoint defines the config and ``cfg`` only lends its
    ``dtype`` and ``attn_impl``)."""
    from boxfusion_tpu_torch.utils.config import read_lines

    class_list = read_lines(class_txt)
    tf = load_class_features(class_features)
    labeler = OpenVocabLabeler(class_list, tf, cfg=cfg, sim_thres=sim_thres, device=device)
    if clip_path:
        from boxfusion_tpu_torch.models.clip.convert import load_clip_image_params

        kw = dict(dtype=cfg.dtype, attn_impl=cfg.attn_impl) if cfg is not None else {}
        tower, _ = load_clip_image_params(clip_path, device=labeler.device, **kw)
        labeler.set_tower(tower)
    elif allow_random:
        labeler.init_random()
    else:
        raise ValueError(
            "open-vocab labeling needs CLIP image weights (--clip-path): "
            "a random tower scored against real class features yields "
            "garbage labels; pass allow_random=True only for synthetic "
            "smoke runs"
        )
    return labeler
