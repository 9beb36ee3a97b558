"""CubifyTransformer (CuTR) assembly: the RGB-D detector in PyTorch.

Port of ``boxfusion_tpu/models/cutr/model.py``.  Capability target: the
reference model assembly (reference cubify_transformer.py:1101-1323) --
Joiner(ViT) backbone, CameraRayEmbedding, input projection (1x1 conv +
GroupNorm32), MetricQueries + EncoderProposals prompting, the 6-layer
PromptDecoder with per-layer predictor stacks, and the inference
postprocess (K^-1 backprojection, T_gravity, per-image top-k).

Layouts follow the JAX package (NHWC images, xyzlhw boxes, (N, 3, 3)
rotations); module names follow the original CuTR state dict
(``backbone.0...``, ``prompting.prompters.1...``, ``decoder.layers.i...``)
so that ``convert.load_torch_state_dict`` is a ``load_state_dict``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from benchmark.reference.models.cutr.decoder import DecoderLayer
from benchmark.reference.models.cutr.heads import (
    AbsoluteBox3DPredictor,
    Box2DPromptEncoderLearned,
    ClassPredictor,
    DeltaBox2DPredictor,
    ScalePredictor,
)
from benchmark.reference.models.cutr.layers import (
    cast,
    Embedding,
    GroupNorm,
    LayerNorm,
    Linear,
    PatchConv,
    box_cxcywh_to_xyxy,
    topk_stable,
)
from benchmark.reference.models.cutr.pos import CameraRayEmbedding
from benchmark.reference.models.cutr.vit import ViT

PIXEL_MEAN = np.array([123.675, 116.28, 103.53], dtype=np.float32)
PIXEL_STD = np.array([58.395, 57.12, 57.375], dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class FrameBatch:
    """Model input: one (possibly batched) preprocessed RGB-D frame.

    Attributes:
      image: (B, S, S, 3) float32, pixel-normalized, zero-padded to square.
      depth: (B, S/r, S/r, 1) float32, per-frame whitened, zero-padded.
      K: (B, 3, 3) intrinsics of the oriented image at actual resolution.
      image_hw: (B, 2) float (H, W) actual image size (pre-padding).
      depth_params: (B, 2) whitening (mean, std) used on the depth map.
      T_gravity: (B, 3, 3) gravity-alignment rotation for predicted poses.
    """

    image: torch.Tensor
    depth: Optional[torch.Tensor]
    K: torch.Tensor
    image_hw: torch.Tensor
    depth_params: torch.Tensor
    T_gravity: torch.Tensor


@dataclasses.dataclass(frozen=True)
class CuTRConfig:
    embed_dim: int = 768            # ViT width (768 / 384 / 192)
    decoder_dim: int = 256
    depth_model: bool = True
    num_decoder_layers: int = 6
    num_queries: int = 300          # EncoderProposals top_k_test
    num_metric_tokens: int = 2
    topk_per_image: int = 100
    level_strides: Tuple[int, ...] = (16, 32, 64)
    min_proposal_size: float = 50.0
    max_query_embeds: int = 1200
    # compute dtype of the matmul-heavy paths; parameters, coordinate
    # decoding, softmax and norm statistics stay float32
    dtype: torch.dtype = torch.float32

    @property
    def vit_heads(self) -> int:
        return {768: 12, 384: 6, 192: 3}[self.embed_dim]


class LayerNorm2d(nn.Module):
    """Channel LayerNorm of the expanded encoder level (``...2.1.ln``)."""

    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.ln = LayerNorm(dim, eps=1e-5, dtype=dtype)

    def forward(self, x):
        return self.ln(x)


class MetricPrompter(nn.Module):
    """The 2 metric query tokens (``prompting.prompters.0``)."""

    def __init__(self, cfg: CuTRConfig):
        super().__init__()
        self.query_embed = Embedding(cfg.num_metric_tokens, cfg.decoder_dim)


class EncoderProposals(nn.Module):
    """Dense anchor proposals over expanded levels, scored and refined
    (cubify_transformer.py:739-943); ``prompting.prompters.1``."""

    def __init__(self, cfg: CuTRConfig):
        super().__init__()
        C, dt = cfg.decoder_dim, cfg.dtype
        self.cfg = cfg
        self.enc_output_proj = nn.ModuleList([
            nn.Identity(),
            nn.Sequential(PatchConv(C, C, 2, dtype=dt)),
            nn.Sequential(
                PatchConv(C, C, 2, dtype=dt), LayerNorm2d(C, dtype=dt), nn.GELU(),
                PatchConv(C, C, 2, dtype=dt),
            ),
        ])
        self.enc_output = Linear(C, C, dtype=dt)
        self.enc_output_norm = LayerNorm(C, eps=1e-5, dtype=dt)
        self.predictors = nn.ModuleList([ClassPredictor(C, dtype=dt), DeltaBox2DPredictor(C, dtype=dt)])
        self.query_embed = Embedding(cfg.max_query_embeds, C)

    def forward(self, src_2d: torch.Tensor, clamp_wh, rank_from: Optional[torch.Tensor] = None):
        """src_2d: (B, F, F, C) stride-16 projected features.

        Returns (enc_logits, enc_boxes_cxcywh, topk_boxes_cxcywh)."""
        cfg = self.cfg
        B, Fs, _, C = src_2d.shape
        S = Fs * cfg.level_strides[0]
        dev = src_2d.device

        # expand_encoder_output (835-862): per-level projections
        mems = [proj(src_2d) for proj in self.enc_output_proj]

        # anchors (864-916): grid centers * stride, wh = min_size * 2^lvl
        proposals, valids, flat = [], [], []
        for lvl, mem in enumerate(mems):
            stride = cfg.level_strides[lvl]
            f = mem.shape[1]
            coords = (torch.arange(f, dtype=torch.float32, device=dev) + 0.5) * stride
            gx = coords[None, :].expand(f, f)
            gy = coords[:, None].expand(f, f)
            wh = torch.full((f, f), cfg.min_proposal_size * (2.0 ** lvl), device=dev)
            p = torch.stack([gx, gy, wh, wh], dim=-1).reshape(-1, 4)
            # strictly inside (1%, 99%) of the padded square
            valid = ((p > 0.01 * S) & (p < 0.99 * S)).all(-1)
            proposals.append(p[None].expand(B, -1, 4))
            valids.append(valid[None].expand(B, -1))
            flat.append(mem.reshape(B, -1, C))

        memory = torch.cat(flat, dim=1)
        anchors = torch.cat(proposals, dim=1)
        valid = torch.cat(valids, dim=1)

        anchors = torch.where(valid[..., None], anchors, float(S))
        memory = torch.where(valid[..., None], memory, 0.0)
        memory = self.enc_output_norm(self.enc_output(memory))

        enc_logits = self.predictors[0](memory)
        _, enc_boxes = self.predictors[1](memory, anchors, clamp_wh)

        # top-k by foreground logit (918-943); ``rank_from`` (another run's
        # encoder logits) fixes which proposals become queries, in what order
        rank = enc_logits if rank_from is None else rank_from
        _, topk_idx = topk_stable(rank[..., 0], cfg.num_queries)
        topk_boxes = torch.gather(enc_boxes, 1, topk_idx[..., None].expand(-1, -1, 4))
        return enc_logits, enc_boxes, topk_boxes


class Prompting(nn.Module):
    """``prompting``: the shared prompt encoders and the two prompters.

    The original module tree shares one encoder module between
    ``prompting.encoders`` and each prompter (cubify_transformer.py:1014),
    so its state dict repeats the tensors under all three paths; the same
    module object is registered under all three here too.
    """

    def __init__(self, cfg: CuTRConfig):
        super().__init__()
        self.encoders = nn.ModuleDict(
            {"box_2d_encoder": Box2DPromptEncoderLearned(cfg.decoder_dim, dtype=cfg.dtype)}
        )
        self.prompters = nn.ModuleList([MetricPrompter(cfg), EncoderProposals(cfg)])
        for prompter in self.prompters:
            prompter.encoders = self.encoders


class Decoder(nn.Module):
    """``decoder``: the layers, the shared output norm, per-layer heads."""

    def __init__(self, cfg: CuTRConfig):
        super().__init__()
        C, dt = cfg.decoder_dim, cfg.dtype
        self.layers = nn.ModuleList(DecoderLayer(C, dtype=dt) for _ in range(cfg.num_decoder_layers))
        self.norm = LayerNorm(C, eps=1e-5, dtype=dt)
        self.predictors = nn.ModuleList(
            nn.ModuleList([
                ScalePredictor(C, dtype=dt), ClassPredictor(C, dtype=dt),
                DeltaBox2DPredictor(C, dtype=dt), AbsoluteBox3DPredictor(C, dtype=dt),
            ])
            for _ in range(cfg.num_decoder_layers)
        )


class CubifyTransformer(nn.Module):
    """Full CuTR detector; ``forward`` returns the packaged top-k detections."""

    def __init__(self, cfg: CuTRConfig = CuTRConfig()):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        self.backbone = nn.ModuleList([
            ViT(
                embed_dim=cfg.embed_dim,
                num_heads=cfg.vit_heads,
                depth_modality=cfg.depth_model,
                layer_scale=not cfg.depth_model,
                encoder_norm=not cfg.depth_model,
                pretrain_img_size=512 if not cfg.depth_model else 224,
                dtype=dt,
            )
        ])
        self.pos_embedding = CameraRayEmbedding(cfg.decoder_dim, dtype=dt)
        self.input_proj = nn.ModuleList([
            nn.ModuleList([
                PatchConv(cfg.embed_dim, cfg.decoder_dim, 1, dtype=dt),
                GroupNorm(32, cfg.decoder_dim, eps=1e-5, dtype=dt),
            ])
        ])
        self.level_embed = nn.Parameter(torch.zeros(1, cfg.decoder_dim))
        self.prompting = Prompting(cfg)
        self.decoder = Decoder(cfg)
        mask = np.ones((cfg.num_queries + cfg.num_metric_tokens,) * 2, dtype=bool)
        nm = cfg.num_metric_tokens
        mask[:nm, :nm] = False
        mask[nm:, nm:] = False
        # block-diagonal self-attention mask between prompt groups
        # (Prompt.cat, cubify_transformer.py:680-702); True = blocked
        self.register_buffer("self_attn_mask", torch.from_numpy(mask), persistent=False)

    def forward(self, batch: FrameBatch, train: bool = False,
                rank_from: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        dt = cfg.dtype
        B, S = batch.image.shape[0], batch.image.shape[1]
        Fs = S // 16
        clamp_wh = (float(S), float(S))

        feat = self.backbone[0](batch.image, batch.depth)  # (B, F, F, D)
        proj_conv, proj_norm = self.input_proj[0]
        src2d = proj_norm(proj_conv(feat))

        pos2d = self.pos_embedding(batch.K, batch.image_hw, Fs)  # (B, F, F, 256)
        src = src2d.reshape(B, Fs * Fs, -1)
        pos = pos2d.reshape(B, Fs * Fs, -1) + self.level_embed[0]

        proposals = self.prompting.prompters[1]
        enc_logits, enc_boxes, topk_boxes = proposals(src2d, clamp_wh, rank_from)

        nq, nm = cfg.num_queries, cfg.num_metric_tokens
        box_queries = proposals.query_embed.weight[None, :nq].expand(B, nq, cfg.decoder_dim)
        box_pos = self.prompting.encoders["box_2d_encoder"](topk_boxes.detach())
        metric_queries = self.prompting.prompters[0].query_embed.weight[None].expand(B, nm, cfg.decoder_dim)

        output = cast(torch.cat([metric_queries, box_queries], dim=1), dt)
        query_pos = cast(torch.cat([torch.zeros_like(metric_queries), box_pos.float()], dim=1), dt)
        src = cast(src, dt)
        pos = cast(pos, dt)

        reference_2d = topk_boxes  # cxcywh
        intermediates = []
        pred = None
        for lid, layer in enumerate(self.decoder.layers):
            output = layer(output, query_pos, reference_2d.detach(), src, pos, (Fs, Fs),
                           self.self_attn_mask, nm)
            x = self.decoder.norm(output)
            scale_pred, class_pred, box2d_pred, box3d_pred = self.decoder.predictors[lid]
            depth_params_pred = scale_pred(x[:, :nm])
            xb = x[:, nm:]
            logits = class_pred(xb)
            _, boxes = box2d_pred(xb, reference_2d, clamp_wh)
            # RGB-D: de-whiten with the GT depth whitening (the reference's
            # WhitenedDepthMeasurementInfo branch); RGB-only: the metric
            # tokens' predicted (shift, scale)
            scale_params = batch.depth_params if cfg.depth_model else depth_params_pred
            box3d = box3d_pred(xb, boxes, scale_params, clamp_wh)
            pred = dict(logits=logits, boxes=boxes, object_desc=xb,
                        depth_params_pred=depth_params_pred, **box3d)
            if train:
                intermediates.append(pred)
            reference_2d = boxes

        out = self._inference(pred, batch)
        out["enc_logits"] = enc_logits
        out["enc_boxes"] = enc_boxes
        if train:
            out["intermediates"] = intermediates
        return out

    def _inference(self, pred: Dict[str, torch.Tensor], batch: FrameBatch):
        """Per-image top-k packaging (cubify_transformer.py:945-996)."""
        cfg = self.cfg
        outs = []
        for b in range(batch.image.shape[0]):
            logits = pred["logits"][b]  # (nq, 2)
            probs = torch.sigmoid(logits).reshape(-1)
            scores, idx = topk_stable(probs, cfg.topk_per_image)
            box_idx = idx // logits.shape[-1]
            labels = idx % logits.shape[-1]

            boxes = box_cxcywh_to_xyxy(pred["boxes"][b])[box_idx]
            h, w = batch.image_hw[b, 0], batch.image_hw[b, 1]
            boxes = torch.minimum(torch.clamp(boxes, min=0.0), torch.stack([w, h, w, h]))

            proj_xy = pred["proj_xy"][b][box_idx]
            z = pred["z_scaled"][b][box_idx]
            dims = pred["dims"][b][box_idx]
            pose = pred["pose"][b][box_idx]
            # backproject through K^-1 (985-988) and gravity-align the pose
            # (991-992); float32, TF32 off
            uvz = torch.cat([z * proj_xy, z], dim=-1)
            xyz = uvz @ torch.linalg.inv(batch.K[b]).T
            pose = torch.einsum("ij,njk->nik", batch.T_gravity[b], pose)
            # WHL -> LHW reorder (971-973): head dims are (w, h, l)
            boxes3d = torch.cat([xyz, dims[:, [2, 1, 0]]], dim=-1)
            outs.append(dict(
                scores=scores, pred_classes=labels, pred_boxes=boxes,
                pred_logits=logits[box_idx], boxes3d=boxes3d, R=pose, proj_xy=proj_xy,
                object_desc=pred["object_desc"][b][box_idx].float(),
            ))
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
