"""CubifyTransformer (CuTR) assembly: the RGB-D detector in PyTorch.

Port of ``boxfusion_tpu/models/cutr/model.py``.  Capability target: the
reference model assembly (reference cubify_transformer.py:1101-1323) --
Joiner(ViT) backbone, CameraRayEmbedding, input projection (1x1 conv +
GroupNorm32), MetricQueries + EncoderProposals prompting, the 6-layer
PromptDecoder with per-layer predictor stacks, and the inference
postprocess (K^-1 backprojection, T_gravity, per-image top-k).

On a card, inference replays a CUDA graph of the forward, captured once per
input shape (``CubifyTransformer.forward``): issuing the eager forward's
stream of small launches costs the host several times the card's work.

Layouts follow the JAX package (NHWC images, xyzlhw boxes, (N, 3, 3)
rotations); module names follow the original CuTR state dict
(``backbone.0...``, ``prompting.prompters.1...``, ``decoder.layers.i...``)
so that ``convert.load_torch_state_dict`` is a ``load_state_dict``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.utils._python_dispatch import _get_current_dispatch_mode

from boxfusion_tpu_torch.models.cutr.decoder import DecoderLayer, TorchMHA
from boxfusion_tpu_torch.models.cutr.heads import (
    AbsoluteBox3DPredictor,
    Box2DPromptEncoderLearned,
    ClassPredictor,
    DeltaBox2DPredictor,
    ScalePredictor,
)
from boxfusion_tpu_torch.models.cutr.layers import (
    Embedding,
    GroupNorm,
    LayerNorm,
    Linear,
    PatchConv,
    box_cxcywh_to_xyxy,
    topk_stable,
)
from boxfusion_tpu_torch.models.cutr.pos import CameraRayEmbedding
from boxfusion_tpu_torch.models.cutr.vit import ViT
from boxfusion_tpu_torch.utils.device import DeviceLike, resolve_device, torch_dtype
from boxfusion_tpu_torch.utils.profiling import _recording, span

PIXEL_MEAN = np.array([123.675, 116.28, 103.53], dtype=np.float32)
PIXEL_STD = np.array([58.395, 57.12, 57.375], dtype=np.float32)

# input shapes with a captured forward at once; a further shape runs eagerly
GRAPH_KEYS = 4


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
    # Backbone attention: "xla" (the plain form, the JAX package's choice for
    # CuTR), "kernel" (ops/attention_kernel.py:whole_seq_attention) or "auto"
    # ("kernel" for CUDA tensors); see models/cutr/vit.py:JointAttention.
    attn_impl: str = "xla"

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

    def forward(self, src_2d: torch.Tensor, clamp_wh):
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

        # top-k by foreground logit (918-943)
        _, topk_idx = topk_stable(enc_logits[..., 0], cfg.num_queries)
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


class _Graphs(dict):
    """Captured forwards by input key.  A copy of the model starts with none:
    a graph reads the storage of the tensors it was captured on."""

    def __deepcopy__(self, memo):
        return _Graphs()

    def __reduce__(self):
        return (_Graphs, ())


_CAPTURE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


class _CapturedForward:
    """A CUDA graph of one eager forward, and its static inputs and outputs.

    Made as ``torch.cuda.graphs`` asks: one eager forward on a side stream
    first (it warms cuBLAS and the caching allocator, and makes the
    forward's constants on the card), then the capture into a private
    memory pool.  Every capture on a device uses one side stream: cuBLAS
    keeps a 32 MiB workspace for each stream it has run on.  The graph
    reads the parameters and buffers where they were at the capture:
    writes into them in place are followed, other storage is not
    (``current``).
    """

    def __init__(self, model: nn.Module, batch: FrameBatch):
        dev = batch.image.device
        self.inputs = FrameBatch(**{
            f.name: None if t is None else t.clone(memory_format=torch.contiguous_format)
            for f in dataclasses.fields(FrameBatch) for t in (getattr(batch, f.name),)
        })
        side = _CAPTURE_STREAMS.get(dev)
        if side is None:
            side = _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            model._forward(self.inputs)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=side):
            self.outputs = model._forward(self.inputs)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph.replay()
        self.held = [(d, n) for m in model.modules() for d in (m._parameters, m._buffers)
                     for n, t in d.items() if t is not None]
        self.addresses = self._addresses()

    def _addresses(self) -> list:
        return [d[n].data_ptr() for d, n in self.held]

    def current(self) -> bool:
        """Whether the model's parameters and buffers are still the storage
        the graph reads (not so inside ``torch.func.functional_call``)."""
        return self._addresses() == self.addresses

    def __call__(self, batch: FrameBatch) -> Dict[str, torch.Tensor]:
        for f in dataclasses.fields(FrameBatch):
            src = getattr(batch, f.name)
            if src is not None:
                getattr(self.inputs, f.name).copy_(src)
        self.graph.replay()
        return self.results()

    def results(self) -> Dict[str, torch.Tensor]:
        """Fresh copies of the outputs: the next replay overwrites them."""
        return {k: v.clone() for k, v in self.outputs.items()}


class CubifyTransformer(nn.Module):
    """Full CuTR detector; ``forward`` returns the packaged top-k detections.

    ``graph_counts`` counts the forwards by how they ran: "capture",
    "replay" and "eager" (``forward``).
    """

    def __init__(self, cfg: CuTRConfig = CuTRConfig()):
        super().__init__()
        self.cfg = cfg
        self._graphs = _Graphs()
        self.graph_counts: Dict[str, int] = {"capture": 0, "replay": 0, "eager": 0}
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
                attn_impl=cfg.attn_impl,
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

    def forward(self, batch: FrameBatch, train: bool = False) -> Dict[str, torch.Tensor]:
        """The packaged detections of ``batch`` (``train``: and every decoder
        layer's predictions).

        Inference on a card (``train`` false, gradients off) replays a CUDA
        graph of the forward, captured at the first call of each input
        shape and dtype, up to ``GRAPH_KEYS`` of them: the same kernels, bit
        for bit, from one launch.  It returns fresh tensors at every call.
        Every other call runs eagerly, and so does a call under a dispatch
        mode (``FlopCounterMode`` must see the ops), with parameters other
        than the graph's (``functional_call``), or one that would capture
        while a profiler records.  Moving the model (``_apply``) or loading
        a state dict drops its graphs.
        """
        key = self._graph_key(batch, train)
        graph = self._graphs.get(key) if key is not None else None
        if graph is not None and graph.current():
            with span("replay", counts=self.graph_counts):
                return graph(batch)
        if (key is None or graph is not None or len(self._graphs) >= GRAPH_KEYS or _recording()
                or not self._own_parameters()):
            with span("eager", counts=self.graph_counts):
                return self._forward(batch, train)
        with span("capture", counts=self.graph_counts):
            graph = self._graphs[key] = _CapturedForward(self, batch)
            return graph.results()

    def _graph_key(self, batch: FrameBatch, train: bool) -> Optional[tuple]:
        """What fixes a captured forward's shapes, or None where the call
        must run eagerly: training, gradients on, a model off the card, or
        a dispatch mode."""
        image = batch.image
        if (train or torch.is_grad_enabled() or not image.is_cuda
                or image.device != self.level_embed.device
                or _get_current_dispatch_mode() is not None):
            return None
        return (torch.is_inference_mode_enabled(), image.device) + tuple(
            None if t is None else (tuple(t.shape), t.dtype)
            for t in (image, batch.depth, batch.K, batch.image_hw, batch.depth_params, batch.T_gravity)
        )

    def _own_parameters(self) -> bool:
        """False inside ``torch.func.functional_call``, which puts plain
        tensors in the parameters' place for one call."""
        return all(isinstance(p, nn.Parameter) for m in self.modules()
                   for p in m._parameters.values() if p is not None)

    def _apply(self, *args, **kwargs):
        self._graphs.clear()  # new storage: the graphs would read the old
        return super()._apply(*args, **kwargs)

    def load_state_dict(self, *args, **kwargs):
        self._graphs.clear()  # ``assign=True`` puts new storage in place
        return super().load_state_dict(*args, **kwargs)

    def _forward(self, batch: FrameBatch, train: bool = False) -> Dict[str, torch.Tensor]:
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
        enc_logits, enc_boxes, topk_boxes = proposals(src2d, clamp_wh)

        nq, nm = cfg.num_queries, cfg.num_metric_tokens
        box_queries = proposals.query_embed.weight[None, :nq].expand(B, nq, cfg.decoder_dim)
        box_pos = self.prompting.encoders["box_2d_encoder"](topk_boxes.detach())
        metric_queries = self.prompting.prompters[0].query_embed.weight[None].expand(B, nm, cfg.decoder_dim)

        output = torch.cat([metric_queries, box_queries], dim=1).to(dt)
        query_pos = torch.cat([torch.zeros_like(metric_queries), box_pos.float()], dim=1).to(dt)
        src = src.to(dt)
        pos = pos.to(dt)

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
            # inv_ex: linalg.inv's kernels without its error check, which
            # reads the card's status back
            xyz = uvz @ torch.linalg.inv_ex(batch.K[b]).inverse.T
            pose = torch.einsum("ij,njk->nik", batch.T_gravity[b], pose)
            # WHL -> LHW reorder (971-973): head dims are (w, h, l)
            boxes3d = torch.cat([xyz, dims.flip(-1)], dim=-1)
            outs.append(dict(
                scores=scores, pred_classes=labels, pred_boxes=boxes,
                pred_logits=logits[box_idx], boxes3d=boxes3d, R=pose, proj_xy=proj_xy,
                object_desc=pred["object_desc"][b][box_idx].float(),
            ))
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax's default kernel init: truncated normal, variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


@torch.no_grad()
def init_weights(model: CubifyTransformer, gen: torch.Generator) -> None:
    """Random initialisation in the JAX package's (flax default) scheme.

    Dense and conv kernels lecun-normal with zero biases, norms at identity,
    embeddings normal(1/sqrt(width)), query embeddings normal(1), the ViT
    position embedding trunc-normal(0.02) (depth: zeros), class-head biases
    at the focal prior, self-attention in-projections xavier-uniform.
    """
    for m in model.modules():
        if isinstance(m, nn.Linear):
            _lecun_normal_(m.weight, m.in_features, gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, PatchConv):
            _lecun_normal_(m.weight, m.weight[0].numel(), gen)
            m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.embedding_dim), generator=gen)
        elif isinstance(m, TorchMHA):
            nn.init.xavier_uniform_(m.in_proj_weight, generator=gen)
            m.in_proj_bias.zero_()
        elif isinstance(m, ViT):
            nn.init.trunc_normal_(m.pos_embed, 0.0, 0.02, -0.04, 0.04, generator=gen)
            if m.depth_modality:
                m.pos_embed_depth.zero_()
    for m in model.modules():  # after the generic Linear init above
        if isinstance(m, ClassPredictor):
            m.linear.bias.fill_(m.bias_value)
        elif isinstance(m, (MetricPrompter, EncoderProposals)):
            m.query_embed.weight.normal_(0.0, 1.0, generator=gen)
    model.level_embed.normal_(0.0, 1.0, generator=gen)


def make_cutr(
    dimension: int = 768,
    depth_model: bool = True,
    device: DeviceLike = None,
    seed: int = 0,
    **kw,
) -> CubifyTransformer:
    """Mirror of make_cubify_transformer (cubify_transformer.py:1232-1323).

    Builds the model with random weights from ``seed`` (a private
    ``torch.Generator``; load trained weights with ``convert``), in eval
    mode, on ``device`` (default "cuda"; raises if there is none).
    ``dtype`` may be a torch dtype or "float32" / "bfloat16".
    """
    dev = resolve_device(device)
    if "dtype" in kw:
        kw["dtype"] = torch_dtype(kw["dtype"])
    model = CubifyTransformer(CuTRConfig(embed_dim=dimension, depth_model=depth_model, **kw))
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
