"""Random weights from the seed, made on the device in a few large draws.

The initialisation table is read off the plain reference's modules (built on
the ``meta`` device, so they hold no memory): kernels normal with variance
1 / fan-in, attention in-projections at the Xavier variance, norms at
identity, biases zero, embeddings normal, CuTR's regression heads and
position bias at a trained detector's scale (``REGRESSION_SCALE``,
``RPE_SCALE``), and every class head's bias at the focal prior plus a lift
(``fit_lift``: the calibration that sets how many of CuTR's rows pass the
score filter).  ``fill`` writes the same numbers into
any module whose parameters have the same names, so the program under test
and the reference are handed one set of weights from one seed.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn as nn

# one draw covers at most this many parameters (a draw is one kernel)
DRAW = 1 << 26
# CuTR's box regressions and its cross-attention position bias, drawn at the
# scale a trained detector works at: each regression head's last layer at a
# tenth of the fan-in scale (a decoder layer moves a box by a few percent,
# not by up to e^4 through its clamped exp), and the first layer of each
# position-bias MLP, whose inputs are pixel offsets of hundreds, at a
# fiftieth (a bias of order one, not of hundreds).  At the plain scale the
# six decoder layers amplified rounding so far that rows differed as much
# in bfloat16 as in float8.  The work is the same at any scale.
REGRESSION_SCALE = 0.1
RPE_SCALE = 0.02


def cutr_table(ref_model: nn.Module, lift: float) -> Dict[str, Tuple[str, float]]:
    """{parameter name: ("normal", std) or ("const", value)} for CuTR."""
    from benchmark.reference.models.cutr import decoder, heads, layers, model, vit

    table = {}
    for mname, m in ref_model.named_modules():
        pre = f"{mname}." if mname else ""
        for pname, p in m.named_parameters(recurse=False):
            name = pre + pname
            if name in table:
                continue
            if isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
                table[name] = ("const", 1.0 if pname == "weight" else 0.0)
            elif isinstance(m, nn.Embedding):
                std = 1.0 if isinstance(_parent(ref_model, mname), (model.MetricPrompter, model.EncoderProposals)) \
                    else 1.0 / math.sqrt(m.embedding_dim)
                table[name] = ("normal", std)
            elif isinstance(m, decoder.TorchMHA) and pname == "in_proj_weight":
                table[name] = ("normal", math.sqrt(2.0 / (p.shape[0] + p.shape[1])))
            elif isinstance(m, vit.ViT):
                table[name] = ("const", 0.0) if pname == "pos_embed_depth" else ("normal", 0.02)
            elif pname == "level_embed":
                table[name] = ("normal", 1.0)
            elif p.dim() == 1:
                table[name] = ("const", 0.0)
            elif isinstance(m, layers.PatchConv):
                table[name] = ("normal", 1.0 / math.sqrt(p[0].numel()))
            else:
                table[name] = ("normal", 1.0 / math.sqrt(p.shape[-1]))
    for mname, m in ref_model.named_modules():
        if isinstance(m, heads.ClassPredictor):
            table[f"{mname}.linear.bias"] = ("const", m.bias_value + float(lift))
        elif isinstance(m, (heads.DeltaBox2DPredictor, heads.AbsoluteBox3DPredictor)):
            last = f"{mname}.mlp.layers.{len(m.mlp.layers) - 1}.weight"
            table[last] = ("normal", table[last][1] * REGRESSION_SCALE)
        elif isinstance(m, decoder.GlobalCrossAttention):
            for k in ("cpb_mlp1.0.weight", "cpb_mlp2.0.weight"):
                table[f"{mname}.{k}"] = ("normal", table[f"{mname}.{k}"][1] * RPE_SCALE)
    return table


def clip_table(ref_tower: nn.Module) -> Dict[str, Tuple[str, float]]:
    """The same table for a CLIP image tower."""
    from benchmark.reference.models.clip import model as clip

    table = {}
    for mname, m in ref_tower.named_modules():
        pre = f"{mname}." if mname else ""
        for pname, p in m.named_parameters(recurse=False):
            name = pre + pname
            if isinstance(m, nn.LayerNorm):
                table[name] = ("const", 1.0 if pname == "weight" else 0.0)
            elif isinstance(m, clip._Attention) and pname == "in_proj_weight":
                table[name] = ("normal", math.sqrt(2.0 / (p.shape[0] + p.shape[1])))
            elif pname in ("class_embedding", "positional_embedding"):
                table[name] = ("normal", 0.02)
            elif pname == "proj":
                table[name] = ("normal", p.shape[0] ** -0.5)
            elif p.dim() == 1:
                table[name] = ("const", 0.0)
            elif p.dim() == 4:
                table[name] = ("normal", 1.0 / math.sqrt(p[0].numel()))
            else:
                table[name] = ("normal", 1.0 / math.sqrt(p.shape[-1]))
    return table


def _parent(root: nn.Module, name: str) -> nn.Module:
    return root.get_submodule(name.rsplit(".", 1)[0]) if "." in name else root


@torch.no_grad()
def fill(module: nn.Module, table: Dict[str, Tuple[str, float]], seed: int, device) -> None:
    """Write the table's weights for ``seed`` into ``module``'s parameters.

    Normal parameters are taken, in the order of their names, from draws of
    at most ``DRAW`` standard normals by one generator on ``device``."""
    params = dict(module.named_parameters())
    if set(params) != set(table):
        missing, extra = sorted(set(table) - set(params)), sorted(set(params) - set(table))
        raise KeyError(f"parameters differ from the table: missing {missing[:5]}, extra {extra[:5]}")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    group, size = [], 0

    def draw():
        nonlocal group, size
        if not group:
            return
        flat = torch.randn(size, generator=gen, device=device, dtype=torch.float32)
        at = 0
        for p, std in group:
            n = p.numel()
            p.copy_(flat[at:at + n].view_as(p) * std)
            at += n
        group, size = [], 0

    for name in sorted(table):
        kind, arg = table[name]
        p = params[name]
        if kind == "const":
            p.fill_(arg)
            continue
        if size + p.numel() > DRAW:
            draw()
        group.append((p, arg))
        size += p.numel()
    draw()


def text_features(n_classes: int, dim: int, seed: int, device) -> torch.Tensor:
    """(n_classes, dim) random class features for ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) + 1)
    return torch.randn(n_classes, dim, generator=gen, device=device, dtype=torch.float32)


def lift_for(config: dict, traffic: dict) -> float:
    """The class-bias lift the traffic file keeps for this configuration
    (``traffic["class_bias_lift"][config name]``), as ``fit_lift`` found it
    once on the card; ``python3 benchmark/control.py --workload <cell>
    --fit-lift`` finds it again."""
    lifts = traffic.get("class_bias_lift", {})
    if config["name"] not in lifts:
        raise KeyError(f"the traffic file has no class_bias_lift for {config['name']!r}: run "
                       "benchmark/control.py --fit-lift on the card and add it")
    return float(lifts[config["name"]])


def fit_lift(config: dict, families, traffic: dict, device) -> tuple:
    """The class-bias lift at which the configuration's weights give
    ``traffic["live_target"]`` live rows (raw score at or above the score
    filter) a keyframe on average, over the first
    ``traffic["lift_keyframes"]`` keyframes of the traffic's scan drawn from
    the weight seed, found with the float32 reference detector.  The same for
    every run seed.

    Adding the same amount to every class head's bias moves every logit by
    it and leaves every ranking as it was (the encoder's proposals and the
    final top-k), so one forward a keyframe at lift 0 gives the live count at
    any lift.  Returns (lift, the mean live count it gives)."""
    from benchmark.reference.engine import ReferenceEngine

    from benchmark.harness.traffic import make_scan

    thresh = float(config["settings"]["detection"]["score_thresh"])
    scan = make_scan(traffic, int(config["weight_seed"]), 0)
    engine = ReferenceEngine(config, families, dict(traffic, class_bias_lift=0.0), device, build_tower=False)
    cut = math.log(thresh / (1.0 - thresh))
    logits = []
    for i in scan.keyframes[: int(traffic["lift_keyframes"])]:
        s = engine.detect(scan.frames[i])["scores"].double().clamp(1e-12, 1 - 1e-12)
        logits.append(torch.log(s / (1 - s)).cpu())
    del engine
    target = float(traffic["live_target"])

    def mean_live(lift):
        return float(sum(int((lg + lift >= cut).sum()) for lg in logits)) / len(logits)

    lo, hi = -20.0, 20.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if mean_live(mid) < target else (lo, mid)
    return hi, mean_live(hi)
