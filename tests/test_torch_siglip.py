"""SigLIP's image tower in the port, against the benchmark's plain reference.

The port's ``SigLIPImageTower`` (``models/clip/siglip.py``) and the plain
tower the benchmark judges it by (``benchmark/reference/models/siglip/``)
are built at a CPU size with SigLIP's traits (no class token, heads of 72,
an MLP that is not 4 x width, LayerNorm eps 1e-6, an attention-pool head)
and handed one set of weights from one seed (``weights.fill``).  Also: the
labeler's crops follow the tower's config, the generalised ``ResidualBlock``
is open_clip's by default, head width 72's launch plan, the checkpoint key
map, the spans of the label stage, and (``cuda``-marked, skipped without a
card) the hd-72 kernel against its twin:

    python -m pytest --noconftest -m cuda tests/test_torch_siglip.py
"""
import os
import sys

import numpy as np
import pytest
import torch

from benchmark.harness import weights
from benchmark.harness.spec import BENCH_DIR, _module
from benchmark.reference.models.clip import head as ref_head
from benchmark.reference.models.clip import model as ref_clip
from benchmark.reference.models.cutr.layers import FP8
from boxfusion_tpu_torch.models.clip import head
from boxfusion_tpu_torch.models.clip.convert import load_siglip_image_params
from boxfusion_tpu_torch.models.clip.model import CLIPConfig, ResidualBlock
from boxfusion_tpu_torch.models.clip.siglip import SigLIPConfig, SigLIPImageTower
from boxfusion_tpu_torch.ops import attention_kernel as ak

torch.set_num_threads(2)

# SigLIP's traits at a CPU size: 4 x 4 patches of 14 px, 2 heads of 72, an
# MLP of 200 (not 4 x 144)
SMALL = dict(image_size=56, patch=14, width=144, layers=2, heads=2, mlp_width=200, ln_eps=1e-6,
             image_mean=[0.5, 0.5, 0.5], image_std=[0.5, 0.5, 0.5], embed_dim=144, n_classes=8, sim_thres=0.0)
SEED = 20261017

# Tolerances on the embedding, as the relative L2 error over a batch of crops:
#  * float32: the port and the reference do the same products in the same
#    order on the CPU; 1e-5 leaves room for a reassociated sum only;
#  * bfloat16: every product's operands rounded to 8 significant bits
#    (2^-9 relative each) through two blocks and the pool: 0.7% here; 3%
#    allows the card's other summation order, and float8 (e4m3, 4
#    significant bits: 2^-5 each) reads 9% and fails it.
REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}


def _family():
    return _module(os.path.join(BENCH_DIR, "families", "siglip_vit.py"), "test_family_")


def _section(dtype: str) -> dict:
    return dict(SMALL, dtype=dtype)


def _filled(section: dict, build, dtype=None):
    fam = _family()
    table = fam.table(fam.reference(section, torch.float32, "meta"))
    tower = build(section) if dtype is None else fam.reference(section, dtype, "cpu")
    weights.fill(tower, table, SEED, "cpu")
    return tower


def _crops(n: int = 5) -> torch.Tensor:
    rng = np.random.RandomState(3)
    return torch.from_numpy(rng.uniform(-1, 1, (n, SMALL["image_size"], SMALL["image_size"], 3)).astype(np.float32))


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tower_matches_plain_reference(dtype):
    fam = _family()
    section = _section(dtype)
    prog = _filled(section, lambda s: fam.program(s, "cpu"))
    ref = _filled(section, None, torch.float32)
    x = _crops()
    with torch.no_grad():
        got, want = prog(x), ref(x)
    tol = REL_TOL[prog.cfg.dtype]
    assert got.dtype == torch.float32 and got.shape == (5, SMALL["width"])
    assert _rel(got, want) <= tol, _rel(got, want)
    if dtype == "bfloat16":
        # the tolerance separates a precision below the configuration's
        with torch.no_grad():
            low = _filled(section, None, FP8)(x)
        assert _rel(low, want) > tol, _rel(low, want)


def test_parameter_names_equal_and_no_class_token():
    fam = _family()
    section = _section("bfloat16")
    prog, ref = fam.program(section, "meta"), fam.reference(section, torch.float32, "meta")
    names = [(n, tuple(p.shape)) for n, p in prog.named_parameters()]
    assert names == [(n, tuple(p.shape)) for n, p in ref.named_parameters()]
    assert not any("class" in n for n, _ in names)
    assert dict(names)["positional_embedding"] == ((56 // 14) ** 2, 144)
    assert dict(names)["head.probe"] == (1, 1, 144)
    assert prog.cfg.embed_dim == 144 and prog.cfg.tokens == 16


def _image_and_boxes():
    rng = np.random.RandomState(5)
    image = torch.from_numpy(rng.uniform(0, 255, (48, 64, 3)).astype(np.float32))
    boxes = torch.tensor([[3.2, 4.0, 40.7, 30.1], [10.0, 10.0, 10.5, 30.0], [0.0, 0.0, 64.0, 48.0]])
    return image, boxes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_labeler_crops_at_the_towers_size_and_statistics(dtype):
    image, boxes = _image_and_boxes()
    cfg = SigLIPConfig(**{k: SMALL[k] for k in ("image_size", "patch", "width", "layers", "heads", "mlp_width")},
                       image_mean=0.5, image_std=0.5, dtype=dtype)
    lab = head.OpenVocabLabeler(["a", "b"], np.eye(2, 144, dtype=np.float32), cfg=cfg, device="cpu")
    got = lab._crops(image, boxes)
    want = ref_head._crop_normalize(image, boxes, dtype, size=56, mean=np.full(3, 0.5, np.float32),
                                    std=np.full(3, 0.5, np.float32))
    assert got.shape == (3, 56, 56, 3) and got.dtype == dtype
    assert torch.equal(got, want)
    # and the tower takes them: init_random builds the config's kind of tower
    lab.init_random(0)
    assert isinstance(lab.tower, SigLIPImageTower)
    feats, sims = lab._encode(image, boxes)
    assert feats.shape == (3, 144) and sims.shape == (3, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_clip_crops_are_unchanged(dtype):
    """224-px crops with CLIP's statistics, bit for bit the reference's frozen
    copy of the labeler's crop; CLIPConfig names that size and those
    statistics."""
    image, boxes = _image_and_boxes()
    want = ref_head._crop_normalize(image, boxes, dtype, size=224, mean=ref_clip.CLIP_IMAGE_MEAN,
                                    std=ref_clip.CLIP_IMAGE_STD)
    assert torch.equal(head._crop_normalize(image, boxes, dtype), want)
    lab = head.OpenVocabLabeler(["a"], np.ones((1, 32), np.float32), cfg=CLIPConfig(dtype=dtype), device="cpu")
    assert torch.equal(lab._crops(image, boxes), want)
    cfg = CLIPConfig()
    assert cfg.image_size == 224 and np.array_equal(cfg.image_mean, ref_clip.CLIP_IMAGE_MEAN)
    assert np.array_equal(cfg.image_std, ref_clip.CLIP_IMAGE_STD)


@pytest.mark.parametrize("width, heads, quick_gelu", [(128, 2, True), (160, 2, False)], ids=["vit_l", "vit_h"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_residual_block_defaults_are_open_clips(width, heads, quick_gelu, dtype):
    """With its new arguments at their defaults the block is bit for bit the
    frozen copy of open_clip's block (heads of 64 as ViT-L's, of 80 as
    ViT-H's): MLP 4 x width, eps 1e-5, exact or quick GELU."""
    gen = torch.Generator().manual_seed(width)
    blk = ResidualBlock(width, heads, "quick" if quick_gelu else "exact", dtype=dtype)
    ref = ref_clip.ResidualBlock(width, heads, quick_gelu, dtype=dtype)
    with torch.no_grad():
        for p in blk.parameters():
            p.normal_(0.0, 0.05, generator=gen)
    ref.load_state_dict(blk.state_dict())
    assert blk.mlp.c_fc.out_features == 4 * width and blk.ln_1.eps == blk.ln_2.eps == 1e-5
    x = torch.randn(3, 17, width, generator=gen).to(dtype)
    with torch.no_grad():
        assert torch.equal(blk(x), ref(x))


def test_head_width_72_plans_within_the_resident_budget():
    for T in (257, 729):
        plan = ak.plan_bf16(T, 72)
        assert plan.smem_bytes <= ak.RESIDENT_BYTES, (T, plan)
        assert plan.smem_bytes == (2 * ak.WARPGROUPS + 2 * plan.stages) * ak.TILE * 80 * 2
    assert ak.plan_bf16(729, 72).n_qtiles == 12 and ak.padded_width(72) == 80
    q = torch.zeros(1, 5, 2 * 72)
    assert ak._check_args(q, q, q, 2) == 72


def _hf_state_dict(tower: SigLIPImageTower) -> dict:
    """The tower's weights under Hugging Face's SigLIP vision keys."""
    sd = {k: v.detach().clone() for k, v in tower.state_dict().items()}
    d = tower.cfg.width
    out = {"vision_model.embeddings.patch_embedding.weight": sd.pop("patch_embedding.weight"),
           "vision_model.embeddings.patch_embedding.bias": sd.pop("patch_embedding.bias"),
           "vision_model.embeddings.position_embedding.weight": sd.pop("positional_embedding")}
    for i in range(tower.cfg.layers):
        a, b = f"vision_model.encoder.layers.{i}.", f"transformer.resblocks.{i}."
        for name in ("weight", "bias"):
            for j, x in enumerate("qkv"):
                out[a + f"self_attn.{x}_proj.{name}"] = sd[b + f"attn.in_proj_{name}"][j * d:(j + 1) * d]
            del sd[b + f"attn.in_proj_{name}"]
            for old, new in (("attn.out_proj", "self_attn.out_proj"), ("ln_1", "layer_norm1"),
                             ("ln_2", "layer_norm2"), ("mlp.c_fc", "mlp.fc1"), ("mlp.c_proj", "mlp.fc2")):
                out[a + f"{new}.{name}"] = sd.pop(b + f"{old}.{name}")
    out.update({"vision_model." + k: v for k, v in sd.items()})  # post_layernorm, head.*
    out["text_model.embeddings.token_embedding.weight"] = torch.zeros(4, 8)  # another tower's key: ignored
    return out


def test_siglip_checkpoint_key_map():
    fam = _family()
    section = _section("float32")
    tower = _filled(section, lambda s: fam.program(s, "cpu"))
    loaded, cfg = load_siglip_image_params(_hf_state_dict(tower), device="cpu", heads=2)
    assert cfg == tower.cfg
    want = tower.state_dict()
    assert set(loaded.state_dict()) == set(want)
    assert all(torch.equal(v, want[k]) for k, v in loaded.state_dict().items())
    with torch.no_grad():
        assert torch.equal(loaded(_crops(2)), tower(_crops(2)))
    # only SO400M's width has a known head count; another width names its heads
    with pytest.raises(ValueError, match="pass its heads"):
        load_siglip_image_params(_hf_state_dict(tower), device="cpu")


def test_label_spans_nest_inside_the_label_stage(tmp_path):
    """Under a profiler the crops and the pool head show as
    ``boxfusion.label.crops`` / ``boxfusion.label.pool`` inside
    ``boxfusion.label``."""
    from boxfusion_tpu_torch.runtime.fused import label_boost_core
    from boxfusion_tpu_torch.utils import profiling

    cfg = SigLIPConfig(**{k: SMALL[k] for k in ("image_size", "patch", "width", "layers", "heads", "mlp_width")})
    lab = head.OpenVocabLabeler([f"c{i}" for i in range(4)], np.random.RandomState(1).randn(4, 144),
                                cfg=cfg, device="cpu").init_random(0)
    image, boxes = _image_and_boxes()
    det = dict(scores=torch.tensor([0.9, 0.8, 0.1]), pred_boxes=boxes)
    totals = {}
    with profiling.trace(str(tmp_path / "tr"), device="cpu") as path:
        with profiling.span("label", totals):
            label_boost_core(lab, [det], (image[None] - 100.0) / 50.0, [(48, 64)], label_budget=3, scale_box=1.5,
                             clip_coeff=0.0, raw_score_thresh=0.5, bucketed=True)
    spans = {e["name"]: e for e in profiling.load_trace(path) if e.get("cat") == "user_annotation"}
    outer = spans["boxfusion.label"]
    for name in ("boxfusion.label.crops", "boxfusion.label.pool"):
        e = spans[name]
        assert float(outer["ts"]) <= float(e["ts"])
        assert float(e["ts"]) + float(e["dur"]) <= float(outer["ts"]) + float(outer["dur"])
    assert set(totals) == {"label"}  # the inner spans keep no totals


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B, T, heads, dtype", [
    (96, 729, 16, torch.bfloat16), (3, 729, 16, torch.bfloat16), (4, 257, 16, torch.bfloat16),
    (2, 729, 2, torch.float32), (3, 257, 16, torch.float32)])
def test_head_width_72_on_card_matches_twin(B, T, heads, dtype):
    """The hd-72 kernels against their twin on the chunk views of one
    (B, T, 3 x heads x 72) qkv tensor: a load of a head's zero channels
    72-79 from device memory would read the next head's (or the next
    tensor's) columns and fail."""
    dev = _card()
    from chip_smoke import attention_tolerance

    atol, rtol = attention_tolerance(dtype)
    gen = torch.Generator(device=dev).manual_seed(B * 10_000 + T)
    qkv = torch.randn(B, T, 3 * heads * 72, generator=gen, device=dev).to(dtype)
    q, k, v = qkv.chunk(3, dim=-1)
    before = ak.whole_seq_attention.launches
    got = ak.whole_seq_attention(q, k, v, heads, 72 ** -0.5)
    want = ak.whole_seq_attention_reference(q, k, v, heads, 72 ** -0.5)
    torch.cuda.synchronize()
    assert ak.whole_seq_attention.launches == before + 1
    assert got.shape == q.shape and torch.isfinite(got).all()
    excess = (got.float() - want.float()).abs() - (atol + rtol * want.float().abs())
    assert float(excess.max()) <= 0, float((got.float() - want.float()).abs().max())


@pytest.mark.cuda
def test_tower_on_card_matches_plain_reference():
    """The small bfloat16 tower on the card (its blocks on the hd-72 kernel)
    against the float32 reference on the CPU, at the bfloat16 tolerance."""
    dev = _card()
    fam = _family()
    section = _section("bfloat16")
    prog = _filled(section, lambda s: fam.program(s, "cpu")).to(dev)
    ref = _filled(section, None, torch.float32)
    x = _crops()
    before = ak.whole_seq_attention.launches
    with torch.no_grad():
        got = prog(x.to(dev)).cpu()
        want = ref(x)
    assert ak.whole_seq_attention.launches == before + SMALL["layers"]
    assert _rel(got, want) <= REL_TOL[torch.bfloat16], _rel(got, want)
