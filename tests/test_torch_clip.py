"""The port's CLIP towers and labeling head against the JAX package's, on the CPU.

Tiny towers (the ``TINY`` config of tests/test_clip.py: patch 32, width 64,
2 layers, 2 heads).  Inputs and weights are drawn with numpy from a seed, go
through the flax module and its torch counterpart, and the weights cross
with ``boxfusion_tpu_torch/models/clip/convert.py``.  The JAX side runs its
plain ("xla") attention on the CPU; so does the port for CPU tensors.

Tolerances: float32 towers 1e-4 on embeddings of unit scale (the bound of the
JAX package's own CLIP activation-parity test, tests/test_clip.py:247,259);
one bfloat16 case at 6e-2 (three bfloat16 digits through two blocks); crops
1e-3 of the 255 pixel range (float32 interpolation weights in another order);
``scale_boxes`` 1e-5; labeler similarities 1e-3 (100 x the embedding bound on
a cosine), boosted scores 1e-4 (the decisions the fused engine's
``label_boost_core`` relies on), categories and background rows identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boxfusion_tpu.models.clip import convert as jax_convert
from boxfusion_tpu.models.clip import head as jax_head
from boxfusion_tpu.models.clip import model as jax_model
from boxfusion_tpu.models.clip import text as jax_text

from boxfusion_tpu_torch.models.clip import convert, head, text
from boxfusion_tpu_torch.models.clip.model import (
    CLIPConfig,
    CLIPImageTower,
    CLIPTextTower,
    ResidualBlock,
)

torch.set_num_threads(2)

TINY_KW = dict(patch=32, width=64, layers=2, heads=2, embed_dim=32, vocab_size=512,
               context_length=16, text_width=64, text_layers=2, text_heads=2)
TINY = CLIPConfig(**TINY_KW)
JAX_TINY = jax_model.CLIPConfig(**TINY_KW)
EMBED_TOL, BF16_TOL, CROP_TOL, SIM_TOL, SCORE_TOL = 1e-4, 6e-2, 1e-3 * 255, 1e-3, 1e-4


def _numpy_params(module, *example, seed=0):
    """A flax parameter tree of ``module`` filled with numpy draws: kernels
    normal(1 / sqrt(fan_in)), norm scales near 1, everything else small."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *example)
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = getattr(path[-1], "key", "")
        if name == "scale":
            return (1.0 + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        if name in ("bias", "attn_in_proj_bias"):
            return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        if name == "attn_in_proj_weight":
            fan_in = leaf.shape[-1]
        elif name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
        elif name in ("proj", "text_projection"):
            fan_in = leaf.shape[0]
        else:  # embeddings
            fan_in = 4
        return (rng.randn(*leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _image_tower_pair(seed=0, **cfg_kw):
    jcfg = dataclasses.replace(JAX_TINY, **{k: (jnp.bfloat16 if v == "bfloat16" else v)
                                            for k, v in cfg_kw.items()})
    jtower = jax_model.CLIPImageTower(jcfg)
    params = _numpy_params(jtower, jnp.zeros((1, 224, 224, 3)), seed=seed)
    tower = CLIPImageTower(CLIPConfig(**{**TINY_KW, **cfg_kw}))
    tower.load_state_dict(convert.image_tower_from_flax(params), strict=True)
    return jtower, params, tower.eval()


@pytest.mark.parametrize("masked", [False, True], ids=["image_block", "causal_block"])
def test_residual_block_matches_flax(masked):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 10, 64).astype(np.float32)
    mask = np.where(np.tril(np.ones((10, 10), bool)), 0.0, -np.inf).astype(np.float32)[None, None]
    jblk = jax_model.ResidualBlock(2, quick_gelu=not masked)
    args = (jnp.asarray(x), jnp.asarray(mask)) if masked else (jnp.asarray(x),)
    params = _numpy_params(jblk, *args, seed=4)
    want = np.asarray(jax.jit(jblk.apply)(params, *args))

    blk = ResidualBlock(64, 2, gelu="quick" if not masked else "exact").eval()
    sd = {}
    convert._resblock_from_flax(sd, "b", params["params"])
    blk.load_state_dict({k[2:]: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = blk(torch.from_numpy(x), mask=torch.from_numpy(mask) if masked else None)
        if not masked:  # "kernel" on a CPU tensor is the twin: the same numbers
            np.testing.assert_array_equal(
                blk(torch.from_numpy(x), attn_impl="kernel").numpy(), got.numpy())
    np.testing.assert_allclose(got.numpy(), want, atol=EMBED_TOL, rtol=EMBED_TOL)


@pytest.mark.parametrize("quick_gelu", [False, True], ids=["gelu", "quick_gelu"])
def test_image_tower_matches_flax(quick_gelu):
    jtower, params, tower = _image_tower_pair(seed=5, quick_gelu=quick_gelu)
    x = np.random.RandomState(6).randn(2, 224, 224, 3).astype(np.float32)
    want = np.asarray(jax.jit(jtower.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tower(torch.from_numpy(x)).numpy()
    assert got.shape == (2, TINY.embed_dim) and 0.1 < np.abs(want).mean() < 10.0
    np.testing.assert_allclose(got, want, atol=EMBED_TOL, rtol=EMBED_TOL)


def test_image_tower_bfloat16_matches_flax():
    jtower, params, tower = _image_tower_pair(seed=5, dtype="bfloat16")
    x = np.random.RandomState(6).randn(2, 224, 224, 3).astype(np.float32)
    want = np.asarray(jax.jit(jtower.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tower(torch.from_numpy(x))
    assert got.dtype == torch.float32  # the projection stays float32
    np.testing.assert_allclose(got.numpy(), want, atol=BF16_TOL, rtol=BF16_TOL)


def _open_clip_state_dict(seed=0):
    """A full CLIP state dict in open_clip's layout at the TINY shapes."""
    c, rng = TINY, np.random.RandomState(seed)
    n = lambda *s, fan=1.0: (rng.randn(*s) / np.sqrt(fan)).astype(np.float32)
    sd = {
        "visual.conv1.weight": n(c.width, 3, c.patch, c.patch, fan=3 * c.patch ** 2),
        "visual.class_embedding": n(c.width, fan=4),
        "visual.positional_embedding": n((224 // c.patch) ** 2 + 1, c.width, fan=4),
        "visual.proj": n(c.width, c.embed_dim, fan=c.width),
        "text_projection": n(c.text_width, c.embed_dim, fan=c.text_width),
        "token_embedding.weight": n(c.vocab_size, c.text_width, fan=4),
        "positional_embedding": n(c.context_length, c.text_width, fan=4),
    }
    norms = [("visual.ln_pre", c.width), ("visual.ln_post", c.width), ("ln_final", c.text_width)]
    blocks = [(f"visual.transformer.resblocks.{i}", c.width) for i in range(c.layers)]
    blocks += [(f"transformer.resblocks.{i}", c.text_width) for i in range(c.text_layers)]
    for p, d in blocks:
        norms += [(p + ".ln_1", d), (p + ".ln_2", d)]
        for name, o, i in (("attn.in_proj_", 3 * d, d), ("attn.out_proj.", d, d),
                           ("mlp.c_fc.", 4 * d, d), ("mlp.c_proj.", d, 4 * d)):
            sd[p + "." + name + "weight"] = n(o, i, fan=i)
            sd[p + "." + name + "bias"] = 0.1 * n(o)
    for p, d in norms:
        sd[p + ".weight"] = 1.0 + 0.1 * n(d)
        sd[p + ".bias"] = 0.1 * n(d)
    return sd


def test_checkpoint_loaders_match_jax_converters(tmp_path):
    """An open_clip-layout checkpoint on disk through both packages' loaders:
    the same inferred config, the same image and text embeddings."""
    sd = _open_clip_state_dict(seed=7)
    path = tmp_path / "clip.pt"
    torch.save({"state_dict": {"module." + k: torch.from_numpy(v) for k, v in sd.items()}}, path)

    jimg_params, jcfg = jax_convert.load_clip_image_params(str(path))
    jtxt_params, _ = jax_convert.load_clip_text_params(str(path))
    itower, cfg = convert.load_clip_image_params(str(path), device="cpu")
    ttower, _ = convert.load_clip_text_params(str(path), device="cpu")
    for f in ("patch", "image_size", "width", "layers", "heads", "embed_dim", "vocab_size",
              "context_length", "text_width", "text_layers", "text_heads", "quick_gelu"):
        assert getattr(cfg, f) == getattr(jcfg, f), f

    rng = np.random.RandomState(8)
    x = rng.randn(2, 224, 224, 3).astype(np.float32)
    toks = rng.randint(1, cfg.vocab_size - 1, (3, cfg.context_length)).astype(np.int32)
    for r, pos in enumerate((5, cfg.context_length - 1, 9)):  # one EOT (= max id) per row
        toks[r, pos] = cfg.vocab_size - 1
    want_i = np.asarray(jax.jit(jax_model.CLIPImageTower(jcfg).apply)(jimg_params, jnp.asarray(x)))
    want_t = np.asarray(jax.jit(jax_model.CLIPTextTower(jcfg).apply)(jtxt_params, jnp.asarray(toks)))
    with torch.no_grad():
        got_i = itower(torch.from_numpy(x)).numpy()
        got_t = ttower(torch.from_numpy(toks.astype(np.int64))).numpy()
    np.testing.assert_allclose(got_i, want_i, atol=EMBED_TOL, rtol=EMBED_TOL)
    np.testing.assert_allclose(got_t, want_t, atol=EMBED_TOL, rtol=EMBED_TOL)

    with pytest.raises(FileNotFoundError, match="CLIP checkpoint not found"):
        convert.load_clip_image_params(str(tmp_path / "nope.pt"), device="cpu")
    del sd["visual.proj"]
    with pytest.raises(ValueError, match="lacks"):
        convert.convert_image_tower(sd, device="cpu")


def test_text_tower_from_flax_and_batching():
    """Flax text-tower weights carried across; ``encode_tokens`` in short
    batches gives the rows of one whole batch."""
    jtower = jax_model.CLIPTextTower(JAX_TINY)
    rng = np.random.RandomState(9)
    toks = rng.randint(1, 500, (5, TINY.context_length)).astype(np.int32)
    toks[np.arange(5), [3, 15, 7, 1, 10]] = 511
    params = _numpy_params(jtower, jnp.asarray(toks), seed=10)
    want = np.asarray(jax.jit(jtower.apply)(params, jnp.asarray(toks)))
    want = want / np.linalg.norm(want, axis=-1, keepdims=True)

    tower = CLIPTextTower(TINY).eval()
    tower.load_state_dict(convert.text_tower_from_flax(params), strict=True)
    got = text.encode_tokens(tower, toks, batch=2)
    np.testing.assert_allclose(got, want, atol=EMBED_TOL, rtol=EMBED_TOL)
    np.testing.assert_allclose(got, text.encode_tokens(tower, toks, batch=64), atol=1e-6, rtol=0)


def test_tokenizer_matches_jax_on_a_small_vocabulary(tmp_path):
    """The standard merges file is not in the repository; on a hand-made one
    the port's tokenizer (its own copy) gives the JAX package's ids."""
    merges = ["#version: test", "c h", "ch a", "i r</w>", "cha ir</w>", "t a", "b l", "e</w> </w>"]
    path = tmp_path / "bpe.txt"
    path.write_text("\n".join(merges) + "\n")
    texts = ["chair", "a table &amp; chairs", "  Sofa-bed 2 ", ""]
    want = jax_text.SimpleTokenizer(str(path))(texts, context_length=16)
    got = text.SimpleTokenizer(str(path))(texts, context_length=16)
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == got[0].max() - 1 and got.dtype == np.int32


def _boxes():
    """interior, border-clipped, sub-pixel, one-pixel, degenerate, inverted"""
    return np.array([[8.0, 8.0, 40.0, 40.0], [-5.0, 50.2, 30.7, 64.0], [70.3, 10.6, 95.9, 33.2],
                     [20.0, 20.0, 21.5, 21.2], [0.0, 0.0, 0.0, 0.0], [30.0, 30.0, 10.0, 10.0],
                     [0.0, 0.0, 96.0, 64.0]], np.float32)


def test_batched_crop_resize_matches_jax():
    img = np.random.RandomState(11).uniform(0, 255, (64, 96, 3)).astype(np.float32)
    want = np.asarray(jax_head.batched_crop_resize(jnp.asarray(img), jnp.asarray(_boxes())))
    got = head.batched_crop_resize(torch.from_numpy(img), torch.from_numpy(_boxes())).numpy()
    assert got.shape == (7, 224, 224, 3)
    assert (got[4] == 0).all() and (got[5] == 0).all() and got[:4].std() > 1.0
    np.testing.assert_allclose(got, want, atol=CROP_TOL, rtol=0)
    # the normalised crops a float32 tower sees
    wantn = np.asarray(jax_head._crop_normalize(jnp.asarray(img), jnp.asarray(_boxes()), jnp.float32))
    gotn = head._crop_normalize(torch.from_numpy(img), torch.from_numpy(_boxes()), torch.float32)
    np.testing.assert_allclose(gotn.numpy(), wantn, atol=CROP_TOL / 255 / 0.26, rtol=0)


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_scale_boxes_matches_jax(kind):
    b = np.array([[10.0, 10.0, 30.0, 50.0], [0.0, 0.0, 100.0, 100.0], [90.5, 3.25, 99.0, 20.0]], np.float32)
    want = jax_head.scale_boxes(b, 100, 100, 1.5)
    np.testing.assert_allclose(want[0], [5.0, 0.0, 35.0, 60.0], atol=1e-5)
    got = head.scale_boxes(torch.from_numpy(b) if kind == "torch" else b, 100, 100, 1.5)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def labelers():
    """A JAX labeler and the port's, with the same tower weights and text features."""
    def make(sim_thres):
        rng = np.random.RandomState(12)
        tf = rng.randn(7, TINY.embed_dim).astype(np.float32)
        names = [f"c{i}" for i in range(7)]
        jtower, params, _ = _image_tower_pair(seed=13)
        jlab = jax_head.OpenVocabLabeler(names, tf, image_params=jax.tree.map(jnp.asarray, params),
                                         cfg=JAX_TINY, sim_thres=sim_thres, max_boxes=8)
        lab = head.OpenVocabLabeler(names, tf, image_params=convert.image_tower_from_flax(params),
                                    cfg=TINY, sim_thres=sim_thres, max_boxes=3, device="cpu")
        return jlab, lab
    return make


@pytest.mark.parametrize("sim_thres", [-1e9, 0.0, 1e9], ids=["all_classes", "mixed", "all_background"])
def test_labeler_call_matches_jax(labelers, sim_thres):
    jlab, lab = labelers(sim_thres)
    img = np.random.RandomState(14).uniform(0, 255, (64, 96, 3)).astype(np.float32)
    boxes = _boxes()  # 7 boxes: the port runs them as 3 + 3 + 1, the JAX side pads to 8
    wc, wf, ws = jlab(img, boxes)
    gc, gf, gs = lab(img, boxes)
    assert gc == wc
    if sim_thres == 1e9:
        assert gc == [""] * 7
    if sim_thres == -1e9:
        assert "" not in gc
    np.testing.assert_allclose(gf, wf, atol=EMBED_TOL, rtol=0)
    np.testing.assert_allclose(gs, ws, atol=SIM_TOL, rtol=0)
    ec, ef, es = lab(img, boxes[:0])
    assert ec == [] and ef.shape == (0, TINY.embed_dim) and es.shape == (0,)


@pytest.mark.parametrize("budget", [4, 16], ids=["over_budget", "within_budget"])
def test_label_boost_device_matches_jax(labelers, budget):
    jlab, lab = labelers(0.0)
    rng = np.random.RandomState(15)
    img = rng.uniform(0, 255, (64, 96, 3)).astype(np.float32)
    boxes = _boxes()
    # a threshold between the best similarities of the budgeted rows, set
    # before either side's first call: some rows are background, some not
    best = np.sort(lab(img, head.scale_boxes(boxes[:4], 64, 96, 1.5))[2])
    jlab.sim_thres = lab.sim_thres = float((best[1] + best[2]) / 2)
    assert best[2] - best[1] > 10 * SIM_TOL
    scores = np.sort(rng.uniform(0.3, 0.9, 7).astype(np.float32))[::-1].copy()
    scores[5] = -1e9  # a dead row past the budget of 4 does not count as overflow
    want = jlab.label_boost_device(jnp.asarray(img), jnp.asarray(boxes), jnp.asarray(scores),
                                   (64.0, 96.0), 1.5, 1.0, budget=budget)
    got = lab.label_boost_device(torch.from_numpy(img), torch.from_numpy(boxes),
                                 torch.from_numpy(scores), (64.0, 96.0), 1.5, 1.0, budget=budget)
    ws, wc, wf, wo = (np.asarray(x) for x in want)
    gs, gc, gf, go = (x.numpy() for x in got)
    np.testing.assert_array_equal(gc, wc)
    assert gc.dtype == np.int32 and int(go) == int(wo) == (2 if budget == 4 else 0)
    np.testing.assert_array_equal(gs < -1e8, ws < -1e8)  # the same background rows
    assert (gc[: min(budget, 7)] == 7).any() and (gc[: min(budget, 7)] < 7).any()
    np.testing.assert_allclose(gs, ws, atol=SCORE_TOL, rtol=0)
    np.testing.assert_allclose(gf, wf, atol=EMBED_TOL, rtol=0)
    if budget == 4:
        assert (gc[4:] == 7).all() and np.array_equal(gs[4:], scores[4:])


def test_build_labeler_requires_clip_weights(tmp_path):
    txt = tmp_path / "classes.txt"
    txt.write_text("chair\ntable\n")
    f = torch.randn(2, TINY.embed_dim, generator=torch.Generator().manual_seed(0))
    torch.save(f / f.norm(dim=-1, keepdim=True), tmp_path / "feats.pt")
    np.save(tmp_path / "feats.npy", f.numpy())
    with pytest.raises(ValueError, match="clip-path"):
        head.build_labeler(None, str(txt), str(tmp_path / "feats.pt"), cfg=TINY, device="cpu")
    lab = head.build_labeler(None, str(txt), str(tmp_path / "feats.npy"), allow_random=True,
                             cfg=TINY, device="cpu")
    assert list(lab.class_list) == ["chair", "table"]
    cats, feats, sims = lab(np.zeros((32, 32, 3), np.float32), np.array([[2.0, 2.0, 30.0, 30.0]]))
    assert len(cats) == 1 and feats.shape == (1, TINY.embed_dim) and np.isfinite(sims).all()
    np.testing.assert_allclose(head.load_class_features(str(tmp_path / "feats.pt")),
                               np.asarray(jax_head.load_class_features(str(tmp_path / "feats.pt"))))
    with pytest.raises(ValueError, match="rows"):
        head.OpenVocabLabeler(["a"], f.numpy(), cfg=TINY, device="cpu")
    with pytest.raises(RuntimeError, match="no image-tower weights"):
        head.OpenVocabLabeler(["a", "b"], f.numpy(), cfg=TINY, device="cpu")(
            np.zeros((32, 32, 3), np.float32), np.array([[2.0, 2.0, 30.0, 30.0]]))
