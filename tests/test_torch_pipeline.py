"""The port's host engine against the JAX host engine, on the CPU.

Both ``OnlinePipeline``s run the same synthetic sequence through the same
detector inputs with the same ``warmup`` (the noisy oracle draws from its
RNG on every call, so the warm-up call shifts its noise stream on both
sides alike).  Host engine against host engine only: the JAX device engine
differs by design.

Bounds (those the JAX package holds its two engines to,
tests/test_device_pipeline.py:371-389): identical init_id sets and fusion
flags, xyzlhw within 5e-3 (PST fusion coordinates are chaotic across
stacks), R within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boxfusion_tpu.data.synthetic import OracleDetector as JaxOracle
from boxfusion_tpu.data.synthetic import SyntheticSequence as JaxSequence
from boxfusion_tpu.runtime import OnlinePipeline as JaxPipeline
from boxfusion_tpu.utils.config import load_config as jax_load_config

from boxfusion_tpu_torch.data.synthetic import OracleDetector, SyntheticSequence
from boxfusion_tpu_torch.models.cutr.layers import topk_stable
from boxfusion_tpu_torch.runtime import OnlinePipeline
from boxfusion_tpu_torch.utils.config import load_config

torch.set_num_threads(2)

XYZLHW_TOL, R_TOL = 5e-3, 1e-5


def _small_caps(c):
    """tests/test_pipeline.py:_small_caps, plus the 0.3 score filter."""
    c["data"]._data["gap"] = 5
    c["detection"]._data["uv_bound"] = False
    c["detection"]._data["floor_mask"] = False
    c["detection"]._data["score_thresh"] = 0.3
    c["box_fusion"]._data["pst_path"] = None
    c["box_fusion"]._data["pst_size"] = 128
    c["box_fusion"]._data["iters"] = 8
    c["box_fusion"]._data["max_fusions_per_frame"] = 4
    c["association"]._data["max_views"] = 5
    return c


def _assert_same_world(jax_pipe, jax_world, pipe, world, expect_fusion):
    a_j, a_t = jax_world.arrays, world.arrays
    np.testing.assert_array_equal(np.sort(a_t["init_id"]), np.sort(a_j["init_id"]))
    oj, ot = np.argsort(a_j["init_id"]), np.argsort(a_t["init_id"])
    np.testing.assert_allclose(a_t["xyzlhw"][ot], a_j["xyzlhw"][oj], atol=XYZLHW_TOL, rtol=0)
    np.testing.assert_allclose(a_t["R"][ot], a_j["R"][oj], atol=R_TOL, rtol=0)
    flags_j = np.asarray(jax_pipe.manager.fusion_flag, bool)[oj]
    flags_t = np.asarray(pipe.manager.fusion_flag, bool)[ot]
    np.testing.assert_array_equal(flags_t, flags_j)
    assert flags_t.any() == expect_fusion


@pytest.mark.parametrize(
    "n_frames,n_boxes,seq_seed,noise,det_seed,fuses",
    [(30, 5, 0, 0.0, 0, False), (40, 4, 1, 0.04, 2, True)],
    ids=["noiseless", "noisy"],
)
def test_pipeline_oracle_matches_jax_host_engine(n_frames, n_boxes, seq_seed, noise, det_seed, fuses):
    jseq = JaxSequence(n_frames=n_frames, n_boxes=n_boxes, seed=seq_seed)
    jpipe = JaxPipeline(_small_caps(jax_load_config("config/ca1m.yaml")),
                        JaxOracle(jseq, noise=noise, seed=det_seed))
    jworld = jpipe.run(jseq, gap=5, warmup=True)

    seq = SyntheticSequence(n_frames=n_frames, n_boxes=n_boxes, seed=seq_seed)
    pipe = OnlinePipeline(_small_caps(load_config("config/ca1m.yaml")),
                          OracleDetector(seq, noise=noise, seed=det_seed), device="cpu")
    world = pipe.run(seq, gap=5, warmup=True)

    _assert_same_world(jpipe, jworld, pipe, world, expect_fusion=fuses)


def _tiny_labelers(sim_thres):
    """The JAX labeler and the port's with the same tiny image tower (numpy
    weights carried across by models/clip/convert.py) and text features."""
    import jax.numpy as jnp

    from boxfusion_tpu.models.clip.head import OpenVocabLabeler as JaxLabeler
    from boxfusion_tpu.models.clip.model import CLIPConfig as JaxCLIPConfig
    from boxfusion_tpu.models.clip.model import CLIPImageTower as JaxTower

    from boxfusion_tpu_torch.models.clip import CLIPConfig, OpenVocabLabeler
    from boxfusion_tpu_torch.models.clip.convert import image_tower_from_flax

    kw = dict(patch=32, width=64, layers=2, heads=2, embed_dim=32)
    shapes = jax.eval_shape(JaxTower(JaxCLIPConfig(**kw)).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 224, 224, 3)))
    rng = np.random.RandomState(5)

    def fill(path, leaf):
        if getattr(path[-1], "key", "") == "scale":
            return np.ones(leaf.shape, np.float32)
        fan_in = int(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 4
        return (rng.randn(*leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    tf = rng.randn(6, 32).astype(np.float32)
    names = [f"class{i}" for i in range(6)]
    jlab = JaxLabeler(names, tf, image_params=jax.tree.map(jnp.asarray, params),
                      cfg=JaxCLIPConfig(**kw), sim_thres=sim_thres, max_boxes=8)
    lab = OpenVocabLabeler(names, tf, image_params=image_tower_from_flax(params),
                           cfg=CLIPConfig(**kw), sim_thres=sim_thres, max_boxes=8, device="cpu")
    return jlab, lab


def test_pipeline_with_labeler_matches_jax_host_engine():
    """The labelled host engine: oracle detections, a tiny CLIP labeler with
    the same weights on both sides, the CLIP score boost on, and a
    background threshold that drops some detections.  Identical init_id
    sets, categories (world rows and observation store) and fusion flags;
    coordinates at the engine bounds; carried features within 1e-4."""
    def caps(c):
        c = _small_caps(c)
        c["box_fusion"]._data["clip_sim_coeff"] = 1.0
        return c

    # the winning similarities of this run lie in 33.8 .. 37.2; the nearest to
    # 35.2 is 0.055 away, far above the 1e-3 the two sides differ by
    jlab, lab = _tiny_labelers(sim_thres=35.2)
    jseq = JaxSequence(n_frames=40, n_boxes=5, seed=1)
    jpipe = JaxPipeline(caps(jax_load_config("config/ca1m.yaml")),
                        JaxOracle(jseq, noise=0.02, seed=2), labeler=jlab)
    jworld = jpipe.run(jseq, gap=5, warmup=True)

    seq = SyntheticSequence(n_frames=40, n_boxes=5, seed=1)
    pipe = OnlinePipeline(caps(load_config("config/ca1m.yaml")),
                          OracleDetector(seq, noise=0.02, seed=2), labeler=lab, device="cpu")
    world = pipe.run(seq, gap=5, warmup=True)

    _assert_same_world(jpipe, jworld, pipe, world,
                       expect_fusion=bool(np.any(jpipe.manager.fusion_flag)))
    oj, ot = np.argsort(jworld.arrays["init_id"]), np.argsort(world.arrays["init_id"])
    assert [world.categories[i] for i in ot] == [jworld.categories[i] for i in oj]
    assert pipe.obs.categories == jpipe.obs.categories
    assert pipe.box_count == jpipe.box_count and len(pipe.obs.categories) == pipe.box_count
    cats = set(pipe.obs.categories)
    assert "" not in cats and "object" not in cats and len(cats) >= 1
    np.testing.assert_allclose(world.arrays["features"][ot], jworld.arrays["features"][oj],
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(world.arrays["scores"][ot], jworld.arrays["scores"][oj],
                               atol=1e-4, rtol=0)
    assert world.arrays["scores"].max() > 0.9  # boosted above the oracle's 0.9
    assert "label" in pipe.timings and pipe.timings["label"] > 0
    # the threshold did drop rows: fewer observations than an unlabelled run keeps
    plain = OnlinePipeline(caps(load_config("config/ca1m.yaml")),
                           OracleDetector(seq, noise=0.02, seed=2), device="cpu")
    plain.run(seq, gap=5, warmup=True)
    assert 0 < pipe.box_count < plain.box_count
    assert set(plain.obs.categories) == {"object"}


@pytest.mark.parametrize("n_frames,gap", [(8, 3), (7, 3), (15, 5)])
def test_keyframes_and_hooks_match_jax(n_frames, gap):
    """The last frame is always a keyframe (demo.py:200), with no double
    processing; on_frame fires per frame, on_keyframe per keyframe."""
    def trace(pipe_cls, seq, det, **kw):
        pipe = pipe_cls(_small_caps((jax_load_config if pipe_cls is JaxPipeline else load_config)(
            "config/ca1m.yaml")), det, **kw)
        seen, frames, worlds = [], [], []
        orig = pipe.process_keyframe

        def spy(frame):
            seen.append(pipe.count)
            return orig(frame)

        pipe.process_keyframe = spy
        pipe.run(seq, gap=gap, on_frame=frames.append, on_keyframe=lambda w: worlds.append(len(w)))
        return seen, len(frames), worlds

    jseq = JaxSequence(n_frames=n_frames, n_boxes=3, seed=4)
    seq = SyntheticSequence(n_frames=n_frames, n_boxes=3, seed=4)
    want = trace(JaxPipeline, jseq, JaxOracle(jseq))
    got = trace(OnlinePipeline, seq, OracleDetector(seq), device="cpu")
    assert got == want
    assert got[0][-1] == n_frames - 1 and got[1] == n_frames


class _Recorder:
    """Port detector that keeps each keyframe's detections by timestamp,
    with the encoder logits and the top-300 proposal ranking that the port's
    ``topk_stable`` chose for them (see ``_RankTap``)."""

    def __init__(self, det, tap):
        self.det, self.tap, self.seen = det, tap, {}

    def __call__(self, frame):
        out = self.det(frame)
        self.seen[frame.timestamp] = (out, self.tap.enc_logits, self.tap.ranking)
        return out


class _RankTap:
    """Stands in for the port model's ``topk_stable``.  It records the
    encoder's proposal ranking (the top-``num_queries`` call), or, when
    ``inject`` is set, returns that ranking instead: the port's decoder is
    then fed the proposals in JAX's order."""

    def __init__(self, topk):
        self.topk, self.inject = topk, None
        self.enc_logits = self.ranking = None

    def __call__(self, x, k):
        if k != NUM_QUERIES:
            return self.topk(x, k)
        if self.inject is not None:
            idx = self.inject[None].expand(x.shape[0], -1)
            return torch.gather(x, -1, idx), idx
        vals, idx = self.topk(x, k)
        self.enc_logits, self.ranking = x[0].detach().numpy().copy(), idx[0].numpy().copy()
        return vals, idx


NUM_QUERIES = 300                  # CuTRConfig.num_queries on both sides
ENC_TOL = 1e-4                     # encoder logits (measured 3.6e-6)
CUTR_BOUNDS = (("scores", 2e-3), ("pred_boxes", 0.5), ("boxes3d", 5e-3), ("R", 1e-3))


def _per_query(last, K, T_gravity):
    """Every decoder query's outputs, packaged as the detectors package their
    top 100 rows: scores per (query, class), cxcywh boxes, camera-frame
    xyzlhw, gravity-aligned R.  Numpy, float64 for the packaging."""
    f = {k: np.asarray(v, np.float64)[0] for k, v in last.items()
         if k in ("logits", "boxes", "proj_xy", "z_scaled", "dims", "pose")}
    uvz = np.concatenate([f["z_scaled"] * f["proj_xy"], f["z_scaled"]], -1)
    xyz = uvz @ np.linalg.inv(np.asarray(K, np.float64)).T
    return dict(scores=1.0 / (1.0 + np.exp(-f["logits"])), boxes=f["boxes"],
                boxes3d=np.concatenate([xyz, f["dims"][:, [2, 1, 0]]], -1),
                R=np.einsum("ij,njk->nik", np.asarray(T_gravity, np.float64), f["pose"]))


def _assert_rows_match(want, got, idx_j, idx_t, probs_j):
    """The final top-100 rows held as a set matched by (query, class), the
    index each row was taken from.  A row may take a place only where JAX's
    score of it lies within the score bound of JAX's score at that place
    (near-ties may swap); a row may be in one top 100 and not the other only
    when its JAX score lies within that bound of JAX's 100th; rows matched
    by index agree at the CuTR bounds."""
    tol = CUTR_BOUNDS[0][1]
    assert np.abs(probs_j[idx_t] - want["scores"]).max() <= tol
    for f in set(idx_j.tolist()) ^ set(idx_t.tolist()):
        assert abs(probs_j[f] - want["scores"][-1]) <= tol, f
    where = {f: r for r, f in enumerate(idx_t.tolist())}
    rows_j = [r for r, f in enumerate(idx_j.tolist()) if f in where]
    rows_t = [where[int(idx_j[r])] for r in rows_j]
    for k, bound in CUTR_BOUNDS:
        np.testing.assert_allclose(np.asarray(got[k])[rows_t], np.asarray(want[k])[rows_j],
                                   atol=bound, rtol=0, err_msg=k)


class _CheckedJaxDetector:
    """JAX CuTR detector held to the port's on every frame it is called on;
    it then hands the JAX engine the port's detections, so that the two host
    engines are compared on identical inputs.

    Held, per frame: the encoder logits within ENC_TOL; the port's top-300
    proposal ranking equal to JAX's except where the two proposals' JAX
    logits lie within ENC_TOL of each other; the port's decoder, fed JAX's
    ranking, against JAX's decoder query by query (queries aligned by
    proposal index) at the CuTR bounds (scores 2e-3, 2D boxes 0.5 px, 3D
    boxes 5 mm, R 1e-3); its final 100 rows against JAX's as a set (see
    ``_assert_rows_match``); and, where the two rankings are equal, the
    detections the port's engine consumed the same way.

    Why the ranking is fed across: the decoder's query at rank i takes the
    content embedding ``query_embed[i]``, so two proposals whose encoder
    logits tie to rounding (frame 0 here: -1.9792159 and -1.9792166, 7e-7
    apart, under the 3.6e-6 at which the stacks' encoder logits agree) swap
    embeddings when the stacks round them apart.  That one swap moved both
    queries' logits by up to 0.52 and, through self-attention, every other
    query's boxes by up to 3 px; fed the same ranking, the port's decoder
    agrees query by query within 2.5e-4 in logits and 1.4e-2 px (CPU, torch
    2.13 / jax 0.9)."""

    def __init__(self, model, params, port_outputs, port_det, tap):
        from boxfusion_tpu.data.preprocess import Preprocessor

        self.port, self.port_det, self.tap = port_outputs, port_det, tap
        self.pre = Preprocessor()
        # the detector's forward, with its per-query decoder outputs
        self.fwd = jax.jit(lambda b: model.apply(params, b, train=True))
        self.checked = self.reordered = 0

    def _port_forward(self, frame, ranking):
        from boxfusion_tpu_torch.data.preprocess import package_frame, resolve_pad_and_ratio

        square, ratio = resolve_pad_and_ratio(frame.image, frame.depth, self.port_det.buckets)
        batch = package_frame(torch.as_tensor(np.ascontiguousarray(frame.image)),
                              torch.as_tensor(np.asarray(frame.depth, np.float32)),
                              torch.as_tensor(np.asarray(frame.K, np.float32)),
                              torch.as_tensor(np.asarray(frame.T_gravity, np.float32)), square, ratio)
        self.tap.inject = torch.from_numpy(ranking.copy())
        try:
            with torch.no_grad():
                out = self.port_det.model(batch, train=True)
        finally:
            self.tap.inject = None
        return out, batch

    def __call__(self, frame):
        got, enc_t, rank_t = self.port[frame.timestamp]
        jb, _, _ = self.pre(frame.image, frame.depth, frame.K, frame.T_gravity)
        jout = self.fwd(jb)
        want = {k: np.asarray(v[0]) for k, v in jout.items() if k in got}
        enc_j = np.asarray(jout["enc_logits"][0, :, 0])
        np.testing.assert_allclose(enc_t, enc_j, atol=ENC_TOL, rtol=0, err_msg="encoder logits")
        rank_j = np.asarray(jax.lax.top_k(jnp.asarray(enc_j), NUM_QUERIES)[1])
        assert np.abs(enc_j[rank_t] - enc_j[rank_j]).max() <= ENC_TOL  # near-ties only
        same_rank = bool(np.array_equal(rank_t, rank_j))
        self.reordered += not same_rank

        tout, tb = self._port_forward(frame, rank_j)
        q_j = _per_query(jout["intermediates"][-1], jb.K[0], jb.T_gravity[0])
        q_t = _per_query({k: v.numpy() for k, v in tout["intermediates"][-1].items()},
                         tb.K[0].numpy(), tb.T_gravity[0].numpy())
        for k, bound in (("scores", 2e-3), ("boxes", 0.5), ("boxes3d", 5e-3), ("R", 1e-3)):
            np.testing.assert_allclose(q_t[k], q_j[k], atol=bound, rtol=0, err_msg=f"per query {k}")

        probs_j = np.asarray(jax.nn.sigmoid(jout["intermediates"][-1]["logits"][0])).reshape(-1)
        idx_j = np.asarray(jax.lax.top_k(jnp.asarray(probs_j), len(want["scores"]))[1])
        probs_t = torch.sigmoid(tout["intermediates"][-1]["logits"][0]).reshape(-1)
        idx_t = topk_stable(probs_t, len(want["scores"]))[1].numpy()
        fed = {k: v[0].numpy() for k, v in tout.items() if k in want}
        _assert_rows_match(want, fed, idx_j, idx_t, probs_j)
        if same_rank:  # the detections the port's engine took came from this decoder input
            _assert_rows_match(want, got, idx_j, idx_t, probs_j)
        self.checked += 1
        return {k: np.array(v) for k, v in got.items()}


def test_pipeline_cutr192_matches_jax_host_engine(monkeypatch):
    """A short CuTR-192 run: 10 frames at gap 5, random weights with the
    class bias lifted by +3.2 (bench.py's calibration) so that detections
    pass the 0.3 filter and association runs on real detector output.  Both
    CuTRs run on every keyframe and are held to each other
    (``_CheckedJaxDetector``); the engines are then held to each other on
    the port's detections."""
    from boxfusion_tpu.models.cutr import make_cutr as jax_make_cutr

    import boxfusion_tpu_torch.models.cutr.model as port_cutr
    from boxfusion_tpu_torch.models.cutr import make_cutr
    from boxfusion_tpu_torch.models.cutr.convert import from_flax_params
    from boxfusion_tpu_torch.runtime import CuTRDetector

    jseq = JaxSequence(n_frames=10, n_boxes=4, seed=0)
    jmodel = jax_make_cutr(dimension=192, depth_model=True)
    shapes = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0),
        jax.tree.map(np.asarray, _first_batch(jseq)),
    )
    rng = np.random.RandomState(0)

    def _init(path, leaf):
        keys = [getattr(p, "key", "") for p in path]
        if keys[-1] in ("scale",):
            return np.ones(leaf.shape, np.float32)
        fan_in = leaf.shape[-2] if len(leaf.shape) >= 2 else 1
        val = rng.normal(0.0, 1.0 / np.sqrt(max(fan_in, 1)), leaf.shape).astype(np.float32)
        if keys[-1] == "bias":
            val = np.zeros(leaf.shape, np.float32)
            if any("class_predictor" in k for k in keys):
                val += -np.log(99.0) + 3.2
        return val

    params = jax.tree_util.tree_map_with_path(_init, shapes)

    model = make_cutr(192, depth_model=True, device="cpu")
    model.load_state_dict(from_flax_params(params), strict=True)
    assert model.cfg.num_queries == jmodel.cfg.num_queries == NUM_QUERIES
    tap = _RankTap(port_cutr.topk_stable)
    monkeypatch.setattr(port_cutr, "topk_stable", tap)
    seq = SyntheticSequence(n_frames=10, n_boxes=4, seed=0)
    port_det = CuTRDetector(model, device="cpu")
    rec = _Recorder(port_det, tap)
    pipe = OnlinePipeline(_small_caps(load_config("config/ca1m.yaml")), rec, device="cpu")
    world = pipe.run(seq, gap=5)

    jdet = _CheckedJaxDetector(jmodel, jax.tree.map(jnp.asarray, params), rec.seen, port_det, tap)
    jpipe = JaxPipeline(_small_caps(jax_load_config("config/ca1m.yaml")), jdet)
    jworld = jpipe.run(jseq, gap=5)

    assert jdet.checked == 1 + 3  # the warm-up call + keyframes 0, 5, 9
    assert len(world) > 0
    _assert_same_world(jpipe, jworld, pipe, world, expect_fusion=bool(np.any(jpipe.manager.fusion_flag)))


def _first_batch(seq):
    from boxfusion_tpu.data.preprocess import Preprocessor

    fr = next(iter(seq))
    batch, _, _ = Preprocessor()(fr.image, fr.depth, fr.K, fr.T_gravity)
    return batch
