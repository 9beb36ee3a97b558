"""The port's device-resident pipeline against the JAX package's device engine.

The scenarios of tests/test_device_pipeline.py and tests/test_unrolled_engine.py
(its ``loops`` engine, the port's one step) at their sizes (capacity 48-64,
16 detections, 128 particles, 5 views), each streamed through
``boxfusion_tpu.runtime.device_pipeline.DevicePipeline`` and through the
port's on ``device="cpu"`` (the fitness kernel's plain twin).  The two
device engines are held to each other, never to a host engine: the engines
differ by design (per-slot ``already``, the NMS tie order).

Tolerances: ``init_id``, ``fusion_flag``, ``fusion_list``, ``valid_num``,
``category``, ``frame_id`` and ``stats`` identical; ``xyzlhw`` within 5e-3
where a box was fused (PST coordinates are chaotic across stacks) and 1e-5
where not; R within 1e-5; boosted scores within 1e-4; two runs of the port
on one sequence equal each other to 1e-6.
"""
import dataclasses
import pickle

import numpy as np
import pytest
import torch
import yaml

from boxfusion_tpu import cli as jax_cli
from boxfusion_tpu.data.synthetic import OracleDetector as JaxOracle
from boxfusion_tpu.data.synthetic import SyntheticSequence as JaxSequence
from boxfusion_tpu.runtime.device_pipeline import DevicePipeline as JaxDevicePipeline
from boxfusion_tpu.utils.config import load_config as jax_load_config

from boxfusion_tpu_torch import cli
from boxfusion_tpu_torch.data.synthetic import OracleDetector, SyntheticSequence
from boxfusion_tpu_torch.runtime import DevicePipeline, device_step
from boxfusion_tpu_torch.runtime.device_pipeline import step_config_from
from boxfusion_tpu_torch.runtime.device_state import init_state, state_from_numpy, state_to_numpy
from boxfusion_tpu_torch.utils.config import load_config

torch.set_num_threads(2)

FUSED_TOL, FLOAT_TOL, SCORE_TOL, ENGINE_TOL = 5e-3, 1e-5, 1e-4, 1e-6


def _cfg(load=load_config, engine=None, iters=6, **over):
    c = load("config/ca1m.yaml")
    c["data"]._data["gap"] = 5
    c["detection"]._data["score_thresh"] = 0.3
    c["detection"]._data["uv_bound"] = False
    c["detection"]._data["floor_mask"] = False
    c["detection"]._data["max_detections"] = 16
    c["box_fusion"]._data["pst_path"] = None
    c["box_fusion"]._data["pst_size"] = 128
    c["box_fusion"]._data["iters"] = iters
    c["box_fusion"]._data["max_fusions_per_frame"] = 4
    c["association"]._data["max_views"] = 5
    if engine is not None:
        c["association"]._data["engine"] = engine
    for k, v in over.items():
        sect, key = k.split(".")
        c[sect]._data[key] = v
    return c


def _jax_world(noise, seed, n_frames=25, n_boxes=4, capacity=48, **over):
    seq = JaxSequence(n_frames=n_frames, n_boxes=n_boxes, seed=seed)
    pipe = JaxDevicePipeline(_cfg(jax_load_config, **over), JaxOracle(seq, noise=noise, seed=seed + 1),
                             capacity=capacity)
    return pipe.run(seq, gap=5)


def _torch_run(noise, seed, n_frames=25, n_boxes=4, capacity=48, **over):
    seq = SyntheticSequence(n_frames=n_frames, n_boxes=n_boxes, seed=seed)
    pipe = DevicePipeline(_cfg(**over), OracleDetector(seq, noise=noise, seed=seed + 1),
                          capacity=capacity, device="cpu")
    return seq, pipe, pipe.run(seq, gap=5)


def assert_worlds_match(got, want, score_tol=FLOAT_TOL, fused_tol=FUSED_TOL):
    """The port's exported world against the JAX device engine's."""
    assert list(got) == list(want)
    for k in ("init_id", "fusion_flag", "valid_num", "category", "frame_id"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["fusion_list"] == want["fusion_list"]
    assert got["stats"] == want["stats"]
    if "categories" in want:
        assert got["categories"] == want["categories"]
    tol = np.where(np.asarray(want["fusion_flag"], bool), fused_tol, FLOAT_TOL)[:, None]
    assert (np.abs(got["xyzlhw"] - want["xyzlhw"]) <= tol).all(), np.abs(got["xyzlhw"] - want["xyzlhw"])
    np.testing.assert_allclose(got["R"], want["R"], atol=FLOAT_TOL, rtol=0)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=score_tol, rtol=0)
    np.testing.assert_allclose(got["pred_boxes"], want["pred_boxes"], atol=1e-4, rtol=0)


def assert_engines_equal(wa, wb):
    """tests/test_unrolled_engine.py:47-53."""
    for k in ("init_id", "fusion_flag", "valid_num", "category"):
        np.testing.assert_array_equal(wa[k], wb[k], err_msg=k)
    assert wa["fusion_list"] == wb["fusion_list"] and wa["stats"] == wb["stats"]
    np.testing.assert_allclose(wa["xyzlhw"], wb["xyzlhw"], atol=ENGINE_TOL, rtol=0)
    np.testing.assert_allclose(wa["scores"], wb["scores"], atol=1e-7, rtol=0)


# ------------------------------------------------------- against ground truth
def test_device_matches_gt_and_jax_noiseless():
    seq, pipe, world = _torch_run(0.0, 0, n_frames=30, n_boxes=5, capacity=64)
    assert len(world["scores"]) == seq.n_boxes
    d = np.linalg.norm(world["xyzlhw"][:, None, :3] - seq.gt_xyzlhw[None, :, :3], axis=-1).min(axis=0)
    assert np.all(d < 0.05), d
    assert pipe.host_reads > 0 and world["stats"]["keyframes"] == 7
    assert_worlds_match(world, _jax_world(0.0, 0, n_frames=30, n_boxes=5, capacity=64))


@pytest.mark.parametrize("noise,seed,fused_tol", [(0.02, 3, FUSED_TOL), (0.02, 7, 3e-2),
                                                  (0.04, 1, 3e-2), (0.05, 3, FUSED_TOL)])
def test_device_matches_jax_noisy_through_fusion(noise, seed, fused_tol):
    """Decisions, lists, counters and every unfused float identical in all
    three.  Fused coordinates: the two stacks' fitness values agree to 2e-3
    only, a particle on the edge of beating particle 0 flips, and a 6-step,
    128-particle search then ends elsewhere.  In the first case every fused
    box holds 5e-3; in each of the other two ONE box of four ends up to
    2.9e-2 away (its dims; the other three hold 2e-5), so they state 3e-2."""
    seq, _, world = _torch_run(noise, seed, n_frames=40)
    want = _jax_world(noise, seed, n_frames=40)
    assert world["fusion_flag"].any() and len(world["scores"]) >= seq.n_boxes
    d = np.linalg.norm(world["xyzlhw"][:, None, :3] - seq.gt_xyzlhw[None, :, :3], axis=-1).min(axis=0)
    assert np.all(d < 0.15), d
    assert_worlds_match(world, want, fused_tol=fused_tol)


# -------------------------------------------------------------- with a labeler
def _labelers(sim_thres):
    """A JAX labeler and the port's with the same tiny tower and text features."""
    import jax
    import jax.numpy as jnp

    from boxfusion_tpu.models.clip import head as jax_head
    from boxfusion_tpu_torch.models.clip import convert, head
    from tests.test_torch_clip import JAX_TINY, TINY, _image_tower_pair

    tf = np.random.RandomState(0).randn(4, TINY.embed_dim).astype(np.float32)
    names = ["chair", "table", "sofa", "lamp"]
    _, params, _ = _image_tower_pair(seed=13)
    jlab = jax_head.OpenVocabLabeler(names, tf, image_params=jax.tree.map(jnp.asarray, params),
                                     cfg=JAX_TINY, sim_thres=sim_thres, max_boxes=16)
    lab = head.OpenVocabLabeler(names, tf, image_params=convert.image_tower_from_flax(params),
                                cfg=TINY, sim_thres=sim_thres, max_boxes=16, device="cpu")
    return jlab, lab


class _ImageOracle:
    """Oracle detections as device arrays plus the device image: the branch
    that labels through label_boost_device."""

    def __init__(self, oracle, to_array):
        self.oracle, self.to_array = oracle, to_array

    def __call__(self, frame):
        det = {k: self.to_array(v) for k, v in self.oracle(frame).items()}
        det["image_dev"] = self.to_array(np.asarray(frame.image, np.float32))
        return det


@pytest.fixture(scope="module")
def labelled_worlds():
    """Both labelling branches of both packages on one sequence."""
    import jax.numpy as jnp

    over = {"box_fusion.clip_sim_coeff": 2.0}
    jlab, lab = _labelers(-1e9)
    out = {}
    jseq = JaxSequence(n_frames=15, n_boxes=3, seed=5)
    seq = SyntheticSequence(n_frames=15, n_boxes=3, seed=5)
    out["jax_host"] = JaxDevicePipeline(_cfg(jax_load_config, **over), JaxOracle(jseq, noise=0.0),
                                        labeler=jlab, capacity=64).run(jseq, gap=5)
    out["jax_device"] = JaxDevicePipeline(
        _cfg(jax_load_config, **over), _ImageOracle(JaxOracle(jseq, noise=0.0), jnp.asarray),
        labeler=jlab, capacity=64).run(jseq, gap=5)
    pipe = DevicePipeline(_cfg(**over), OracleDetector(seq, noise=0.0), labeler=lab, capacity=64, device="cpu")
    out["torch_host"] = pipe.run(seq, gap=5)
    assert pipe.step_cfg.score_thresh == -1e8 and "label" in pipe.timings
    out["torch_device"] = DevicePipeline(
        _cfg(**over), _ImageOracle(OracleDetector(seq, noise=0.0), torch.as_tensor),
        labeler=lab, capacity=64, device="cpu").run(seq, gap=5)
    return out


@pytest.mark.parametrize("branch", ["host", "device"])
def test_device_with_labeler_matches_jax(labelled_worlds, branch):
    """numpy detections through the labeler's call and the packed buffer
    (host), tensors plus the device image through label_boost_device
    (device): categories, boosted scores and worlds as the JAX engine's."""
    got, want = labelled_worlds[f"torch_{branch}"], labelled_worlds[f"jax_{branch}"]
    assert len(got["scores"]) == 3
    assert all(c in ("chair", "table", "sofa", "lamp") for c in got["categories"])
    assert_worlds_match(got, want, score_tol=SCORE_TOL)
    # and the two branches agree with each other, as in the JAX package
    other = labelled_worlds["torch_device" if branch == "host" else "torch_host"]
    assert got["categories"] == other["categories"]
    np.testing.assert_allclose(got["scores"], other["scores"], atol=SCORE_TOL, rtol=0)


def test_device_labeling_background_dropped_and_budget_overflow(capsys):
    """sim_thres above every similarity labels everything background: the
    step drops every detection.  A label budget below the detection count is
    counted and warned about, not silent."""
    _, lab = _labelers(1e9)
    seq = SyntheticSequence(n_frames=10, n_boxes=3, seed=5)
    det = _ImageOracle(OracleDetector(seq, noise=0.0), torch.as_tensor)
    world = DevicePipeline(_cfg(), det, labeler=lab, capacity=64, device="cpu").run(seq, gap=5)
    assert len(world["scores"]) == 0

    _, lab = _labelers(-1e9)
    capsys.readouterr()
    world = DevicePipeline(_cfg(**{"detection.max_label_boxes": 2}), det, labeler=lab, capacity=64,
                           device="cpu").run(seq, gap=5)
    assert world["stats"]["label_overflow"] == 3  # 3 boxes, 3 keyframes, budget 2
    assert "exceeded the CLIP label budget" in capsys.readouterr().out


# ------------------------------------------------------------------ edge cases
def test_device_empty_keyframes():
    class EmptyDetector:
        def __call__(self, frame):
            return dict(scores=np.zeros(0, np.float32), pred_boxes=np.zeros((0, 4), np.float32),
                        boxes3d=np.zeros((0, 6), np.float32), R=np.zeros((0, 3, 3), np.float32),
                        proj_xy=np.zeros((0, 2), np.float32))

    seq = SyntheticSequence(n_frames=10, n_boxes=3, seed=2)
    pipe = DevicePipeline(_cfg(), EmptyDetector(), capacity=64, device="cpu")
    world = pipe.run(seq, gap=5)
    assert len(world["scores"]) == 0 and world["stats"]["keyframes"] == 3
    assert pipe.run(seq, gap=5, export=False) is None


def test_device_resident_detections_match_numpy_path():
    """Tensor detections take keyframe_step_devdet (nothing read back, rows
    past max_detections truncated) and give the world of the packed path."""
    seq = SyntheticSequence(n_frames=30, n_boxes=5, seed=0)
    oracle = OracleDetector(seq, noise=0.0)

    class DeviceOracle:
        def __call__(self, frame):
            det = {k: torch.as_tensor(v) for k, v in oracle(frame).items()}
            pad = 20 - det["scores"].shape[0]  # junk rows beyond max_detections = 16
            det = {k: torch.cat([v, torch.zeros((pad,) + v.shape[1:], dtype=v.dtype)]) for k, v in det.items()}
            det["scores"][-pad:] = -1e9
            return det

    ref = DevicePipeline(_cfg(), oracle, capacity=64, device="cpu").run(seq, gap=5)
    dev = DevicePipeline(_cfg(), DeviceOracle(), capacity=64, device="cpu").run(seq, gap=5)
    assert_engines_equal(dev, ref)


def _step_meta(frame_idx):
    K = np.array([[100.0, 0, 64], [0, 100.0, 64], [0, 0, 1]], np.float32)
    m = np.zeros(device_step.META_WIDTH, np.float32)
    m[:16], m[16:25], m[25:34], m[34:36], m[36] = np.eye(4).ravel(), K.ravel(), K.ravel(), (128.0, 128.0), frame_idx
    return m


def _step_det(centers, scores):
    n = len(centers)
    return dict(
        scores=torch.as_tensor(np.asarray(scores, np.float32)),
        pred_boxes=torch.as_tensor(np.tile([10, 10, 30, 30.0], (n, 1)).astype(np.float32)),
        boxes3d=torch.as_tensor(np.concatenate([np.asarray(centers, np.float32),
                                                np.full((n, 3), 0.4, np.float32)], 1)),
        R=torch.eye(3).repeat(n, 1, 1),
        proj_xy=torch.zeros(n, 2),
        category=torch.zeros(n, dtype=torch.int32),
    )


def test_world_capacity_overflow_drops_not_corrupts():
    """When the world buffer fills, excess detections are dropped and
    counted; existing rows stay intact (tests/test_device_pipeline.py:158)."""
    cap, kmax = 8, 6
    state = init_state(capacity=cap, max_views=5, obs_capacity=12, device="cpu")
    cfg = device_step.StepConfig(score_thresh=0.1, fusion_use=False, nms_threshold=0.1,
                                 uv_bound=False, floor_mask=False)
    pst = torch.zeros(128, 6)

    def det_at(xoff):  # 6 well-separated boxes in front of the camera
        centers = np.stack([np.linspace(-5, 5, 6) + xoff, np.zeros(6), np.full(6, 3.0)], 1)
        return _step_det(centers, np.linspace(0.9, 0.5, 6))

    state = device_step.keyframe_step_devdet(state, det_at(0.0), _step_meta(0), pst, cfg, kmax)
    first = state.xyzlhw[:6].clone()
    assert int(state.n) == 6
    state = device_step.keyframe_step_devdet(state, det_at(100.0), _step_meta(1), pst, cfg, kmax)
    assert int(state.n) == cap  # clamped, not wrapped
    torch.testing.assert_close(state.xyzlhw[:6], first, atol=1e-5, rtol=0)
    assert state.stats[:2].tolist() == [4, 0]
    # the two that fit are the two best-scoring new rows
    torch.testing.assert_close(state.scores[6:8], torch.tensor([0.9, 0.82]), atol=1e-6, rtol=0)
    # observation bank: 12 slots, 8 used; with room in the world again a
    # third keyframe can bank 4 of its 6 only
    state = dataclasses.replace(state, n=torch.tensor(2, dtype=torch.int32))
    state = device_step.keyframe_step_devdet(state, det_at(200.0), _step_meta(2), pst, cfg, kmax)
    assert int(state.obs_n) == 12 and int(state.n) == 6 and state.stats[:2].tolist() == [4, 2]


def test_device_check_valid_drops_unreobserved():
    """box_fusion.check_valid: a box never re-observed within one keyframe
    gap is dropped (tests/test_device_pipeline.py:215)."""
    gap = 5
    cfg = device_step.StepConfig(score_thresh=0.1, fusion_use=False, uv_bound=False, floor_mask=False,
                                 check_valid=True, gap=gap)
    state = init_state(capacity=16, max_views=5, obs_capacity=64, device="cpu")
    pst = torch.zeros(128, 6)
    A, B = [0.0, 0.0, 3.0], [4.0, 0.0, 3.0]
    state = device_step.keyframe_step_devdet(state, _step_det([A, B], [0.8, 0.8]), _step_meta(0), pst, cfg, 4)
    assert int(state.n) == 2
    state = device_step.keyframe_step_devdet(state, _step_det([A], [0.8]), _step_meta(gap), pst, cfg, 4)
    assert int(state.n) == 2
    state = device_step.keyframe_step_devdet(state, _step_det([A], [0.8]), _step_meta(2 * gap), pst, cfg, 4)
    assert int(state.n) == 1
    np.testing.assert_allclose(state.xyzlhw[0, :3].numpy(), A, atol=1e-4)


def test_worker_error_propagates_mid_run(monkeypatch):
    """A keyframe-step failure surfaces on a LATER call, not silently and not
    from the call that ran the step (tests/test_device_pipeline.py:392; the
    port has no worker thread, the contract is the same); flush raises it
    too, and the pipeline goes on afterwards."""
    seq = SyntheticSequence(n_frames=10, n_boxes=3, seed=0)
    frames = list(seq)
    pipe = DevicePipeline(_cfg(), OracleDetector(seq), capacity=64, device="cpu")

    def boom(*a, **k):
        raise ValueError("injected step failure")

    with monkeypatch.context() as m:
        m.setattr(device_step, "keyframe_step_packed", boom)
        pipe.process_keyframe(frames[0])  # fails inside the step, does not raise
    with pytest.raises(RuntimeError, match="earlier device keyframe step failed") as e:
        pipe.process_keyframe(frames[5])  # surfaced here, not lost
    assert isinstance(e.value.__cause__, ValueError)
    with monkeypatch.context() as m:
        m.setattr(device_step, "keyframe_step_packed", boom)
        pipe.process_keyframe(frames[5])
        with pytest.raises(RuntimeError, match="step failed"):
            pipe.flush()
    pipe.process_keyframe(frames[5])
    pipe.flush()
    assert int(pipe.state.n) == 3


# ------------------------------------------------------------ dense overlaps
def test_engine_parity_dense_overlaps_and_jax():
    """Heavy contention: jittered duplicates of every box force suppression
    chains, keep-swaps and correspondence merges
    (tests/test_unrolled_engine.py:63), against the JAX loops engine."""

    class CrowdedDetector:
        def __init__(self, seq, seed, oracle_cls):
            self.oracle = oracle_cls(seq, noise=0.02, seed=seed)
            self.rng = np.random.RandomState(seed + 7)

        def __call__(self, frame):
            det = self.oracle(frame)
            n = len(det["scores"])
            if n == 0:
                return det
            out = {}
            for k, v in det.items():
                dup = np.asarray(v).copy()
                if k == "scores":
                    dup = dup * self.rng.uniform(0.8, 1.2, dup.shape).astype(dup.dtype)
                elif k == "boxes3d":
                    dup[:, :3] += self.rng.uniform(-0.03, 0.03, (n, 3))
                out[k] = np.concatenate([np.asarray(v), dup], axis=0)
            return out

    seq = SyntheticSequence(n_frames=20, n_boxes=5, seed=11)
    got = DevicePipeline(_cfg(), CrowdedDetector(seq, 11, OracleDetector), capacity=48,
                         device="cpu").run(seq, gap=5)
    jseq = JaxSequence(n_frames=20, n_boxes=5, seed=11)
    want = JaxDevicePipeline(_cfg(jax_load_config), CrowdedDetector(jseq, 11, JaxOracle),
                             capacity=48).run(jseq, gap=5)
    assert_worlds_match(got, want)
    assert sum(v for v in want["valid_num"]) > 0


def test_step_config_from_config():
    sc = step_config_from(_cfg(engine="auto"))
    assert sc.opt.fitness_impl == "kernel"
    assert (sc.max_fusions, sc.gap, sc.opt.iters) == (4, 5, 6)
    sc2 = step_config_from(_cfg(**{"box_fusion.fitness_impl": "xla"}))
    assert sc2.opt.fitness_impl == "reference"
    with pytest.raises(ValueError, match="engine"):
        step_config_from(_cfg(engine="bogus"))
    with pytest.raises(ValueError, match="fitness_impl"):
        step_config_from(_cfg(**{"box_fusion.fitness_impl": "bogus"}))
    # the same values as the JAX package reads from the same file, in every
    # field the two packages share
    from boxfusion_tpu.runtime.device_pipeline import step_config_from as jax_step_config_from

    want = dataclasses.asdict(jax_step_config_from(_cfg(jax_load_config)))
    got = dataclasses.asdict(sc)
    for k, v in got.items():
        if k != "opt":
            assert v == want[k], k
    for k in ("iters", "center_init_size", "shape_scaling_coefficient", "beta"):
        assert got["opt"][k] == want["opt"][k], k


@pytest.mark.parametrize("engine", ["loops", "unrolled"])
def test_step_config_from_engine_key(engine):
    """association.engine: "loops" names the port's one step, as "auto"
    does; the JAX package's "unrolled" is refused, not run as "loops"."""
    if engine == "loops":
        assert step_config_from(_cfg(engine="loops")) == step_config_from(_cfg(engine="auto"))
    else:
        with pytest.raises(ValueError, match="one step engine"):
            step_config_from(_cfg(engine=engine))


# ------------------------------------------------- state carried across stacks
def test_jax_state_handed_over_mid_sequence(tmp_path):
    """The JAX device engine streams the first 20 frames; its state crosses
    as the {field: ndarray} tree of its snapshot code; the port streams the
    rest and ends in the world of the uninterrupted JAX run.  The port's own
    save_state / restore_state round trip resumes the same way."""
    noise, seed, n_frames, cut = 0.02, 3, 40, 20
    want = _jax_world(noise, seed, n_frames=n_frames)

    jseq = JaxSequence(n_frames=n_frames, n_boxes=4, seed=seed)
    jdet = JaxOracle(jseq, noise=noise, seed=seed + 1)
    jpipe = JaxDevicePipeline(_cfg(jax_load_config), jdet, capacity=48)
    frames = list(jseq)
    for f in frames[:cut]:  # the oracle draws its noise per call: keyframes only, as run() does
        if jpipe.count % 5 == 0:
            jpipe.process_keyframe(f)
        jpipe.count += 1
    jpipe.flush()
    tree = {f.name: np.asarray(getattr(jpipe.state, f.name)) for f in dataclasses.fields(jpipe.state)}

    seq = SyntheticSequence(n_frames=n_frames, n_boxes=4, seed=seed)
    det = OracleDetector(seq, noise=noise, seed=seed + 1)
    det.rng = jdet.rng  # the noise stream goes on where the JAX run left it
    pipe = DevicePipeline(_cfg(), det, capacity=48, device="cpu")
    pipe.state = state_from_numpy(tree, device="cpu")
    pipe.count = cut
    rest = list(seq)[cut:]
    got = pipe.run(rest, gap=5)
    assert_worlds_match(got, want)

    # the port's own snapshot: save at the cut, restore into a fresh pipeline
    _, _, straight = _torch_run(noise, seed, n_frames=n_frames)
    det = OracleDetector(seq, noise=noise, seed=seed + 1)
    a = DevicePipeline(_cfg(), det, capacity=48, device="cpu")
    for f in list(seq)[:cut]:
        if a.count % 5 == 0:
            a.process_keyframe(f)
        a.count += 1
    path = str(tmp_path / "mid.pt")
    a.save_state(path)
    b = DevicePipeline(_cfg(), det, capacity=48, device="cpu")
    b.restore_state(path, count=a.count)
    for name, x in state_to_numpy(a.state).items():
        np.testing.assert_array_equal(state_to_numpy(b.state)[name], x, err_msg=name)
    assert_engines_equal(b.run(rest, gap=5), straight)
    b.reset()
    assert int(b.state.n) == 0 and b.count == 0 and b.state.capacity == 48


# ----------------------------------------------------------------------- CLIs
def _cli_cfg(tmp_path, name):
    with open("config/ca1m.yaml") as f:
        raw = yaml.safe_load(f)
    raw["data"]["gap"] = 5
    raw["data"]["output_dir"] = str(tmp_path / name)
    raw["detection"].update(score_thresh=0.3, uv_bound=False, floor_mask=False,
                            compute_dtype="float32", max_detections=16)
    raw["box_fusion"].update(pst_path=None, pst_size=128, iters=4, max_fusions_per_frame=4)
    raw["association"]["max_views"] = 5
    raw["vis"]["rerun"] = False
    raw["eval"] = True
    p = tmp_path / f"{name}.yaml"
    p.write_text(yaml.safe_dump(raw))
    return str(p)


def _corners(path):
    with open(path, "rb") as f:
        saved = pickle.load(f)
    return np.stack([np.asarray(e[1]) for e in saved[0]])


def test_cli_device_engine_matches_jax_cli_and_resumes(tmp_path, capsys):
    """``--engine device --capacity 48`` of the two CLIs: the same world-box
    count and eval corners within the fused tolerance.  Then the port's
    --save-state and --restore-state --restore-count reproduce the
    uninterrupted world."""
    assert jax_cli.main(["synthetic", "--config", _cli_cfg(tmp_path, "jax"),
                         "--engine", "device", "--capacity", "48"]) == 0
    jax_out = capsys.readouterr().out
    assert cli.main(["synthetic", "--config", _cli_cfg(tmp_path, "torch"), "--engine", "device",
                     "--capacity", "48", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "device engine: 6 world boxes" in out and "device engine: 6 world boxes" in jax_out
    want = _corners(tmp_path / "jax" / "synthetic_boxes.pkl")
    got = _corners(tmp_path / "torch" / "synthetic_boxes.pkl")
    assert got.shape == want.shape == (6, 8, 3)
    np.testing.assert_allclose(got, want, atol=FUSED_TOL, rtol=0)

    # snapshot after the run; a second process-like run restores it, skips the
    # 60 frames already streamed (tests/test_cli.py:91) and writes the same world
    snap = str(tmp_path / "snap.pt")
    assert cli.main(["synthetic", "--config", _cli_cfg(tmp_path, "saved"), "--engine", "device",
                     "--capacity", "48", "--device", "cpu", "--save-state", snap]) == 0
    assert "saved pipeline state" in capsys.readouterr().out
    assert cli.main(["synthetic", "--config", _cli_cfg(tmp_path, "resumed"), "--engine", "device",
                     "--capacity", "48", "--device", "cpu", "--restore-state", snap,
                     "--restore-count", "60"]) == 0
    assert "resumed pipeline state" in capsys.readouterr().out
    np.testing.assert_array_equal(_corners(tmp_path / "resumed" / "synthetic_boxes.pkl"),
                                  _corners(tmp_path / "saved" / "synthetic_boxes.pkl"))
    np.testing.assert_array_equal(_corners(tmp_path / "saved" / "synthetic_boxes.pkl"), got)
