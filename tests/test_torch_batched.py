"""The port's batched engine (runtime/batched.py) on the CPU, against the JAX
package's BatchedPipeline once and against the port's own device and fused
engines (held to JAX in tests/test_torch_device_pipeline.py and
tests/test_torch_fused.py) otherwise.

The scenarios of tests/test_batched.py, at their sizes (CuTR-192, capacity
64, 16 detections, 128 particles, 4 iterations, 5 views, 6-16 frames), with
the committed trained CuTR-192 fixture as the detector, at gap 2 (fusion
happens).

Tolerances:
- a lane against a single-sequence run of the port: ``init_id``,
  ``fusion_flag``, ``fusion_list``, ``valid_num``, ``category``, ``frame_id``
  and ``stats`` identical; R, scores and the boxes never fused within 1e-4
  (the bound of tests/test_batched.py: the CuTR forward at batch N rounds
  apart from batch 1, by up to 4e-5 here); fused boxes within 5e-3 (the
  fused-coordinate bound of tests/test_torch_device_pipeline.py: the PST
  search moves its end by more than its inputs moved, up to 6.7e-4 here);
- packed against arrays at f32 depth: the same bounds (the two transports
  package the same frames; measured 0);
- the port's batched engine against JAX's (arrays, 2 lanes): the integers
  identical; ``xyzlhw`` within 5e-3, R within 1e-3, scores within 2e-3 (the
  CuTR-192 bounds of tests/test_torch_cutr.py: each package runs its own
  CuTR).
"""
import numpy as np
import pytest
import torch

from boxfusion_tpu_torch.data.synthetic import SyntheticSequence
from boxfusion_tpu_torch.runtime import BatchedPipeline, CuTRDetector, DevicePipeline, FusedDevicePipeline
from tests.test_torch_fused import (
    CLASSES,
    FIXTURE,
    FUSED_TOL,
    JAX_BOX_TOL,
    JAX_R_TOL,
    JAX_SCORE_TOL,
    assert_same_world,
    cfg_for,
    load_fixture_model,
    make_labeler,
    mm_frames,
)

torch.set_num_threads(2)

LANE_TOL = 1e-4


@pytest.fixture(scope="module")
def model():
    return load_fixture_model()


def _device_world(model, frames, **over):
    return DevicePipeline(cfg_for(**over), CuTRDetector(model, device="cpu", device_output=True),
                          capacity=64, device="cpu").run(frames, gap=2)


@pytest.fixture(scope="module")
def two_lanes(model):
    """Two sequences through the arrays transport, exported after the run."""
    seqs = [list(SyntheticSequence(n_frames=11, n_boxes=3, seed=s)) for s in range(2)]
    pipe = BatchedPipeline(cfg_for(), CuTRDetector(model, device="cpu"), n_lanes=2, capacity=64,
                           device="cpu")
    assert pipe.run([iter(s) for s in seqs], gap=2, export=False) is None
    assert pipe.host_reads > 0 and pipe.rounds == 6 and len(pipe.lane_fps) == 2
    return pipe, seqs, pipe.export_worlds()


def test_batched_arrays_matches_jax_batched(two_lanes):
    """The JAX BatchedPipeline, arrays transport, 2 lanes, the fixture weights."""
    from boxfusion_tpu.data.synthetic import SyntheticSequence as JaxSequence
    from boxfusion_tpu.models.cutr import make_cutr as jax_make_cutr
    from boxfusion_tpu.models.cutr.convert import load_checkpoint
    from boxfusion_tpu.runtime.batched import BatchedPipeline as JaxBatched
    from boxfusion_tpu.runtime.detector import CuTRDetector as JaxCuTRDetector
    from boxfusion_tpu.utils.config import load_config as jax_load_config

    _, _, worlds = two_lanes
    params, dim, depth_model = load_checkpoint(FIXTURE)
    jpipe = JaxBatched(cfg_for(jax_load_config),
                       JaxCuTRDetector(jax_make_cutr(dimension=dim, depth_model=depth_model), params),
                       n_lanes=2, capacity=64)
    want = jpipe.run([iter(JaxSequence(n_frames=11, n_boxes=3, seed=s)) for s in range(2)], gap=2)
    assert any(w["fusion_flag"].any() for w in want)
    for got, w in zip(worlds, want):
        assert_same_world(got, w, tol=JAX_BOX_TOL, r_tol=JAX_R_TOL, score_tol=JAX_SCORE_TOL)


def test_batched_lanes_match_single_pipelines(model, two_lanes):
    """Lanes of different lengths (the middle one exhausts first and goes
    inactive) each build the world of a dedicated DevicePipeline; so do the
    lanes of the deferred export."""
    seqs = [list(SyntheticSequence(n_frames=n, n_boxes=3, seed=s))
            for s, n in enumerate((11, 4, 13))]
    pipe = BatchedPipeline(cfg_for(), CuTRDetector(model, device="cpu"), n_lanes=3, capacity=64,
                           device="cpu")
    worlds = pipe.run([iter(s) for s in seqs], gap=2)
    assert len(worlds) == 3 and pipe.keyframes == 6 + 3 + 7
    for got, frames in zip(worlds, seqs):
        assert_same_world(got, _device_world(model, frames), tol=LANE_TOL, fused_tol=FUSED_TOL)
    _, seqs, worlds = two_lanes
    assert_same_world(worlds[1], _device_world(model, seqs[1]), tol=LANE_TOL, fused_tol=FUSED_TOL)


def test_batched_reset_tail_group(model, two_lanes):
    """One pipeline reused across groups: reset() clears the lanes; a tail
    group smaller than n_lanes runs with the spare lane inactive."""
    pipe = two_lanes[0]
    pipe.reset()
    assert all(int(s.n) == 0 and int(s.stats[3]) == 0 for s in pipe.states)
    tail = list(SyntheticSequence(n_frames=6, n_boxes=3, seed=2))
    (world,) = pipe.run([iter(tail)], gap=2)
    assert len(pipe.lane_fps) == 1 and int(pipe.states[1].stats[3]) == 0
    assert_same_world(world, _device_world(model, tail), tol=LANE_TOL, fused_tol=FUSED_TOL)


def test_packed_transport_matches_arrays(model, two_lanes):
    """One stacked byte upload a round builds the arrays transport's worlds;
    f32 depth is bit-exact, u16 depth quantises to millimetres (runs, same
    keyframe count)."""
    _, seqs, worlds = two_lanes
    packed = BatchedPipeline(cfg_for(), CuTRDetector(model, device="cpu"), n_lanes=2, capacity=64,
                             transport="packed", depth_mode="f32", device="cpu")
    for got, want in zip(packed.run([iter(s) for s in seqs], gap=2), worlds):
        assert_same_world(got, want, tol=LANE_TOL, fused_tol=FUSED_TOL)
    u16 = BatchedPipeline(cfg_for(), CuTRDetector(model, device="cpu"), n_lanes=2, capacity=64,
                          transport="packed", depth_mode="u16", device="cpu")
    for got, want in zip(u16.run([iter(s) for s in seqs], gap=2), worlds):
        assert got["stats"]["keyframes"] == want["stats"]["keyframes"]


def test_packed_with_labeler_matches_fused(model):
    """Packed transport with open-vocab labels: every lane's world (boxes,
    boosted scores, categories, overflow counter) is that of a dedicated
    FusedDevicePipeline run with the fixed budget; one tower call a round
    over 2 lanes x 32 crops."""
    over = {"box_fusion.clip_sim_coeff": 2.0, "detection.label_bucketing": False}
    seqs = [mm_frames(SyntheticSequence(n_frames=11, n_boxes=3, seed=s)) for s in (1, 4)]
    pipe = BatchedPipeline(cfg_for(**over), CuTRDetector(model, device="cpu"), n_lanes=2,
                           capacity=64, transport="packed", labeler=make_labeler(), device="cpu")
    worlds = pipe.run([iter(s) for s in seqs], gap=2)
    assert pipe.label_batch == 2 * 32
    for got, frames in zip(worlds, seqs):
        want = FusedDevicePipeline(cfg_for(**over), CuTRDetector(model, device="cpu"),
                                   labeler=make_labeler(), capacity=64, device="cpu").run(frames, gap=2)
        assert set(got["categories"]) <= set(CLASSES) and len(got["scores"]) > 0
        assert got["categories"] == [(CLASSES + [""])[int(c)] for c in got["category"]]
        assert_same_world(got, want, tol=LANE_TOL, fused_tol=FUSED_TOL)


def test_label_boost_lanes_equals_per_lane():
    """One tower call over N lanes' crops: each lane's scores, labels and
    overflow are label_boost_device's on that lane alone (1e-5: the tower's
    products at another batch size)."""
    rng = np.random.RandomState(0)
    n, k = 3, 20
    images = rng.uniform(0, 255, (n, 96, 128, 3)).astype(np.float32)
    scores = -np.sort(-rng.uniform(0, 1, (n, k)), axis=1).astype(np.float32)
    scores[1, 4:] = -1e9  # a lane with 4 live rows
    xy = rng.uniform(0, 80, (n, k, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 40, (n, k, 2))], -1).astype(np.float32)
    lab = make_labeler()
    hws = [(96.0, 128.0)] * n
    got = lab.label_boost_lanes(torch.from_numpy(images), boxes, scores, hws, 1.5, 2.0, budget=8)
    for i in range(n):
        want = lab.label_boost_device(torch.from_numpy(images[i]), boxes[i], scores[i], hws[i],
                                      1.5, 2.0, budget=8)
        torch.testing.assert_close(got[0][i], want[0], atol=1e-5, rtol=0)
        assert torch.equal(got[1][i], want[1])
        torch.testing.assert_close(got[2][i], want[2], atol=1e-5, rtol=0)
        assert int(got[3][i]) == int(want[3]) == (12 if i != 1 else 0)


def test_label_boost_core_lanes_equal_single_frames():
    """The label stage both engines share: N lanes in one call (the batched
    engine's, one tower call) give each lane the scores, labels and overflow
    of a one-frame call (the fused engine's), within 1e-5 (the tower's
    products at another batch size)."""
    from boxfusion_tpu_torch.runtime.fused import label_boost_core

    rng = np.random.RandomState(1)
    n, k = 3, 20
    images = torch.from_numpy(rng.randn(n, 96, 128, 3).astype(np.float32))
    scores = -np.sort(-rng.uniform(0, 1, (n, k)), axis=1).astype(np.float32)
    scores[2, 3:] = 0.1  # a lane with 3 rows past the raw-score filter
    xy = rng.uniform(0, 80, (n, k, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 40, (n, k, 2))], -1).astype(np.float32)
    dets = [dict(scores=torch.from_numpy(scores[i]), pred_boxes=torch.from_numpy(boxes[i]))
            for i in range(n)]
    hws = [(96.0, 128.0), (90.0, 120.0), (96.0, 128.0)]
    kw = dict(label_budget=8, scale_box=1.5, clip_coeff=2.0, raw_score_thresh=0.3)
    lab = make_labeler()
    got, got_ovf = label_boost_core(lab, dets, images, hws, **kw)
    assert len(got) == n and got_ovf.shape == (n,)
    for i in range(n):
        (want,), want_ovf = label_boost_core(lab, [dets[i]], images[i:i + 1], [hws[i]], **kw)
        torch.testing.assert_close(got[i]["scores"], want["scores"], atol=1e-5, rtol=0)
        assert torch.equal(got[i]["category"], want["category"])
        assert torch.equal(got[i]["pred_boxes"], dets[i]["pred_boxes"])
        assert int(got_ovf[i]) == int(want_ovf[0])
    live = (scores >= 0.3).sum(axis=1)
    assert got_ovf.tolist() == np.maximum(live - 8, 0).tolist() and live[2] == 3


@pytest.mark.parametrize("case", ["transport", "labeler_arrays", "no_depth", "buckets", "lanes"])
def test_batched_errors(model, case):
    """The JAX class's errors: transport and depth mode names, a labeler only
    with packed, packed needs depth, one shape bucket per round, no more
    sequences than lanes."""
    import dataclasses

    det = CuTRDetector(model, device="cpu")
    frames = list(SyntheticSequence(n_frames=2, n_boxes=3, seed=0))
    if case == "transport":
        with pytest.raises(ValueError, match="transport"):
            BatchedPipeline(cfg_for(), det, n_lanes=2, transport="bytes", device="cpu")
        with pytest.raises(ValueError, match="depth_mode"):
            BatchedPipeline(cfg_for(), det, n_lanes=2, depth_mode="u8", device="cpu")
    elif case == "labeler_arrays":
        with pytest.raises(ValueError, match="packed"):
            BatchedPipeline(cfg_for(), det, n_lanes=2, labeler=make_labeler(), device="cpu")
    elif case == "no_depth":
        pipe = BatchedPipeline(cfg_for(), det, n_lanes=1, transport="packed", device="cpu")
        with pytest.raises(ValueError, match="requires depth"):
            pipe.process_keyframes([dataclasses.replace(frames[0], depth=None)], [0])
    elif case == "buckets":
        big = next(iter(SyntheticSequence(n_frames=1, n_boxes=3, seed=0, image_hw=(300, 400))))
        for transport in ("arrays", "packed"):
            pipe = BatchedPipeline(cfg_for(), det, n_lanes=2, transport=transport, device="cpu")
            with pytest.raises(ValueError, match="one shape bucket"):
                pipe.process_keyframes([frames[0], big], [0, 0])
    else:
        pipe = BatchedPipeline(cfg_for(), det, n_lanes=1, device="cpu")
        with pytest.raises(ValueError, match="lanes"):
            pipe.run([frames, frames])
