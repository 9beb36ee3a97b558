"""The port's fused engine (runtime/fused.py) on the CPU, against the JAX
package's fused engine once and against the port's own device engine
(itself held to JAX, tests/test_torch_device_pipeline.py) otherwise.

The scenarios of tests/test_fused_pipeline.py, at their sizes (CuTR-192,
capacity 64, 16 detections, 128 particles, 4 iterations, 5 views, 8-11
frames), with the committed trained CuTR-192 fixture as the detector: its
detections are realistic (2-28 live rows a keyframe) and, at gap 2, some
boxes fuse.  Depth is quantised to whole millimetres, so the u16 transfer is
lossless and the fused engine sees the device engine's input.

Tolerances:
- port against port (fused vs device, chunked vs per frame, bucketed vs full
  budget): ``init_id``, ``fusion_flag``, ``fusion_list``, ``valid_num``,
  ``category``, ``frame_id`` and ``stats`` identical; every float within
  1e-6 (the engines run the same eager ops; measured 0);
- the port's fused engine against JAX's: the integers identical; ``xyzlhw``
  within 5e-3 (the CuTR-192 box bound of tests/test_torch_cutr.py, and the
  engines' fused-coordinate bound), R within 1e-3 and scores within 2e-3
  (the CuTR-192 bounds): each package runs its own CuTR.

Without JAX, the card test below also runs on a GPU machine:

    python -m pytest --noconftest -m cuda tests/test_torch_fused.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from boxfusion_tpu_torch.data.synthetic import SyntheticSequence
from boxfusion_tpu_torch.models.clip import CLIPConfig, OpenVocabLabeler
from boxfusion_tpu_torch.runtime import CuTRDetector, DevicePipeline, FusedDevicePipeline
from boxfusion_tpu_torch.runtime import fused as fused_mod
from boxfusion_tpu_torch.utils.config import load_config

torch.set_num_threads(2)

FIXTURE = "tests/fixtures/cutr_trained_192_f16.pth"
ENGINE_TOL, FUSED_TOL, JAX_BOX_TOL, JAX_R_TOL, JAX_SCORE_TOL = 1e-6, 5e-3, 5e-3, 1e-3, 2e-3
TINY_CLIP = CLIPConfig(patch=32, width=64, layers=2, heads=2, embed_dim=32, vocab_size=64,
                       context_length=8, text_width=64, text_layers=1, text_heads=2)
CLASSES = ["chair", "table", "sofa", "lamp"]


def cfg_for(load=load_config, **over):
    """tests/test_fused_pipeline.py:_cfg at gap 2 and score_thresh 0.3."""
    c = load("config/ca1m.yaml")
    c["data"]._data["gap"] = 2
    c["detection"]._data["score_thresh"] = 0.3
    c["detection"]._data["uv_bound"] = False
    c["detection"]._data["floor_mask"] = False
    c["detection"]._data["max_detections"] = 16
    c["box_fusion"]._data["pst_path"] = None
    c["box_fusion"]._data["pst_size"] = 128
    c["box_fusion"]._data["iters"] = 4
    c["box_fusion"]._data["max_fusions_per_frame"] = 4
    c["association"]._data["max_views"] = 5
    for k, v in over.items():
        sect, key = k.split(".")
        c[sect]._data[key] = v
    return c


def mm_frames(seq):
    """Frames whose depth is whole millimetres: the u16 transfer is lossless."""
    return [dataclasses.replace(f, depth=(np.round(f.depth * 1000.0) / 1000.0).astype(np.float32))
            for f in seq]


def load_fixture_model(device="cpu"):
    from boxfusion_tpu_torch.models.cutr.convert import load_torch_state_dict

    return load_torch_state_dict(torch.load(FIXTURE, map_location="cpu", weights_only=True),
                                 device=device)


def make_labeler(device="cpu", n_classes=4):
    tf = np.random.RandomState(0).randn(n_classes, TINY_CLIP.embed_dim).astype(np.float32)
    return OpenVocabLabeler(CLASSES[:n_classes], tf, cfg=TINY_CLIP, sim_thres=-1e9,
                            max_boxes=16, device=device).init_random(0)


def assert_same_world(got, want, tol=ENGINE_TOL, r_tol=None, score_tol=None, fused_tol=None):
    """Decisions identical; boxes within ``tol`` (``fused_tol`` where a box
    was fused), R within ``r_tol`` and scores within ``score_tol`` (default
    ``tol``)."""
    assert len(got["scores"]) == len(want["scores"])
    for k in ("init_id", "fusion_flag", "valid_num", "category", "frame_id"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["fusion_list"] == want["fusion_list"]
    assert got["stats"] == want["stats"]
    if "categories" in want:
        assert got["categories"] == want["categories"]
    box_tol = np.where(np.asarray(want["fusion_flag"], bool), fused_tol or tol, tol)[:, None]
    assert (np.abs(got["xyzlhw"] - want["xyzlhw"]) <= box_tol).all(), \
        np.abs(got["xyzlhw"] - want["xyzlhw"]).max(axis=1)
    np.testing.assert_allclose(got["R"], want["R"], atol=r_tol or tol, rtol=0)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=score_tol or tol, rtol=0)


@pytest.fixture(scope="module")
def model():
    return load_fixture_model()


@pytest.fixture(scope="module")
def frames():
    return mm_frames(SyntheticSequence(n_frames=11, n_boxes=4, seed=3))


@pytest.fixture(scope="module")
def fused_world(model, frames):
    pipe = FusedDevicePipeline(cfg_for(), CuTRDetector(model, device="cpu"), capacity=64,
                               device="cpu")
    world = pipe.run(frames, gap=2)
    assert world["fusion_flag"].any() and world["stats"]["keyframes"] == 6
    return world


# ------------------------------------------------------------ against JAX
def test_fused_matches_jax_fused_engine(fused_world, frames):
    """The JAX FusedDevicePipeline, unlabelled, u16 depth, the same fixture
    weights (boxfusion_tpu.models.cutr.convert.load_checkpoint)."""
    from boxfusion_tpu.data.synthetic import SyntheticSequence as JaxSequence
    from boxfusion_tpu.models.cutr import make_cutr as jax_make_cutr
    from boxfusion_tpu.models.cutr.convert import load_checkpoint
    from boxfusion_tpu.runtime.detector import CuTRDetector as JaxCuTRDetector
    from boxfusion_tpu.runtime.fused import FusedDevicePipeline as JaxFused
    from boxfusion_tpu.utils.config import load_config as jax_load_config

    params, dim, depth_model = load_checkpoint(FIXTURE)
    jmodel = jax_make_cutr(dimension=dim, depth_model=depth_model)
    jframes = mm_frames(JaxSequence(n_frames=11, n_boxes=4, seed=3))
    for a, b in zip(jframes, frames):
        np.testing.assert_array_equal(a.image, b.image)
        np.testing.assert_array_equal(a.depth, b.depth)
    want = JaxFused(cfg_for(jax_load_config), JaxCuTRDetector(jmodel, params), capacity=64,
                    depth_mode="u16").run(jframes, gap=2)
    assert_same_world(fused_world, want, tol=JAX_BOX_TOL, r_tol=JAX_R_TOL,
                      score_tol=JAX_SCORE_TOL)


# ------------------------------------------------ against the device engine
def test_fused_matches_device_pipeline(model, frames, fused_world):
    ref = DevicePipeline(cfg_for(), CuTRDetector(model, device="cpu", device_output=True),
                         capacity=64, device="cpu")
    assert_same_world(fused_world, ref.run(frames, gap=2))


@pytest.fixture(scope="module")
def labelled_worlds(model, frames):
    """Labelled worlds: the device engine (label_boost_device on the exported
    image) and the fused engine with and without label buckets.  A budget of
    40 makes the buckets (0, 32, 40): every keyframe here has 2-28 live rows,
    so the bucketed run labels 32 crops where the full budget labels 40."""
    over = {"box_fusion.clip_sim_coeff": 2.0, "detection.max_label_boxes": 40}
    out = {}
    pipe = DevicePipeline(cfg_for(**over),
                          CuTRDetector(model, device="cpu", device_output=True, export_image=True),
                          labeler=make_labeler(), capacity=64, device="cpu")
    out["device"] = pipe.run(frames, gap=2)
    for bucketing in (False, True):
        pipe = FusedDevicePipeline(cfg_for(**over, **{"detection.label_bucketing": bucketing}),
                                   CuTRDetector(model, device="cpu"), labeler=make_labeler(),
                                   capacity=64, device="cpu")
        out[bucketing] = pipe.run(frames, gap=2)
        out[bucketing, "reads"] = pipe.host_reads
        assert "label" in pipe.timings
    return out


def test_fused_with_labeler_matches_device_pipeline(labelled_worlds):
    got, want = labelled_worlds[False], labelled_worlds["device"]
    assert set(got["categories"]) <= set(CLASSES) and len(got["scores"]) > 0
    assert_same_world(got, want)


def test_bucketed_labeling_matches_full_budget(labelled_worlds):
    """One counted host read a labelled keyframe picks the bucket; decisions,
    labels, scores and the overflow counter are those of the full budget."""
    assert_same_world(labelled_worlds[True], labelled_worlds[False])
    assert labelled_worlds[True, "reads"] == labelled_worlds[False, "reads"] + 6


@pytest.mark.parametrize("live,bucket", [(0, 0), (5, 32), (32, 32), (40, 64), (70, 96), (100, 100)])
def test_label_boost_core_bucket_equals_full_budget(monkeypatch, live, bucket):
    """At the main path's budget of 100 the buckets are (0, 32, 64, 96, 100):
    the smallest bucket covering the live rows is labelled, and the rows the
    step keeps (score above -1e8) carry the full budget's scores and labels."""
    assert fused_mod.label_buckets_for(100) == (0, 32, 64, 96, 100)
    rng = np.random.RandomState(live)
    n = 100
    scores = np.sort(rng.uniform(0.0, 1.0, n)).astype(np.float32)[::-1].copy()
    scores[:live] = np.maximum(scores[:live], 0.31)
    scores[live:] = np.minimum(scores[live:], 0.29)
    xy = rng.uniform(0, 200, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 60, (n, 2))], 1).astype(np.float32)
    det = dict(scores=torch.from_numpy(scores), pred_boxes=torch.from_numpy(boxes))
    image = torch.from_numpy(rng.randn(1, 256, 256, 3).astype(np.float32))
    labeler = make_labeler()
    budgets = []
    real = labeler.label_boost_lanes
    monkeypatch.setattr(labeler, "label_boost_lanes",
                        lambda *a, budget, **k: budgets.append(budget) or real(*a, budget=budget, **k))
    kw = dict(label_budget=100, scale_box=1.5, clip_coeff=2.0, raw_score_thresh=0.3)
    (got,), got_ovf = fused_mod.label_boost_core(labeler, [det], image, [(256.0, 256.0)],
                                                 bucketed=True, **kw)
    (want,), want_ovf = fused_mod.label_boost_core(labeler, [det], image, [(256.0, 256.0)], **kw)
    assert budgets == ([bucket] if bucket else []) + [100]
    assert got_ovf.tolist() == want_ovf.tolist() == [0]
    keep = want["scores"] > -1e8
    assert torch.equal(got["scores"] > -1e8, keep) and int(keep.sum()) == live
    torch.testing.assert_close(got["scores"][keep], want["scores"][keep], atol=ENGINE_TOL, rtol=0)
    assert torch.equal(got["category"][keep], want["category"][keep])


def test_fused_from_disk_via_prefetcher(model, frames, tmp_path):
    """tests/test_fused_pipeline.py's I/O-inclusive case: the sequence
    written in the CA-1M layout, streamed back by CA1MDataset (its native
    decoder when that builds) through the threaded Prefetcher into the
    fused engine, gives the world of the read-back frames fed as a list:
    the prefetch thread and the disk decode change no decision."""
    from boxfusion_tpu_torch.data.readers import CA1MDataset, write_ca1m_sequence
    from boxfusion_tpu_torch.native import Prefetcher

    out = tmp_path / "42898867"
    write_ca1m_sequence(frames, str(out))
    cfg = cfg_for(**{"data.datadir": str(out), "data.start": 0, "cam.png_depth_scale": 1000.0})
    h, w = frames[0].image.shape[:2]
    cfg["cam"]._data["H"], cfg["cam"]._data["W"] = w, h
    read_back = list(CA1MDataset(cfg))
    assert len(read_back) == 11

    def engine():
        return FusedDevicePipeline(cfg, CuTRDetector(model, device="cpu"), capacity=64, device="cpu")

    base = engine().run(read_back, gap=2)
    streamed_pipe = engine()
    streamed = streamed_pipe.run(Prefetcher(CA1MDataset(cfg), depth=3), gap=2)
    assert streamed_pipe.count == 11 and base["stats"]["keyframes"] == 6
    assert_same_world(streamed, base)


def test_chunked_matches_per_frame(model, monkeypatch):
    """chunk 3 at gap 1 over 8 frames: two uploads of 3 stacked buffers, then
    the partial tail of 2 through the per-frame path; the world is the
    per-frame engine's (tests/test_fused_pipeline.py:248)."""
    frames = mm_frames(SyntheticSequence(n_frames=8, n_boxes=4, seed=5))
    shapes = []
    real = fused_mod.upload
    monkeypatch.setattr(fused_mod, "upload", lambda buf, dev: shapes.append(buf.shape) or real(buf, dev))
    worlds = {}
    for chunk in (1, 3):
        shapes.clear()
        pipe = FusedDevicePipeline(cfg_for(), CuTRDetector(model, device="cpu"), capacity=64,
                                   device="cpu", chunk=chunk)
        worlds[chunk] = pipe.run(frames, gap=1)
        assert [s[0] for s in shapes] == ([1] * 8 if chunk == 1 else [3, 3, 1, 1])
    assert worlds[1]["fusion_flag"].any()
    assert_same_world(worlds[3], worlds[1])


def test_pending_chunk_and_restore_state(model, tmp_path):
    """Keyframes buffered in a partial chunk wait (the state has not seen
    them); restore_state drops them (they belong to the replaced timeline);
    flush runs them."""
    frames = mm_frames(SyntheticSequence(n_frames=8, n_boxes=4, seed=5))
    det = CuTRDetector(model, device="cpu")
    straight = FusedDevicePipeline(cfg_for(), det, capacity=64, device="cpu")
    for f in frames[:4]:
        straight.process_keyframe(f)
        straight.count += 1
    snapshot = str(tmp_path / "state.pt")
    straight.save_state(snapshot)

    pipe = FusedDevicePipeline(cfg_for(), det, capacity=64, device="cpu", chunk=4)
    for f in frames[4:7]:
        pipe.process_keyframe(f)
        pipe.count += 1
    assert len(pipe._pending) == 3 and int(pipe.state.stats[3]) == 0
    pipe.restore_state(snapshot, count=4)
    assert not pipe._pending and int(pipe.state.stats[3]) == 4
    for f in frames[4:7]:
        pipe.process_keyframe(f)
        pipe.count += 1
    pipe.flush()
    assert not pipe._pending and int(pipe.state.stats[3]) == 7
    for f in frames[4:7]:
        straight.process_keyframe(f)
        straight.count += 1
    from boxfusion_tpu_torch.runtime.device_state import export_world

    assert_same_world(export_world(pipe.state), export_world(straight.state))


def _inside(inner, outer):
    return (float(outer["ts"]) <= float(inner["ts"])
            and float(inner["ts"]) + float(inner["dur"]) <= float(outer["ts"]) + float(outer["dur"]))


def test_fused_spans_under_a_trace(model, frames, tmp_path):
    """A labelled fused run under ``trace``: one ``boxfusion.keyframe`` span
    a keyframe, the upload / detect / label / step spans inside one, the
    step's loops inside a step span, and one ``boxfusion.read.<site>`` span
    for each counted host read."""
    from boxfusion_tpu_torch.utils import profiling
    from boxfusion_tpu_torch.utils.device import host_reads

    pipe = FusedDevicePipeline(cfg_for(), CuTRDetector(model, device="cpu"), labeler=make_labeler(),
                               capacity=64, device="cpu")
    keyframes = frames[:5:2]
    reads0 = host_reads.count
    with profiling.trace(str(tmp_path / "tr"), device="cpu") as path:
        for f in keyframes:
            pipe.process_keyframe(f)
            pipe.count += 2
        pipe.flush()
    reads = host_reads.count - reads0
    spans = [e for e in profiling.load_trace(path)
             if e.get("cat") == "user_annotation" and e["name"].startswith("boxfusion.")]
    by_name = {}
    for e in spans:
        by_name.setdefault(e["name"][len("boxfusion."):], []).append(e)
    assert len(by_name["keyframe"]) == len(keyframes)
    for stage in ("upload", "detect", "label", "step"):
        assert len(by_name[stage]) >= len(keyframes), stage
        assert all(any(_inside(e, k) for k in by_name["keyframe"]) for e in by_name[stage]), stage
    for k in by_name["keyframe"]:
        assert all(any(_inside(e, k) for e in by_name[stage]) for stage in ("upload", "detect", "step"))
    for stage in ("step.nms", "step.correspond", "step.fuse"):
        assert by_name[stage] and all(any(_inside(e, s) for s in by_name["step"]) for e in by_name[stage])
    read_spans = [e for e in spans if e["name"].startswith("boxfusion.read.")]
    assert reads > 0 and len(read_spans) == reads == pipe.host_reads
    assert {e["name"] for e in read_spans} >= {"boxfusion.read.step.gate", "boxfusion.read.label.live",
                                               "boxfusion.read.nms", "boxfusion.read.iou.gated"}
    assert pipe.timings["host_read_wait"] > 0
    assert pipe.timings["keyframe"] >= pipe.timings["upload"] + pipe.timings["detect"] + pipe.timings["step"]


def test_totals_survive_reset(model, frames):
    """Two sequences with a reset between them: ``timings`` and
    ``host_reads`` cover both, while the state and the frame counter start
    afresh (the second sequence's world is the first's)."""
    from boxfusion_tpu_torch.runtime.device_state import export_world
    from boxfusion_tpu_torch.utils.device import host_reads

    pipe = FusedDevicePipeline(cfg_for(), CuTRDetector(model, device="cpu"), capacity=64, device="cpu")
    worlds, totals = [], []
    reads0 = host_reads.count
    for _ in range(2):
        for f in frames[:3:2]:
            pipe.process_keyframe(f)
            pipe.count += 2
        pipe.flush()
        worlds.append(export_world(pipe.state))
        totals.append((dict(pipe.timings), pipe.host_reads))
        pipe.reset()
        assert pipe.count == 0 and int(pipe.state.n) == 0 and int(pipe.state.stats[3]) == 0
        assert (dict(pipe.timings), pipe.host_reads) == totals[-1]
    (first, reads1), (both, reads2) = totals
    assert reads1 > 0 and reads2 == 2 * reads1 == host_reads.count - reads0
    for stage in ("keyframe", "upload", "detect", "step", "step.nms", "host_read_wait"):
        assert both[stage] > first[stage] > 0, stage
    assert_same_world(worlds[1], worlds[0])


@pytest.mark.parametrize("depth_mode", ["u16", "f32"])
def test_packed_buffer_round_trip_odd_width(depth_mode):
    """pack (the JAX package's bytes exactly) -> unpack at an odd image and
    depth width, where the depth plane and the meta block start at offsets
    that are not multiples of their item size."""
    from boxfusion_tpu.runtime.fused import pack_fused_buffer as jax_pack

    seq = SyntheticSequence(n_frames=1, n_boxes=3, seed=0, image_hw=(45, 61))
    frame = mm_frames(seq)[0]
    h, w = frame.image.shape[:2]
    dh, dw = frame.depth.shape
    assert w % 2 and dw % 2 and (h * w * 3) % 2
    buf = fused_mod.pack_fused_buffer(frame, 7, depth_mode, 1000.0)
    np.testing.assert_array_equal(buf, jax_pack(frame, 7, depth_mode, 1000.0))
    assert buf.shape[0] == h * w * 3 + dh * dw * (2 if depth_mode == "u16" else 4) + 48 * 4

    image, depth, meta = fused_mod.unpack_fused_buffer(torch.from_numpy(buf), h=h, w=w, dh=dh,
                                                       dw=dw, depth_mode=depth_mode)
    np.testing.assert_array_equal(image.numpy(), frame.image)
    if depth_mode == "u16":  # u16 -> float32, divided by meta[46] in float32
        want = np.round(frame.depth * 1000.0).astype(np.uint16).astype(np.float32) / np.float32(1000.0)
        np.testing.assert_array_equal(depth.numpy(), want)
    else:
        np.testing.assert_array_equal(depth.numpy(), frame.depth)
    m = meta.numpy()
    np.testing.assert_array_equal(m, fused_mod.fused_meta_host(buf))
    np.testing.assert_array_equal(m[:16], frame.gt_pose.ravel())
    np.testing.assert_array_equal(m[16:25], frame.K.ravel())
    np.testing.assert_array_equal(m[37:46], frame.T_gravity.ravel())
    assert (m[34], m[35], m[36], m[46]) == (h, w, 7, 1000.0)


def test_label_buckets_for():
    from boxfusion_tpu.runtime.fused import label_buckets_for as jax_buckets

    assert fused_mod.label_buckets_for(128) == (0, 32, 64, 96, 112, 128)
    assert fused_mod.label_buckets_for(96) == (0, 32, 64, 96)
    assert fused_mod.label_buckets_for(48) == (0, 32, 48)
    assert fused_mod.label_buckets_for(16) == (0, 16)
    for b in range(1, 200):
        assert fused_mod.label_buckets_for(b) == jax_buckets(b)


def test_fused_rejects_bad_arguments(model):
    det = CuTRDetector(model, device="cpu")
    with pytest.raises(ValueError, match="depth_mode"):
        FusedDevicePipeline(cfg_for(), det, depth_mode="u8", device="cpu")
    with pytest.raises(ValueError, match="chunk"):
        FusedDevicePipeline(cfg_for(), det, chunk=0, device="cpu")


# ------------------------------------------------------------- on the card
@pytest.mark.cuda
def test_fused_and_batched_on_card():
    """The fixture CuTR-192 on the card: fused at chunk 1 and 3 against the
    device engine, and 2 batched lanes (packed) against single device-engine
    runs.  The fused engine and the device engine run the same ops in the
    same order: 1e-6.  A lane of the batched engine runs CuTR at batch 2,
    whose products may round apart from batch 1: decisions identical,
    coordinates within 5e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from boxfusion_tpu_torch.ops.pst_search import pst_search
    from boxfusion_tpu_torch.runtime import BatchedPipeline

    dev = torch.device("cuda")
    model = load_fixture_model(dev)
    frames = mm_frames(SyntheticSequence(n_frames=11, n_boxes=4, seed=3))
    ref = DevicePipeline(cfg_for(), CuTRDetector(model, device=dev, device_output=True),
                         capacity=64, device=dev).run(frames, gap=2)
    assert ref["fusion_flag"].any()
    for chunk in (1, 3):
        before = pst_search.launches
        got = FusedDevicePipeline(cfg_for(), CuTRDetector(model, device=dev), capacity=64,
                                  device=dev, chunk=chunk).run(frames, gap=2)
        assert pst_search.launches > before
        assert_same_world(got, ref)
    seqs = [mm_frames(SyntheticSequence(n_frames=n, n_boxes=4, seed=s)) for s, n in ((3, 11), (5, 8))]
    worlds = BatchedPipeline(cfg_for(), CuTRDetector(model, device=dev), n_lanes=2, capacity=64,
                             transport="packed", device=dev).run(seqs, gap=2)
    for got, lane in zip(worlds, seqs):
        want = DevicePipeline(cfg_for(), CuTRDetector(model, device=dev, device_output=True),
                              capacity=64, device=dev).run(lane, gap=2)
        assert_same_world(got, want, tol=JAX_BOX_TOL)
