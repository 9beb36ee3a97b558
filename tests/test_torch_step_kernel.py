"""The step's NMS and correspondence loops as one-block kernels
(ops/step_kernel.py) and their plain twins.

This file imports torch and the port only -- no JAX -- so that its card tests
(marker ``cuda``) also run on a GPU machine that has no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_step_kernel.py

On the CPU the wrappers run their twins, the loops the step ran before;
tests/test_torch_device_step.py holds those to the JAX package
(``test_nms_greedy_matches_jax``, ``test_correspondence_matches_jax``).  On
the card each kernel is held to its twin on the same inputs' CPU copies, for
exact equality of every output and of the tally's growth; and a whole scan
through the device engine with the kernels equals, field by field, the same
scan with the twins run on the card's tensors.
"""
import collections
import os
import sys

import pytest
import torch

from boxfusion_tpu_torch.ops import step_kernel
from boxfusion_tpu_torch.runtime.device_step import StepConfig
from boxfusion_tpu_torch.utils.device import host_reads

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from chip_smoke import (  # noqa: E402
    CORR_ARGS,
    NMS_ARGS,
    corr_scene,
    manager_scene,
    pose_bit_shares,
    stepping_through,
    step_kernel_against_twin,
)

CFG = StepConfig()


def _recontest(scene, threshold=CFG.nms_threshold):
    """``_contested``'s masks again, after an edit of the IoU cache (every
    slot live)."""
    pair_on = scene["iou"] > threshold
    scene["contested"] = pair_on.any(1) | pair_on.any(0)
    scene["isolated"] = ~scene["contested"]
    return scene


def _members(scene, slot, ids):
    scene["fcount"][slot] = len(ids)
    scene["flist"][slot, :len(ids)] = torch.tensor(ids, dtype=torch.int32)
    scene["init_id"][slot] = ids[0]


# --------------------------------------------------------------- on the CPU
def test_wrappers_run_their_twins_on_cpu():
    """CPU tensors take the twins: the loop's host reads, no launch, the
    tally grows by the twin's work, and no input is written."""
    scene = manager_scene("cpu", seed=5, G=24, V=6, M=64)
    kept = {k: v.clone() for k, v in scene.items()}
    launches = (step_kernel.nms_greedy.launches, step_kernel.correspond_hits.launches)
    tally0, reads0 = step_kernel.tally("cpu").clone(), host_reads.count
    got = step_kernel.nms_greedy(*(scene[k] for k in NMS_ARGS), CFG)
    reads = host_reads.count - reads0
    want = step_kernel.nms_greedy_reference(*(scene[k] for k in NMS_ARGS), CFG)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    picks, records, hits = (step_kernel.tally("cpu") - tally0).tolist()
    # one read before the first pick, one per pick; the twin called twice
    assert picks >= 2 and picks % 2 == 0 and records >= 2 and hits == 0
    assert reads == picks // 2 + 1

    corr = corr_scene("cpu", seed=5, G=24, V=6, M=64, hits=5)
    tally0, reads0 = step_kernel.tally("cpu").clone(), host_reads.count
    step_kernel.correspond_hits(*(corr[k] for k in CORR_ARGS), CFG)
    assert host_reads.count - reads0 == 1
    assert (step_kernel.tally("cpu") - tally0).tolist() == [0, 0, 5]
    assert step_kernel.counts("cpu") == dict(zip(step_kernel.TALLY_NAMES, step_kernel.tally("cpu").tolist()))
    assert (step_kernel.nms_greedy.launches, step_kernel.correspond_hits.launches) == launches
    for k, v in kept.items():
        assert torch.equal(scene[k], v), k


@pytest.mark.parametrize("field,dtype,error", [
    ("scores", torch.float64, TypeError),
    ("flist", torch.int64, TypeError),
    ("iou", None, ValueError),
])
def test_nms_greedy_refuses_what_it_does_not_take(field, dtype, error):
    scene = manager_scene("cpu", seed=6, G=8, V=4, M=16)
    scene[field] = scene[field].to(dtype) if dtype is not None else scene[field][:, :4]
    with pytest.raises(error, match=field):
        step_kernel.nms_greedy(*(scene[k] for k in NMS_ARGS), CFG)


# ------------------------------------------------------------------ on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


def _on(scene, dev):
    return {k: v.to(dev) for k, v in scene.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("seed,G,V", [(0, 64, 10), (1, 64, 10), (2, 100, 5), (3, 37, 16), (4, 512, 10)])
def test_nms_greedy_matches_twin_on_random_states(seed, G, V):
    """Scores with ties, an asymmetric cache, lists of 1..V members."""
    dev = _card()
    scene = manager_scene(dev, seed=seed, G=G, V=V, M=4 * G)
    out = step_kernel_against_twin("nms_greedy", scene, CFG)
    assert out["tally"]["picks"] >= 1 and out["tally"]["records"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("V", [10, 4])
def test_nms_greedy_case_a_appends_at_the_cap(V):
    """A survivor of 4 members suppresses six single observations seen from
    far poses: the first is appended (5 members), the rest are not (the
    cap); at V = 4 the append lands on the last slot, as the twin's clamp."""
    dev = _card()
    scene = manager_scene("cpu", seed=7, G=16, V=V, M=64, density=0.0, single_share=1.0, pose_spread=5.0)
    scene["scores"][:] = 0.5
    scene["scores"][0] = 0.9
    _members(scene, 0, [1, 2, 3, 4])
    for s in range(1, 7):
        _members(scene, s, [10 + s])
    scene["iou"][0, 1:7] = 0.3
    out = step_kernel_against_twin("nms_greedy", _on(_recontest(scene), dev), CFG)
    assert out["tally"] == dict(picks=1, records=6, hits=0)
    got = step_kernel.nms_greedy(*(_on(scene, dev)[k] for k in NMS_ARGS), CFG)
    assert int(got[3][0]) == 5


@pytest.mark.cuda
def test_nms_greedy_case_b_merges_truncate():
    """Multi-view boxes of 3 members merge into a survivor of 4 at V = 6:
    every merge drops members past V, and the count says how many."""
    dev = _card()
    scene = manager_scene("cpu", seed=8, G=12, V=6, M=64, density=0.0, pose_spread=5.0)
    scene["scores"][:] = 0.5
    scene["scores"][0] = 0.9
    _members(scene, 0, [1, 2, 3, 4])
    for s in range(1, 5):
        _members(scene, s, [10 * s, 10 * s + 1, 10 * s + 2])
    scene["iou"][0, 1:5] = 0.3
    out = step_kernel_against_twin("nms_greedy", _on(_recontest(scene), dev), CFG)
    assert out["trunc"] > 0


@pytest.mark.cuda
def test_nms_greedy_keep_swaps():
    """Suppressed boxes of 5 members cannot merge: the first takes the
    survivor's place (keep-swap), the later ones find it gone."""
    dev = _card()
    scene = manager_scene("cpu", seed=9, G=12, V=10, M=64, density=0.0)
    scene["scores"][:] = 0.5
    scene["scores"][0] = 0.9
    _members(scene, 0, [1, 2])
    for s in range(1, 4):
        _members(scene, s, list(range(10 * s, 10 * s + 5)))
    scene["iou"][0, 1:4] = 0.3
    step_kernel_against_twin("nms_greedy", _on(_recontest(scene), dev), CFG)
    keep = step_kernel.nms_greedy(*(_on(scene, dev)[k] for k in NMS_ARGS), CFG)[0].cpu()
    # records in score order, ties to the larger slot: slot 3 swaps in first
    assert not keep[0] and keep[3] and not keep[1:3].any()


@pytest.mark.cuda
def test_nms_greedy_with_nothing_contested():
    dev = _card()
    scene = manager_scene(dev, seed=10, G=64, V=10, M=128, density=0.0)
    assert not scene["contested"].any()
    out = step_kernel_against_twin("nms_greedy", scene, CFG)
    assert out["tally"] == dict(picks=0, records=0, hits=0) and out["kept"] == 64


@pytest.mark.cuda
def test_nms_greedy_large_world():
    """The cells' capacity (2048 slots, 10 views, 16,384 observations) with
    300 or more contested slots."""
    dev = _card()
    scene = manager_scene(dev, seed=1, G=2048, V=10, M=16384, n=1200, density=0.0005)
    assert int(scene["contested"].sum()) >= 300
    out = step_kernel_against_twin("nms_greedy", scene, CFG)
    assert out["tally"]["picks"] >= 100


@pytest.mark.cuda
@pytest.mark.parametrize("G,hits", [(64, 0), (64, 1), (64, 24), (2048, 200)])
def test_correspond_hits_matches_twin(G, hits):
    """Zero, one and many hits; best matches shared by several hits."""
    dev = _card()
    scene = corr_scene(dev, seed=G + hits, G=G, V=10, M=4 * G, hits=hits)
    out = step_kernel_against_twin("correspond_hits", scene, CFG)
    assert out["tally"]["hits"] == hits


@pytest.mark.cuda
def test_pose_terms_decide_as_torch_on_the_card():
    """Over 10^5 pose pairs the kernels' pose test decides as PyTorch's
    operations do, on the card and on the CPU (the bit shares are
    chip_smoke's record)."""
    _card()
    rec = pose_bit_shares(torch.device("cuda"))
    assert rec["pairs"] >= 100_000
    for where, shares in rec["shares"].items():
        assert shares["decision"] == 0.0, (where, shares)


def _scan(dev, twins: bool):
    from chip_smoke import _oracle_config
    from boxfusion_tpu_torch.data.synthetic import OracleDetector, SyntheticSequence
    from boxfusion_tpu_torch.runtime import DevicePipeline

    cfg = _oracle_config()
    cfg["data"]._data["gap"] = 1
    seq = SyntheticSequence(n_frames=30, n_boxes=24)
    pipe = DevicePipeline(cfg, OracleDetector(seq, noise=0.05), capacity=512, device=dev)
    calls = collections.Counter()

    def counted(kind):
        fn = getattr(step_kernel, kind + "_reference" if twins else kind)

        def call(*args):
            calls[kind] += 1
            return fn(*args)
        return call

    with stepping_through(nms_greedy=counted("nms_greedy"), correspond_hits=counted("correspond_hits")):
        pipe.run(seq, export=False)
    return pipe, calls


@pytest.mark.cuda
def test_keyframe_steps_over_a_scan_equal_the_twins():
    """30 keyframes of a synthetic scan through the device engine: with the
    kernels, and with the twins on the card's tensors; every state field
    equal, element by element.  One launch per stage entered."""
    dev = _card()
    launches = (step_kernel.nms_greedy.launches, step_kernel.correspond_hits.launches)
    tally0 = step_kernel.tally(dev).cpu()
    kernels, calls = _scan(dev, twins=False)
    assert (step_kernel.nms_greedy.launches - launches[0],
            step_kernel.correspond_hits.launches - launches[1]) == (calls["nms_greedy"],
                                                                    calls["correspond_hits"])
    assert calls["nms_greedy"] >= 20 and calls["correspond_hits"] >= 1
    grown = dict(zip(step_kernel.TALLY_NAMES, (step_kernel.tally(dev).cpu() - tally0).tolist()))
    assert grown["picks"] > 0 and grown["records"] > 0
    twins, _ = _scan(dev, twins=True)
    for name in ("n", "xyzlhw", "R", "scores", "flist", "fcount", "fflag", "valid_num", "iou",
                 "init_id", "frame_id", "already", "already_valid", "obs_n", "stats"):
        assert torch.equal(getattr(kernels.state, name), getattr(twins.state, name)), name


@pytest.mark.cuda
def test_wrappers_never_synchronise():
    dev = _card()
    scene = manager_scene(dev, seed=11, G=256, V=10, M=1024)
    corr = corr_scene(dev, seed=11, G=256, V=10, M=1024, hits=16)
    step_kernel.nms_greedy(*(scene[k] for k in NMS_ARGS), CFG)  # the build and the tally
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        keep = step_kernel.nms_greedy(*(scene[k] for k in NMS_ARGS), CFG)[0]
        step_kernel.correspond_hits(*(corr[k] for k in CORR_ARGS[:3]), keep,
                                    *(corr[k] for k in CORR_ARGS[4:]), CFG)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
