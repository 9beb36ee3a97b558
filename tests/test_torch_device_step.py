"""The port's device keyframe step against the JAX package's, function by function.

Every case builds its inputs with numpy from a seed (a crafted
``{field: ndarray}`` state tree, detections, poses), hands them to the JAX
function (jitted, on the CPU) and to its torch counterpart on
``device="cpu"``, where the fitness kernel's wrapper runs its plain twin.

Tolerances.  Integer and boolean fields, masks, counters: exact, on world
slots ``[0, n)`` and observations ``[0, obs_n)`` (slots past them are not
state: the JAX append also writes its filtered-out rows there, the port does
not).  Floats that no fusion touched: 1e-5 (float32 sums in another order);
pixel-valued fields (``pred_boxes``, ``obs_corners2d``) 1e-4, two float32 ulps
at 512 px.
Fused ``xyzlhw``: 5e-3 (PST coordinates are chaotic across stacks, as in
tests/test_device_pipeline.py:58).  R: 1e-5.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boxfusion_tpu.fusion.optimizer import PSTOptConfig as JaxOpt
from boxfusion_tpu.fusion.pst import load_pst as jax_load_pst
from boxfusion_tpu.runtime import device_state as jstate
from boxfusion_tpu.runtime import device_step as jstep

from boxfusion_tpu_torch.fusion.optimizer import PSTOptConfig, init_opt_params
from boxfusion_tpu_torch.runtime import device_step as step
from boxfusion_tpu_torch.runtime.device_state import (
    FIELD_NAMES,
    PAD_ID,
    init_state,
    state_from_numpy,
    state_to_numpy,
)
from boxfusion_tpu_torch.utils.device import host_reads

torch.set_num_threads(2)

FLOAT_TOL, PIXEL_TOL, FUSED_TOL = 1e-5, 1e-4, 5e-3
WORLD_INT = ("category", "init_id", "frame_id", "flist", "fcount", "fflag", "already", "already_valid")
WORLD_FLOAT = ("xyzlhw", "R", "scores", "pred_boxes", "valid_num")
OBS_FLOAT = ("obs_pose", "obs_xyzlhw", "obs_R", "obs_score", "obs_corners2d")
K_MAT = np.array([[300.0, 0, 256], [0, 300.0, 192], [0, 0, 1]], np.float32)
HW = (384.0, 512.0)


def _cfgs(**kw):
    """The same StepConfig for both packages (the optimizer's too)."""
    opt = dict(iters=6)
    return (
        jstep.StepConfig(**kw, opt=JaxOpt(**opt, fitness_impl="xla")),
        step.StepConfig(**kw, opt=PSTOptConfig(**opt)),
    )


def _yaw(rng, n):
    a = rng.uniform(-np.pi, np.pi, n)
    R = np.zeros((n, 3, 3), np.float32)
    R[:, 0, 0], R[:, 0, 1], R[:, 1, 0], R[:, 1, 1], R[:, 2, 2] = np.cos(a), -np.sin(a), np.sin(a), np.cos(a), 1
    return R


def _poses(rng, n, spread=2.0):
    p = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    p[:, :3, :3] = _yaw(rng, n)
    p[:, :3, 3] = rng.uniform(-spread, spread, (n, 3))
    return p


def make_tree(seed, G=12, V=5, M=40, n=9, obs_n=24):
    """A crafted state: score ties, an ASYMMETRIC IoU cache, fusion lists of
    1..V members, some multi-view boxes, one slot already fused."""
    rng = np.random.RandomState(seed)
    t = state_to_numpy(init_state(G, V, M, device="cpu"))
    t["xyzlhw"] = np.concatenate([rng.uniform(-2, 2, (G, 3)), rng.uniform(0.2, 0.9, (G, 3))], 1).astype(np.float32)
    t["R"] = _yaw(rng, G)
    t["scores"] = rng.uniform(0.3, 0.9, G).round(1).astype(np.float32)  # ties
    t["category"] = rng.randint(0, 4, G).astype(np.int32)
    xy = rng.uniform(0, 300, (G, 2))
    t["pred_boxes"] = np.concatenate([xy, xy + rng.uniform(20, 150, (G, 2))], 1).astype(np.float32)
    t["frame_id"] = rng.randint(0, 30, G).astype(np.int32)
    t["valid_num"] = rng.randint(0, 3, G).astype(np.float32)
    flist = np.full((G, V), PAD_ID, np.int32)
    fcount = np.ones(G, np.int32)
    for g in range(G):
        c = rng.randint(1, V + 1) if g < n else 1
        flist[g, :c] = np.sort(rng.choice(obs_n, c, replace=False))
        fcount[g] = c
    t["flist"], t["fcount"] = flist, fcount
    t["init_id"] = flist[:, 0].copy()
    t["fflag"] = rng.rand(G) > 0.6
    fused = int(np.argmax(fcount[:n] >= 3))
    t["already"][fused] = flist[fused]
    t["already_valid"][fused] = True
    iou = rng.uniform(0, 0.35, (G, G)).astype(np.float32)
    iou[rng.rand(G, G) < 0.7] = 0.0  # sparse and asymmetric
    np.fill_diagonal(iou, 0.0)
    t["iou"] = iou
    t["obs_pose"] = _poses(rng, M)
    t["obs_xyzlhw"] = np.concatenate([rng.uniform(-2, 2, (M, 3)), rng.uniform(0.2, 0.9, (M, 3))], 1).astype(np.float32)
    t["obs_R"] = _yaw(rng, M)
    t["obs_score"] = rng.uniform(0.3, 0.9, M).astype(np.float32)
    t["obs_corners2d"] = rng.uniform(100, 400, (M, 8, 2)).astype(np.float32)
    t["n"], t["obs_n"] = np.int32(n), np.int32(obs_n)
    t["stats"] = rng.randint(0, 5, t["stats"].shape).astype(np.int32)
    return t


def both(tree):
    return (jstate.DeviceState(**{k: jnp.asarray(v) for k, v in tree.items()}),
            state_from_numpy(tree, device="cpu"))


def jtree(s):
    return {f.name: np.asarray(getattr(s, f.name)) for f in dataclasses.fields(s)}


def assert_states_match(jax_state, torch_state, fused=None, float_tol=FLOAT_TOL, skip=()):
    """World slots [0, n) and observations [0, obs_n); ``fused`` (a bool mask
    over the slots) widens xyzlhw to FUSED_TOL on those rows."""
    want, got = jtree(jax_state), state_to_numpy(torch_state)
    assert int(got["n"]) == int(want["n"]) and int(got["obs_n"]) == int(want["obs_n"])
    n, m = int(want["n"]), int(want["obs_n"])
    np.testing.assert_array_equal(got["stats"], want["stats"], err_msg="stats")
    for name in WORLD_INT:
        if name not in skip:
            np.testing.assert_array_equal(got[name][:n], want[name][:n], err_msg=name)
    for name in WORLD_FLOAT:
        if name in skip:
            continue
        tol = np.full(n, PIXEL_TOL if name == "pred_boxes" and float_tol else float_tol)
        if name == "xyzlhw" and fused is not None:
            tol = np.where(fused[:n], FUSED_TOL, float_tol)
        diff = np.abs(got[name][:n] - want[name][:n]).reshape(n, -1).max(1) if n else np.zeros(0)
        assert (diff <= tol).all(), (name, diff)
    if "iou" not in skip:
        np.testing.assert_allclose(got["iou"][:n, :n], want["iou"][:n, :n], atol=float_tol, rtol=0, err_msg="iou")
    for name in OBS_FLOAT:
        tol = PIXEL_TOL if name == "obs_corners2d" and float_tol else float_tol
        np.testing.assert_allclose(got[name][:m], want[name][:m], atol=tol, rtol=0, err_msg=name)


def make_det(seed, K=8, near=None):
    """K detector rows in the camera frame; ``near`` (a world tree) puts the
    first rows on top of existing world boxes so that NMS has work."""
    rng = np.random.RandomState(seed)
    boxes = np.concatenate([rng.uniform(-1.5, 1.5, (K, 2)), rng.uniform(2, 5, (K, 1)),
                            rng.uniform(0.2, 0.9, (K, 3))], 1).astype(np.float32)
    if near is not None:
        k = min(4, K)
        boxes[:k] = near["xyzlhw"][:k] + rng.normal(0, 0.02, (k, 6))
    xy = rng.uniform(0, 300, (K, 2))
    return dict(
        scores=np.sort(rng.uniform(0.2, 0.95, K).round(1).astype(np.float32))[::-1].copy(),
        pred_boxes=np.concatenate([xy, xy + rng.uniform(20, 150, (K, 2))], 1).astype(np.float32),
        boxes3d=boxes,
        R=_yaw(rng, K),
        proj_xy=rng.uniform(0, 512, (K, 2)).astype(np.float32),
        category=rng.randint(0, 4, K).astype(np.int32),
    )


def jdet(det):
    return {k: jnp.asarray(v) for k, v in det.items()}


def tdet(det):
    return {k: torch.from_numpy(v) for k, v in det.items()}


# ------------------------------------------------------------------- filters
@pytest.mark.parametrize("hw", [(384.0, 512.0), (480.0, 640.0)], ids=["512", "640_f32_floor"])
def test_filter_mask_matches_jax(hw):
    """Every filter on; at W = 640 the uv margin floors to 64 in float32 and
    to 63 in float64, and a row sits on u = 63.5 to tell them apart."""
    jcfg, cfg = _cfgs(score_thresh=0.4, uv_bound=True, floor_mask=True, size_max_thres=1.2)
    rng = np.random.RandomState(0)
    det = make_det(1, K=64)
    det["proj_xy"] = np.stack([rng.uniform(0, hw[1], 64), rng.uniform(0, hw[0], 64)], 1).astype(np.float32)
    det["proj_xy"][0] = (63.5, hw[0] / 2)
    det["scores"][0] = 0.9
    det["boxes3d"][:8, 3:] = [[2.0, 0.1, 0.1], [0.8, 0.1, 0.09], [1.0, 0.14, 0.1], [3.0, 1.0, 1.0],
                              [0.3, 0.3, 0.3], [0.9, 0.12, 0.11], [1.6, 0.1, 0.2], [0.5, 0.5, 0.03]]
    want = np.asarray(jax.jit(partial(jstep._filter_mask, cfg=jcfg))(jdet(det), jnp.asarray(hw, jnp.float32)))
    got = step._filter_mask(tdet(det), hw, cfg).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < 64
    if hw[1] == 640.0:
        assert not got[0]


# -------------------------------------------------------------------- append
@pytest.mark.parametrize("n,obs_n,case", [(3, 10, "room"), (9, 24, "world_nearly_full"),
                                          (3, 37, "obs_nearly_full"), (12, 24, "world_full")])
def test_append_detections_matches_jax(n, obs_n, case):
    tree = make_tree(2, n=n, obs_n=obs_n)
    det = make_det(3, K=8)
    mask = np.array([1, 0, 1, 1, 0, 1, 1, 1], bool)
    pose = _poses(np.random.RandomState(4), 1)[0]
    js, ts = both(tree)
    jfn = jax.jit(jstep._append_detections)
    jout, jk = jfn(js, jdet(det), jnp.asarray(mask), jnp.asarray(pose), jnp.asarray(K_MAT),
                   jnp.asarray(HW, jnp.float32), jnp.int32(7))
    tout, tk = step._append_detections(ts, tdet(det), torch.from_numpy(mask), torch.from_numpy(pose),
                                       torch.from_numpy(K_MAT), HW, 7)
    assert int(tk) == int(jk) == min(6, 12 - n, 40 - obs_n)
    assert_states_match(jout, tout)
    # the live rows were not touched, and the input state is not written
    got = state_to_numpy(tout)
    np.testing.assert_array_equal(got["xyzlhw"][:n], tree["xyzlhw"][:n])
    np.testing.assert_array_equal(got["obs_pose"][:obs_n], tree["obs_pose"][:obs_n])
    np.testing.assert_array_equal(state_to_numpy(ts)["xyzlhw"], tree["xyzlhw"])
    drops = got["stats"][:2] - tree["stats"][:2]
    assert drops.sum() == 6 - int(tk)


# -------------------------------------------------------------------- record
def _record_tree():
    """Slots: 0 survivor (3 views), 1 fresh single, 2 multi-view mergeable,
    3 multi-view NOT mergeable (5 members: a keep-swap), 4 single seen from
    the survivor's own pose (no append)."""
    t = make_tree(5, n=6)
    rng = np.random.RandomState(6)
    poses = _poses(rng, 40, spread=0.1)          # all near the origin ...
    poses[20:] = _poses(rng, 20, spread=0.1)
    poses[20:, :3, 3] += 5.0                     # ... or 5 m away
    t["obs_pose"] = poses
    P = PAD_ID
    t["flist"][:5] = [[1, 2, 3, P, P], [21, P, P, P, P], [22, 23, P, P, P],
                      [24, 25, 26, 27, 28], [4, P, P, P, P]]
    t["fcount"][:5] = [3, 1, 2, 5, 1]
    t["init_id"][:5] = [1, 21, 22, 24, 4]
    t["obs_pose"][4] = t["obs_pose"][1]
    t["fflag"][:5] = [False, False, True, True, False]
    return t


@pytest.mark.parametrize("i,j,extra,case", [
    (0, 1, False, "A_append"), (0, 4, False, "A_same_pose_no_append"), (0, 4, True, "A_center_far"),
    (0, 2, False, "B_merge"), (0, 3, False, "B_keep_swap"), (3, 2, False, "B_merge_truncates"),
])
def test_record_core_matches_jax(i, j, extra, case):
    jcfg, cfg = _cfgs()
    t = _record_tree()
    keep = np.ones(12, bool)
    keep[j] = False
    jfn = jax.jit(partial(jstep._record_core, cfg=jcfg))
    want = jfn(jnp.asarray(t["flist"]), jnp.asarray(t["fcount"]), jnp.asarray(t["fflag"]),
               jnp.asarray(keep), jnp.int32(i), jnp.int32(j), jnp.bool_(extra),
               jnp.asarray(t["obs_pose"]), jnp.asarray(t["init_id"]))
    ten = [torch.from_numpy(np.array(t[k])) for k in ("flist", "fcount", "fflag")] + [torch.from_numpy(keep.copy())]
    trunc = step._record_core(*ten, torch.tensor([i]), torch.tensor([j]), torch.tensor(extra),
                              torch.from_numpy(t["obs_pose"]), torch.from_numpy(t["init_id"]), cfg)
    for g, w, name in zip(ten + [trunc], want, ("flist", "fcount", "fflag", "keep", "trunc")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{case}: {name}")
    flist, fcount, _, keep_out = (x.numpy() for x in ten)
    if case in ("A_append", "A_center_far"):
        assert fcount[0] == 4
    if case == "A_same_pose_no_append":
        assert fcount[0] == 3
    if case == "B_merge":
        assert fcount[0] == 5 and list(flist[0]) == [1, 2, 3, 22, 23]
    if case == "B_keep_swap":
        assert not keep_out[0] and keep_out[3] and fcount[0] == 3
    if case == "B_merge_truncates":
        assert int(trunc) == 2 and fcount[3] == 5


# ----------------------------------------------------------------------- NMS
def test_argmax_and_rank_break_score_ties_by_larger_slot():
    scores = torch.tensor([0.5, 0.9, 0.9, 0.1, 0.9, 0.5])
    mask = torch.tensor([True, True, True, True, False, True])
    assert int(step._argmax_score_desc(scores, mask)) == 2


@pytest.mark.parametrize("seed", [7, 8])
def test_nms_greedy_matches_jax(seed):
    jcfg, cfg = _cfgs()
    tree = make_tree(seed)
    js, ts = both(tree)
    jout, jkeep, jsucc = jax.jit(partial(jstep._nms_greedy, cfg=jcfg))(js)
    reads0 = host_reads.count
    tout, tkeep, tsucc = step._nms_greedy(ts, cfg)
    reads = host_reads.count - reads0
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(tsucc.numpy(), np.asarray(jsucc))
    assert_states_match(jout, tout)
    assert 0 < tkeep[:9].sum() < 9 and tsucc.any()
    assert reads >= 2
    np.testing.assert_array_equal(state_to_numpy(ts)["flist"], tree["flist"])  # input not written


def test_nms_greedy_matches_jax_on_a_large_world():
    """The step kernels' CPU twins at 256 slots with 240 contested: over a
    hundred picks and a hundred records in one pass."""
    jcfg, cfg = _cfgs()
    tree = make_tree(21, G=256, V=5, M=512, n=240, obs_n=400)
    iou = tree["iou"]
    iou[np.random.RandomState(22).rand(256, 256) < 0.95] = 0.0  # ~3.6 pairs a row above 0
    contested, _ = step._contested(state_from_numpy(tree, device="cpu"), cfg)
    assert int(contested.sum()) >= 100
    js, ts = both(tree)
    jout, jkeep, jsucc = jax.jit(partial(jstep._nms_greedy, cfg=jcfg))(js)
    tout, tkeep, tsucc = step._nms_greedy(ts, cfg)
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(tsucc.numpy(), np.asarray(jsucc))
    assert_states_match(jout, tout)
    assert 20 < int(tkeep[:240].sum()) < 220 and int(tsucc.sum()) > 10


# ------------------------------------------------------------ correspondence
def _corr_case(seed):
    """Small new boxes (slots >= n_before) whose 2D boxes overlap the
    projections of kept globals, with higher and lower scores than theirs."""
    tree = make_tree(seed, n=10)
    rng = np.random.RandomState(seed + 1)
    n_before = 6
    tree["xyzlhw"][:, 3:] = rng.uniform(0.2, 0.45, (12, 3))
    tree["xyzlhw"][2, 3:] = 0.9  # a large global: not a candidate
    proj = tree["pred_boxes"].copy()
    for s, g in ((6, 0), (7, 1), (8, 2), (9, 3)):
        tree["pred_boxes"][s] = proj[g] + rng.uniform(-4, 4, 4)
    tree["scores"][[6, 7, 8, 9]] = [0.95, 0.2, 0.9, 0.5]
    tree["scores"][3] = 0.5  # a tie: the old box wins (new_wins needs <)
    keep = np.ones(12, bool)
    keep[[4, 10, 11]] = False
    success = np.zeros(12, bool)
    success[5] = True
    return tree, keep, success, n_before, proj.astype(np.float32)


def test_correspondence_matches_jax():
    jcfg, cfg = _cfgs()
    tree, keep, success, n_before, proj = _corr_case(9)
    js, ts = both(tree)
    jfn = jax.jit(partial(jstep._correspondence, cfg=jcfg))
    tfn = partial(step._correspondence, cfg=cfg)
    jout, jkeep = jfn(js, jnp.asarray(keep), jnp.asarray(success), jnp.int32(n_before), jnp.asarray(proj))
    reads0 = host_reads.count
    tout, tkeep = tfn(ts, torch.from_numpy(keep), torch.from_numpy(success),
                      torch.tensor(n_before, dtype=torch.int32), torch.from_numpy(proj))
    reads = host_reads.count - reads0
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    assert_states_match(jout, tout)
    dropped = keep & ~tkeep.numpy()
    bumped = state_to_numpy(tout)["valid_num"] != tree["valid_num"]
    # both outcomes happened: a new box won (its valid_num rose) and an old one did
    assert dropped.any() and bumped[:n_before].any() and bumped[n_before:].any()
    assert reads == 1


def test_iou2d_rows_is_iou_2d_row_by_row():
    from boxfusion_tpu_torch.geometry.iou import iou_2d

    t = make_tree(3)
    a, b = torch.from_numpy(t["pred_boxes"]), torch.from_numpy(t["pred_boxes"][::-1].copy())
    rows = step._iou2d_rows(a, b)
    for r in range(12):
        assert torch.equal(rows[r], iou_2d(a[r], b))


# ---------------------------------------------------------------- compaction
def test_compact_matches_jax():
    tree = make_tree(10)
    keep = np.array([1, 0, 1, 1, 0, 0, 1, 1, 1, 1, 1, 0], bool)  # slots past n = 9 are not kept
    js, ts = both(tree)
    jout = jax.jit(jstep._compact)(js, jnp.asarray(keep))
    tout = step._compact(ts, torch.from_numpy(keep))
    assert int(tout.n) == 6
    assert_states_match(jout, tout, float_tol=0.0)
    np.testing.assert_array_equal(state_to_numpy(tout)["init_id"][:6], tree["init_id"][[0, 2, 3, 6, 7, 8]])


# -------------------------------------------------------------------- fusion
def test_init_opt_params_batched_matches_jax_vmap():
    from boxfusion_tpu.fusion.optimizer import init_opt_params as jinit

    rng = np.random.RandomState(11)
    F, V = 5, 4
    box = np.concatenate([rng.uniform(-1, 1, (F, V, 3)), rng.uniform(0.2, 0.9, (F, V, 3))], -1).astype(np.float32)
    R = np.stack([_yaw(rng, V) for _ in range(F)])
    sc = rng.uniform(0.3, 0.9, (F, V)).round(1).astype(np.float32)  # score ties: the first wins
    m = (rng.rand(F, V) > 0.3).astype(np.float32)
    m[0] = 0.0  # an inactive slot
    wx, wR = jax.vmap(jinit)(jnp.asarray(box), jnp.asarray(R), jnp.asarray(sc), jnp.asarray(m))
    gx, gR = init_opt_params(*(torch.from_numpy(a) for a in (box, R, sc, m)))
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(gR.numpy(), np.asarray(wR))
    ox, oR = init_opt_params(*(torch.from_numpy(a[2]) for a in (box, R, sc, m)))
    np.testing.assert_array_equal(ox.numpy(), gx[2].numpy())
    np.testing.assert_array_equal(oR.numpy(), gR[2].numpy())


def _fusable_tree(seed):
    """A world whose multi-view boxes are seen from a ring of cameras: the
    observation corners are true projections, the members noisy copies."""
    from boxfusion_tpu_torch.geometry.boxes import box_corners
    from boxfusion_tpu_torch.geometry.projection import project_corners_to_image

    tree = make_tree(seed, G=12, V=5, M=40, n=8, obs_n=30)
    rng = np.random.RandomState(seed + 1)
    tree["xyzlhw"][:, :3] = rng.uniform(-0.6, 0.6, (12, 3))
    tree["xyzlhw"][:, 3:] = rng.uniform(0.3, 0.6, (12, 3))
    ang = rng.uniform(0, 2 * np.pi, 40)
    poses = np.tile(np.eye(4, dtype=np.float32), (40, 1, 1))
    for m in range(40):
        eye = np.array([3.5 * np.cos(ang[m]), 3.5 * np.sin(ang[m]), 0.5])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(np.array([0.0, 0.0, -1.0]), fwd)
        right /= np.linalg.norm(right)
        poses[m, :3, :3] = np.stack([right, np.cross(fwd, right), fwd], 1)
        poses[m, :3, 3] = eye
    tree["obs_pose"] = poses
    for g in range(8):
        for v in range(tree["fcount"][g]):
            o = tree["flist"][g, v]
            tree["obs_xyzlhw"][o] = tree["xyzlhw"][g] + rng.normal(0, 0.03, 6)
            tree["obs_R"][o] = tree["R"][g]
            c3 = box_corners(torch.from_numpy(tree["xyzlhw"][g][None]), torch.from_numpy(tree["R"][g][None]))
            tree["obs_corners2d"][o] = project_corners_to_image(
                c3, torch.from_numpy(poses[o][None]), torch.from_numpy(K_MAT), *HW)[0].numpy()
    return tree


def test_fuse_device_matches_jax():
    jcfg, cfg = _cfgs(max_fusions=3)
    tree = _fusable_tree(12)
    eligible = (tree["fcount"][:8] >= 3) & ~tree["already_valid"][:8]
    assert eligible.sum() > 3  # some slots are deferred past max_fusions
    js, ts = both(tree)
    pst = jax_load_pst(None, 128)
    jout = jax.jit(partial(jstep._fuse_device, cfg=jcfg))(
        js, jnp.asarray(pst), jnp.asarray(K_MAT), jnp.float32(HW[0]), jnp.float32(HW[1]))
    tout = step._fuse_device(ts, torch.from_numpy(np.asarray(pst)), torch.from_numpy(K_MAT), *HW, cfg)
    moved = np.asarray(jout.already_valid) & ~tree["already_valid"]
    assert moved.sum() == 3 and list(np.flatnonzero(moved)) == list(np.flatnonzero(eligible)[:3])
    # the IoU rows of moved boxes follow their coordinates: wider tolerance
    assert_states_match(jout, tout, fused=moved, skip=("iou",))
    np.testing.assert_allclose(state_to_numpy(tout)["iou"][:8, :8], np.asarray(jout.iou)[:8, :8], atol=0.05)
    assert int(tout.stats[6]) - tree["stats"][6] == eligible.sum() - 3


# ------------------------------------------------------------- the whole step
def _meta(pose, frame_idx):
    m = np.zeros(step.META_WIDTH, np.float32)
    m[:16], m[16:25], m[25:34], m[34:36], m[36] = pose.ravel(), K_MAT.ravel(), K_MAT.ravel(), HW, frame_idx
    return m


# the whole step's configuration in the cases below: one JAX compile serves
# every case that keeps it and the world's shapes
STEP_KW = dict(score_thresh=0.3, uv_bound=False, floor_mask=False, max_fusions=3, check_valid=True, gap=5)


def test_keyframe_step_entries_match_each_other_and_jax():
    """One keyframe on a populated world through keyframe_step,
    keyframe_step_devdet and keyframe_step_packed: the three entries give one
    state, and it is the JAX step's."""
    jcfg, cfg = _cfgs(**STEP_KW)
    tree = _fusable_tree(13)
    np.fill_diagonal(tree["iou"], 0.0)
    pose = np.eye(4, dtype=np.float32)
    det = make_det(14, K=8, near=tree)
    det["scores"][:4] = [0.9, 0.8, 0.7, 0.6]
    js, ts = both(tree)
    pst = np.asarray(jax_load_pst(None, 128))
    kmax = 10  # wider than the detector's 8 rows: devdet pads
    meta = _meta(pose, 40)
    jout = jstep.keyframe_step_devdet(js, jdet(det), jnp.asarray(meta), jnp.asarray(pst), jcfg, kmax)

    tpst = torch.from_numpy(pst)
    a = step.keyframe_step_devdet(ts, tdet(det), meta, tpst, cfg, kmax)
    padded = step.pad_detections(tdet(det), kmax)
    b = step.keyframe_step(ts, padded, tpst, pose, K_MAT, K_MAT, HW, 40, cfg)
    buf = np.zeros(kmax * step.DET_PACK_WIDTH + step.META_WIDTH, np.float32)
    packed = buf[: kmax * step.DET_PACK_WIDTH].reshape(kmax, step.DET_PACK_WIDTH)
    p = {k: v.numpy() for k, v in padded.items()}
    packed[:, 0], packed[:, 1:5], packed[:, 5:11] = p["scores"], p["pred_boxes"], p["boxes3d"]
    packed[:, 11:20], packed[:, 20:22], packed[:, 22] = p["R"].reshape(kmax, 9), p["proj_xy"], p["category"]
    buf[kmax * step.DET_PACK_WIDTH:] = meta
    c = step.keyframe_step_packed(ts, buf, tpst, cfg)
    for name in FIELD_NAMES:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
        assert torch.equal(getattr(a, name), getattr(c, name)), name

    n = int(jout.n)
    moved = np.zeros(12, bool)
    moved[:n] = np.any(np.asarray(jout.xyzlhw)[:n, None] != tree["xyzlhw"][None, :8], -1).all(1) & (
        np.asarray(jout.frame_id)[:n] != 40)
    assert_states_match(jout, a, fused=np.ones(12, bool), skip=("iou",))
    assert int(a.n) != 8 + 8 and int(a.stats[3]) == tree["stats"][3] + 1
    assert np.asarray(jout.fflag)[:n].any()
    np.testing.assert_array_equal(state_to_numpy(ts)["xyzlhw"], tree["xyzlhw"])  # input not written


def _step_both(tree, det, **kw):
    """One keyframe (frame 40, identity pose, kmax 10) through the JAX step and
    the port's; returns (JAX state, port state, the port's read sites)."""
    jcfg, cfg = _cfgs(**{**STEP_KW, **kw})
    js, ts = both(tree)
    pst = np.asarray(jax_load_pst(None, 128))
    meta = _meta(np.eye(4, dtype=np.float32), 40)
    jout = jstep.keyframe_step_devdet(js, jdet(det), jnp.asarray(meta), jnp.asarray(pst), jcfg, 10)
    with _read_sites() as sites:
        tout = step.keyframe_step_devdet(ts, tdet(det), meta, torch.from_numpy(pst), cfg, 10)
    return jout, tout, sites


class _read_sites:
    """The sites of the host reads made inside the block, in order."""

    def __enter__(self):
        from boxfusion_tpu_torch.utils import device

        sites, self.saved = [], device._Read

        class Recorded(device._Read):
            def __init__(self, reads, site):
                sites.append(site)
                super().__init__(reads, site)

        device._Read = Recorded
        return sites

    def __exit__(self, *exc):
        from boxfusion_tpu_torch.utils import device

        device._Read = self.saved


@pytest.mark.parametrize("budget,truncated", [(5, 8), (13, 0)], ids=["below", "equal"])
def test_gated_pair_truncation_matches_jax(budget, truncated):
    """max_gated_pairs below and at the keyframe's 13 gated pairs: the pairs
    past it are counted (stats[2]) and scored 0, as in the JAX step."""
    tree = _fusable_tree(13)
    np.fill_diagonal(tree["iou"], 0.0)
    det = make_det(14, K=8, near=tree)
    det["scores"][:4] = [0.9, 0.8, 0.7, 0.6]
    jout, tout, sites = _step_both(tree, det, fusion_use=False, max_gated_pairs=budget)
    assert int(tout.stats[2]) - tree["stats"][2] == truncated
    assert_states_match(jout, tout)
    assert sites.count("iou.gated") == 1


def test_keyframe_with_every_new_box_suppressed_stops_after_go(monkeypatch):
    """Every new detection lies on a higher-scoring world box: NMS suppresses
    all of them, and the step ends after the ``step.go`` read -- no
    correspondence, no stale drop, no fusion -- in the JAX step's state."""
    def never(*args, **kw):
        raise AssertionError("the step went past step.go")

    monkeypatch.setattr(step, "_correspondence", never)
    monkeypatch.setattr(step, "_fuse_device", never)
    tree = _fusable_tree(13)
    tree["iou"][:] = 0.0
    tree["scores"][:4] = 0.95
    tree["valid_num"][5], tree["frame_id"][5] = 0.0, 0  # stale: the drop would take it
    det = make_det(14, K=8, near=tree)
    det["R"][:4] = tree["R"][:4]
    det["scores"][:] = [0.5, 0.5, 0.45, 0.4, 0.1, 0.1, 0.1, 0.1]  # the last four fail the filter
    jout, tout, sites = _step_both(tree, det)
    assert_states_match(jout, tout)
    assert int(tout.n) == tree["n"] and sites[-1] == "step.go" and "correspond" not in sites
    eligible = (tree["fcount"][:8] >= 3) & ~tree["already_valid"][:8]
    assert eligible.any()  # a step that went on would fuse


def test_jax_snapshot_budget_count_passes_through_a_keyframe():
    """stats[7], which only the JAX package's unrolled engine writes, crosses
    state_from_numpy, a port keyframe and export_world unchanged."""
    from boxfusion_tpu_torch.runtime.device_state import export_world

    tree = _fusable_tree(13)
    np.fill_diagonal(tree["iou"], 0.0)
    tree["stats"][7] = 5
    det = make_det(14, K=8, near=tree)
    det["scores"][:4] = [0.9, 0.8, 0.7, 0.6]
    jout, tout, _ = _step_both(tree, det)
    got = export_world(tout)["stats"]
    assert got["nms_budget_exhausted"] == 5 and got["keyframes"] == tree["stats"][3] + 1
    assert list(got.values()) == np.asarray(jout.stats).tolist()


def _reads_det(centers, scores):
    n = len(centers)
    return dict(
        scores=torch.tensor(scores, dtype=torch.float32),
        pred_boxes=torch.tensor([[10.0, 10.0, 30.0, 30.0]] * n),
        boxes3d=torch.cat([torch.tensor(centers, dtype=torch.float32), torch.full((n, 3), 0.4)], 1),
        R=torch.eye(3).repeat(n, 1, 1),
        proj_xy=torch.zeros(n, 2),
        category=torch.zeros(n, dtype=torch.int32),
    )


@pytest.mark.parametrize("kind,want", [
    ("first", ["step.gate", "iou.gated"]),
    ("filtered", ["step.gate"]),
    ("new_rows", ["step.gate", "iou.gated", "nms", "nms", "step.go", "correspond", "fuse.done", "iou.gated"]),
], ids=["first", "filtered", "new_rows"])
def test_host_reads_per_keyframe(kind, want):
    """The reads of one keyframe on the CPU, by site, on a fixed scene: the
    first keyframe, one whose detections all fail the filter, and one with
    new rows (one suppressed, one kept; no fusion list long enough to fuse)."""
    cfg = step.StepConfig(score_thresh=0.3, uv_bound=False, floor_mask=False, max_fusions=3)
    state = init_state(16, 5, 64, device="cpu")
    pst = torch.zeros(128, 6)
    A, B, C = [0.0, 0.0, 3.0], [4.0, 0.0, 3.0], [-4.0, 0.0, 3.0]
    keyframes = {"first": _reads_det([A, B], [0.8, 0.8]),
                 "filtered": _reads_det([A, C], [0.1, 0.1]),
                 "new_rows": _reads_det([[0.02, 0.0, 3.0], C], [0.7, 0.8])}
    for i, (name, det) in enumerate(keyframes.items()):
        reads = host_reads.count
        with _read_sites() as sites:
            state = step.keyframe_step(state, det, pst, np.eye(4), K_MAT, K_MAT, HW, 5 * i, cfg)
        assert host_reads.count - reads == len(sites)
        if name == kind:
            break
    assert sites == want
    assert int(state.n) == {"first": 2, "filtered": 2, "new_rows": 3}[kind]
