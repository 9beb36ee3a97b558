"""The one-launch PST search (ops/pst_search.py) and its plain version.

This file imports torch and the port only -- no JAX -- so that its card tests
(marker ``cuda``) also run on a GPU machine that has no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_pst_search.py

On the CPU, ``optimize_boxes`` goes through ``pst_search_reference``, and
its numbers are those of the eager loop that ran before the search had a
kernel (``_eager_loop`` below), bit for bit.  On the card the kernel is held
to the plain version: ``need_update`` equal, fused boxes within 5e-3 (the
port's cross-stack PST bound: sums over particles are taken in another order
and the projection is rounded apart from torch's einsum, so a particle whose
fitness ties particle 0's within rounding can flip into or out of the
weighted mean, and the search is chaotic after that) and within 1e-3 after
one iteration, where no flip has had time to compound.
"""
import os
import sys

import pytest
import torch

from boxfusion_tpu_torch.fusion.kernel import multiview_fitness
from boxfusion_tpu_torch.fusion.optimizer import (
    PSTOptConfig,
    _cal_transform,
    _update_search_size,
    optimize_boxes,
)
from boxfusion_tpu_torch.ops import pst_search as search_mod
from boxfusion_tpu_torch.ops.fitness_kernel import prepare_observed
from boxfusion_tpu_torch.ops.pst_search import (
    CELL_CORNER_OPS,
    CELL_OPS,
    PARTICLE_CORNER_OPS,
    PARTICLE_OPS,
    operation_count,
    plan_pst_search,
    pst_search,
    pst_search_reference,
)
from boxfusion_tpu_torch.utils.device import host_reads

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from chip_smoke import pst_scene, search_args  # noqa: E402

SEARCH_TOL = 5e-3    # fused boxes after a full search (ROADMAP section C)
ONE_ITER_TOL = 1e-3  # fused boxes after one iteration


def _eager_loop(init_xyzlhw, init_R, pst, cam_poses, obs_corners, view_mask, obj_mask, K, H, W, cfg):
    """optimize_boxes(fitness_impl="kernel") as it ran before the search had
    a kernel: the eager loop around multiview_fitness, on the CPU."""
    xyzlhw0, R, poses, corners = init_xyzlhw, init_R, cam_poses, obs_corners
    vmask = view_mask > 0
    active = obj_mask.bool()
    N, V = vmask.shape
    prep = prepare_observed(corners.reshape(N * V, 8, 2))
    ss = torch.as_tensor([cfg.center_init_size] * 3 + [cfg.shape_init_size] * 3,
                         dtype=torch.float32).expand(N, 6)
    xyzlhw = xyzlhw0
    prev_ss = torch.zeros((N, 6), dtype=torch.float32)
    prev_success = torch.zeros(N, dtype=torch.bool)
    fail = torch.zeros(N, dtype=torch.int32)
    need_update = torch.zeros(N, dtype=torch.bool)
    done = ~active
    for _ in range(cfg.iters):
        if bool(done.all()):
            break
        fitness = multiview_fitness(xyzlhw, R, pst, ss, poses, corners, vmask & ~done[:, None], K, H, W,
                                    impl="kernel", prep=prep)
        success, mean_iou, mean_transform = _cal_transform(fitness, pst, ss, cfg.max_contributors)
        new_ss = _update_search_size(mean_iou, mean_transform, cfg)
        new_ss = torch.where((prev_success & success)[:, None],
                             cfg.beta * new_ss + (1.0 - cfg.beta) * prev_ss, new_ss)
        upd = success & ~done
        xyzlhw = torch.where(upd[:, None], xyzlhw + mean_transform, xyzlhw)
        prev_ss = torch.where(upd[:, None], new_ss, prev_ss)
        fail = torch.where(done, fail, torch.where(success, 0, fail + 1))
        need_update = need_update | upd
        new_done = done | (fail >= cfg.fail_limit)
        ss = torch.where(done[:, None], ss, new_ss)
        prev_success = torch.where(done, prev_success, success)
        done = new_done
    fused = torch.cat([xyzlhw[:, :3], torch.clamp(xyzlhw[:, 3:], min=0.01)], dim=-1)
    return torch.where(need_update[:, None], fused, xyzlhw0), need_update & active


def _small_scene(**kw):
    """Four objects x 4 view slots x 128 particles; object 3 inactive."""
    s = pst_scene("cpu", n_obj=4, n_views=4, n_particles=128, seed=3, **kw)
    s["obj_mask"][3] = False
    return s


def _optimize_args(s):
    return (s["init_xyzlhw"], s["init_R"], s["pst"], s["cam_poses"], s["obs_corners"], s["view_mask"],
            s["obj_mask"], s["K"], s["H"], s["W"])


def test_optimize_boxes_on_cpu_is_the_eager_loop_bit_for_bit(monkeypatch):
    s = _small_scene()
    cfg = PSTOptConfig(iters=6)
    calls = []
    real = search_mod.pst_search_reference
    monkeypatch.setattr(search_mod, "pst_search_reference", lambda *a, **k: calls.append(1) or real(*a, **k))
    launches = pst_search.launches
    got_x, got_u = optimize_boxes(*_optimize_args(s), cfg, device="cpu")
    want_x, want_u = _eager_loop(*_optimize_args(s), cfg)
    assert calls == [1] and pst_search.launches == launches
    assert torch.equal(got_u, want_u) and want_u[:3].all() and not want_u[3]
    assert torch.equal(got_x, want_x)
    # the plain version itself, and with the loop unrolled (no host read)
    fused, upd, iters = pst_search_reference(*search_args(s), cfg)
    assert torch.equal(fused, want_x) and torch.equal(upd, want_u)
    assert iters.dtype == torch.int32 and iters[3] == 0 and (iters[:3] >= 1).all() and (iters <= 6).all()
    reads = host_reads.count
    fused, upd, iters_u = pst_search_reference(*search_args(s), PSTOptConfig(iters=6, unroll=True))
    assert host_reads.count == reads
    assert torch.equal(fused, want_x) and torch.equal(upd, want_u) and torch.equal(iters_u, iters)


def test_search_counts_iterations_of_an_early_and_a_late_object():
    """An active object with no live view never beats particle 0: it fails
    fail_limit times and stops; the others run on."""
    s = _small_scene(offset=0.2)
    s["view_mask"][1] = 0.0
    cfg = PSTOptConfig(iters=8)
    fused, upd, iters = pst_search(*search_args(s), cfg)
    assert iters.tolist()[1] == cfg.fail_limit and iters.tolist()[3] == 0
    assert iters[0] > cfg.fail_limit and iters[2] > cfg.fail_limit
    assert not upd[1] and torch.equal(fused[1], s["init_xyzlhw"][1])


def _bad_args(case):
    args = list(search_args(_small_scene()))
    prep = dict(args[7])
    if case == "shape":
        args[1] = args[1][:, :2]
    elif case == "prep-shape":
        prep["hull"] = prep["hull"][:, :7].contiguous()
    elif case == "dtype":
        args[0] = args[0].double()
    elif case == "mask-dtype":
        args[5] = args[5].float()
    elif case == "device":
        args[3] = args[3].to("meta")
    elif case == "contiguous":
        args[2] = args[2].t().contiguous().t()
    elif case == "meta":
        args = [a.to("meta") if torch.is_tensor(a) else a for a in args]
        prep = {k: v.to("meta") for k, v in prep.items()}
    args[7] = prep
    return args


@pytest.mark.parametrize("case, error, match", [
    ("shape", ValueError, "R must be"), ("prep-shape", ValueError, "hull"),
    ("dtype", TypeError, "float32"), ("mask-dtype", TypeError, "torch.bool"),
    ("device", ValueError, "is on meta"), ("contiguous", ValueError, "contiguous"),
    ("meta", ValueError, "cuda or cpu"),
])
def test_pst_search_rejects_bad_arguments(case, error, match):
    before = pst_search.launches
    with pytest.raises(error, match=match):
        pst_search(*_bad_args(case), PSTOptConfig(iters=2))
    assert pst_search.launches == before


def test_plan_pst_search_lays_out_what_the_kernel_takes():
    for P, cluster in ((128, 1), (256, 2), (1024, 8)):
        plan = plan_pst_search(16, 10, P)
        assert (plan.cluster, plan.threads) == (cluster, 512)
    assert plan_pst_search(0, 1, 128).cluster == 1 and plan_pst_search(512, 16, 1024).cluster == 8
    for N, V, P, match in ((16, 10, 64, "P = 128 k"), (16, 10, 200, "P = 128 k"),
                           (16, 10, 2048, "P = 128 k"), (16, 0, 1024, "view slots"),
                           (16, 17, 1024, "view slots"), (-1, 10, 1024, "objects"),
                           (513, 10, 1024, "objects")):
        with pytest.raises(ValueError, match=match):
            plan_pst_search(N, V, P)


def test_operation_count_adds_up():
    """The counts are the sums of their terms, each counted from the source;
    a search's count is, per iteration an object ran, P x (live views x
    (fitness + CELL_OPS) + PARTICLE_OPS)."""
    assert PARTICLE_CORNER_OPS == dict(perturb=6 + 6 + 3, half_dims=3, signs=3 + 3, world=3 * 6)
    assert CELL_CORNER_OPS == dict(relative=3, camera=3 * 5, z_guard=3, pixel=2 * 5, centre=2)
    assert (PARTICLE_OPS, CELL_OPS) == (8 * 42, 8 * 33)
    iters = torch.tensor([20, 3, 0], dtype=torch.int32)
    vmask = torch.tensor([[1, 1, 1, 0], [1, 0, 0, 0], [1, 1, 1, 1]], dtype=torch.bool)
    want = (20 * 3 + 3 * 1) * 1024 * (5000.5 + 264) + (20 + 3) * 1024 * 336
    assert operation_count(iters, vmask, 1024, 5000.5) == round(want)


# ------------------------------------------------------------------ on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _held_to_plain(args, cfg, tol):
    got = pst_search(*args, cfg)
    want = pst_search_reference(*args, cfg)
    torch.cuda.synchronize()
    assert torch.isfinite(got[0]).all()
    assert torch.equal(got[1], want[1])
    assert float((got[0] - want[0]).abs().max()) <= tol
    return got, want


@pytest.mark.cuda
def test_pst_search_on_card_matches_plain_version():
    """The fitness scene: 16 objects x 10 view slots x 1024 particles, 20
    iterations."""
    dev = _card()
    args = search_args(pst_scene(dev))
    before = pst_search.launches
    (_, _, iters), (_, _, want_iters) = _held_to_plain(args, PSTOptConfig(iters=20), SEARCH_TOL)
    assert pst_search.launches == before + 1
    assert (iters >= 1).all() and (iters <= 20).all() and want_iters.min() >= 1


@pytest.mark.cuda
def test_pst_search_one_iteration_caps_contributors_past_the_first_cta():
    """One iteration from boxes 0.3 m off: over 200 particles beat particle
    0, so the max_contributors cap falls in a CTA other than the first."""
    from boxfusion_tpu_torch.fusion.kernel import project_candidates
    from boxfusion_tpu_torch.ops.fitness_kernel import fitness_cells_reference
    from boxfusion_tpu_torch.fusion.kernel import cell_fitness

    dev = _card()
    args = search_args(pst_scene(dev, offset=0.3, seed=1))
    init, R, pst, poses, K, vmask, _, prep, H, W = args
    ss = torch.tensor([0.1] * 3 + [0.5] * 3, device=dev).expand(init.shape[0], 6)
    fit = cell_fitness(project_candidates(init, R, pst, ss, poses, K, H, W), prep, vmask,
                       fitness_cells_reference)
    better = (fit[:, 1:] < fit[:, :1]).sum(1)
    assert int(better.max()) > 200
    (_, upd, iters), _ = _held_to_plain(args, PSTOptConfig(iters=1), ONE_ITER_TOL)
    assert (iters == 1).all() and upd.any()


@pytest.mark.cuda
def test_pst_search_early_and_late_objects_and_all_inactive():
    """The fitness scene with one object's views all dead.  The bound holds
    at this scene, not at every one: the search is chaotic whatever computes
    it -- on an NVIDIA H100 the plain version on the card and on the CPU end
    up to 0.32 m apart from 0.2 m starts, and on the CPU alone a relative
    change of 2e-7 in the start moves a box by 0.27 m there and by 6e-4 from
    the fitness scene's 0.05 m starts."""
    dev = _card()
    scene = pst_scene(dev)
    scene["view_mask"][1] = 0.0  # never beats particle 0: stops after fail_limit
    cfg = PSTOptConfig(iters=20)
    (_, _, iters), (_, _, want_iters) = _held_to_plain(search_args(scene), cfg, SEARCH_TOL)
    assert iters[1] == cfg.fail_limit == want_iters[1] and iters.max() > cfg.fail_limit

    scene["obj_mask"][:] = False
    before = pst_search.launches
    fused, upd, iters = pst_search(*search_args(scene), cfg)
    torch.cuda.synchronize()
    assert pst_search.launches == before + 1
    assert torch.equal(fused, scene["init_xyzlhw"]) and not upd.any() and not iters.any()


@pytest.mark.cuda
def test_optimize_boxes_on_card_is_one_launch_and_no_host_read():
    from boxfusion_tpu_torch.ops.fitness_kernel import fitness_cells

    dev = _card()
    s = pst_scene(dev)
    optimize_boxes(*_optimize_args(s), PSTOptConfig(iters=20), device=dev)  # build and load first
    before = (pst_search.launches, fitness_cells.launches, host_reads.count)
    fused, upd = optimize_boxes(*_optimize_args(s), PSTOptConfig(iters=20), device=dev)
    assert (pst_search.launches, fitness_cells.launches, host_reads.count) == (
        before[0] + 1, before[1], before[2])
    torch.cuda.synchronize()
    assert fused.shape == (16, 6) and upd.dtype == torch.bool and torch.isfinite(fused).all()
