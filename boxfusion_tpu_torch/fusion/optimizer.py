"""PST box-fusion optimizer (torch), batched over objects.

Port of ``boxfusion_tpu/fusion/optimizer.py``.  Capability target: the
host-side optimizer loop of ``BoxFusion`` (reference box_fusion.py:463-724):

  * ``init_opt_params`` (566-600): center = mean of member centers, dims =
    mean of axis-sorted member dims permuted to the best-scoring box's axis
    order, rotation = best-scoring box's rotation;
  * ``init_searchsize`` (468-473) + per-iteration ``evaluate_iou`` (the
    fitness kernel), ``cal_transform`` (475-535: weighted mean over
    particles that beat particle 0, first-200 cap), ``update_PST`` (537-563:
    anisotropic rescale proportional to fitness), EMA smoothing across
    consecutive successes (685-691, beta=0.9), stop after 3 consecutive
    failures (708-714), final dims clamp >= 0.01 (716-720).

The JAX version vmaps over objects and runs a ``while_loop`` per object on
the device.  Here, with ``fitness_impl="kernel"`` (the default) on a CUDA
device, the whole search of all N objects is one launch of
``ops.pst_search.pst_search`` (one thread-block cluster per object; the loop,
its early exit and the particle reduction run on the card, and nothing is
read back: ``cfg.unroll`` changes nothing there).  On the CPU, and with
``fitness_impl="reference"``, ``search_loop`` runs it eagerly: all N objects
step together, converged objects are frozen (their updates are masked by
``done``) and their view cells are masked out of the fitness call, so the
trajectory does not depend on when the loop stops.  With ``cfg.unroll`` that
loop runs its fixed ``cfg.iters`` iterations and reads nothing back; without
it (the default, as in the JAX package) it reads one flag per iteration --
every object done? -- and stops early, as the ``while_loop`` does
(utils/device.py:host_reads counts the reads).
"""
from __future__ import annotations

import dataclasses

import torch

from boxfusion_tpu_torch.fusion.kernel import multiview_fitness
from boxfusion_tpu_torch.ops.fitness_kernel import prepare_observed
from boxfusion_tpu_torch.ops.pst_search import pst_search
from boxfusion_tpu_torch.utils.device import DeviceLike, host_reads, resolve_device


@dataclasses.dataclass(frozen=True)
class PSTOptConfig:
    iters: int = 20
    center_init_size: float = 0.1
    center_scaling_coefficient: float = 0.1
    shape_init_size: float = 0.5
    shape_scaling_coefficient: float = 0.5
    beta: float = 0.9  # EMA across consecutive successes (box_fusion.py:622)
    max_contributors: int = 200  # cal_transform cap (box_fusion.py:514)
    min_scale: float = 1e-3
    fail_limit: int = 3
    # "kernel" (prepare_observed + pst_search: one CUDA launch for the whole
    # search on a GPU, the eager loop around the plain fitness twin on the
    # CPU) or "reference" (the eager loop around the prepare_polygon path).
    fitness_impl: str = "kernel"
    # The eager loop only.  True: run the fixed `iters` iterations with no
    # device-to-host read.  False: read one flag per iteration and stop once
    # every object is done.  Identical trajectory -- the body freezes
    # converged objects.
    unroll: bool = False


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along the last axis (``jnp.argmax``'s tie
    rule, spelled out so that no backend's choice among ties matters)."""
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device)
    return torch.where(x == x.amax(-1, keepdim=True), idx, n).amin(-1)


def init_opt_params(box_3d: torch.Tensor, R: torch.Tensor, scores: torch.Tensor, mask: torch.Tensor):
    """Initialization from member observations (box_fusion.py:566-600).

    Works on one object or, with leading batch axes, on many at once (the
    JAX package vmaps it over the fusion slots).

    Args:
      box_3d: (..., V, 6) member xyzlhw.  R: (..., V, 3, 3).  scores: (..., V).
      mask: (..., V) valid member slots.

    Returns:
      (xyzlhw (..., 6), R (..., 3, 3)).
    """
    m = mask.to(box_3d.dtype)
    nv = torch.clamp(m.sum(-1, keepdim=True), min=1.0)
    best = _first_argmax(torch.where(mask.bool(), scores, -torch.inf))  # (...)
    mean_xyz = (box_3d[..., :3] * m[..., None]).sum(-2) / nv
    best_dims = torch.gather(
        box_3d[..., 3:], -2, best[..., None, None].expand(*best.shape, 1, 3)
    )[..., 0, :]
    # get_indices[i] = rank position of axis i among the best box's dims
    get_indices = torch.argsort(torch.argsort(best_dims, dim=-1, stable=True), dim=-1, stable=True)
    dims_sorted = torch.sort(box_3d[..., 3:], dim=-1).values  # (..., V, 3) small->large
    dims_in_best_order = torch.gather(
        dims_sorted, -1, get_indices[..., None, :].expand(dims_sorted.shape)
    )
    mean_dims = (dims_in_best_order * m[..., None]).sum(-2) / nv
    best_R = torch.gather(R, -3, best[..., None, None, None].expand(*best.shape, 1, 3, 3))[..., 0, :, :]
    return torch.cat([mean_xyz, mean_dims], dim=-1), best_R


def _cal_transform(fitness: torch.Tensor, pst: torch.Tensor, search_size: torch.Tensor, cap: int):
    """Weighted particle mean (box_fusion.py:475-535), per object.

    Args:
      fitness: (N, P); pst: (P, 6); search_size: (N, 6).

    Returns (success (N,), mean_iou (N,), mean_transform (N, 6)).
    """
    f0 = fitness[:, :1]
    f = fitness[:, 1:]
    better = f < f0
    rank = torch.cumsum(better.to(torch.int32), dim=1)
    use = better & (rank <= cap)

    w = torch.where(use, f0 - f, 0.0)
    sw = w.sum(1)
    success = sw > 0
    denom = torch.where(success, sw, 1.0)[:, None]

    sums = (pst[None, 1:] * w[..., None]).sum(1)  # (N, 6)
    mean_transform = (sums / denom) * search_size
    mean_iou = (f * w).sum(1, keepdim=True) / denom
    mean_iou = torch.where(success[:, None], mean_iou, f0)[:, 0]
    mean_transform = torch.where(success[:, None], mean_transform, 0.0)
    return success, mean_iou, mean_transform


def _update_search_size(iou: torch.Tensor, mean_transform: torch.Tensor, cfg: PSTOptConfig):
    """Anisotropic search rescale (box_fusion.py:537-563), per object."""
    s = mean_transform.abs() + cfg.min_scale
    normal = s / torch.sqrt((s * s).sum(-1, keepdim=True))
    scale = torch.tensor(
        [cfg.center_scaling_coefficient] * 3 + [cfg.shape_scaling_coefficient] * 3,
        dtype=s.dtype, device=s.device,
    )
    return scale * iou[:, None] * normal + cfg.min_scale


def search_loop(xyzlhw0: torch.Tensor, pst: torch.Tensor, active: torch.Tensor, fitness,
                cfg: PSTOptConfig):
    """The PST search as an eager loop over iterations, all objects at once.

    Args:
      xyzlhw0: (N, 6) initial boxes; pst: (P, 6); active: (N,) bool.
      fitness: ``fitness(xyzlhw, search_size, done) -> (N, P)``, the fitness
        of every particle with the views of ``done`` objects masked.

    Returns:
      (fused (N, 6), need_update (N,) bool, iterations (N,) int32).
    """
    dev = xyzlhw0.device
    N = xyzlhw0.shape[0]
    ss = torch.tensor([cfg.center_init_size] * 3 + [cfg.shape_init_size] * 3,
                      dtype=torch.float32, device=dev).expand(N, 6)
    xyzlhw = xyzlhw0
    prev_ss = torch.zeros((N, 6), dtype=torch.float32, device=dev)
    prev_success = torch.zeros(N, dtype=torch.bool, device=dev)
    fail = torch.zeros(N, dtype=torch.int32, device=dev)
    need_update = torch.zeros(N, dtype=torch.bool, device=dev)
    iterations = torch.zeros(N, dtype=torch.int32, device=dev)
    done = ~active  # inactive slots are born converged

    for _ in range(cfg.iters):
        if not cfg.unroll and host_reads.read(done.all()):
            break
        success, mean_iou, mean_transform = _cal_transform(
            fitness(xyzlhw, ss, done), pst, ss, cfg.max_contributors)
        new_ss = _update_search_size(mean_iou, mean_transform, cfg)
        new_ss = torch.where(
            (prev_success & success)[:, None],
            cfg.beta * new_ss + (1.0 - cfg.beta) * prev_ss,
            new_ss,
        )

        upd = success & ~done
        xyzlhw = torch.where(upd[:, None], xyzlhw + mean_transform, xyzlhw)
        prev_ss = torch.where(upd[:, None], new_ss, prev_ss)
        fail = torch.where(done, fail, torch.where(success, 0, fail + 1))
        need_update = need_update | upd
        iterations = iterations + (~done).to(torch.int32)
        new_done = done | (fail >= cfg.fail_limit)
        ss = torch.where(done[:, None], ss, new_ss)
        prev_success = torch.where(done, prev_success, success)
        done = new_done

    # final dims clamp (box_fusion.py:716-720), applied only when fused
    fused = torch.cat([xyzlhw[:, :3], torch.clamp(xyzlhw[:, 3:], min=0.01)], dim=-1)
    return torch.where(need_update[:, None], fused, xyzlhw0), need_update & active, iterations


def optimize_boxes(
    init_xyzlhw,
    init_R,
    pst,
    cam_poses,
    obs_corners,
    view_mask,
    obj_mask,
    K,
    H: float,
    W: float,
    cfg: PSTOptConfig = PSTOptConfig(),
    device: DeviceLike = None,
):
    """Run the PST optimization for a batch of objects.

    Args:
      init_xyzlhw: (N, 6) initial parameters (from `init_opt_params`).
      init_R: (N, 3, 3) fixed rotations.
      pst: (P, 6) particle table (row 0 identity).
      cam_poses: (N, V, 4, 4); obs_corners: (N, V, 8, 2);
      view_mask: (N, V) member-slot validity.
      obj_mask: (N,) which object slots are real.
      K: (3, 3); H, W: image bounds.
      device: where to run (default "cuda"); array inputs are moved there.

    Returns:
      (fused_xyzlhw (N, 6), need_update (N,) bool), on ``device``.  With
      ``cfg.fitness_impl == "kernel"`` on a CUDA device this is one launch
      of ``pst_search`` and reads nothing back.
    """
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()

    xyzlhw0 = f32(init_xyzlhw)
    R = f32(init_R)
    pst = f32(pst)
    poses = f32(cam_poses)
    corners = f32(obs_corners)
    vmask = f32(view_mask) > 0
    active = torch.as_tensor(obj_mask, device=dev).bool().contiguous()
    K = f32(K)
    N, V = vmask.shape

    if cfg.fitness_impl == "kernel":
        prep = prepare_observed(corners.reshape(N * V, 8, 2))  # once per view
        fused, need_update, _ = pst_search(xyzlhw0, R, pst, poses, K, vmask, active, prep, H, W, cfg)
        return fused, need_update

    def fitness(xyzlhw, ss, done):
        # converged objects' views are masked: their cells are skipped
        return multiview_fitness(
            xyzlhw, R, pst, ss, poses, corners, vmask & ~done[:, None], K, H, W,
            impl=cfg.fitness_impl,
        )

    fused, need_update, _ = search_loop(xyzlhw0, pst, active, fitness, cfg)
    return fused, need_update
