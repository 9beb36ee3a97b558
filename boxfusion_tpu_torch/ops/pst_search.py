"""The whole PST search in one launch: CUDA for Hopper, with its plain version.

``pst_search`` runs what ``boxfusion_tpu/fusion/optimizer.py:optimize_boxes``
runs on a TPU as one device program -- a ``jax.vmap`` over objects of a
``lax.while_loop`` whose body calls the Pallas fitness kernel
(``fitness_cells_pallas``) -- as one kernel launch for a batch of objects:
projection, fitness, the particle reduction, the search-size update and the
per-object early exit, all on the card, with no host read.  On a CUDA tensor
it launches ``csrc/pst_search_kernel.cu`` (one thread-block cluster per
object; built with nvcc at first use, ops/build.py) and counts the launch in
``pst_search.launches``; on a CPU tensor it runs ``pst_search_reference``,
the eager loop of ``fusion/optimizer.py:search_loop`` around the plain
fitness twin.  There is no other path: a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from boxfusion_tpu_torch.ops import build
from boxfusion_tpu_torch.ops.fitness_kernel import N_OBS_PLANES, fitness_cells_reference

# The kernel's layout (csrc/pst_search_kernel.cu): 128 particles per CTA, 4
# view lanes per particle, one cluster of P / 128 CTAs per object (at most 8,
# the portable cluster size), at most 16 view slots and 512 objects.
PARTICLES_PER_CTA = 128
VIEW_LANES = 4
MAX_CLUSTER = 8
MAX_VIEWS = 16
MAX_OBJECTS = 512

# float32 operations besides the fitness body's (ops/fitness_kernel.py:
# OPS_PER_LIVE_PARTICLE), per iteration, counted from
# csrc/pst_search_kernel.cu (add, sub, mul, div, abs, neg, min, max, compare
# and select count one each).  Per particle, for each of its 8 corners
# (world_corner): the candidate x + pst * ss with dims clamped >= 0.01 (6
# mul, 6 add, 3 max), half dims (3), signed (3 neg, 3 select), R local +
# centre (3 x (3 mul, 3 add)).
PARTICLE_CORNER_OPS = dict(perturb=6 + 6 + 3, half_dims=3, signs=3 + 3, world=3 * (3 + 3))
PARTICLE_OPS = 8 * sum(PARTICLE_CORNER_OPS.values())
# Per live (view, particle) cell, for each corner (project_particle): minus
# the camera position (3), pose^T rel (3 x (3 mul, 2 add)), the z guard
# (abs, compare, select), pixel coordinates (2 x (mul, div, add, max, min)),
# minus the view's centre (2).
CELL_CORNER_OPS = dict(relative=3, camera=3 * (3 + 2), z_guard=3, pixel=2 * 5, centre=2)
CELL_OPS = 8 * sum(CELL_CORNER_OPS.values())


@dataclasses.dataclass(frozen=True)
class SearchPlan:
    """The launch layout: CTAs per object (one cluster), threads per CTA."""

    cluster: int
    threads: int


def plan_pst_search(N: int, V: int, P: int) -> SearchPlan:
    """The one layout the kernel takes for N objects, V view slots and P
    particles: a cluster of P / 128 CTAs per object, 128 particles x 4 view
    lanes = 512 threads each.  Raises ValueError where the kernel has none."""
    if not 0 <= N <= MAX_OBJECTS:
        raise ValueError(f"pst_search takes 0 to {MAX_OBJECTS} objects, got {N}")
    if not 1 <= V <= MAX_VIEWS:
        raise ValueError(f"pst_search takes 1 to {MAX_VIEWS} view slots, got {V}")
    if P % PARTICLES_PER_CTA or not 1 <= P // PARTICLES_PER_CTA <= MAX_CLUSTER:
        raise ValueError(
            f"pst_search takes P = 128 k particles, k in 1..{MAX_CLUSTER}, got {P}")
    return SearchPlan(cluster=P // PARTICLES_PER_CTA, threads=PARTICLES_PER_CTA * VIEW_LANES)


def operation_count(iterations: torch.Tensor, view_mask: torch.Tensor, n_particles: int,
                    fitness_ops: float) -> int:
    """float32 operations of one search: for every iteration an object ran,
    P particles' corners (PARTICLE_OPS) and, in each live view, P cells of
    projection (CELL_OPS) and fitness body (``fitness_ops``: this run's mean
    per live particle-cell, from ``fitness_kernel.operation_count``, which
    depends on the data).

    Args:
      iterations: (N,) iterations each object ran; view_mask: (N, V).
    """
    its = iterations.long()
    cells = int((its * (view_mask > 0).sum(-1)).sum()) * n_particles
    return round(cells * (fitness_ops + CELL_OPS) + int(its.sum()) * n_particles * PARTICLE_OPS)


_PREP_SHAPES = dict(center=(2,), hull=(8, 2), planes=(N_OBS_PLANES, 3), pvalid=(N_OBS_PLANES,), area=())


def _check_args(init_xyzlhw, R, pst, cam_poses, K, view_mask, obj_mask, prep) -> None:
    if init_xyzlhw.dim() != 2 or init_xyzlhw.shape[1] != 6:
        raise ValueError(f"init_xyzlhw must be (N, 6), got {tuple(init_xyzlhw.shape)}")
    if view_mask.dim() != 2 or pst.dim() != 2 or pst.shape[1] != 6:
        raise ValueError(f"view_mask must be (N, V) and pst (P, 6), got "
                         f"{tuple(view_mask.shape)} and {tuple(pst.shape)}")
    N, V = view_mask.shape
    floats = dict(init_xyzlhw=(init_xyzlhw, (N, 6)), R=(R, (N, 3, 3)), pst=(pst, tuple(pst.shape)),
                  cam_poses=(cam_poses, (N, V, 4, 4)), K=(K, (3, 3)))
    floats.update({f"prep[{k!r}]": (prep[k], (N * V, *shape)) for k, shape in _PREP_SHAPES.items()})
    masks = dict(view_mask=(view_mask, (N, V)), obj_mask=(obj_mask, (N,)))
    for name, (t, shape) in {**floats, **masks}.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        want = torch.bool if name in masks else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if t.device != init_xyzlhw.device:
            raise ValueError(f"{name} is on {t.device}, init_xyzlhw on {init_xyzlhw.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def pst_search_reference(init_xyzlhw, R, pst, cam_poses, K, view_mask, obj_mask, prep, H, W, cfg,
                         cells=fitness_cells_reference):
    """Plain PyTorch version: the eager loop (``fusion/optimizer.py:
    search_loop``), each iteration projecting the candidates and calling
    ``cells`` -- the plain fitness twin, or ``fitness_cells`` for the
    one-iteration kernel -- on the (object x view) cells.  Same arguments and
    results as ``pst_search``."""
    from boxfusion_tpu_torch.fusion.kernel import cell_fitness, project_candidates
    from boxfusion_tpu_torch.fusion.optimizer import search_loop

    def fitness(xyzlhw, search_size, done):
        uv = project_candidates(xyzlhw, R, pst, search_size, cam_poses, K, H, W)
        # converged objects' views are masked: their cells are skipped
        return cell_fitness(uv, prep, view_mask & ~done[:, None], cells)

    return search_loop(init_xyzlhw, pst, obj_mask, fitness, cfg)


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load("pst_search_kernel")
    lib.pst_search_launch.argtypes = (
        [ctypes.c_void_p] * 15 + [ctypes.c_int] * 8 + [ctypes.c_float] * 9 + [ctypes.c_void_p])
    lib.pst_search_launch.restype = ctypes.c_int
    lib.pst_search_info.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.pst_search_info.restype = ctypes.c_int
    return lib


def kernel_info(P: int) -> dict:
    """What the compiler and the occupancy calculator say of the kernel at
    plan_pst_search's layout for P particles: registers and local (spill +
    stack) bytes per thread, static shared bytes per CTA, threads per CTA,
    CTAs per cluster and clusters resident on the card at once.  Needs a
    card (it loads the library)."""
    info = (ctypes.c_int * 6)()
    rc = _library().pst_search_info(P, info)
    if rc != 0:
        raise RuntimeError(f"pst_search_info failed: cudaError_t {rc}")
    return dict(registers=info[0], local_bytes=info[1], smem_bytes=info[2], threads=info[3],
                cluster=info[4], max_active_clusters=info[5])


def pst_search(init_xyzlhw, R, pst, cam_poses, K, view_mask, obj_mask, prep, H, W, cfg):
    """The PST search of N objects, one launch on a CUDA device.

    Args:
      init_xyzlhw: (N, 6) initial boxes; R: (N, 3, 3) fixed rotations;
      pst: (P, 6) particle table (row 0 identity); cam_poses: (N, V, 4, 4)
      camera-to-world; K: (3, 3) -- all float32.
      view_mask: (N, V) bool live view slots; obj_mask: (N,) bool real objects.
      prep: ``prepare_observed`` of the (N * V) observed polygons.
      H, W: image bounds.  cfg: ``PSTOptConfig`` (its ``fitness_impl`` is
        not read: the loop runs on the card, with no read).
      All tensors contiguous, on one device.

    Returns:
      (fused (N, 6), need_update (N,) bool, iterations (N,) int32): the fused
      boxes (the initial box where nothing was fused), whether each was
      fused, and how many iterations each object ran.  On a CUDA device the
      launch is asynchronous on the current stream.
    """
    _check_args(init_xyzlhw, R, pst, cam_poses, K, view_mask, obj_mask, prep)
    dev = init_xyzlhw.device
    if dev.type == "cpu":
        return pst_search_reference(init_xyzlhw, R, pst, cam_poses, K, view_mask, obj_mask,
                                    prep, H, W, cfg)
    if dev.type != "cuda":
        raise ValueError(f"pst_search runs on cuda or cpu tensors, got {dev}")
    N, V = view_mask.shape
    P = pst.shape[0]
    plan = plan_pst_search(N, V, P)
    fused = torch.empty((N, 6), dtype=torch.float32, device=dev)
    need_update = torch.empty(N, dtype=torch.bool, device=dev)
    iterations = torch.empty(N, dtype=torch.int32, device=dev)
    ptrs = [t.data_ptr() for t in (init_xyzlhw, R, pst, cam_poses, K, view_mask, obj_mask,
                                   prep["center"], prep["hull"], prep["planes"], prep["pvalid"],
                                   prep["area"], fused, need_update, iterations)]
    with torch.cuda.device(dev):
        rc = _library().pst_search_launch(
            *ptrs, N, V, P, plan.cluster, plan.threads, cfg.iters, cfg.max_contributors,
            cfg.fail_limit, float(H), float(W), cfg.center_init_size, cfg.shape_init_size,
            cfg.center_scaling_coefficient, cfg.shape_scaling_coefficient, cfg.beta,
            1.0 - cfg.beta, cfg.min_scale, torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"pst_search kernel launch failed: cudaError_t {rc}")
    pst_search.launches += int(N > 0)  # the C entry launches nothing for no object
    return fused, need_update, iterations


pst_search.launches = 0
