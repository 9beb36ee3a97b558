"""The whole PST search by the plain eager loop (a frozen copy of the port's
``pst_search_reference``): ``fusion/optimizer.py:search_loop`` around the
plain fitness, each iteration projecting the candidates and scoring the
(object x view) cells."""
from __future__ import annotations

import torch

from benchmark.reference.ops.fitness_kernel import N_OBS_PLANES

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


def pst_search_reference(init_xyzlhw, R, pst, cam_poses, K, view_mask, obj_mask, prep, H, W, cfg):
    """Plain PyTorch version: the eager loop (``fusion/optimizer.py:
    search_loop``), each iteration projecting the candidates and scoring the
    (object x view) cells with the plain fitness.  Same arguments and
    results as ``pst_search``."""
    from benchmark.reference.fusion.kernel import cell_fitness, project_candidates
    from benchmark.reference.fusion.optimizer import search_loop

    def fitness(xyzlhw, search_size, done):
        uv = project_candidates(xyzlhw, R, pst, search_size, cam_poses, K, H, W)
        # converged objects' views are masked: their cells are skipped
        return cell_fitness(uv, prep, view_mask & ~done[:, None])

    return search_loop(init_xyzlhw, pst, obj_mask, fitness, cfg)


def pst_search(init_xyzlhw, R, pst, cam_poses, K, view_mask, obj_mask, prep, H, W, cfg):
    """The PST search of N objects by the plain eager loop, on any device."""
    _check_args(init_xyzlhw, R, pst, cam_poses, K, view_mask, obj_mask, prep)
    return pst_search_reference(init_xyzlhw, R, pst, cam_poses, K, view_mask, obj_mask,
                                prep, H, W, cfg)
