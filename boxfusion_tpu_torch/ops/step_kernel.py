"""The keyframe step's two serial loops in one launch each: CUDA for Hopper,
with their plain twins.

``nms_greedy`` runs the greedy NMS of ``runtime/device_step.py:_nms_greedy``
after its vectorised part (``_contested``): survivor picks in score order,
the suppression pass over the pick's row of the IoU cache, and each
suppressed slot's record (``_record_core``, the manager bookkeeping of
box_manager.py:40-88) in score-descending order.  ``correspond_hits`` runs
the hits of the correspondence pass (``_corr_body`` for each slot of
``todo``, ascending) after its vectorised plan (``_corr_plan``).

On CUDA tensors each launches one thread block of ``csrc/step_kernel.cu``
(built with nvcc at first use, ops/build.py) and counts the launch in
``nms_greedy.launches`` / ``correspond_hits.launches``: no host read, and
no launch per pick or record.  On CPU tensors each runs its twin
(``nms_greedy_reference``, ``correspond_hits_reference``): the eager loop
the step ran before, with one counted host read per pick (site ``nms``) or
per pass (site ``correspond``).  There is no other path: a CUDA tensor
launches the kernel or raises.

Both paths add their serial work to the device's ``tally``: NMS survivor
picks, suppression records and correspondence hits (``TALLY_NAMES``), int64
on the device, totals over the process; ``counts`` reads it (one read of the
card, so never inside a keyframe).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from boxfusion_tpu_torch.ops import build
from boxfusion_tpu_torch.utils.device import host_reads

# The kernels' limits (csrc/step_kernel.cu): one lane per view slot, 13
# bytes of shared memory per world slot.
MAX_VIEWS = 16
MAX_CAPACITY = 16384

TALLY_NAMES = ("picks", "records", "hits")
_TALLIES: Dict[torch.device, torch.Tensor] = {}


def _device_key(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def tally(device) -> torch.Tensor:
    """The (3,) int64 tally of ``device`` (picks, records, hits), made on
    first use; both paths add to it in place."""
    dev = _device_key(device)
    t = _TALLIES.get(dev)
    if t is None:
        with torch.inference_mode(False):  # updated in and out of inference mode
            t = torch.zeros(len(TALLY_NAMES), dtype=torch.int64, device=dev)
        _TALLIES[dev] = t
    return t


def counts(device) -> Dict[str, int]:
    """``tally(device)`` on the host, by name."""
    return dict(zip(TALLY_NAMES, tally(device).tolist()))


def nms_greedy_reference(scores, iou, contested, isolated, flist, fcount, fflag, valid_num,
                         xyzlhw, obs_pose, init_id, cfg):
    """Plain PyTorch version: the eager loop, one host read per survivor
    pick (how many boxes it suppressed, and whether any box remains).  Same
    arguments and results as ``nms_greedy``."""
    from boxfusion_tpu_torch.runtime.device_step import (
        _argmax_score_desc,
        _center_far,
        _record_core,
    )

    G = scores.shape[0]
    remaining, keep = contested.clone(), isolated.clone()
    success = torch.zeros(G, dtype=torch.bool, device=scores.device)
    flist, fcount, fflag = flist.clone(), fcount.clone(), fflag.clone()
    valid_num = valid_num.clone()
    trunc_acc = torch.zeros((), dtype=torch.int32, device=scores.device)
    picks = records = 0

    more = host_reads.read(remaining.any(), "nms")
    while more:
        i = _argmax_score_desc(scores, remaining)
        keep[i] = True
        remaining[i] = False

        supp = remaining & (iou[i][0] > cfg.nms_threshold)
        remaining &= ~supp

        n_supp = supp.sum()
        any_supp = n_supp > 0
        valid_num[i] = valid_num[i] + any_supp.to(valid_num.dtype)
        success[i] = success[i] | any_supp

        n_records, more = host_reads.read(torch.stack([n_supp, remaining.any().to(n_supp.dtype)]), "nms")
        picks, records = picks + 1, records + n_records
        # process suppressed in score-descending order
        for _ in range(n_records):
            j = _argmax_score_desc(scores, supp)
            supp[j] = False
            trunc_acc += _record_core(
                flist, fcount, fflag, keep, i, j, _center_far(xyzlhw, i, j),
                obs_pose, init_id, cfg,
            )
    tally(scores.device).add_(torch.tensor([picks, records, 0]).to(scores.device))
    return keep, success, flist, fcount, fflag, valid_num, trunc_acc


def correspond_hits_reference(todo, best, new_wins, keep, flist, fcount, fflag, valid_num,
                              obs_pose, init_id, cfg):
    """Plain PyTorch version: one host read (how many pending boxes hit),
    then ``_corr_body`` once per hit.  Same arguments and results as
    ``correspond_hits``."""
    from boxfusion_tpu_torch.runtime.device_step import _corr_body

    todo = todo.clone()
    flist, fcount, fflag = flist.clone(), fcount.clone(), fflag.clone()
    keep, valid_num = keep.clone(), valid_num.clone()
    trunc_acc = torch.zeros((), dtype=torch.int32, device=todo.device)
    hits = host_reads.read(todo.sum(), "correspond")
    for _ in range(hits):
        trunc_acc += _corr_body(
            todo, best, new_wins, flist, fcount, fflag, keep, valid_num, obs_pose, init_id, cfg
        )
    tally(todo.device).add_(torch.tensor([0, 0, hits]).to(todo.device))
    return keep, flist, fcount, fflag, valid_num, trunc_acc


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load("step_kernel")
    lib.step_nms_greedy_launch.argtypes = (
        [ctypes.c_void_p] * 19 + [ctypes.c_int] * 3 + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    lib.step_nms_greedy_launch.restype = ctypes.c_int
    lib.step_correspond_hits_launch.argtypes = (
        [ctypes.c_void_p] * 17 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    lib.step_correspond_hits_launch.restype = ctypes.c_int
    lib.step_kernel_info.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.step_kernel_info.restype = ctypes.c_int
    lib.step_pose_bits.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_float] * 2
                                   + [ctypes.c_void_p] * 2)
    lib.step_pose_bits.restype = ctypes.c_int
    return lib


def kernel_info(G: int) -> Dict[str, dict]:
    """What the compiler says of each kernel: registers and local (spill +
    stack) bytes per thread, static shared bytes, threads per block, and
    dynamic shared bytes at capacity ``G``.  Needs a card (it loads the
    library)."""
    out = {}
    for which, name in enumerate(("nms_greedy", "correspond_hits")):
        info = (ctypes.c_int * 5)()
        rc = _library().step_kernel_info(which, G, info)
        if rc != 0:
            raise RuntimeError(f"step_kernel_info failed: cudaError_t {rc}")
        out[name] = dict(registers=info[0], local_bytes=info[1], smem_bytes=info[2], threads=info[3],
                         dynamic_smem_bytes=info[4])
    return out


# pose_bits' columns: the kernels' own terms of the pose test
POSE_BITS_COLUMNS = ("baseline", "trace", "angle", "differs")


def pose_bits(pm: torch.Tensor, pr: torch.Tensor, translation_gap: float,
              rotation_gap: float) -> torch.Tensor:
    """The kernels' float32 terms of ``_pose_differs`` for N pose pairs and
    their decision at the gaps (``POSE_BITS_COLUMNS``): (N, 4).  ``pm``,
    ``pr``: (N, 4, 4).  The baseline column is also the norm of the centre
    escape.  For the bit check against PyTorch's own operations."""
    N = pm.shape[0]
    for name, t in (("pm", pm), ("pr", pr)):
        if t.device.type != "cuda" or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"pose_bits: {name} must be contiguous float32 on a card")
    if tuple(pm.shape) != (N, 4, 4) or tuple(pr.shape) != (N, 4, 4):
        raise ValueError("pose_bits takes two (N, 4, 4)")
    out = torch.empty((N, len(POSE_BITS_COLUMNS)), dtype=torch.float32, device=pm.device)
    with torch.cuda.device(pm.device):
        rc = _library().step_pose_bits(pm.data_ptr(), pr.data_ptr(), N, translation_gap,
                                       rotation_gap, out.data_ptr(),
                                       torch.cuda.current_stream(pm.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"step_pose_bits failed: cudaError_t {rc}")
    return out


def _checked(what: str, device, G: int, V: int, **tensors) -> list:
    """The tensors, contiguous, after checking their device, dtype and shape
    (each given as (tensor, dtype, shape))."""
    out = []
    for name, (t, dtype, shape) in tensors.items():
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, not {device}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} must be {shape}, got {tuple(t.shape)}")
        out.append(t.contiguous())
    if device.type == "cuda" and not (1 <= G <= MAX_CAPACITY and 1 <= V <= MAX_VIEWS):
        raise ValueError(f"{what} takes 1 to {MAX_CAPACITY} slots of 1 to {MAX_VIEWS} views, "
                         f"got {G} x {V}")
    return out


def _manager_args(flist, fcount, fflag, valid_num, obs_pose, init_id) -> dict:
    """The state fields both kernels take, as ``_checked`` takes them."""
    G, V = flist.shape
    M = obs_pose.shape[0]
    return dict(flist=(flist, torch.int32, (G, V)), fcount=(fcount, torch.int32, (G,)),
                fflag=(fflag, torch.bool, (G,)), valid_num=(valid_num, torch.float32, (G,)),
                obs_pose=(obs_pose, torch.float32, (M, 4, 4)), init_id=(init_id, torch.int32, (G,)))


def _device_of(what: str, t: torch.Tensor) -> torch.device:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what} runs on cuda or cpu tensors, got {t.device}")
    return t.device


def nms_greedy(scores, iou, contested, isolated, flist, fcount, fflag, valid_num, xyzlhw, obs_pose,
               init_id, cfg):
    """The greedy NMS of one keyframe over G world slots, one launch on a
    CUDA device.

    Args:
      scores: (G,) float32; iou: (G, G) float32, the cached pairwise IoU
        (row i: slot i against every slot; it may be asymmetric).
      contested / isolated: (G,) bool, ``device_step._contested``'s masks.
      flist: (G, V) int32 fusion lists; fcount: (G,) int32; fflag: (G,) bool;
        valid_num: (G,) float32; xyzlhw: (G, 6) float32; obs_pose: (M, 4, 4)
        float32; init_id: (G,) int32 -- the state's fields.
      cfg: the ``StepConfig`` (``nms_threshold``, ``translation_gap``,
        ``rotation_gap``).

    Returns:
      (keep, success, flist, fcount, fflag, valid_num, trunc): new tensors
      (no input is written); ``trunc`` the 0-d int32 count of fusion-list
      members dropped past V.  On a CUDA device the launch is asynchronous
      on the current stream.
    """
    dev = _device_of("nms_greedy", scores)
    G, V = flist.shape
    args = _manager_args(flist, fcount, fflag, valid_num, obs_pose, init_id)
    (scores, iou, contested, isolated, xyzlhw, flist, fcount, fflag, valid_num, obs_pose,
     init_id) = _checked(
        "nms_greedy", dev, G, V, scores=(scores, torch.float32, (G,)),
        iou=(iou, torch.float32, (G, G)), contested=(contested, torch.bool, (G,)),
        isolated=(isolated, torch.bool, (G,)), xyzlhw=(xyzlhw, torch.float32, (G, 6)), **args)
    if dev.type == "cpu":
        return nms_greedy_reference(scores, iou, contested, isolated, flist, fcount, fflag,
                                    valid_num, xyzlhw, obs_pose, init_id, cfg)
    keep = torch.empty(G, dtype=torch.bool, device=dev)
    success = torch.empty(G, dtype=torch.bool, device=dev)
    flist_out, fcount_out = torch.empty_like(flist), torch.empty_like(fcount)
    fflag_out, valid_num_out = torch.empty_like(fflag), torch.empty_like(valid_num)
    trunc = torch.empty((), dtype=torch.int32, device=dev)
    ptrs = [t.data_ptr() for t in (
        scores, iou, contested, isolated, flist, fcount, fflag, valid_num, xyzlhw, obs_pose, init_id,
        keep, success, flist_out, fcount_out, fflag_out, valid_num_out, trunc, tally(dev))]
    with torch.cuda.device(dev):
        rc = _library().step_nms_greedy_launch(
            *ptrs, G, V, obs_pose.shape[0], cfg.nms_threshold, cfg.translation_gap,
            cfg.rotation_gap, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nms_greedy kernel launch failed: cudaError_t {rc}")
    nms_greedy.launches += 1
    return keep, success, flist_out, fcount_out, fflag_out, valid_num_out, trunc


nms_greedy.launches = 0


def correspond_hits(todo, best, new_wins, keep, flist, fcount, fflag, valid_num, obs_pose, init_id,
                    cfg):
    """The hits of one keyframe's correspondence pass, in ascending slot
    order, one launch on a CUDA device.

    Args:
      todo: (G,) bool, the pending slots that hit; best: (G,) int64, each
        slot's best-matching global slot; new_wins: (G,) bool, whether the
        slot outscores it (``device_step._corr_plan``).
      keep: (G,) bool, NMS's; the state's flist, fcount, fflag, valid_num,
        obs_pose and init_id as in ``nms_greedy``.
      cfg: the ``StepConfig`` (``translation_gap``, ``rotation_gap``).

    Returns:
      (keep, flist, fcount, fflag, valid_num, trunc), new tensors as in
      ``nms_greedy``.
    """
    dev = _device_of("correspond_hits", todo)
    G, V = flist.shape
    args = _manager_args(flist, fcount, fflag, valid_num, obs_pose, init_id)
    todo, best, new_wins, keep, flist, fcount, fflag, valid_num, obs_pose, init_id = _checked(
        "correspond_hits", dev, G, V, todo=(todo, torch.bool, (G,)), best=(best, torch.int64, (G,)),
        new_wins=(new_wins, torch.bool, (G,)), keep=(keep, torch.bool, (G,)), **args)
    if dev.type == "cpu":
        return correspond_hits_reference(todo, best, new_wins, keep, flist, fcount, fflag, valid_num,
                                         obs_pose, init_id, cfg)
    keep_out, flist_out, fcount_out = torch.empty_like(keep), torch.empty_like(flist), torch.empty_like(fcount)
    fflag_out, valid_num_out = torch.empty_like(fflag), torch.empty_like(valid_num)
    trunc = torch.empty((), dtype=torch.int32, device=dev)
    ptrs = [t.data_ptr() for t in (
        todo, best, new_wins, keep, flist, fcount, fflag, valid_num, obs_pose, init_id,
        keep_out, flist_out, fcount_out, fflag_out, valid_num_out, trunc, tally(dev))]
    with torch.cuda.device(dev):
        rc = _library().step_correspond_hits_launch(
            *ptrs, G, V, obs_pose.shape[0], cfg.translation_gap, cfg.rotation_gap,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"correspond_hits kernel launch failed: cudaError_t {rc}")
    correspond_hits.launches += 1
    return keep_out, flist_out, fcount_out, fflag_out, valid_num_out, trunc


correspond_hits.launches = 0
