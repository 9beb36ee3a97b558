"""Device mesh + sharding rules (dp / fsdp / tp) for CuTR training and eval.

Port of ``boxfusion_tpu/parallel/mesh.py`` to ``torch.distributed``.  The
reference has no distributed runtime at all (SURVEY.md section 2); the JAX
package adds a mesh of axes ("dp", "fsdp", "tp"):

  * dp: data parallel -- the batch is split over dp x fsdp;
  * fsdp: fully-sharded parameter storage (ZeRO-style), sharding the *input*
    dimension of large weights;
  * tp: tensor-parallel storage, sharding the *output* dimension.

PyTorch's idiom is one process per device, so a mesh spans the ranks of a
process group (``init_process_group`` makes a one-rank group when the
program was not started by ``torchrun``).  The placement rule is the JAX
package's ``_spec_for``, read in torch layouts: a flax ``(in, out)`` kernel
is a torch ``(out, in)`` weight, so fsdp shards dim 1 and tp dim 0; the
packed ``in_proj_weight`` already has the torch layout (tp dim 0, fsdp dim
1); a conv's output channels are dim 0 of OIHW.  Biases, norms, layer-scale
gammas and embedding tables are replicated, and so is every tensor whose
smallest side is under 128; an axis whose size does not divide its
dimension is dropped.

A parameter that the rule splits over some axis of more than one rank (and
its AdamW moments, which take its placement) is stored as a DTensor; any
other stays a plain tensor, since a DTensor would only add dispatch to it
(so at world size 1 nothing is a DTensor).
Compute does not run on DTensors -- DTensor has no sharding rule for some
of CuTR's ops (top-k, gathers) -- but on the full parameters, gathered
before each forward (the FSDP2 pattern).  A sharded parameter's gradient
flows back through the gather: summed over the data axes (reduce-scatter
onto fsdp, all-reduce over dp) and re-sharded locally over tp, where every
rank saw the same data; a plain parameter's gradient is all-reduced over
the data axes.  So a sharded step computes the one-device step, with the
sharded parameters and their moments held 1 / (fsdp x tp) per rank.
"""
from __future__ import annotations

import dataclasses
import os
import socket
from collections import defaultdict
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from torch.func import functional_call

AXES = ("dp", "fsdp", "tp")
DATA_AXES = ("dp", "fsdp")


def init_process_group(device_type: str = "cuda") -> bool:
    """Join or make the process group the mesh spans.

    Started by ``torchrun`` (``RANK`` / ``WORLD_SIZE`` in the environment),
    the process joins its group; otherwise it makes a group of one rank on a
    free localhost port.  Backend nccl for "cuda", gloo for "cpu".  Returns
    True when this call made the group (the caller then destroys it), False
    when one was already initialised.
    """
    if dist.is_initialized():
        return False
    backend = "nccl" if device_type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    return True


def make_mesh(
    n_devices: Optional[int] = None,
    axes: Tuple[str, ...] = AXES,
    shape: Optional[Tuple[int, ...]] = None,
) -> DeviceMesh:
    """A mesh over the process group's ranks (one device each).

    The default shape puts as much as possible on tp / fsdp: (dp=2, fsdp=2,
    tp=2) at 8 ranks, degenerating for fewer.  ``n_devices`` must equal the
    group's world size.  The mesh's devices are "cuda" under nccl and "cpu"
    under gloo.
    """
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh spans the whole process group: {n} devices asked, world size {world}")
    if shape is None:
        shape = _default_shape(n, len(axes))
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not hold {n} devices")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def mesh_shape(mesh: DeviceMesh) -> Dict[str, int]:
    """{axis: size}, as ``dict(jax_mesh.shape)`` prints."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _default_shape(n: int, n_axes: int) -> Tuple[int, ...]:
    shape = [1] * n_axes
    rem = n
    i = n_axes - 1
    while rem > 1:
        take = 2 if rem % 2 == 0 else rem
        shape[i] = shape[i] * take
        rem //= take
        i = (i - 1) % n_axes
    return tuple(shape)


_REPLICATED_SUFFIXES = (
    "bias",
    "scale",
    "gamma",  # ls1.gamma / ls2.gamma (flax: ls1_gamma / ls2_gamma)
    "in_proj_bias",
)


def _spec_for(name: str, shape, mesh: DeviceMesh, embedding: bool = False) -> Tuple:
    """Sharding rule for one parameter, in torch layout: one mesh axis name
    (or None) per tensor dimension; () replicates.

    Large Linear weights (out, in) -> ("tp", "fsdp"); the packed
    (3D, D) ``in_proj_weight`` -> ("tp", "fsdp"); embedding tables and small
    tensors replicate; conv (O, I, kh, kw) -> ("tp", None, None, None).  Any
    dim not divisible by its mesh axis replicates.
    """
    sizes = mesh_shape(mesh)

    def fit(spec):
        return tuple(a if a is not None and shape[i] % sizes[a] == 0 else None
                     for i, a in enumerate(spec))

    if any(name.endswith(s) for s in _REPLICATED_SUFFIXES):
        return ()
    if len(shape) == 2 and min(shape) >= 128:
        if embedding:
            return (None, None)
        return fit(("tp", "fsdp"))
    if len(shape) == 4 and shape[0] >= 128:  # conv OIHW: shard out channels
        return fit(("tp", None, None, None))
    return ()


def _placements(spec: Tuple, mesh: DeviceMesh) -> Tuple:
    """One DTensor placement per mesh dimension for a per-tensor-dim spec."""
    return tuple(
        Shard(spec.index(axis)) if axis in spec else Replicate() for axis in mesh.mesh_dim_names
    )


def _embedding_tables(model: nn.Module) -> set:
    """Names of the embedding tables: nn.Embedding weights and parameters
    registered under a name ending in "embed" (flax names them so)."""
    names = {f"{m_name}.weight" if m_name else "weight"
             for m_name, m in model.named_modules() if isinstance(m, nn.Embedding)}
    names.update(n for n, _ in model.named_parameters() if n.split(".")[-1].endswith("embed"))
    return names


def param_shardings(model: nn.Module, mesh: DeviceMesh) -> Dict[str, Tuple]:
    """DTensor placements (one per mesh dimension) for every parameter."""
    tables = _embedding_tables(model)
    return {
        name: _placements(_spec_for(name, tuple(p.shape), mesh, name in tables), mesh)
        for name, p in model.named_parameters()
    }


def batch_sharding(mesh: DeviceMesh) -> Tuple:
    """Placements of a batch tensor: dim 0 split over dp, then fsdp;
    replicated over tp."""
    return tuple(Shard(0) if a in DATA_AXES else Replicate() for a in mesh.mesh_dim_names)


def data_ranks(mesh: DeviceMesh) -> int:
    """How many ways the batch is split: dp x fsdp."""
    sizes = mesh_shape(mesh)
    return int(np.prod([sizes.get(a, 1) for a in DATA_AXES]))


def local_rows(mesh: DeviceMesh, n: int) -> slice:
    """This rank's rows of an n-row batch under ``batch_sharding``."""
    count = data_ranks(mesh)
    if n % count:
        raise ValueError(f"batch {n} must be divisible by dp*fsdp={count} (mesh {mesh_shape(mesh)})")
    coord = mesh.get_coordinate()
    idx = 0
    for i, axis in enumerate(mesh.mesh_dim_names):
        if axis in DATA_AXES:
            idx = idx * mesh.size(i) + coord[i]
    per = n // count
    return slice(idx * per, (idx + 1) * per)


def shard_batch(tree, mesh: DeviceMesh):
    """This rank's slice of every tensor of a batch (a dataclass such as
    FrameBatch, a dict, or a tensor), the full batch on every rank in."""
    if isinstance(tree, torch.Tensor):
        return tree[local_rows(mesh, tree.shape[0])]
    if isinstance(tree, dict):
        return {k: shard_batch(v, mesh) for k, v in tree.items()}
    if tree is None:
        return None
    return dataclasses.replace(tree, **{f.name: shard_batch(getattr(tree, f.name), mesh)
                                        for f in dataclasses.fields(tree)})


def gathered_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict with every DTensor gathered whole (a
    collective: every rank calls it)."""
    return {k: v.full_tensor() if isinstance(v, DTensor) else v for k, v in model.state_dict().items()}


def _is_sharded(placements: Tuple, mesh: DeviceMesh) -> bool:
    """True when the placements split the tensor over some axis of more than
    one rank (a Shard over an axis of one rank replicates)."""
    return any(isinstance(pl, Shard) and mesh.size(i) > 1 for i, pl in enumerate(placements))


def _shard_module(model: nn.Module, mesh: DeviceMesh) -> Dict[str, nn.Parameter]:
    """Replace every parameter of ``model`` that ``param_shardings`` splits
    (``_is_sharded``) by a DTensor parameter so placed; the others stay as
    they are.  Returns {name: parameter} for all of them."""
    placements = param_shardings(model, mesh)
    out = {}
    for m_name, module in model.named_modules():
        for p_name, p in list(module.named_parameters(recurse=False)):
            name = f"{m_name}.{p_name}" if m_name else p_name
            out[name] = p
            if _is_sharded(placements[name], mesh):
                out[name] = nn.Parameter(distribute_tensor(p.detach(), mesh, placements[name]),
                                         requires_grad=p.requires_grad)
                setattr(module, p_name, out[name])
    return out


class _SumGradOver(torch.autograd.Function):
    """Identity forward; backward all-reduces (sums) the gradient over each
    process group given."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        for group in ctx.groups:
            dist.all_reduce(grad, group=group)
        return grad, None


def shard_inference(model: nn.Module, mesh: DeviceMesh):
    """Model-parallel serving: the parameters that ``param_shardings`` splits
    (``_is_sharded``) stored sharded over the mesh, gathered whole for each
    forward.

    The batch is replicated (single-stream online serving).  Returns
    ``(apply, placed)``: ``apply(placed, batch)`` is the model's forward
    (no gradient) with the parameters ``placed`` ({name: DTensor, or the
    plain tensor where nothing is split}).
    """
    placements = param_shardings(model, mesh)
    placed = {n: distribute_tensor(p.detach(), mesh, placements[n]) if _is_sharded(placements[n], mesh)
              else p.detach() for n, p in model.named_parameters()}

    def apply(params, batch, **kw):
        with torch.no_grad():
            full = {n: v.full_tensor() if isinstance(v, DTensor) else v for n, v in params.items()}
            # tie_weights=True would leave a module registered under two
            # names (CuTR's shared box encoders) holding the gathered tensor
            return functional_call(model, full, (batch,), kw, tie_weights=False)

    return apply, placed


def shard_train_step(train_step, mesh: DeviceMesh, state, batch, targets):
    """The train step with parameters and AdamW moments sharded over the mesh.

    ``state.model``'s split parameters become DTensors (``_is_sharded``)
    and ``state.optimizer`` is pointed at them, any moments it holds moved
    to their parameter's placement.  The returned step takes the full batch
    on every rank, hands ``train_step`` this rank's rows
    (``batch_sharding``), the gathered parameters and the loss scale
    1 / (dp x fsdp), and returns the global batch's loss.

    Returns (sharded_step, state, placed_batch, placed_targets), the last
    two this rank's rows of ``batch`` and ``targets``.
    """
    name_of = {p: n for n, p in state.model.named_parameters()}
    params = _shard_module(state.model, mesh)
    opt = state.optimizer
    old_state, opt.state = opt.state, defaultdict(dict)
    for group in opt.param_groups:
        old_group, group["params"] = group["params"], [params[name_of[p]] for p in group["params"]]
        for old_p, p in zip(old_group, group["params"]):
            opt.state[p] = {
                k: distribute_tensor(v, mesh, p.placements)
                if isinstance(p, DTensor) and isinstance(v, torch.Tensor) and v.shape == p.shape else v
                for k, v in old_state.get(old_p, {}).items()
            }

    n_data = data_ranks(mesh)
    grad_placements = [Partial() if a in DATA_AXES else Replicate() for a in mesh.mesh_dim_names]
    replicated = [Replicate()] * mesh.ndim
    sharded = {n: p for n, p in params.items() if isinstance(p, DTensor)}
    plain = {n: p for n, p in params.items() if not isinstance(p, DTensor)}
    data_groups = [mesh.get_group(a) for a in mesh.mesh_dim_names
                   if a in DATA_AXES and mesh.size(mesh.mesh_dim_names.index(a)) > 1]

    def sharded_step(state, batch, targets):
        full = {n: p.redistribute(mesh, replicated).to_local(grad_placements=grad_placements)
                for n, p in sharded.items()}
        if data_groups:
            full.update({n: _SumGradOver.apply(p, data_groups) for n, p in plain.items()})
        state, metrics = train_step(state, shard_batch(batch, mesh), shard_batch(targets, mesh),
                                    params=full, loss_scale=1.0 / n_data)
        loss = metrics["loss"].clone()
        world = dist.get_world_size()
        if world > 1:  # tp ranks hold equal losses: the world mean is the data ranks' mean
            dist.all_reduce(loss)
            loss = loss / world
        return state, {"loss": loss}

    sharded_step.schedule = train_step.schedule
    return sharded_step, state, shard_batch(batch, mesh), shard_batch(targets, mesh)
