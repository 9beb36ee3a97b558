"""The port's mesh and sharding rules against the JAX package's, on the CPU.

  * ``_default_shape`` equals JAX's for 1..16 devices;
  * ``param_shardings``: every CuTR-192 parameter's placement is JAX's
    ``PartitionSpec`` for the matching flax leaf, read in torch layouts
    (a Dense kernel (in, out) is a Linear weight (out, in); a conv HWIO is
    OIHW; ``in_proj_weight`` keeps its layout), on meshes (1, 2, 2) and
    (2, 2, 2); and JAX's two toy kernels of
    ``test_mesh_shardings_divisibility``;
  * four ranks on gloo, mesh (1, 2, 2): ``shard_inference`` against the
    one-process forward at the JAX test's bounds (enc_logits 2e-3,
    enc_boxes 0.5 px, sorted scores 2e-3) with more than 20 parameters
    really sharded and only those stored as DTensors; ``shard_train_step``
    against the one-process step (loss rtol 1e-4; the gradients the update
    used, gathered, within GRAD_TOL = 1e-3 relative L2 over all parameters
    and over the plain, replicated ones alone -- measured 4.3e-5 and 7.3e-5,
    where a gradient left unsummed over the data ranks is 0.5 off; every
    parameter within 2 x lr after the step; the AdamW moments stored with
    their parameter's placement; the model holding the optimizer's
    parameters again after the step); a batch row split equal to DTensor's;
    and the trainer's "divisible" error.

JAX is imported inside the tests that use it: the four ranks are spawned
processes that import this module and need torch only.
"""
import json
import os
import socket
import time
import types
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.nn as nn

from boxfusion_tpu_torch.models.cutr import FrameBatch, make_cutr
from boxfusion_tpu_torch.parallel import mesh as tmesh

AXES = ("dp", "fsdp", "tp")
S, R = 256, 4


def _fake_mesh(shape):
    """What the placement rule reads of a mesh: its axis names and sizes."""
    return types.SimpleNamespace(mesh_dim_names=AXES, shape=tuple(shape))


def _spec_of(placements, ndim):
    """DTensor placements (one per mesh axis) -> one axis name (or None) per
    tensor dimension, the form of a JAX PartitionSpec."""
    from torch.distributed.tensor import Shard

    spec = [None] * ndim
    for axis, pl in zip(AXES, placements):
        if isinstance(pl, Shard):
            spec[pl.dim] = axis
    return tuple(spec)


def test_default_shape_equals_jax():
    from boxfusion_tpu.parallel.mesh import _default_shape as jax_default_shape

    for n in range(1, 17):
        assert tmesh._default_shape(n, 3) == jax_default_shape(n, 3), n
    assert tmesh._default_shape(8, 3) == (2, 2, 2)


def _flax_leaf_names(params, wanted):
    """{torch parameter name: (flax path, flax shape)} for the names in
    ``wanted``: each flax leaf is filled with its own index and pushed
    through ``from_flax_params``."""
    import jax

    from boxfusion_tpu_torch.models.cutr.convert import from_flax_params

    leaves, treedef = jax.tree_util.tree_flatten_with_path(params)
    tagged = jax.tree_util.tree_unflatten(
        treedef, [np.full(leaf.shape, i, np.float32) for i, (_, leaf) in enumerate(leaves)])
    names = {}
    for name, value in from_flax_params(tagged).items():
        if name not in wanted:  # the box encoder's constant bounds are buffers
            continue
        i = int(value.reshape(-1)[0])
        assert bool((value == i).all()), name
        path = "/".join(str(p.key) if hasattr(p, "key") else str(p) for p in leaves[i][0])
        names[name] = (path, tuple(leaves[i][1].shape))
    return names


@pytest.mark.parametrize("shape", [(1, 2, 2), (2, 2, 2)])
def test_param_shardings_equal_jax_for_every_cutr_parameter(shape):
    import jax
    from jax.sharding import Mesh

    from boxfusion_tpu.models.cutr import FrameBatch as JaxFrameBatch
    from boxfusion_tpu.models.cutr import make_cutr as jax_make_cutr
    from boxfusion_tpu.parallel.mesh import _spec_for as jax_spec_for

    n = int(np.prod(shape))
    jax_mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(shape), AXES)
    batch = JaxFrameBatch(
        image=jax.ShapeDtypeStruct((1, S, S, 3), np.float32),
        depth=jax.ShapeDtypeStruct((1, S // R, S // R, 1), np.float32),
        K=jax.ShapeDtypeStruct((1, 3, 3), np.float32),
        image_hw=jax.ShapeDtypeStruct((1, 2), np.float32),
        depth_params=jax.ShapeDtypeStruct((1, 2), np.float32),
        T_gravity=jax.ShapeDtypeStruct((1, 3, 3), np.float32),
    )
    params = jax.eval_shape(jax_make_cutr(dimension=192, depth_model=True).init,
                            jax.random.PRNGKey(0), batch)
    model = make_cutr(192, device="cpu")
    flax_of = _flax_leaf_names(params, dict(model.named_parameters()))
    got = tmesh.param_shardings(model, _fake_mesh(shape))
    assert set(got) == {n for n, _ in model.named_parameters()}
    n_sharded = 0
    for name, p in model.named_parameters():
        path, flax_shape = flax_of[name]
        spec = tuple(jax_spec_for(path, flax_shape, jax_mesh))
        spec = spec + (None,) * (len(flax_shape) - len(spec))
        if len(flax_shape) == 4:  # HWIO -> OIHW
            want = tuple(spec[i] for i in (3, 2, 0, 1))
        elif len(flax_shape) == 2 and path.endswith("kernel"):  # Dense (in, out) -> (out, in)
            want = spec[::-1]
        else:  # in_proj_weight, embeddings, vectors: the same layout
            want = spec
        assert _spec_of(got[name], p.dim()) == want, (name, path, want, got[name])
        n_sharded += any(a is not None for a in want)
    assert n_sharded > 20


def test_param_shardings_toy_kernels_divisibility():
    """JAX's test_mesh_shardings_divisibility: kernels (255, 256) and
    (256, 512) on (2, 2, 2) -> P(None, "tp") and P("fsdp", "tp"); here the
    Linear weights (256, 255) and (512, 256)."""
    toy = nn.ModuleDict({"a": nn.Linear(255, 256), "b": nn.Linear(256, 512)})
    got = tmesh.param_shardings(toy, _fake_mesh((2, 2, 2)))
    assert _spec_of(got["a.weight"], 2) == ("tp", None)
    assert _spec_of(got["b.weight"], 2) == ("tp", "fsdp")
    assert _spec_of(got["a.bias"], 1) == (None,) and _spec_of(got["b.bias"], 1) == (None,)


# -------------------------------------------------------------- four ranks
def _frame_batch(B, seed=0):
    rng = np.random.RandomState(seed)
    f = 0.6 * S
    return FrameBatch(
        image=torch.from_numpy(rng.randn(B, S, S, 3).astype(np.float32)),
        depth=torch.from_numpy(rng.randn(B, S // R, S // R, 1).astype(np.float32)),
        K=torch.tensor([[f, 0, S / 2], [0, f, S / 2], [0, 0, 1]]).repeat(B, 1, 1),
        image_hw=torch.tensor([[0.75 * S, S]]).repeat(B, 1),
        depth_params=torch.tensor([[2.0, 0.5]]).repeat(B, 1),
        T_gravity=torch.eye(3).repeat(B, 1, 1),
    )


def _targets(B, G=4, seed=1):
    rng = np.random.RandomState(seed)
    return dict(
        boxes2d=torch.from_numpy(rng.uniform(50, 200, (B, G, 4)).astype(np.float32)),
        proj_xy=torch.from_numpy(rng.uniform(0, 256, (B, G, 2)).astype(np.float32)),
        z=torch.from_numpy(rng.uniform(0.5, 4.0, (B, G, 1)).astype(np.float32)),
        dims=torch.from_numpy(rng.uniform(0.1, 1.0, (B, G, 3)).astype(np.float32)),
        pose=torch.eye(3).repeat(B, G, 1, 1),
        mask=torch.ones(B, G),
    )


LR = 1e-4
GRAD_TOL = 1e-3


def _rank_main(rank, world, port, out_dir):
    """One rank of the four: its findings go to <out_dir>/<rank>.json."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    from boxfusion_tpu_torch.parallel import batch_sharding, make_mesh, shard_inference, shard_train_step
    from boxfusion_tpu_torch.train.__main__ import main as train_main
    from boxfusion_tpu_torch.train.step import init_train_state, make_train_step

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank,
                            timeout=timedelta(seconds=120))
    res = {}
    try:
        mesh = make_mesh(world, shape=(1, 2, 2))
        res["mesh"] = tmesh.mesh_shape(mesh)

        # model-parallel forward against the one-process forward
        model = make_cutr(192, device="cpu", seed=0)
        batch = _frame_batch(1)
        with torch.no_grad():
            want = model(batch)
        apply, placed = shard_inference(model, mesh)
        got = apply(placed, batch)
        res["n_sharded"] = sum(isinstance(v, DTensor) and any(isinstance(pl, Shard) for pl in v.placements)
                               for v in placed.values())
        res["n_placed_dtensor"] = sum(isinstance(v, DTensor) for v in placed.values())
        res["local_fraction"] = (sum((v.to_local() if isinstance(v, DTensor) else v).numel()
                                     for v in placed.values()) / sum(v.numel() for v in placed.values()))
        res["enc_logits"] = float((got["enc_logits"] - want["enc_logits"]).abs().max())
        res["enc_boxes"] = float((got["enc_boxes"] - want["enc_boxes"]).abs().max())
        res["scores"] = float((got["scores"].flatten().sort().values
                               - want["scores"].flatten().sort().values).abs().max())

        # the sharded step against the one-process step on the same batch of 4
        fb, tg = _frame_batch(4, seed=2), _targets(4)
        plain = make_cutr(192, device="cpu", seed=1)
        step, opt = make_train_step(plain, learning_rate=LR)
        plain_state, plain_m = step(init_train_state(plain, opt), fb, tg)
        sharded = make_cutr(192, device="cpu", seed=1)
        step, opt = make_train_step(sharded, learning_rate=LR)
        sstep, state, lb, _ = shard_train_step(step, mesh, init_train_state(sharded, opt), fb, tg)
        state, m = sstep(state, fb, tg)
        res["rows"] = int(lb.image.shape[0])
        res["loss_plain"], res["loss_sharded"] = float(plain_m["loss"]), float(m["loss"])
        full = tmesh.gathered_state_dict(state.model)
        ref = plain_state.model.state_dict()
        res["param_diff"] = max(float((full[k] - ref[k]).abs().max()) for k in ref)
        # the gradients the update used, summed over the data ranks: the
        # sharded ones through the gather, the plain ones by _SumGradOver
        want = {n: p.grad for n, p in plain_state.model.named_parameters()}
        got = {n: p.grad.full_tensor() if isinstance(p.grad, DTensor) else p.grad
               for n, p in state.model.named_parameters()}
        plain_names = [n for n, p in state.model.named_parameters() if not isinstance(p, DTensor)]

        def rel_l2(names):
            a, b = (torch.cat([g[n].flatten() for n in names]) for g in (got, want))
            return float((a - b).norm() / b.norm())

        res["grad_rel_l2"] = rel_l2(sorted(want))
        res["grad_rel_l2_plain"] = rel_l2(plain_names)
        res["n_plain"] = len(plain_names)
        res["moments_placed"] = all(
            (isinstance(st["exp_avg"], DTensor) and st["exp_avg"].placements == p.placements
             and st["exp_avg_sq"].placements == p.placements) if isinstance(p, DTensor)
            else not isinstance(st["exp_avg"], DTensor) and not isinstance(st["exp_avg_sq"], DTensor)
            for p, st in state.optimizer.state.items())
        res["n_moments"] = len(state.optimizer.state)
        # after the step the model holds the optimizer's parameters again,
        # on every path of a module registered under two names
        res["model_holds_optimizer_params"] = (
            {id(p) for _, p in state.model.named_parameters(remove_duplicate=False)}
            == {id(p) for g in state.optimizer.param_groups for p in g["params"]})

        # this rank's rows are DTensor's shard of the batch
        x = torch.arange(24.0).reshape(8, 3)
        res["rows_equal"] = torch.equal(
            distribute_tensor(x, mesh, batch_sharding(mesh)).to_local(), x[tmesh.local_rows(mesh, 8)])

        try:
            train_main(["--steps", "1", "--batch", "3", "--device", "cpu"])
        except SystemExit as e:
            res["divisible"] = str(e)
    finally:
        dist.destroy_process_group()
        with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
            json.dump(res, f)


def test_four_ranks_shard_inference_and_train_step(tmp_path):
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.start_processes(_rank_main, args=(4, port, str(tmp_path)), nprocs=4, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + 300
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the four ranks did not finish within 300 s")
    results = [json.load(open(tmp_path / f"{r}.json")) for r in range(4)]
    for res in results:
        assert res["mesh"] == {"dp": 1, "fsdp": 2, "tp": 2}
        assert res["n_sharded"] > 20 and res["local_fraction"] < 0.5, res
        # a parameter replicated on every axis is kept a plain tensor
        assert res["n_placed_dtensor"] == res["n_sharded"], res
        assert res["enc_logits"] <= 2e-3 and res["enc_boxes"] <= 0.5 and res["scores"] <= 2e-3, res
        assert res["rows"] == 2
        np.testing.assert_allclose(res["loss_sharded"], res["loss_plain"], rtol=1e-4)
        assert res["param_diff"] <= 2 * LR, res
        assert res["grad_rel_l2"] <= GRAD_TOL and res["grad_rel_l2_plain"] <= GRAD_TOL, res
        assert res["moments_placed"] and res["n_moments"] == 461
        assert res["model_holds_optimizer_params"]
        assert res["rows_equal"]
        assert "must be divisible by dp*fsdp=2" in res["divisible"]
