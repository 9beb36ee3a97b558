"""The port's training stack against the JAX package's, on the CPU.

Held here, each with its bound:

  * ``greedy_match``: assignments identical (JAX's two cases, seeded random
    costs with padded slots and ties, single and batched);
  * ``detection_loss``: every term within rtol 1e-6; its gradient with
    respect to the predictions (JAX ``grad`` against autograd) within 1e-5;
  * the learning-rate schedule equals optax's at steps 0..N within 1e-7;
  * the train step at CuTR-192 (S = 256, r = 4, B = 2), both sides from the
    same flax parameters (``from_flax_params``): loss rtol 1e-4; every
    parameter's gradient (the JAX tree through the same, linear, converter)
    within a relative L2 error of 1e-3 plus twice the JAX package's own
    spread (see ``test_train_step_matches_jax``); after one AdamW step at a
    constant learning rate, every parameter within 2 x lr of optax's, and
    the update itself optax's (same sign and within 1e-2 lr wherever the
    gradients agree, 0.1 relative L2 over the model); the parameters that
    get no gradient exactly zero on both sides and decayed as optax decays
    them (also at a rate that shows, through the trainer's optimizer
    factory);
  * JAX's "5 steps lower the loss" case, on the port;
  * the trainer's command line: a synthetic run that checkpoints, a resume
    of that checkpoint that reproduces its parameters exactly, a resume of
    the committed reference-layout fixture, and the ``--data-root`` run on
    a capture converted by the port's ``data_process convert``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from boxfusion_tpu.models.cutr import FrameBatch as JaxFrameBatch
from boxfusion_tpu.models.cutr import make_cutr as jax_make_cutr
from boxfusion_tpu.train.loss import detection_loss as jax_detection_loss
from boxfusion_tpu.train.loss import greedy_match as jax_greedy_match
from boxfusion_tpu.train.step import make_train_step as jax_make_train_step

from boxfusion_tpu_torch.models.cutr import FrameBatch, make_cutr
from boxfusion_tpu_torch.models.cutr.convert import from_flax_params
from boxfusion_tpu_torch.train.loss import detection_loss, greedy_match
from boxfusion_tpu_torch.train.step import (
    ADAM_EPS,
    batch_loss,
    init_train_state,
    make_train_step,
    warmup_cosine_decay_schedule,
)

torch.set_num_threads(4)

FIXTURE = "tests/fixtures/cutr_trained_192_f16.pth"
S, R, B, G = 256, 4, 2, 4
LR, WD = 1e-4, 1e-4
# the encoder proposals' class head: its logits are not in the loss, and
# neither are the decoder's metric-token scale heads (the RGB-D model
# de-whitens with the GT depth parameters)
NO_GRAD_PREFIXES = ("prompting.prompters.1.predictors.0.", "decoder.predictors.")
NO_GRAD_SUFFIX = ".0.shift.weight .0.shift.bias .0.scale.weight .0.scale.bias".split()


def _no_grad_param(name: str) -> bool:
    if name.startswith(NO_GRAD_PREFIXES[0]):
        return True
    return name.startswith(NO_GRAD_PREFIXES[1]) and any(name.endswith(s) for s in NO_GRAD_SUFFIX)


# ------------------------------------------------------------------ matching
@pytest.mark.parametrize("cost,want", [
    ([[0.0, 5.0], [5.0, 0.0], [2.0, 2.0]], [0, 1]),
    # query 0 is cheapest for both GTs; the second GT takes the next best
    ([[0.0, 0.1], [1.0, 0.5], [2.0, 2.0]], [0, 1]),
])
def test_greedy_match_jax_cases(cost, want):
    c = np.asarray(cost, np.float32)
    got = greedy_match(torch.from_numpy(c), torch.ones(2, dtype=torch.bool))
    ref = jax_greedy_match(jnp.asarray(c), jnp.ones(2, bool))
    assert got.tolist() == want == np.asarray(ref).tolist()


def test_greedy_match_random_costs_equal_jax():
    rng = np.random.RandomState(0)
    costs, masks = [], []
    for trial in range(12):
        Q, Gs = (20, 6) if trial % 2 else (7, 7)
        c = rng.uniform(0, 1, (Q, Gs)).astype(np.float32)
        if trial % 3 == 0:  # exact ties: the first index wins on both sides
            c = np.round(c * 4) / 4
        m = rng.uniform(size=Gs) > 0.3
        got = greedy_match(torch.from_numpy(c), torch.from_numpy(m))
        ref = np.asarray(jax_greedy_match(jnp.asarray(c), jnp.asarray(m)))
        np.testing.assert_array_equal(got.numpy(), ref)
        if Q == 20:
            costs.append(c)
            masks.append(m)
    # the batched form equals the per-image one
    got = greedy_match(torch.from_numpy(np.stack(costs)), torch.from_numpy(np.stack(masks)))
    for b in range(len(costs)):
        ref = np.asarray(jax_greedy_match(jnp.asarray(costs[b]), jnp.asarray(masks[b])))
        np.testing.assert_array_equal(got[b].numpy(), ref)


# ---------------------------------------------------------------------- loss
def _loss_inputs(seed=0, Q=20, Gs=3):
    rng = np.random.RandomState(seed)
    yaw = rng.uniform(-np.pi, np.pi, (Q,))
    c, s = np.cos(yaw), np.sin(yaw)
    z, o = np.zeros_like(c), np.ones_like(c)
    pose = np.stack([c, z, s, z, o, z, -s, z, c], -1).reshape(Q, 3, 3)
    pred = dict(
        logits=rng.randn(Q, 2), boxes=rng.uniform(0, 256, (Q, 4)),
        proj_xy=rng.uniform(0, 256, (Q, 2)), z_scaled=rng.uniform(0.5, 3, (Q, 1)),
        dims=rng.uniform(0.1, 1, (Q, 3)), pose=pose,
    )
    tgt = dict(
        boxes2d=rng.uniform(0, 256, (Gs, 4)), proj_xy=rng.uniform(0, 256, (Gs, 2)),
        z=rng.uniform(0.5, 3, (Gs, 1)), dims=rng.uniform(0.1, 1, (Gs, 3)),
        pose=np.tile(np.eye(3)[None], (Gs, 1, 1)), mask=(np.arange(Gs) < Gs - 1).astype(np.float64),
    )
    f32 = lambda d: {k: v.astype(np.float32) for k, v in d.items()}
    return f32(pred), f32(tgt)


def test_detection_loss_terms_and_gradient_match_jax():
    for seed in range(3):
        pred, tgt = _loss_inputs(seed)
        want = jax.jit(lambda p, t: jax_detection_loss(p, t, 256.0))(
            {k: jnp.asarray(v) for k, v in pred.items()}, {k: jnp.asarray(v) for k, v in tgt.items()})
        tp = {k: torch.from_numpy(v).requires_grad_() for k, v in pred.items()}
        got = detection_loss(tp, {k: torch.from_numpy(v) for k, v in tgt.items()}, 256.0)
        for term in ("cls", "box2d", "center", "z", "dims", "pose", "total"):
            np.testing.assert_allclose(float(got[term]), float(want[term]), rtol=1e-6, err_msg=term)
        got["total"].backward()
        jgrad = jax.grad(lambda p: jax_detection_loss(p, {k: jnp.asarray(v) for k, v in tgt.items()},
                                                      256.0)["total"])(
            {k: jnp.asarray(v) for k, v in pred.items()})
        for k in pred:
            np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jgrad[k]), atol=1e-5, rtol=0,
                                       err_msg=k)
    # the batched form gives each image's loss
    pairs = [_loss_inputs(seed) for seed in range(3)]
    batched = detection_loss({k: torch.from_numpy(np.stack([p[k] for p, _ in pairs])) for k in pairs[0][0]},
                             {k: torch.from_numpy(np.stack([t[k] for _, t in pairs])) for k in pairs[0][1]},
                             256.0)
    for b, (p, t) in enumerate(pairs):
        one = detection_loss({k: torch.from_numpy(v) for k, v in p.items()},
                             {k: torch.from_numpy(v) for k, v in t.items()}, 256.0)
        torch.testing.assert_close(batched["total"][b], one["total"], rtol=1e-6, atol=0)


def test_regression_terms_vanish_when_targets_are_predictions():
    """JAX's test_detection_loss_finite_and_improves_with_match, on the port."""
    pred, _ = _loss_inputs(0)
    tgt = dict(boxes2d=pred["boxes"][:3], proj_xy=pred["proj_xy"][:3], z=pred["z_scaled"][:3],
               dims=pred["dims"][:3], pose=pred["pose"][:3], mask=np.ones(3, np.float32))
    out = detection_loss({k: torch.from_numpy(v) for k, v in pred.items()},
                         {k: torch.from_numpy(v) for k, v in tgt.items()}, 256.0)
    assert np.isfinite(float(out["total"]))
    assert float(out["box2d"]) < 1e-5 and float(out["dims"]) < 1e-5


@pytest.mark.parametrize("init,peak,warmup,decay,end", [
    (0.0, 3e-4, 20, 200, 3e-6),
    (0.0, 3e-4, 2, 4, 3e-6),
    (1e-5, 1e-3, 0, 50, 0.0),
    (0.0, 0.0, 5, 6, 0.0),
])
def test_schedule_equals_optax(init, peak, warmup, decay, end):
    want = optax.warmup_cosine_decay_schedule(init_value=init, peak_value=peak, warmup_steps=warmup,
                                              decay_steps=decay, end_value=end)
    got = warmup_cosine_decay_schedule(init, peak, warmup, decay, end)
    for k in range(decay + 10):
        assert abs(got(k) - float(want(k))) <= 1e-7, k
    if warmup:
        assert got(0) == init  # with init 0 the first update moves nothing


# ---------------------------------------------------------------- train step
def _step_inputs():
    rng = np.random.RandomState(0)
    f = 0.6 * S
    inputs = dict(
        image=rng.randn(B, S, S, 3).astype(np.float32),
        depth=rng.randn(B, S // R, S // R, 1).astype(np.float32),
        K=np.tile(np.array([[f, 0, S / 2], [0, f, S / 2], [0, 0, 1]], np.float32)[None], (B, 1, 1)),
        image_hw=np.tile(np.array([[0.75 * S, S]], np.float32), (B, 1)),
        depth_params=np.tile(np.array([[2.0, 0.5]], np.float32), (B, 1)),
        T_gravity=np.tile(np.eye(3, dtype=np.float32)[None], (B, 1, 1)),
    )
    rng = np.random.RandomState(1)
    targets = dict(
        boxes2d=rng.uniform(50, 200, (B, G, 4)).astype(np.float32),
        proj_xy=rng.uniform(0, 256, (B, G, 2)).astype(np.float32),
        z=rng.uniform(0.5, 4.0, (B, G, 1)).astype(np.float32),
        dims=rng.uniform(0.1, 1.0, (B, G, 3)).astype(np.float32),
        pose=np.tile(np.eye(3, dtype=np.float32)[None, None], (B, G, 1, 1)),
        mask=np.ones((B, G), np.float32),
    )
    targets["mask"][1, G - 1] = 0.0  # one padded slot
    return inputs, targets


@pytest.fixture(scope="module")
def jax_step():
    """JAX's loss and gradients at the inputs and at the image scaled by
    (1 + 1e-7), and optax's parameters after one AdamW step at lr 1e-4."""
    inputs, targets = _step_inputs()
    model = jax_make_cutr(dimension=192, depth_model=True)
    batch = JaxFrameBatch(**{k: jnp.asarray(v) for k, v in inputs.items()})
    params = jax.jit(model.init)(jax.random.PRNGKey(0), batch)
    train_step, tx = jax_make_train_step(model, learning_rate=LR, weight_decay=WD)
    # JAX's own loss function, from the step's closure
    loss_fn = dict(zip(train_step.__code__.co_freevars,
                       (c.cell_contents for c in train_step.__closure__)))["loss_fn"]
    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    jt = {k: jnp.asarray(v) for k, v in targets.items()}
    loss, grads = value_and_grad(params, batch, jt)
    nudged = JaxFrameBatch(**{**{k: jnp.asarray(v) for k, v in inputs.items()},
                              "image": jnp.asarray(inputs["image"] * np.float32(1 + 1e-7))})
    _, grads_nudged = value_and_grad(params, nudged, jt)
    updates, _ = tx.update(grads, tx.init(params), params)
    stepped = optax.apply_updates(params, updates)
    return dict(params=jax.tree.map(np.asarray, params), loss=float(loss),
                grads=from_flax_params(jax.tree.map(np.asarray, grads)),
                grads_nudged=from_flax_params(jax.tree.map(np.asarray, grads_nudged)),
                stepped=from_flax_params(jax.tree.map(np.asarray, stepped)),
                inputs=inputs, targets=targets)


def _port_model(params):
    model = make_cutr(192, depth_model=True, device="cpu")
    model.load_state_dict(from_flax_params(params), strict=True)
    return model


def _torch_batch(inputs):
    return FrameBatch(**{k: torch.from_numpy(v) for k, v in inputs.items()})


def test_train_step_matches_jax(jax_step):
    """One port step against JAX's loss, gradients and optax update.

    The gradient bound is 1e-3 of each tensor's JAX norm plus twice the
    JAX package's own spread: how far its gradient moves when the image is
    scaled by (1 + 1e-7), a float32 rounding of the input.  CuTR's gradient
    is piecewise: ReLUs in the decoder's FFN, its rpe MLPs and the heads sit
    a few 1e-7 from their kink, and a rounding-level change of the forward
    flips some of them.  Measured (CPU, torch 2.13 / jax 0.9): the JAX
    spread reaches 1.0e-2 on decoder layer 2 and 1.2e-3 on the backbone; the
    port against JAX reaches the same 1.0e-2 / 1.5e-3, and at most 2e-5 on
    every head.  Gradients that vanish in exact arithmetic (a key bias does
    not move a softmax; norms ~1e-8) are held against 1e-4 absolute.

    The update (parameters after the step less before) is held against
    optax's: wherever the two gradients agree within 10% and lie 100 x
    Adam's eps above zero, the same sign and within 1e-2 lr (measured
    4.8e-3 lr, 0 sign differences); those elements at least 90% of the
    model's (measured 93.6%); the relative L2 error of the whole update at
    most 0.1 (measured 3.2e-2: Adam's first step is lr x sign(g), so an
    element whose gradient sits near a kink or near zero moves the other
    way; a skipped step would be 1 off, a reversed one 2).
    """
    ref = jax_step
    model = _port_model(ref["params"])
    p0 = from_flax_params(ref["params"])
    step, opt = make_train_step(model, learning_rate=LR, weight_decay=WD)
    state = init_train_state(model, opt)
    state, metrics = step(state, _torch_batch(ref["inputs"]),
                          {k: torch.from_numpy(v) for k, v in ref["targets"].items()})
    assert state.step == 1
    np.testing.assert_allclose(float(metrics["loss"]), ref["loss"], rtol=1e-4)

    worst, updates, n_sure = {}, [], 0
    for name, p in model.named_parameters():
        want, g = ref["grads"][name], p.grad
        if _no_grad_param(name):
            assert float(want.abs().max()) == 0.0 and float(g.abs().max()) == 0.0, name
            # updated as optax updates them (by the decay alone; at lr wd =
            # 1e-8 that rounds away in float32 -- test_zero_grad_parameters_decay
            # holds it at a rate that shows)
            torch.testing.assert_close(p.detach(), ref["stepped"][name], rtol=0, atol=1e-7)
            continue
        norm = max(float(want.norm()), 1e-4)
        spread = float((ref["grads_nudged"][name] - want).norm()) / norm
        err = float((g - want).norm()) / norm
        worst[name] = (err, spread)
        assert err <= 1e-3 + 2 * spread, (name, err, spread)
        # one AdamW step: every parameter within 2 x lr of optax's
        diff = float((p.detach() - ref["stepped"][name]).abs().max())
        assert diff <= 2 * LR, (name, diff)
        # the update against optax's where the two gradients agree (within
        # 10%, and 100 x Adam's eps above zero): same sign, within 1e-2 lr
        u_t, u_j = p.detach() - p0[name], ref["stepped"][name] - p0[name]
        sure = ((g - want).abs() <= 0.1 * want.abs()) & (want.abs() > 100 * ADAM_EPS)
        assert torch.equal(torch.sign(u_t[sure]), torch.sign(u_j[sure])), name
        assert bool(((u_t - u_j)[sure].abs() <= 1e-2 * LR).all()), name
        n_sure += int(sure.sum())
        updates.append((u_t.flatten(), u_j.flatten()))
    # those elements are most of the model, and the whole update is optax's
    # (a skipped step is 1 off, a reversed one 2)
    u_t, u_j = (torch.cat(u) for u in zip(*updates))
    assert n_sure >= 0.9 * u_t.numel(), (n_sure, u_t.numel())
    assert float((u_t - u_j).norm() / u_j.norm()) <= 0.1
    assert sum(_no_grad_param(n) for n, _ in model.named_parameters()) == 26
    # the heads, where no kink lies between the loss and the parameter, hold 1e-3 alone
    heads = [v[0] for n, v in worst.items() if n.startswith("decoder.predictors.")]
    assert heads and max(heads) <= 1e-3


def test_zero_grad_parameters_decay_as_optax_decays_them():
    """A parameter the loss does not reach gets a zero gradient and still
    decays, as optax.adamw decays every leaf; three steps at lr 0.1 and
    weight decay 0.1 against optax, within 5e-6 of the 0.3 a parameter
    travels: optax evaluates 1 - 0.999 ** count in float32, 1.3e-5 from
    its value, which moves its update by 6e-6 relative (torch matches a
    float64 recurrence to 1e-7 here)."""
    from boxfusion_tpu_torch.train.step import TrainState, apply_update, make_optimizer

    rng = np.random.RandomState(0)
    w = {"used": rng.randn(2, 3).astype(np.float32), "unused": rng.randn(2, 3).astype(np.float32)}
    x = rng.randn(4, 3).astype(np.float32)
    model = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in w.items()})
    opt = make_optimizer(model.parameters(), weight_decay=0.1)  # make_train_step's optimizer
    state = TrainState(model=model, optimizer=opt)
    tx = optax.adamw(0.1, weight_decay=0.1)
    params = {k: jnp.asarray(v) for k, v in w.items()}
    opt_state = tx.init(params)
    loss_fn = lambda p: jnp.sum((jnp.asarray(x) @ p["used"].T) ** 2)
    for _ in range(3):
        apply_update(state, lambda k: 0.1, (torch.from_numpy(x) @ model["used"].T).pow(2).sum())
        updates, opt_state = tx.update(jax.grad(loss_fn)(params), opt_state, params)
        params = optax.apply_updates(params, updates)
    assert float(model["unused"].grad.abs().max()) == 0.0
    for k in w:
        np.testing.assert_allclose(model[k].detach().numpy(), np.asarray(params[k]), atol=5e-6, rtol=0)
    np.testing.assert_allclose(model["unused"].detach().numpy(), w["unused"] * (1 - 0.01) ** 3, rtol=1e-6)


def test_train_step_reduces_loss():
    """JAX's test_train_step_reduces_loss on the port: 5 steps at a constant
    lr 1e-4 end below the first loss."""
    inputs, _ = _step_inputs()
    inputs = {k: v[:1] for k, v in inputs.items()}
    rng = np.random.RandomState(1)
    targets = dict(
        boxes2d=torch.from_numpy(rng.uniform(50, 200, (1, G, 4)).astype(np.float32)),
        proj_xy=torch.from_numpy(rng.uniform(0, 256, (1, G, 2)).astype(np.float32)),
        z=torch.from_numpy(rng.uniform(0.5, 4.0, (1, G, 1)).astype(np.float32)),
        dims=torch.from_numpy(rng.uniform(0.1, 1.0, (1, G, 3)).astype(np.float32)),
        pose=torch.eye(3)[None, None].repeat(1, G, 1, 1),
        mask=torch.ones(1, G),
    )
    model = make_cutr(192, depth_model=True, device="cpu")
    step, opt = make_train_step(model, learning_rate=1e-4)
    state = init_train_state(model, opt)
    batch = _torch_batch(inputs)
    state, m0 = step(state, batch, targets)
    for _ in range(4):
        state, m = step(state, batch, targets)
    assert float(m["loss"]) < float(m0["loss"]), (float(m0["loss"]), float(m["loss"]))


def test_batch_loss_is_the_mean_of_per_image_losses(jax_step):
    model = _port_model(jax_step["params"])
    inputs, targets = jax_step["inputs"], jax_step["targets"]
    with torch.no_grad():
        both = batch_loss(model, _torch_batch(inputs), {k: torch.from_numpy(v) for k, v in targets.items()})
        each = [batch_loss(model, _torch_batch({k: v[b:b + 1] for k, v in inputs.items()}),
                           {k: torch.from_numpy(v[b:b + 1]) for k, v in targets.items()}) for b in range(B)]
    torch.testing.assert_close(both, sum(each) / B, rtol=1e-5, atol=0)


# -------------------------------------------------------------- command line
def _losses(out: str):
    return [float(line.split("loss")[1].split("|")[0]) for line in out.splitlines() if "| loss" in line]


CLI_SMALL = ["--dim", "192", "--image-size", "256", "--n-sequences", "1", "--frames-per-seq", "4",
             "--n-boxes", "4", "--device", "cpu"]


def test_train_cli_runs_checkpoints_and_resumes_exactly(tmp_path, capsys):
    from boxfusion_tpu_torch.train.__main__ import main
    from boxfusion_tpu_torch.utils.checkpoint import restore_params

    ckpt = tmp_path / "ckpt"
    main(["--steps", "3", "--batch", "2", "--log-every", "2", "--warmup", "2",
          "--ckpt-dir", str(ckpt), "--ckpt-every", "3", *CLI_SMALL])
    out = capsys.readouterr().out
    assert "mesh {'dp': 1, 'fsdp': 1, 'tp': 1} | batch 2 | dim 192" in out
    assert "dataset: 4 frames, 4 GT slots/frame" in out
    losses = _losses(out)
    assert len(losses) == 2 and all(np.isfinite(l) for l in losses)
    saved = ckpt / "step_0000003"
    assert saved.exists() and f"saved {ckpt}/step_0000003" in out
    first = restore_params(str(saved))

    # resume it with a zero learning rate and decay: the step moves nothing,
    # so the next checkpoint holds exactly the resumed parameters
    ckpt2 = tmp_path / "ckpt2"
    main(["--steps", "1", "--batch", "2", "--lr", "0", "--weight-decay", "0", "--warmup", "0",
          "--resume", str(saved), "--ckpt-dir", str(ckpt2), "--ckpt-every", "1", *CLI_SMALL])
    out = capsys.readouterr().out
    assert f"resumed params from {saved}" in out
    again = restore_params(str(ckpt2 / "step_0000001"))
    assert again.keys() == first.keys()
    for k in first:
        assert torch.equal(again[k], first[k]), k


def test_train_cli_resumes_reference_fixture(capsys):
    from boxfusion_tpu_torch.train.__main__ import main

    main(["--steps", "2", "--batch", "2", "--log-every", "1", "--warmup", "1",
          "--resume", FIXTURE, *CLI_SMALL])
    out = capsys.readouterr().out
    assert f"resumed params from {FIXTURE}" in out
    losses = _losses(out)
    assert len(losses) == 2 and all(np.isfinite(l) for l in losses)
    with pytest.raises(SystemExit, match="pass --dim 192"):
        main(["--steps", "1", "--batch", "2", "--resume", FIXTURE, *CLI_SMALL, "--dim", "384"])


def test_train_cli_real_ca1m_sequence(tmp_path, capsys):
    """JAX's test_train_cli_real_ca1m_sequence on the port: capture -> the
    port's data_process convert -> GT corners -> trainer --data-root."""
    from test_dataprocess import _write_capture

    from boxfusion_tpu_torch.data_process.__main__ import main as prep_main
    from boxfusion_tpu_torch.geometry.boxes import box_corners
    from boxfusion_tpu_torch.train.__main__ import main as train_main

    cap = _write_capture(tmp_path, n_frames=4, hw=(48, 64))
    out = tmp_path / "slam" / "42898867"
    assert prep_main(["convert", str(cap), str(out)]) == 0

    # two GT boxes in front of the camera path, in box_corners vertex order
    xyzlhw = torch.tensor([[0.0, 0.0, 1.2, 0.4, 0.3, 0.2], [0.3, -0.1, 1.5, 0.2, 0.2, 0.5]])
    corners = box_corners(xyzlhw, torch.eye(3).repeat(2, 1, 1)).numpy()
    np.save(out / "after_filter_boxes.npy", corners)

    cfg_path = tmp_path / "cfg.yaml"
    base = open("config/ca1m.yaml").read()
    # landscape 48x64 capture: CA-1M convention stores W=height, H=width
    cfg_path.write_text(base.replace("H: 384", "H: 64").replace("W: 512", "W: 48"))

    train_main([
        "--steps", "2", "--batch", "2", "--dim", "192",
        "--data-root", str(out), "--train-config", str(cfg_path),
        "--gap", "1", "--n-boxes", "4", "--depth-ratio", "4",
        "--log-every", "1", "--warmup", "1", "--device", "cpu",
    ])
    outtxt = capsys.readouterr().out
    assert "dataset: 4 frames" in outtxt
    losses = _losses(outtxt)
    assert losses and all(np.isfinite(l) for l in losses)


def test_training_targets_match_jax():
    """The trainer's two target functions against the JAX package's on the
    same frames: equal within 1e-5 + 1e-6 relative (one float32 step of a
    pixel coordinate; the real-GT path goes through each package's
    corners_to_params)."""
    from boxfusion_tpu.data.synthetic import SyntheticSequence as JaxSequence
    from boxfusion_tpu.train.__main__ import _frame_targets as jax_frame_targets
    from boxfusion_tpu.train.__main__ import _targets_from_world_corners as jax_world_targets

    from boxfusion_tpu_torch.data.synthetic import SyntheticSequence
    from boxfusion_tpu_torch.train.__main__ import _frame_targets, _targets_from_world_corners

    from boxfusion_tpu_torch.geometry.boxes import box_corners
    from boxfusion_tpu_torch.geometry.rotation import euler_angles_to_matrix

    seq, jseq = SyntheticSequence(n_frames=3, n_boxes=5, seed=3), JaxSequence(n_frames=3, n_boxes=5, seed=3)
    rng = np.random.RandomState(0)
    xyzlhw = np.concatenate([rng.uniform(-1.5, 1.5, (6, 3)), rng.uniform(0.2, 1.0, (6, 3))], 1)
    R = euler_angles_to_matrix(torch.from_numpy(rng.uniform(-np.pi, np.pi, (6, 3))).float(), "YXZ")
    corners = torch.cat([
        box_corners(torch.from_numpy(seq.gt_xyzlhw).float(), torch.from_numpy(seq.gt_R).float()),
        box_corners(torch.from_numpy(xyzlhw).float(), R),
    ]).numpy()
    for frame, jframe in zip(seq, jseq):
        got, want = _frame_targets(seq, frame, 8), jax_frame_targets(jseq, jframe, 8)
        assert want["mask"].sum() > 0
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-6, err_msg=k)
        got = _targets_from_world_corners(corners, frame, 8)
        want = jax_world_targets(corners, jframe, 8)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-6, err_msg=k)
