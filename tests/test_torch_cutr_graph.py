"""CuTR's forward as a CUDA graph, and the constants it needs on the card.

On the CPU every forward runs eagerly and counts as such; the constants
made once per device give the tensors the per-call form gave, bit for bit;
two calls never share an output's storage; moving, copying or reloading the
model drops its graphs.  On the card (``-m cuda``; this file imports no JAX,
so it runs where JAX is not installed): a replay equals the eager forward
bit for bit at the two cells' pad buckets, leaves an earlier call's outputs
alone, holds no synchronisation, follows weights written in place and
parameters swapped in by ``functional_call``.
"""
import copy
import pickle

import numpy as np
import pytest
import torch

from boxfusion_tpu_torch.data.preprocess import PIXEL_MEAN_U8, package_frame, pick_square_pad
from boxfusion_tpu_torch.models.cutr import make_cutr
from boxfusion_tpu_torch.models.cutr.layers import _bicubic, torch_bicubic_matrix
from boxfusion_tpu_torch.utils.device import device_constant

torch.set_num_threads(2)


def _frame(h, w, ratio=4, seed=0, device="cpu", depth=True, square=None):
    rng = np.random.RandomState(seed)
    image = torch.from_numpy(rng.randint(0, 255, (h, w, 3)).astype(np.uint8)).to(device)
    dep = torch.from_numpy(rng.uniform(0.5, 3.0, (h // ratio, w // ratio)).astype(np.float32)).to(device)
    K = torch.tensor([[0.9 * w, 0, w / 2], [0, 0.9 * w, h / 2], [0, 0, 1]], device=device)
    c, s = np.cos(0.2), np.sin(0.2)
    T = torch.tensor([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=torch.float32, device=device)
    square = square or pick_square_pad(max(h, w))
    return package_frame(image, dep if depth else None, K, T, square, ratio)


def _shares_storage(a, b):
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


# ------------------------------------------------------------- on the CPU
@pytest.fixture(scope="module")
def cpu_model():
    return make_cutr(192, depth_model=True, device="cpu", seed=2)


@pytest.mark.parametrize("mode", ["inference", "no_grad", "grad", "train"])
def test_cpu_forward_runs_eagerly(cpu_model, mode):
    """Off the card no call captures or replays; each counts as eager, and
    every mode gives the inference outputs bit for bit."""
    batch = _frame(192, 250)
    with torch.inference_mode():
        want = cpu_model(batch)
    before = dict(cpu_model.graph_counts)
    if mode == "inference":
        with torch.inference_mode():
            got = cpu_model(batch)
    elif mode == "no_grad":
        with torch.no_grad():
            got = cpu_model(batch)
    else:
        got = cpu_model(batch, train=mode == "train")
    counts = cpu_model.graph_counts
    assert counts["eager"] == before["eager"] + 1
    assert (counts["capture"], counts["replay"]) == (before["capture"], before["replay"]) == (0, 0)
    assert not cpu_model._graphs
    assert ("intermediates" in got) == (mode == "train")
    for k, v in want.items():
        assert torch.equal(got[k].detach(), v), k


def test_successive_calls_share_no_storage(cpu_model):
    with torch.inference_mode():
        first = cpu_model(_frame(192, 250, seed=1))
        second = cpu_model(_frame(192, 250, seed=2))
    assert set(first) == set(second)
    for a in first.values():
        for b in second.values():
            assert not _shares_storage(a, b)


def test_training_after_inference_backpropagates():
    """The constants made inside inference mode are ordinary tensors: a
    later training forward may save them for backward."""
    model = make_cutr(192, depth_model=True, device="cpu", seed=4)
    batch = _frame(160, 200, seed=3)
    with torch.inference_mode():
        model(batch)
    out = model(batch, train=True)
    (out["boxes3d"].sum() + out["pred_boxes"].sum() + out["proj_xy"].sum()).backward()
    assert model.decoder.predictors[5][2].mlp.layers[0].weight.grad is not None


@pytest.mark.parametrize("values, dtype", [
    ((256.0, 256.0, 256.0, 256.0), torch.float32),
    ((640.0, 640.0), torch.float32),
    ((512.0, 512.0, 512.0, 512.0), torch.bfloat16),
    (2.0 ** np.linspace(0.0, np.log2(16), 85), torch.float32),
    (2.0 ** np.linspace(0.0, np.log2(20), 85), torch.bfloat16),
    (PIXEL_MEAN_U8, torch.float32),
    ([[518, 392]], torch.float32),
])
def test_device_constant_is_the_per_call_tensor(values, dtype):
    """Bit for bit the tensor the per-call form made, once per key, and an
    ordinary tensor even when first made inside inference mode."""
    with torch.inference_mode():
        got = device_constant(values, torch.device("cpu"), dtype)
    want = torch.as_tensor(np.asarray(values), dtype=dtype)
    assert got.dtype == dtype and torch.equal(got, want)
    assert device_constant(values, torch.device("cpu"), dtype) is got
    assert not got.is_inference() and not got.requires_grad


def test_bicubic_matrix_and_inverse_are_the_per_call_ones():
    with torch.inference_mode():
        m = _bicubic(14, 32, torch.device("cpu"))
    assert not m.is_inference()
    assert torch.equal(m, torch.from_numpy(torch_bicubic_matrix(14, 32)))
    K = torch.tensor([[463.0, 0, 256.3], [0, 461.2, 191.7], [0, 0, 1]])
    assert torch.equal(torch.linalg.inv_ex(K).inverse, torch.linalg.inv(K))


def test_moving_copying_or_reloading_drops_the_graphs():
    model = make_cutr(192, depth_model=True, device="cpu", seed=5)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    for drop in (lambda m: m.float(), lambda m: m.to("cpu"), lambda m: m.load_state_dict(state),
                 lambda m: m.load_state_dict(state, assign=True)):
        model._graphs["key"] = object()
        drop(model)
        assert not model._graphs
    model._graphs["key"] = object()
    assert not copy.deepcopy(model)._graphs
    assert not pickle.loads(pickle.dumps(model))._graphs
    assert model._graphs


def test_functional_call_is_seen_as_other_parameters(cpu_model):
    """Inside ``functional_call`` the model holds plain tensors where its
    parameters were, so no graph is captured on them."""
    seen = []
    hook = cpu_model.register_forward_pre_hook(lambda m, args: seen.append(m._own_parameters()))
    try:
        params = {n: p.detach() for n, p in cpu_model.named_parameters()}
        with torch.no_grad():
            torch.func.functional_call(cpu_model, params, (_frame(192, 250),), tie_weights=False)
            cpu_model(_frame(192, 250))
    finally:
        hook.remove()
    assert seen == [False, True]


# ------------------------------------------------------------- on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _eager(model, batch):
    """The eager forward's outputs (gradients on take the eager path)."""
    with torch.enable_grad():
        return {k: v.detach() for k, v in model(batch).items()}


def _assert_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.fixture(scope="module")
def card_model():
    dev = _card()
    return make_cutr(768, depth_model=True, device=dev, seed=0, dtype="bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(384, 512), (518, 392)], ids=["pad512", "pad640"])
def test_replay_equals_eager_on_card(card_model, hw):
    """At the two cells' frames (RGB-D, depth at full resolution): the
    capture's result and a replay's each equal the eager forward bit for
    bit; the first call's outputs survive the second; replays hold no
    synchronisation, and neither does the eager forward."""
    dev = _card()
    h, w = hw
    frames = [_frame(h, w, ratio=1, seed=s, device=dev) for s in (11, 12, 13)]
    counts = card_model.graph_counts
    c0 = dict(counts)
    with torch.inference_mode():
        first = card_model(frames[0])
        kept = {k: v.clone() for k, v in first.items()}
        second = card_model(frames[1])
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            third = card_model(frames[2])
            eager_train = card_model(frames[2], train=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert counts["capture"] == c0["capture"] + 1
    assert counts["replay"] == c0["replay"] + 2
    _assert_equal(first, kept)
    for frame, got in zip(frames, (first, second, third)):
        _assert_equal(got, _eager(card_model, frame))
    for a in first.values():
        for b in second.values():
            assert not _shares_storage(a, b)
    _assert_equal({k: eager_train[k] for k in third}, third)


@pytest.mark.cuda
def test_replay_follows_weights_on_card():
    """A weight written in place is read by the next replay; parameters
    swapped in by ``functional_call`` run eagerly; ``.to`` another dtype
    drops the graphs, and the next call captures anew."""
    dev = _card()
    model = make_cutr(768, depth_model=True, device=dev, seed=1, dtype="bfloat16")
    batch = _frame(384, 512, ratio=1, seed=21, device=dev)
    with torch.inference_mode():
        before = model(batch)
        bias = model.decoder.predictors[5][1].linear.bias
        bias.add_(1.5)
        lifted = model(batch)
    assert model.graph_counts == {"capture": 1, "replay": 1, "eager": 0}
    assert not torch.equal(lifted["scores"], before["scores"])
    _assert_equal(lifted, _eager(model, batch))

    # parameters swapped in for one call run eagerly, whether or not the
    # call's key has a graph (no_grad: a key of its own)
    swapped = {n: p.detach().clone() for n, p in model.named_parameters()}
    swapped["decoder.predictors.5.1.linear.bias"] -= 1.5
    swapped_out = []
    for _ in range(2):
        with torch.no_grad():
            swapped_out.append(torch.func.functional_call(model, swapped, (batch,), tie_weights=False))
            model(batch)
    assert model.graph_counts == {"capture": 2, "replay": 2, "eager": 3}
    with torch.no_grad():
        bias.sub_(1.5)
    for got in swapped_out:
        _assert_equal(got, _eager(model, batch))

    model.to(torch.bfloat16)
    assert not model._graphs
    model.to(torch.float32)
    with torch.inference_mode():
        again = model(batch)
    assert model.graph_counts["capture"] == 3
    _assert_equal(again, _eager(model, batch))
