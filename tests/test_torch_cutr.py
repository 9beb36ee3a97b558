"""The port's CuTR against the JAX package's, on the CPU, in float32.

A CuTR at width 192 with a 256 px square pad and depth at 1/4 resolution
(r = 4).  Weights: random flax parameters pushed through the port's
``from_flax_params``, and the committed trained fixture loaded on both
sides (JAX through ``load_checkpoint``, the port through
``load_torch_state_dict``).  One module-scoped JAX compile serves both.

Tolerances are the JAX package's own activation-parity bounds
(README "checkpoint-activation parity"): scores 2e-3, 2D boxes 0.5 px, 3D
boxes 5 mm.  Rotations are yaw-only matrices of a head output; they get
1e-3.  ``standardize_depth`` is a sort and two sums: 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boxfusion_tpu.data.preprocess import standardize_depth as jax_standardize_depth
from boxfusion_tpu.models.cutr import FrameBatch as JaxFrameBatch
from boxfusion_tpu.models.cutr import make_cutr as jax_make_cutr
from boxfusion_tpu.models.cutr.convert import load_checkpoint

from boxfusion_tpu_torch.data.preprocess import standardize_depth
from boxfusion_tpu_torch.models.cutr import FrameBatch, make_cutr
from boxfusion_tpu_torch.models.cutr.convert import from_flax_params, load_torch_state_dict

torch.set_num_threads(2)

FIXTURE = "tests/fixtures/cutr_trained_192_f16.pth"
SCORE_TOL, BOX2D_PX, BOX3D_M = 2e-3, 0.5, 5e-3


def _inputs(S=256, r=4, seed=0):
    rng = np.random.RandomState(seed)
    c, s = np.cos(0.3), np.sin(0.3)
    return dict(
        image=rng.randn(1, S, S, 3).astype(np.float32),
        depth=rng.randn(1, S // r, S // r, 1).astype(np.float32),
        K=np.array([[[200.0, 0, 120], [0, 200.0, 90], [0, 0, 1]]], np.float32),
        image_hw=np.array([[192.0, 250.0]], np.float32),
        depth_params=np.array([[2.0, 0.5]], np.float32),
        T_gravity=np.array([[[1, 0, 0], [0, c, -s], [0, s, c]]], np.float32),
    )


@pytest.fixture(scope="module")
def jax_side():
    """(jitted apply with intermediates, random flax params, inputs)."""
    model = jax_make_cutr(dimension=192, depth_model=True)
    inputs = _inputs()
    batch = JaxFrameBatch(**{k: jnp.asarray(v) for k, v in inputs.items()})
    params = jax.jit(model.init)(jax.random.PRNGKey(0), batch)
    apply = jax.jit(lambda p, b: model.apply(p, b, train=True))
    return apply, params, batch, inputs


def _torch_batch(inputs):
    return FrameBatch(**{k: torch.from_numpy(v) for k, v in inputs.items()})


def _compare(want, got):
    last_w, last_g = want["intermediates"][-1], got["intermediates"][-1]
    # dense last-layer predictions of all 300 queries, before top-k
    np.testing.assert_allclose(
        torch.sigmoid(last_g["logits"]).numpy(), np.asarray(jax.nn.sigmoid(last_w["logits"])),
        atol=SCORE_TOL, rtol=0,
    )
    np.testing.assert_allclose(last_g["boxes"].numpy(), np.asarray(last_w["boxes"]), atol=BOX2D_PX, rtol=0)
    np.testing.assert_allclose(
        np.asarray(got["enc_logits"].numpy()), np.asarray(want["enc_logits"]), atol=SCORE_TOL, rtol=0
    )
    # the packaged top-k detections
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), atol=SCORE_TOL, rtol=0)
    np.testing.assert_allclose(got["pred_boxes"].numpy(), np.asarray(want["pred_boxes"]), atol=BOX2D_PX, rtol=0)
    np.testing.assert_allclose(got["boxes3d"].numpy(), np.asarray(want["boxes3d"]), atol=BOX3D_M, rtol=0)
    np.testing.assert_allclose(got["R"].numpy(), np.asarray(want["R"]), atol=1e-3, rtol=0)
    np.testing.assert_array_equal(got["pred_classes"].numpy(), np.asarray(want["pred_classes"]))


def test_cutr_random_flax_params_match_jax(jax_side):
    apply, params, batch, inputs = jax_side
    want = apply(params, batch)
    model = make_cutr(192, depth_model=True, device="cpu")
    model.load_state_dict(from_flax_params(jax.tree.map(np.asarray, params)), strict=True)
    with torch.no_grad():
        got = model(_torch_batch(inputs), train=True)
    _compare(want, got)


def test_cutr_trained_fixture_matches_jax(jax_side):
    apply, _, batch, inputs = jax_side
    params, dim, depth_model = load_checkpoint(FIXTURE)
    assert (dim, depth_model) == (192, True)
    want = apply(params, batch)
    sd = torch.load(FIXTURE, map_location="cpu", weights_only=True)
    model = load_torch_state_dict(sd, device="cpu")
    assert model.cfg.embed_dim == 192 and model.cfg.depth_model
    with torch.no_grad():
        got = model(_torch_batch(inputs), train=True)
    _compare(want, got)
    # trained weights detect: the packaged scores are not all at the prior
    assert got["scores"].max() > 0.1


def test_cutr_attn_impl_kernel_equals_plain():
    """``attn_impl="kernel"`` packs heads along the channel axis and joins RGB
    and depth tokens into one sequence; on the CPU the wrapper runs its twin,
    so the two paths differ by float32 reassociation only: 1e-5 on the packaged
    scores and 3D boxes; raw logits and pixel boxes (up to 256) 1e-4 + 1e-5
    relative."""
    inputs = _inputs()
    plain = make_cutr(192, depth_model=True, device="cpu", seed=3)
    kern = make_cutr(192, depth_model=True, device="cpu", seed=3, attn_impl="kernel")
    assert plain.cfg.attn_impl == "xla" and kern.backbone[0].blocks[0].attn.attn_impl == "kernel"
    kern.load_state_dict(plain.state_dict(), strict=True)
    from boxfusion_tpu_torch.ops.attention_kernel import whole_seq_attention

    with torch.no_grad():
        want = plain(_torch_batch(inputs), train=True)
        before = whole_seq_attention.launches
        got = kern(_torch_batch(inputs), train=True)
    assert whole_seq_attention.launches == before  # CPU tensors: the twin, no launch
    for key in ("logits", "boxes"):
        np.testing.assert_allclose(got["intermediates"][-1][key].numpy(),
                                   want["intermediates"][-1][key].numpy(), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"].numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["boxes3d"].numpy(), want["boxes3d"].numpy(), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="attn_impl"):
        make_cutr(192, device="cpu", attn_impl="flash")


def test_load_torch_state_dict_rejects_incomplete():
    sd = torch.load(FIXTURE, map_location="cpu", weights_only=True)["model"]
    sd = {k: v for k, v in sd.items() if not k.startswith("decoder.norm")}
    with pytest.raises(ValueError, match="lacks"):
        load_torch_state_dict(sd, device="cpu")


@pytest.mark.parametrize("invalid_share", [0.0, 0.3])
def test_standardize_depth_matches_jax(invalid_share):
    rng = np.random.RandomState(1)
    depth = (rng.rand(96, 128) * 4.0 + 0.2).astype(np.float32)
    depth[rng.rand(96, 128) < invalid_share] = 0.0
    want_map, want_par = jax.jit(jax_standardize_depth)(jnp.asarray(depth))
    got_map, got_par = standardize_depth(torch.from_numpy(depth))
    np.testing.assert_allclose(got_par.numpy(), np.asarray(want_par), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_map.numpy(), np.asarray(want_map), rtol=1e-5, atol=1e-5)
