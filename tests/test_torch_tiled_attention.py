"""The attention ablation's plain twin against the JAX package's kernel.

``tools/pallas_attention_ablation.py:tiled_attention`` runs in Pallas
interpret mode on the CPU (as tests/test_ops.py runs it); the same numpy
inputs go through ``boxfusion_tpu_torch/tools/attention_ablation.py``, whose
wrapper runs ``reference_attention`` on CPU tensors.  Tolerance: rtol = atol
= 2e-4, the JAX package's own bound for this kernel (tests/test_ops.py:31).

JAX is imported inside the fixture, not at the top, so that the card test at
the bottom also runs on a machine that has no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_tiled_attention.py
"""
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from boxfusion_tpu_torch.tools.attention_ablation import reference_attention, tiled_attention

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-4


@pytest.fixture(scope="module")
def jax_tool():
    """The JAX ablation tool, imported from its file as tests/test_ops.py does."""
    spec = importlib.util.spec_from_file_location(
        "pallas_attention_ablation", os.path.join(REPO, "tools", "pallas_attention_ablation.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _qkv(n, seed, bh=2, d=64):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(bh, n, d).astype(np.float32) for _ in range(3))


@pytest.mark.parametrize("n", [256, 320, 576])
def test_reference_attention_matches_jax_tiled_attention(jax_tool, n):
    import jax.numpy as jnp

    q, k, v = _qkv(n, seed=n)
    want = np.asarray(jax_tool.tiled_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                               block_q=256, interpret=True))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = tiled_attention(tq, tk, tv, block_q=256)  # CPU tensors: the plain twin
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(reference_attention(tq, tk, tv).numpy(),
                               np.asarray(jax_tool.reference_attention(
                                   jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))),
                               rtol=TOL, atol=TOL)


def test_bfloat16_twin_rounds_probabilities_to_v_type():
    """bfloat16 in, bfloat16 out, float32 softmax in between: against the
    float32 result the error is bfloat16 rounding (2e-2 on unit-variance
    inputs, chip_smoke.attention_tolerance's atol), not more."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(320, seed=7))
    got = tiled_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert got.dtype == torch.bfloat16
    want = reference_attention(q.bfloat16().float(), k.bfloat16().float(), v.bfloat16().float())
    assert float((got.float() - want).abs().max()) < 2e-2


def test_wrapper_checks_its_arguments():
    q = torch.zeros(2, 16, 64)
    with pytest.raises(ValueError, match="shape"):
        tiled_attention(q, q[:, :8], q)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tiled_attention(q.double(), q.double(), q.double())
    with pytest.raises(TypeError, match="q is"):
        tiled_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="block_q"):
        tiled_attention(q, q, q, block_q=0)
    with pytest.raises(ValueError, match=r"\(BH, N, D\)"):
        tiled_attention(q[0], q[0], q[0])


@pytest.mark.cuda
def test_tiled_attention_kernel_on_card_matches_twin():
    """The CUDA kernel against its twin at chip_smoke's shapes and
    tolerances, float32 and bfloat16, ragged N included; a launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    sys.path.insert(0, REPO)
    from chip_smoke import TILED_CASES, TILED_F32_TOL, attention_tolerance, tiled_case

    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = ((TILED_F32_TOL, TILED_F32_TOL) if dtype == torch.float32
                      else attention_tolerance(dtype))
        for bh, n in TILED_CASES:
            q, k, v = tiled_case(torch.device("cuda"), bh, n, dtype)
            before = tiled_attention.launches
            got = tiled_attention(q, k, v)
            want = reference_attention(q, k, v)
            torch.cuda.synchronize()
            assert tiled_attention.launches == before + 1
            assert got.dtype == q.dtype and got.shape == q.shape and torch.isfinite(got).all()
            excess = (got.float() - want.float()).abs() - (atol + rtol * want.float().abs())
            assert float(excess.max()) <= 0, (bh, n, dtype)
