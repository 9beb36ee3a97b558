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

from boxfusion_tpu_torch.tools import attention_ablation as ab
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


@pytest.mark.parametrize("hd", ab.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_fits_the_card_and_fills_it(hd, dtype):
    """plan_tiled: shared memory fits a block on Hopper, at least two K, V
    stages, 64 query rows per consumer warpgroup (float32: one warpgroup of
    64 rows; bfloat16: two consumers, or three at head widths up to 64,
    beside the producer, one block per SM), and at (12, 4096, 64), the
    ablation's long shape, at least one block for every SM of the card.  At
    (12, 1024, 64) bfloat16 runs 96 blocks of two consumers: timed faster
    than a full wave of 192 one-consumer blocks, which load K and V twice as
    often.  The card test holds these against what the C entry lays out."""
    for bh, n in ((1, 1), (3, 63), (3, 65), (2, 320), (12, 1024), (12, 4096), (66, 129), (40, 1000)):
        plan = ab.plan_tiled(bh, n, hd, dtype)
        assert plan.smem_bytes < ab.SMEM_LIMIT and plan.stages >= 2, (bh, n, plan)
        if dtype == torch.float32:
            assert (plan.block_rows, plan.warpgroups, plan.stages) == (64, 1, 2)
            continue
        consumers = plan.warpgroups - 1
        assert consumers in (2, 3) and plan.block_rows == 64 * consumers, (bh, n, plan)
        assert consumers == 2 or hd <= 64
        assert 2 <= plan.stages <= ab.MAX_STAGES
    blocks = lambda bh, n, d: -(-n // ab.plan_tiled(bh, n, hd, d).block_rows) * bh
    assert blocks(12, 1024, torch.float32) >= ab.NUM_SMS
    if hd == 64:
        assert blocks(12, 4096, torch.float32) >= ab.NUM_SMS
        assert ab.plan_tiled(12, 4096, hd, torch.bfloat16).warpgroups == 4  # 264 blocks: two full waves
        assert blocks(12, 4096, torch.bfloat16) == 2 * ab.NUM_SMS
        assert ab.plan_tiled(12, 1024, hd, torch.bfloat16).warpgroups == 3  # 96 blocks of 128 rows


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="no plan"):
        ab.plan_tiled(12, 1024, 80, torch.bfloat16)
    with pytest.raises(ValueError, match="no plan"):
        ab.plan_tiled(12, 0, 64, torch.float32)
    with pytest.raises(ValueError, match="no plan"):
        ab.plan_tiled(12, 64, 64, torch.float16)


# the card test's lengths: around the key tiles and the 128-row blocks, and
# the ablation's; (BH, N) pairs whose last bfloat16 block is ragged with
# consumers that hold no live row: three consumers over 1000 = 5 x 192 + 40
# rows (two idle, and a partial key tile), two over 129 rows (one idle)
CARD_LENGTHS = (1, 63, 64, 65, 127, 129, 320, 1024, 4096)
CARD_RAGGED_BLOCK_CASES = ((40, 1000), (66, 129))


@pytest.mark.cuda
def test_tiled_attention_kernel_on_card_matches_twin():
    """The CUDA kernel against its twin on the card at every head width, in
    float32 and bfloat16 (chip_smoke.tiled_tolerance), at N in CARD_LENGTHS
    (BH = 3), chip_smoke's TILED_CASES and two cases whose last block holds
    idle consumers; a launch counted each time.  The launch the C entry lays
    out (query rows, warpgroups, stages, shared bytes) is plan_tiled's, with
    nothing spilled; the C entry refuses a scale <= 0 and a plan the kernel
    does not take."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    sys.path.insert(0, REPO)
    from chip_smoke import TILED_CASES, tiled_tolerance

    dev = torch.device("cuda")
    cases = [(3, n) for n in CARD_LENGTHS] + list(TILED_CASES) + list(CARD_RAGGED_BLOCK_CASES)
    for dtype in (torch.float32, torch.bfloat16):
        for hd in ab.HEAD_DIMS:
            for bh, n in cases:
                plan, info = ab.plan_tiled(bh, n, hd, dtype), ab.kernel_info(bh, n, hd, dtype)
                laid_out = (info["block_rows"], info["warpgroups"], info["stages"], info["smem_bytes"])
                assert laid_out == (plan.block_rows, plan.warpgroups, plan.stages, plan.smem_bytes), (bh, n, hd)
                assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1, (bh, n, hd, info)
                gen = torch.Generator(device=dev).manual_seed(1000 * n + hd)
                q, k, v = torch.randn(3, bh, n, hd, generator=gen, device=dev).to(dtype).unbind(0)
                before = tiled_attention.launches
                got = tiled_attention(q, k, v)
                want = reference_attention(q, k, v)
                torch.cuda.synchronize()
                assert tiled_attention.launches == before + 1
                assert got.dtype == q.dtype and got.shape == q.shape and torch.isfinite(got).all()
                excess = (got.float() - want.float()).abs() - tiled_tolerance(want)
                assert float(excess.max()) <= 0, (bh, n, hd, dtype, float((got.float() - want.float()).abs().max()))

    lib, stream = ab._library(), torch.cuda.current_stream().cuda_stream
    for hd, scale, consumers, stages in ((64, -0.125, 2, 2), (64, 0.0, 2, 2), (128, 0.125, 3, 2),
                                         (64, 0.125, 2, ab.MAX_STAGES + 1), (64, 0.125, 2, 1)):
        x = torch.randn(3, 64, hd, device=dev, dtype=torch.bfloat16)
        out = torch.empty_like(x)
        assert lib.tiled_attention_launch(x.data_ptr(), x.data_ptr(), x.data_ptr(), out.data_ptr(), 3, 64, hd,
                                          scale, 1, consumers, stages, stream) != 0, (hd, scale, consumers, stages)


@pytest.mark.cuda
def test_empty_work_launches_nothing_and_counts_nothing():
    """Both attention wrappers count a launch only where the C entry makes
    one: with no slice (or no sequence) it returns at once, so the count
    (which chip_smoke holds against the kernel events of a torch.profiler
    trace) stays where it was.  tiled_attention's bfloat16 plan refuses an
    empty batch outright (ValueError), which launches nothing either."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from boxfusion_tpu_torch.ops.attention_kernel import whole_seq_attention

    dev = torch.device("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros(0, 64, 64, dtype=dtype, device=dev)
        before = tiled_attention.launches
        if dtype == torch.float32:
            assert tiled_attention(q, q, q).shape == (0, 64, 64)
        else:
            with pytest.raises(ValueError, match="no plan"):
                tiled_attention(q, q, q)
        assert tiled_attention.launches == before
        x = torch.zeros(0, 17, 4 * 64, dtype=dtype, device=dev)
        before = whole_seq_attention.launches
        assert whole_seq_attention(x, x, x, heads=4, sm_scale=0.125).shape == (0, 17, 256)
        assert whole_seq_attention.launches == before
        one = torch.randn(1, 64, 64, device=dev).to(dtype)
        before = tiled_attention.launches
        tiled_attention(one, one, one)
        assert tiled_attention.launches == before + 1
    torch.cuda.synchronize()
