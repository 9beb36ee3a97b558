"""The port's whole-sequence attention against the JAX package's, on the CPU.

On the CPU ``whole_seq_attention`` runs its plain twin (the CUDA kernel has no
CPU mode; chip_smoke.py and the ``cuda``-marked test at the bottom hold the
kernel to the twin on the card).  Here the twin is held to the Pallas kernel
run in interpret mode, at the two shapes of tests/test_ops.py:51-86 and at
the JAX package's own bound for them (rtol = atol = 1e-5, float32
reassociation only), and the bfloat16 kernel's launch plan is checked.

JAX is imported inside the test that needs it, so that the card test also
runs on a machine that has no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_attention.py
"""
import os
import sys

import numpy as np
import pytest
import torch

from boxfusion_tpu_torch.ops import attention_kernel as ak
from boxfusion_tpu_torch.ops.attention_kernel import (
    whole_seq_attention,
    whole_seq_attention_reference,
)

torch.set_num_threads(2)


@pytest.mark.parametrize("seed,B,T,H,HD", [(0, 3, 37, 4, 16), (1, 2, 128, 2, 64)],
                         ids=["ragged", "aligned"])
def test_twin_matches_pallas_interpret(seed, B, T, H, HD):
    import jax.numpy as jnp

    from boxfusion_tpu.ops.attention_kernel import whole_seq_attention as jax_whole_seq_attention

    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, T, H * HD).astype(np.float32) for _ in range(3))
    scale = HD ** -0.5
    want = np.asarray(jax_whole_seq_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              heads=H, sm_scale=scale, interpret=True))
    args = [torch.from_numpy(x) for x in (q, k, v)]
    before = whole_seq_attention.launches
    got = whole_seq_attention(*args, heads=H, sm_scale=scale)
    assert whole_seq_attention.launches == before  # a CPU tensor launches nothing
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(
        got.numpy(), whole_seq_attention_reference(*args, H, scale).numpy())


def test_wrapper_takes_chunk_views_and_bfloat16():
    """The tower hands the wrapper the three chunk views of one qkv tensor;
    in bfloat16 the result is within bfloat16 rounding of float32 math."""
    rng = np.random.RandomState(2)
    qkv = torch.from_numpy(rng.randn(2, 50, 3 * 64).astype(np.float32))
    q, k, v = qkv.chunk(3, dim=-1)
    want = whole_seq_attention(q.contiguous(), k.contiguous(), v.contiguous(), 2, 32 ** -0.5)
    got = whole_seq_attention(q, k, v, 2, 32 ** -0.5)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    lo = whole_seq_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), 2, 32 ** -0.5)
    assert lo.dtype == torch.bfloat16
    # one bfloat16 rounding of the scores, the probabilities and the output
    np.testing.assert_allclose(lo.float().numpy(), want.numpy(), atol=3e-2, rtol=0)


def test_strided_views_are_passed_through_or_copied():
    qkv = torch.zeros(2, 5, 3 * 64, dtype=torch.bfloat16)
    q = qkv.chunk(3, dim=-1)[1]
    assert ak._strided(q) is q                      # rows 16-byte aligned: read in place
    odd = torch.zeros(2, 5, 70, dtype=torch.bfloat16)[:, :, 3:67]
    assert ak._strided(odd).is_contiguous() and ak._strided(odd) is not odd
    t = torch.zeros(2, 64, 5).transpose(1, 2)       # channel axis not contiguous
    assert ak._strided(t).is_contiguous()


@pytest.mark.parametrize("case", ["shape", "dtype", "mixed", "heads", "width", "device"])
def test_wrapper_rejects(case):
    q = torch.zeros(1, 4, 64)
    if case == "shape":
        with pytest.raises(ValueError, match="q's shape"):
            whole_seq_attention(q, torch.zeros(1, 5, 64), q, 2, 1.0)
    elif case == "dtype":
        h = q.half()
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            whole_seq_attention(h, h, h, 2, 1.0)
    elif case == "mixed":
        with pytest.raises(TypeError, match="k is"):
            whole_seq_attention(q, q.bfloat16(), q, 2, 1.0)
    elif case == "heads":
        with pytest.raises(ValueError, match="multiple of heads"):
            whole_seq_attention(q, q, q, 3, 1.0)
    elif case == "width":
        with pytest.raises(ValueError, match="head width"):
            whole_seq_attention(q, q, q, 8, 1.0)  # 8-wide heads
    else:
        m = torch.zeros(1, 4, 64, device="meta")
        with pytest.raises(ValueError, match="cuda or cpu"):
            whole_seq_attention(m, m, m, 2, 1.0)


@pytest.mark.parametrize("hd", ak.HEAD_DIMS)
def test_bf16_plan_fills_tiles_and_blocks_at_least_half(hd):
    """plan_bf16, on what Python decides (the kernel cuts the rows and the
    tiles by these counts; the card test checks that every row comes out
    right): ceil(T / 64) query tiles, so each fits one 64-row wgmma tile of
    floor or ceil(T / n_qtiles) rows and, from T = 64 on, is at least half
    full; at most one block per tile; each block's live rows are at least
    half of what its rounds (one tile per warpgroup) could hold unless it is
    the only block of its (sequence, head); the Q buffers' reuse rule; shared
    memory fits a block on Hopper (a tile is 16-channel aligned: hd 72's is
    80 wide).  At T = 257 no tile or block exists for the 257th row."""
    for T in (1, 37, 257, 1024, 4096, *range(2, 700, 7)):
        plan = ak.plan_bf16(T, hd)
        n_kt = -(-T // ak.TILE)
        assert plan.n_qtiles == n_kt
        assert -(-T // plan.n_qtiles) <= ak.TILE
        assert T < ak.TILE or 2 * (T // plan.n_qtiles) >= ak.TILE, (T, hd)
        assert 1 <= plan.n_groups <= plan.n_qtiles
        for tiles in {plan.n_qtiles // plan.n_groups, -(-plan.n_qtiles // plan.n_groups)}:
            capacity = -(-tiles // ak.WARPGROUPS) * ak.WARPGROUPS * ak.TILE
            assert plan.n_groups == 1 or 2 * tiles * (T // plan.n_qtiles) >= capacity, (T, hd, tiles)
        assert 2 <= plan.stages <= n_kt + 1
        assert plan.smem_bytes == (2 * ak.WARPGROUPS + 2 * plan.stages) * ak.TILE * ak.padded_width(hd) * 2 <= ak.SMEM_LIMIT
    main = ak.plan_bf16(257, 64)
    assert (main.n_qtiles, main.n_groups, main.stages, main.smem_bytes) == (5, 1, 5, 114_688)


@pytest.mark.cuda
def test_bf16_kernel_on_card_matches_twin():
    """The wgmma kernel against its twin on the card, on the chunk views of
    one qkv tensor, at every head width and at lengths around the 16- and
    64-row edges, at chip_smoke's bfloat16 tolerance; each launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import attention_tolerance

    dev = torch.device("cuda")
    atol, rtol = attention_tolerance(torch.bfloat16)
    cases = [(T, hd, hd ** -0.5) for T in (1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 256, 257, 1024)
             for hd in ak.HEAD_DIMS]
    cases += [(257, 64, -0.125), (65, 16, 0.0)]  # the kernel negates Q for a negative scale
    for T, hd, scale in cases:
        gen = torch.Generator(device=dev).manual_seed(T * 1000 + hd)
        qkv = torch.randn(3, T, 3 * 2 * hd, generator=gen, device=dev).bfloat16()
        q, k, v = qkv.chunk(3, dim=-1)
        before = whole_seq_attention.launches
        got = whole_seq_attention(q, k, v, 2, scale)
        want = whole_seq_attention_reference(q, k, v, 2, scale)
        torch.cuda.synchronize()
        assert whole_seq_attention.launches == before + 1
        assert got.dtype == torch.bfloat16 and got.shape == q.shape and torch.isfinite(got).all()
        excess = (got.float() - want.float()).abs() - (atol + rtol * want.float().abs())
        assert float(excess.max()) <= 0, (T, hd, scale, float((got.float() - want.float()).abs().max()))
