"""The work that the inputs need, counted from shapes at the configuration's
widths: the yardstick of the MFU and the rooflines.

FLOPs count the matrix products (2 per multiply-add), as
``torch.utils.flop_counter.FlopCounterMode`` counts them; the CPU tests hold
these formulas to that counter run on the plain reference.  The PST search's
float32 operations are a frozen copy of ``ops/pst_search.py:operation_count``
and ``ops/fitness_kernel.py``'s per-cell constants, less the work of valid
candidate planes (which only the search's own projections can count): a
lower bound of what the kernel does.
"""
from __future__ import annotations

import math

# ops/fitness_kernel.py and ops/pst_search.py, frozen
OPS_PER_LIVE_PARTICLE = 28 * 100 + 141 + 133 + 34 + 612 + 256 + 10
OPS_PER_VALID_OBS_PLANE = 64
PARTICLE_OPS = 8 * ((6 + 6 + 3) + 3 + (3 + 3) + 3 * (3 + 3))
CELL_OPS = 8 * (3 + 3 * (3 + 2) + 3 + 2 * 5 + 2)


def _linear(tokens: int, n_in: int, n_out: int) -> int:
    return 2 * tokens * n_in * n_out


def _vit_block(tokens: int, attn_pairs: int, width: int, mlp: int, mlp_tokens: int | None = None) -> int:
    """qkv + the two attention products + out projection + a 2-layer MLP.
    ``attn_pairs``: query-key pairs summed over the attention groups."""
    mlp_tokens = tokens if mlp_tokens is None else mlp_tokens
    return (_linear(tokens, width, 3 * width) + 2 * 2 * attn_pairs * width
            + _linear(tokens, width, width) + _linear(mlp_tokens, width, mlp) + _linear(mlp_tokens, mlp, width))


def cutr_flops(pad: int, depth_ratio: int = 1, embed_dim: int = 768, decoder_dim: int = 256,
               num_queries: int = 300, num_metric: int = 2, decoder_layers: int = 6, ffn: int = 2048,
               rpe_hidden: int = 512, xattn_heads: int = 8, vit_depth: int = 12, window: int = 16,
               window_blocks=(0, 1, 3, 4, 6, 7, 9, 10), pretrain_grid: int = 14, top_k: int = 100) -> int:
    """FLOPs of one CuTR RGB-D forward at the square pad ``pad``."""
    D, C, Q = embed_dim, decoder_dim, num_queries + num_metric
    F = pad // 16
    Fd = (pad // depth_ratio) // 16
    N, Nd = F * F, Fd * Fd
    flops = _linear(N, 16 * 16 * 3, D) + _linear(Nd, 16 * 16, D)
    # bicubic resize of the pretraining position grid, RGB and depth
    for f in (F, Fd):
        flops += 2 * f * pretrain_grid * pretrain_grid * D + 2 * f * f * pretrain_grid * D

    def padded(f, w):
        return (math.ceil(f / w) * w) ** 2

    dws = window // max(1, F // Fd) if Fd else window
    for i in range(vit_depth):
        if i in window_blocks:
            rgb, dep = padded(F, window), padded(Fd, dws)
            n_win = rgb // (window * window)
            keys = window * window + dws * dws
            flops += _vit_block(rgb + dep, n_win * keys * keys, D, 4 * D, mlp_tokens=N + Nd)
        else:
            flops += _vit_block(N, N * N, D, 4 * D)
    flops += _linear(N, D, C)                      # input projection
    flops += _linear(N, 3 * (C // 3), C)           # camera-ray embedding
    # encoder proposals: two extra levels, the memory head, class and box MLPs
    f2, f4 = F // 2, F // 4
    flops += _linear(f2 * f2, 4 * C, C) + _linear(f2 * f2, 4 * C, C) + _linear(f4 * f4, 4 * C, C)
    M = N + f2 * f2 + f4 * f4
    flops += _linear(M, C, C) + _linear(M, C, 2) + _linear(M, C, C) * 2 + _linear(M, C, 4)
    nb = num_queries
    for _ in range(decoder_layers):
        flops += _linear(Q, C, 3 * C) + 2 * 2 * Q * Q * C + _linear(Q, C, C)      # self-attention
        flops += 2 * (_linear(nb * F, 2, rpe_hidden) + _linear(nb * F, rpe_hidden, xattn_heads))
        flops += _linear(Q, C, C) + 2 * _linear(N, C, C) + 2 * 2 * Q * N * C + _linear(Q, C, C)
        flops += _linear(Q, C, ffn) + _linear(Q, ffn, C)
        flops += 2 * _linear(1, C, 1)                                              # depth scale
        flops += _linear(nb, C, 2)                                                 # class
        flops += 2 * _linear(nb, C, C) + _linear(nb, C, 4)                         # 2D box
        flops += 2 * _linear(nb, C, C) + _linear(nb, C, 7)                         # 3D box
    flops += _linear(top_k, 3, 3) + top_k * 3 * 3 * 3 * 2                          # back-projection
    return int(flops)


def tower_flops(crops: int, image_size: int = 224, patch: int = 14, width: int = 1280, layers: int = 32,
                embed_dim: int = 1024) -> int:
    """FLOPs of the CLIP image tower over ``crops`` crops."""
    grid = (image_size // patch) ** 2
    T = grid + 1
    flops = _linear(crops * grid, patch * patch * 3, width)
    flops += layers * _vit_block(crops * T, crops * T * T, width, 4 * width)
    flops += _linear(crops, width, embed_dim)
    return int(flops)


def attention_work(batch: int, tokens: int, heads: int, head_dim: int, elem_bytes: int = 2) -> tuple:
    """(FLOPs, bytes) of whole-sequence attention: the two products, and Q,
    K, V read once and O written once."""
    flops = 4 * batch * heads * tokens * tokens * head_dim
    bytes_ = 4 * batch * tokens * heads * head_dim * elem_bytes
    return flops, bytes_


def pst_search_ops(iterations, view_mask, n_particles: int, obs_planes) -> int:
    """float32 operations of one PST search, at least: for every iteration an
    object ran, its particles' corners, and in each live view, per particle,
    the projection, the fitness body and the work of each valid observed
    plane.

    Args (host arrays): iterations (N,); view_mask (N, V); obs_planes (N, V)
    valid observed planes of each view's polygon."""
    total = 0
    for n in range(len(iterations)):
        its = int(iterations[n])
        if its == 0:
            continue
        live = [v for v in range(len(view_mask[n])) if view_mask[n][v]]
        per_iter = sum(CELL_OPS + OPS_PER_LIVE_PARTICLE + int(obs_planes[n][v]) * OPS_PER_VALID_OBS_PLANE
                       for v in live)
        total += its * n_particles * (per_iter + PARTICLE_OPS)
    return total
