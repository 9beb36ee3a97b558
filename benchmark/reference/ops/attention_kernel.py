"""Whole-sequence multi-head attention, the plain form (a frozen copy of the
port's ``whole_seq_attention_reference``): full attention without a mask
over (B, T, D) tensors whose heads are packed along the channel axis, scores
in the compute type, softmax in float32, probabilities cast to v's type."""
from __future__ import annotations

import torch


def whole_seq_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  heads: int, sm_scale: float) -> torch.Tensor:
    """Plain PyTorch twin: q pre-scaled in the compute type, scores in the
    compute type, softmax in float32, probabilities cast to v's type."""
    B, T, D = q.shape
    hd = D // heads
    qh = (q * sm_scale).reshape(B, T, heads, hd).transpose(1, 2)  # (B, h, T, c)
    kh = k.reshape(B, T, heads, hd).permute(0, 2, 3, 1)           # (B, h, c, T)
    vh = v.reshape(B, T, heads, hd).transpose(1, 2)
    a = torch.softmax((qh @ kh).float(), dim=-1).to(v.dtype)
    return (a @ vh).transpose(1, 2).reshape(B, T, D)
