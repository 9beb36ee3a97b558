"""Pre-sampled Search Table (PST) loading.

Capability target: BoxFusion.__init__ loading ``data/pst_1024_0.tiff`` via
``cv2.imread(-1)`` (reference box_fusion.py:31-32): a (1024, 6) float32
table in roughly [-1, 1] whose row 0 is the all-zero identity particle.
cv2 is not required here -- PIL reads the float tiff directly, and a
deterministic fallback generator reproduces the table's structure (row 0
zero, remaining rows quasi-random in [-1, 1]) when the asset is absent.
"""
from __future__ import annotations

import os

import numpy as np


def synthesize_pst(pst_size: int = 1024, seed: int = 0) -> np.ndarray:
    """Deterministic low-discrepancy stand-in for the shipped PST asset."""
    from scipy.stats import qmc

    sampler = qmc.Halton(d=6, scramble=True, seed=seed)
    table = (sampler.random(pst_size) * 2.0 - 1.0).astype(np.float32)
    table[0] = 0.0
    return table
