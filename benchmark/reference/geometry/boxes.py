"""Oriented 3D boxes as plain tensors (torch).

Port of ``boxfusion_tpu/geometry/boxes.py``.  A "general" box is a
gravity-centered parametrization `xyzlhw` of shape (..., 6) -- center
(x, y, z) and dims (l, h, w) -- plus an explicit per-box rotation matrix R of
shape (..., 3, 3).  The local corner template assigns l to the local X axis,
h to local Y, and w to local Z, with the vertex numbering of the reference
(boxes.py:726-778):

            v4_____________________v5
            /|                    /|
           / |                   / |
          /__|__________________/  |
       v0|   |                  |v1|
         |   |__________________|__|
         |  / v7                |  /v6
         | /                    | /
         |/_____________________|/
         v3                     v2

X: -l/2 at {0,3,4,7}, +l/2 at {1,2,5,6}
Y: -h/2 at {0,1,4,5}, +h/2 at {2,3,6,7}
Z: -w/2 at {0,1,2,3}, +w/2 at {4,5,6,7}

Coordinate math runs in float32 with TF32 off (see the package docstring).
"""
from __future__ import annotations

import numpy as np
import torch


# (8, 3) signs multiplying (l/2, h/2, w/2); row i = local corner v_i.
CORNER_SIGNS = np.array(
    [
        [-1, -1, -1],
        [+1, -1, -1],
        [+1, +1, -1],
        [-1, +1, -1],
        [-1, -1, +1],
        [+1, -1, +1],
        [+1, +1, +1],
        [-1, +1, +1],
    ],
    dtype=np.float32,
)


def box_corners(xyzlhw: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """World-frame corners of oriented boxes.

    Args:
      xyzlhw: (..., 6) center + dims (l, h, w).
      R: (..., 3, 3) rotations.

    Returns:
      (..., 8, 3) corners, vertex order as in `CORNER_SIGNS`.
    """
    center = xyzlhw[..., :3]
    half = xyzlhw[..., 3:6] * 0.5  # (l/2, h/2, w/2) on local (X, Y, Z)
    signs = torch.as_tensor(CORNER_SIGNS, dtype=xyzlhw.dtype, device=xyzlhw.device)
    local = signs * half[..., None, :]  # (..., 8, 3)
    return torch.einsum("...ij,...kj->...ki", R, local) + center[..., None, :]


