"""Oriented 3D boxes as immutable objects over float32 tensors (PyTorch).

Port of ``boxfusion_tpu/structures/boxes3d.py``:

  * ``GeneralBoxes3D``: capability target ``GeneralInstance3DBoxes``
    (reference boxfusion/boxes.py:656-943) -- gravity-centered ``(N, 6)``
    ``xyzlhw`` parameters plus explicit per-box rotations ``R`` ``(N, 3, 3)``;
  * ``DepthBoxes``: the reference's bottom-centered, z-up, yaw-parameterized
    ``DepthInstance3DBoxes`` (boxes.py:115-654).

Both are functional, as in the JAX package: every transform returns a new
object (the reference mutates in place and returns ``self``).  The geometry
is the port's ``geometry`` package; ``.to(device)`` moves the tensors.
"""
from __future__ import annotations

import math
from typing import Iterable, List

import torch

from boxfusion_tpu_torch.geometry.boxes import box_corners, boxes_to_world, yaw_box_corners
from boxfusion_tpu_torch.geometry.rotation import rotation_3d_in_axis


class GeneralBoxes3D:
    """(N, 6) xyzlhw + (N, 3, 3) rotations; immutable."""

    __slots__ = ("tensor", "R")

    def __init__(self, tensor: torch.Tensor, R: torch.Tensor):
        object.__setattr__(self, "tensor", tensor)
        object.__setattr__(self, "R", R)

    def __setattr__(self, *_):
        raise AttributeError("GeneralBoxes3D is immutable")

    def __len__(self) -> int:
        return int(self.tensor.shape[0])

    def __getitem__(self, item) -> "GeneralBoxes3D":
        if isinstance(item, int):
            item = slice(item, item + 1 if item != -1 else None)
        return GeneralBoxes3D(self.tensor[item], self.R[item])

    def to(self, device) -> "GeneralBoxes3D":
        return GeneralBoxes3D(self.tensor.to(device), self.R.to(device))

    @property
    def gravity_center(self) -> torch.Tensor:
        """(N, 3) box centers (reference boxes.py:700-706)."""
        return self.tensor[..., :3]

    @property
    def dims(self) -> torch.Tensor:
        """(N, 3) box dims (l, h, w) (reference boxes.py:688-695)."""
        return self.tensor[..., 3:6]

    @property
    def volume(self) -> torch.Tensor:
        return torch.prod(self.dims, dim=-1)

    @property
    def corners(self) -> torch.Tensor:
        """(N, 8, 3) world corners (reference boxes.py:726-778 layout)."""
        return box_corners(self.tensor, self.R)

    def transform2world(self, cam_pose: torch.Tensor) -> "GeneralBoxes3D":
        """Camera frame -> world frame via (N, 4, 4) / (4, 4) poses.

        Matches ``GeneralInstance3DBoxes.transform2world`` (reference
        boxes.py:825-833) but returns a new object instead of mutating.
        """
        t, r = boxes_to_world(self.tensor, self.R, cam_pose)
        return GeneralBoxes3D(t, r)

    def translate(self, translation: torch.Tensor) -> "GeneralBoxes3D":
        center = self.tensor[..., :3] + translation
        return GeneralBoxes3D(torch.cat([center, self.tensor[..., 3:]], dim=-1), self.R)

    @staticmethod
    def cat(boxes_list: Iterable["GeneralBoxes3D"]) -> "GeneralBoxes3D":
        boxes_list = list(boxes_list)
        return GeneralBoxes3D(
            torch.cat([b.tensor for b in boxes_list], dim=0),
            torch.cat([b.R for b in boxes_list], dim=0),
        )

    def split(self, sizes) -> List["GeneralBoxes3D"]:
        out, start = [], 0
        for n in sizes:
            out.append(GeneralBoxes3D(self.tensor[start : start + n], self.R[start : start + n]))
            start += n
        return out

    def clone(self) -> "GeneralBoxes3D":
        return GeneralBoxes3D(self.tensor.clone(), self.R.clone())

    def __repr__(self):
        return f"GeneralBoxes3D(n={self.tensor.shape[0]})"


class DepthBoxes:
    """Bottom-centered z-up yaw boxes: the reference's yaw-parameterized API.

    Capability target: ``DepthInstance3DBoxes`` and its ``BaseInstance3DBoxes``
    surface (reference boxes.py:115-510, 512-654): ``(N, 7)``
    ``[x, y, z, dx, dy, dz, yaw]`` rows, bottom-center origin (0.5, 0.5, 0),
    yaw about +z.  Immutable/functional: mutating reference methods
    (``rotate``/``translate``/``flip``/``scale``) return a NEW ``DepthBoxes``
    (the reference mutates in place and returns ``self``; callers there
    ``clone()`` first, so the functional form covers the same use).

    6-wide inputs gain a zero fake yaw with ``with_yaw=False``
    (boxes.py:164-172); non-default ``origin`` is normalized to bottom-center
    on construction (boxes.py:177-181).
    """

    __slots__ = ("tensor", "with_yaw")
    YAW_AXIS = 2  # boxes.py:513

    def __init__(self, tensor, with_yaw: bool = True, origin=(0.5, 0.5, 0.0)):
        tensor = torch.as_tensor(tensor, dtype=torch.float32)
        if tensor.numel() == 0:
            tensor = tensor.reshape(0, 7)
        if tensor.dim() != 2 or tensor.shape[-1] not in (6, 7):
            raise ValueError(f"DepthBoxes expects (N, 6|7), got {tuple(tensor.shape)}")
        if tensor.shape[-1] == 6:
            tensor = torch.cat([tensor, tensor.new_zeros((tensor.shape[0], 1))], dim=-1)
            with_yaw = False
        if tuple(origin) != (0.5, 0.5, 0.0):
            dst = tensor.new_tensor([0.5, 0.5, 0.0])
            src = tensor.new_tensor(origin)
            tensor = torch.cat([tensor[:, :3] + tensor[:, 3:6] * (dst - src), tensor[:, 3:]], dim=-1)
        object.__setattr__(self, "tensor", tensor)
        object.__setattr__(self, "with_yaw", bool(with_yaw))

    def __setattr__(self, *_):
        raise AttributeError("DepthBoxes is immutable")

    def _new(self, tensor) -> "DepthBoxes":
        return DepthBoxes(tensor, with_yaw=self.with_yaw)

    def to(self, device) -> "DepthBoxes":
        return self._new(self.tensor.to(device))

    # -- properties (boxes.py:184-248, 514-543) -------------------------------
    def __len__(self) -> int:
        return self.tensor.shape[0]

    @property
    def shape(self):
        return self.tensor.shape

    @property
    def volume(self) -> torch.Tensor:
        return self.tensor[:, 3] * self.tensor[:, 4] * self.tensor[:, 5]

    @property
    def dims(self) -> torch.Tensor:
        return self.tensor[:, 3:6]

    @property
    def yaw(self) -> torch.Tensor:
        return self.tensor[:, 6]

    @property
    def height(self) -> torch.Tensor:
        return self.tensor[:, 5]

    @property
    def bottom_height(self) -> torch.Tensor:
        return self.tensor[:, 2]

    @property
    def top_height(self) -> torch.Tensor:
        return self.bottom_height + self.height

    @property
    def bottom_center(self) -> torch.Tensor:
        return self.tensor[:, :3]

    center = bottom_center  # MMDet3D depth convention (boxes.py:229-233)

    @property
    def gravity_center(self) -> torch.Tensor:
        bc = self.bottom_center
        return torch.cat([bc[:, :2], (bc[:, 2] + self.tensor[:, 5] * 0.5)[:, None]], dim=1)

    @property
    def corners(self) -> torch.Tensor:
        return yaw_box_corners(self.tensor)

    # -- transforms (boxes.py:282-291, 340-349, 545-654) ----------------------
    def rotate(self, angle) -> "DepthBoxes":
        """Rotate about +z by an angle or a 3x3 matrix (boxes.py:545-593).

        Matrix input follows the reference exactly: the matrix is used as
        ``rot_mat_T`` (centers right-multiply it) and the yaw increment is
        ``arctan2(R[0, 1], R[0, 0])``."""
        angle = torch.as_tensor(angle, dtype=torch.float32, device=self.tensor.device)
        if angle.dim() == 2:
            rot_mat_t = angle
            ang = torch.atan2(rot_mat_t[0, 1], rot_mat_t[0, 0])
            centers = self.tensor[:, :3] @ rot_mat_t
        else:
            ang = angle
            n = self.tensor.shape[0]
            centers = rotation_3d_in_axis(
                self.tensor[:, None, :3], ang.expand(n), axis=self.YAW_AXIS
            )[:, 0]
            c, s = torch.cos(ang), torch.sin(ang)
            zero, one = torch.zeros_like(c), torch.ones_like(c)
            rot_mat_t = torch.stack([torch.stack([c, s, zero]), torch.stack([-s, c, zero]),
                                     torch.stack([zero, zero, one])])

        t = torch.cat([centers, self.tensor[:, 3:]], dim=-1)
        if self.with_yaw:
            return self._new(torch.cat([t[:, :6], (t[:, 6] + ang)[:, None]], dim=-1))
        # axis-aligned boxes: refit the enclosing AABB after rotation
        # (boxes.py:580-590; note the reference rotates self.corners AFTER
        # the centers already moved -- replicated for parity)
        corners_rot = self._new(t).corners @ rot_mat_t
        new_x = corners_rot[..., 0].amax(dim=1) - corners_rot[..., 0].amin(dim=1)
        new_y = corners_rot[..., 1].amax(dim=1) - corners_rot[..., 1].amin(dim=1)
        return self._new(torch.cat([t[:, :3], new_x[:, None], new_y[:, None], t[:, 5:]], dim=-1))

    def translate(self, trans_vector) -> "DepthBoxes":
        trans = torch.as_tensor(trans_vector, dtype=torch.float32, device=self.tensor.device)
        return self._new(torch.cat([self.tensor[:, :3] + trans, self.tensor[:, 3:]], dim=-1))

    def scale(self, scale_factor: float) -> "DepthBoxes":
        return self._new(torch.cat([self.tensor[:, :6] * scale_factor, self.tensor[:, 6:]], dim=-1))

    def flip(self, bev_direction: str = "horizontal") -> "DepthBoxes":
        """BEV flip (boxes.py:595-620): horizontal negates x (yaw -> pi-yaw),
        vertical negates y (yaw -> -yaw)."""
        if bev_direction not in ("horizontal", "vertical"):
            raise ValueError(bev_direction)
        t = self.tensor.clone()
        if bev_direction == "horizontal":
            t[:, 0] = -t[:, 0]
            if self.with_yaw:
                t[:, 6] = -t[:, 6] + math.pi
        else:
            t[:, 1] = -t[:, 1]
            if self.with_yaw:
                t[:, 6] = -t[:, 6]
        return self._new(t)

    def enlarged_box(self, extra_width) -> "DepthBoxes":
        """Grow every side by extra_width (boxes.py:632-647)."""
        extra = torch.as_tensor(extra_width, dtype=torch.float32, device=self.tensor.device)
        t = self.tensor.clone()
        t[:, 3:6] = t[:, 3:6] + extra * 2.0
        z_extra = extra[..., 2] if extra.dim() and extra.shape[-1] == 3 else extra
        t[:, 2] = t[:, 2] - z_extra
        return self._new(t)

    # -- predicates (boxes.py:293-318, 351-371) -------------------------------
    def in_range_3d(self, box_range) -> torch.Tensor:
        r = torch.as_tensor(box_range, dtype=torch.float32, device=self.tensor.device)
        t = self.tensor
        return (
            (t[:, 0] > r[0]) & (t[:, 1] > r[1]) & (t[:, 2] > r[2])
            & (t[:, 0] < r[3]) & (t[:, 1] < r[4]) & (t[:, 2] < r[5])
        )

    def nonempty(self, threshold: float = 0.0) -> torch.Tensor:
        d = self.tensor[:, 3:6]
        return (d[:, 0] > threshold) & (d[:, 1] > threshold) & (d[:, 2] > threshold)

    # -- container ops (boxes.py:373-398, 422-505) ----------------------------
    def __getitem__(self, item) -> "DepthBoxes":
        if not isinstance(item, (int, slice, torch.Tensor)):
            item = torch.as_tensor(item, device=self.tensor.device)
        t = self.tensor[item]
        if t.dim() == 1:
            t = t[None]
        return self._new(t)

    @staticmethod
    def cat(boxes_list: Iterable["DepthBoxes"]) -> "DepthBoxes":
        boxes_list = list(boxes_list)
        return DepthBoxes(
            torch.cat([b.tensor for b in boxes_list], dim=0),
            with_yaw=all(b.with_yaw for b in boxes_list),
        )

    def clone(self) -> "DepthBoxes":
        return self._new(self.tensor.clone())

    def __repr__(self):
        return f"DepthBoxes(n={len(self)}, with_yaw={self.with_yaw})"
