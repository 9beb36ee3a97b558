"""Lightweight sensor / measurement metadata (host side).

Capability target: the Apple-derived metadata stack of the reference --
``SensorInfo`` / ``PosedSensorInfo`` / ``SensorArrayInfo`` (reference
boxfusion/sensor.py:14-293) and ``ImageMeasurementInfo`` /
``DepthMeasurementInfo`` / ``WhitenedDepthMeasurementInfo`` (reference
boxfusion/measurement.py:26-150).

A copy of ``boxfusion_tpu/structures/sensor.py`` (numpy only).  The
reference keeps these as mutable torch-tensor attr bags threaded *through
the model*; here they are small frozen numpy dataclasses used only in the
host data pipeline.  Everything the model needs (K, actual size, T_gravity,
depth whitening params) is handed to the model as tensors in a
``FrameBatch``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from boxfusion_tpu_torch.geometry.orientation import (
    ImageOrientation,
    get_orientation,
    rotate_K,
    rotate_pose,
)


@dataclasses.dataclass(frozen=True)
class ImageInfo:
    """Image measurement metadata: (W, H) size + 3x3 intrinsics.

    Mirrors ImageMeasurementInfo (measurement.py:26-128).
    """

    size: Tuple[int, int]  # (W, H)
    K: np.ndarray  # (3, 3)

    def resize(self, new_size: Tuple[int, int]) -> "ImageInfo":
        sw = new_size[0] / self.size[0]
        sh = new_size[1] / self.size[1]
        K = self.K.copy()
        K[0, :] *= sw
        K[1, :] *= sh
        return dataclasses.replace(self, size=tuple(new_size), K=K)

    def orient(self, current: ImageOrientation,
               target: ImageOrientation = ImageOrientation.UPRIGHT) -> "ImageInfo":
        K = rotate_K(self.K[None], current, self.size, target)[0]
        size = self.size
        if current != target and {current, target} != {ImageOrientation.UPSIDE_DOWN,
                                                        ImageOrientation.UPRIGHT}:
            size = (self.size[1], self.size[0])
        return dataclasses.replace(self, size=size, K=K)


@dataclasses.dataclass(frozen=True)
class DepthInfo(ImageInfo):
    """Depth measurement metadata; `parameters` holds (shift, scale) whitening.

    Mirrors DepthMeasurementInfo.normalize -> WhitenedDepthMeasurementInfo
    (measurement.py:130-150): once depth is whitened, the (mean, std) used are
    carried here so the model can de-whiten its z / dims predictions.
    """

    parameters: Optional[np.ndarray] = None  # (2,) = (shift, scale)

    def normalize(self, parameters: np.ndarray) -> "DepthInfo":
        return dataclasses.replace(self, parameters=np.asarray(parameters, np.float32))


@dataclasses.dataclass
class PosedSensor:
    """A posed sensor with image/depth measurements.

    Mirrors PosedSensorInfo (sensor.py:171-229): pose RT (camera-to-world),
    orientation inference from the pose z-row, and `orient` which rotates the
    pose and all measurement intrinsics together.
    """

    RT: np.ndarray  # (4, 4)
    image: Optional[ImageInfo] = None
    depth: Optional[DepthInfo] = None
    T_gravity: Optional[np.ndarray] = None  # (3, 3)

    @property
    def orientation(self) -> ImageOrientation:
        return get_orientation(self.RT)

    def has(self, name: str) -> bool:
        return getattr(self, name, None) is not None

    def orient(self, current: ImageOrientation,
               target: ImageOrientation = ImageOrientation.UPRIGHT) -> "PosedSensor":
        out = PosedSensor(
            RT=rotate_pose(self.RT, current, target),
            image=self.image.orient(current, target) if self.image else None,
            depth=self.depth.orient(current, target) if self.depth else None,
            T_gravity=self.T_gravity,
        )
        return out


@dataclasses.dataclass
class SensorArray:
    """Named sensors for one frame; here `wide` (model input) and `gt` (pose).

    Mirrors SensorArrayInfo (sensor.py:231-293).
    """

    wide: Optional[PosedSensor] = None
    gt: Optional[PosedSensor] = None

    def has(self, name: str) -> bool:
        return getattr(self, name, None) is not None
