from boxfusion_tpu_torch.structures.instances import Instances
from boxfusion_tpu_torch.structures.boxes3d import DepthBoxes, GeneralBoxes3D
from boxfusion_tpu_torch.structures.sensor import (
    ImageInfo,
    DepthInfo,
    PosedSensor,
    SensorArray,
)

__all__ = [
    "Instances",
    "DepthBoxes",
    "GeneralBoxes3D",
    "ImageInfo",
    "DepthInfo",
    "PosedSensor",
    "SensorArray",
]
