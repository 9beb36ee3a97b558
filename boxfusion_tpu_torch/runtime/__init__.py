from boxfusion_tpu_torch.runtime.detector import CuTRDetector
from boxfusion_tpu_torch.runtime.device_pipeline import DevicePipeline
from boxfusion_tpu_torch.runtime.pipeline import OnlinePipeline, WorldState

__all__ = ["CuTRDetector", "DevicePipeline", "OnlinePipeline", "WorldState"]
