from boxfusion_tpu_torch.data_process.prep import (
    classify_sequence_orientation,
    convert_capture_to_slam,
    extract_archives,
    rotate_sequence_upright,
)
from boxfusion_tpu_torch.data_process.gt_filter import filter_gt_boxes, read_ply_points

__all__ = [
    "classify_sequence_orientation",
    "convert_capture_to_slam",
    "extract_archives",
    "rotate_sequence_upright",
    "filter_gt_boxes",
    "read_ply_points",
]
