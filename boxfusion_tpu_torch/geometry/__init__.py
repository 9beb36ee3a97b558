from boxfusion_tpu_torch.geometry.rotation import (
    euler_angles_to_matrix,
    axis_angle_rotation,
    rotation_3d_in_axis,
)
from boxfusion_tpu_torch.geometry.boxes import (
    CORNER_SIGNS,
    box_corners,
    boxes_to_world,
    yaw_box_corners,
)
from boxfusion_tpu_torch.geometry.projection import (
    project_points,
    project_corners_to_image,
    project_boxes_to_2d,
    unproject_depth,
)
from boxfusion_tpu_torch.geometry.iou import (
    iou_2d,
    gated_pair_iou,
    obb_grid_iou,
    obb_intersect_mask,
    pairwise_obb_iou,
)

__all__ = [
    "euler_angles_to_matrix",
    "axis_angle_rotation",
    "rotation_3d_in_axis",
    "CORNER_SIGNS",
    "box_corners",
    "boxes_to_world",
    "yaw_box_corners",
    "project_points",
    "project_corners_to_image",
    "project_boxes_to_2d",
    "unproject_depth",
    "iou_2d",
    "gated_pair_iou",
    "obb_grid_iou",
    "obb_intersect_mask",
    "pairwise_obb_iou",
]
