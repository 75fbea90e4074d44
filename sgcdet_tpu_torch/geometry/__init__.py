"""Box geometry of the port (sgcdet_tpu/geometry/): NumPy boxes and rotated
overlaps for the host, and the torch rotated IoU of the ARKit loss."""
from .boxes import DepthBoxes3D, axis_aligned_overlaps_3d, rotation_3d_in_axis
from .rotated_iou import box_iou_rotated, rotated_iou_3d, rotated_iou_3d_torch

__all__ = [
    "DepthBoxes3D", "axis_aligned_overlaps_3d", "rotation_3d_in_axis",
    "box_iou_rotated", "rotated_iou_3d", "rotated_iou_3d_torch",
]
