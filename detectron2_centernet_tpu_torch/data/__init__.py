from .detection_utils import (
    apply_affine_to_boxes,
    get_affine_transform,
    invert_affine,
    unwarp_boxes,
    warp_image,
)
from .transforms import letterbox_transform

__all__ = [
    "apply_affine_to_boxes",
    "get_affine_transform",
    "invert_affine",
    "letterbox_transform",
    "unwarp_boxes",
    "warp_image",
]
