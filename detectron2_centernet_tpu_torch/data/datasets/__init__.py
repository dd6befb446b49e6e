from .builtin_meta import COCO_CATEGORIES
from .coco import convert_to_coco_dict, convert_to_coco_json
from .synthetic import (
    ensure_synthetic_datasets,
    register_learnable_instances,
    register_synthetic_instances,
)

__all__ = [
    "COCO_CATEGORIES",
    "convert_to_coco_dict",
    "convert_to_coco_json",
    "ensure_synthetic_datasets",
    "register_learnable_instances",
    "register_synthetic_instances",
]
