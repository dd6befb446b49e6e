from .builtin_meta import COCO_CATEGORIES, get_builtin_metadata
from .cityscapes import load_cityscapes_instances, load_cityscapes_semantic, register_cityscapes
from .coco import convert_to_coco_dict, convert_to_coco_json, load_coco_json, register_coco_instances
from .lvis import load_lvis_json, register_lvis_instances
from .pascal_voc import load_voc_instances, register_pascal_voc
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
    "get_builtin_metadata",
    "load_cityscapes_instances",
    "load_cityscapes_semantic",
    "load_coco_json",
    "load_lvis_json",
    "load_voc_instances",
    "register_cityscapes",
    "register_coco_instances",
    "register_learnable_instances",
    "register_lvis_instances",
    "register_pascal_voc",
    "register_synthetic_instances",
]
