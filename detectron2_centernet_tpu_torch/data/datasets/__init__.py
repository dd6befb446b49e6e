from .builtin_meta import COCO_CATEGORIES
from .synthetic import (
    ensure_synthetic_datasets,
    register_learnable_instances,
    register_synthetic_instances,
)

__all__ = [
    "COCO_CATEGORIES",
    "ensure_synthetic_datasets",
    "register_learnable_instances",
    "register_synthetic_instances",
]
