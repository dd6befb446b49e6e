from .build import build_detection_train_loader, get_detection_dataset_dicts
from .catalog import DatasetCatalog, MetadataCatalog
from .dataset_mapper import DatasetMapper
from .detection_utils import (
    apply_affine_to_boxes,
    get_affine_transform,
    invert_affine,
    unwarp_boxes,
    warp_image,
)
from .samplers import TrainingSampler
from .transforms import CenterAffineAug, letterbox_transform

__all__ = [
    "CenterAffineAug",
    "DatasetCatalog",
    "DatasetMapper",
    "MetadataCatalog",
    "TrainingSampler",
    "apply_affine_to_boxes",
    "build_detection_train_loader",
    "get_affine_transform",
    "get_detection_dataset_dicts",
    "invert_affine",
    "letterbox_transform",
    "unwarp_boxes",
    "warp_image",
]
