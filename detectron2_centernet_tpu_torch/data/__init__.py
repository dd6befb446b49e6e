from .build import build_detection_test_loader, build_detection_train_loader, get_detection_dataset_dicts
from .catalog import DatasetCatalog, MetadataCatalog
from .dataset_mapper import DatasetMapper
from .detection_utils import (
    apply_affine_to_boxes,
    fast_letterbox,
    get_affine_transform,
    invert_affine,
    unwarp_boxes,
    warp_image,
)
from .datasets import register_coco_instances
from .datasets.builtin import register_builtin_datasets
from .samplers import InferenceSampler, RepeatFactorTrainingSampler, TrainingSampler
from .transforms import CenterAffineAug, letterbox_transform

register_builtin_datasets()

__all__ = [
    "CenterAffineAug",
    "DatasetCatalog",
    "DatasetMapper",
    "InferenceSampler",
    "MetadataCatalog",
    "RepeatFactorTrainingSampler",
    "TrainingSampler",
    "apply_affine_to_boxes",
    "build_detection_test_loader",
    "build_detection_train_loader",
    "fast_letterbox",
    "get_affine_transform",
    "get_detection_dataset_dicts",
    "invert_affine",
    "letterbox_transform",
    "register_coco_instances",
    "unwarp_boxes",
    "warp_image",
]
