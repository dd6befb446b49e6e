"""The builtin dataset names (a copy of the JAX package's
``data/datasets/builtin.py``; the reference's
``detectron2/data/datasets/builtin.py``): COCO 2014/2017, the fork's LISA
and bulb-wise traffic-light splits, LVIS v0.5 and v1, Pascal VOC 2007/2012,
COCO panoptic "separated" and Cityscapes, each rooted at
``$DETECTRON2_DATASETS`` (``datasets`` when unset). Registration is lazy:
a file is read only when its dataset is first loaded, so a name whose files
are missing registers all the same and raises when loaded
(``synthetic.ensure_synthetic_datasets`` replaces it). The panoptic names'
sem-seg half evaluates with ``SemSegEvaluator``, the Cityscapes sem-seg
names with ``CityscapesSemSegEvaluator``.
"""

import os

from ..catalog import DatasetCatalog, MetadataCatalog
from .builtin_meta import get_builtin_metadata
from .cityscapes import register_cityscapes
from .coco import load_coco_json, register_coco_instances
from .lvis import register_lvis_instances
from .pascal_voc import register_pascal_voc

__all__ = ["register_builtin_datasets"]

_PREDEFINED_SPLITS_COCO = {
    "coco_2014_train": ("coco/train2014", "coco/annotations/instances_train2014.json"),
    "coco_2014_val": ("coco/val2014", "coco/annotations/instances_val2014.json"),
    "coco_2014_minival": ("coco/val2014", "coco/annotations/instances_minival2014.json"),
    "coco_2017_train": ("coco/train2017", "coco/annotations/instances_train2017.json"),
    "coco_2017_val": ("coco/val2017", "coco/annotations/instances_val2017.json"),
    "coco_2017_val_100": ("coco/val2017", "coco/annotations/instances_val2017_100.json"),
}

# the fork's LISA traffic-light splits (reference builtin.py:239-250)
_PREDEFINED_SPLITS_LISA = {
    "lisa_bulb_coco_train": ("lisa", "lisa/Annotations/coco/annotations/bulb_instances_train2017.json"),
    "lisa_bulb_coco_val": ("lisa", "lisa/Annotations/coco/annotations/bulb_instances_val2017.json"),
    "lisa_day_bulb_coco_train": ("lisa", "lisa/Annotations/coco/annotations/day_bulb_instances_train2017.json"),
    "lisa_day_bulb_coco_val": ("lisa", "lisa/Annotations/coco/annotations/day_bulb_instances_val2017.json"),
    "lisa_night_bulb_coco_train": ("lisa", "lisa/Annotations/coco/annotations/night_bulb_instances_train2017.json"),
    "lisa_night_bulb_coco_val": ("lisa", "lisa/Annotations/coco/annotations/night_bulb_instances_val2017.json"),
}

# the fork's bulb-wise traffic-light splits (reference builtin.py:252-265)
_PREDEFINED_SPLITS_BULB = {
    "tl_bulb_train": ("traffic_light_bulb/images", "traffic_light_bulb/annotations/train2020_tl_bulb.json"),
    "tl_train": ("traffic_light_bulb/images", "traffic_light_bulb/annotations/train2020_tl.json"),
    "bulb_train": ("traffic_light_bulb/images", "traffic_light_bulb/annotations/train_split_2020_bulb.json"),
    "bulb_val": ("traffic_light_bulb/images", "traffic_light_bulb/annotations/val_split_2020_bulb.json"),
    "bulb": ("traffic_light_bulb/images", "traffic_light_bulb/annotations/train2020_bulb.json"),
    "class_agnostic_bulb_train": ("traffic_light_bulb/images",
                                  "traffic_light_bulb/annotations/class_agnostic_train_split_2020_bulb.json"),
    "class_agnostic_bulb_val": ("traffic_light_bulb/images",
                                "traffic_light_bulb/annotations/class_agnostic_val_split_2020_bulb.json"),
    "class_agnostic_bulb": ("traffic_light_bulb/images",
                            "traffic_light_bulb/annotations/class_agnostic_train2020_bulb.json"),
}

_PREDEFINED_SPLITS_LVIS = {
    "lvis_v0.5_train": ("coco/", "lvis/lvis_v0.5_train.json"),
    "lvis_v0.5_val": ("coco/", "lvis/lvis_v0.5_val.json"),
    "lvis_v1_train": ("coco/", "lvis/lvis_v1_train.json"),
    "lvis_v1_val": ("coco/", "lvis/lvis_v1_val.json"),
}

_PREDEFINED_VOC = [
    ("voc_2007_trainval", "VOC2007", "trainval", 2007),
    ("voc_2007_train", "VOC2007", "train", 2007),
    ("voc_2007_val", "VOC2007", "val", 2007),
    ("voc_2007_test", "VOC2007", "test", 2007),
    ("voc_2012_trainval", "VOC2012", "trainval", 2012),
    ("voc_2012_train", "VOC2012", "train", 2012),
    ("voc_2012_val", "VOC2012", "val", 2012),
]

_PREDEFINED_PANOPTIC = {
    "coco_2017_train_panoptic_separated": ("coco/train2017", "coco/annotations/instances_train2017.json",
                                           "coco/panoptic_stuff_train2017"),
    "coco_2017_val_panoptic_separated": ("coco/val2017", "coco/annotations/instances_val2017.json",
                                         "coco/panoptic_stuff_val2017"),
}


def register_all_coco(root: str) -> None:
    for key, (image_root, json_file) in _PREDEFINED_SPLITS_COCO.items():
        register_coco_instances(key, get_builtin_metadata("coco"), os.path.join(root, json_file),
                                os.path.join(root, image_root))


def register_all_tl(root: str) -> None:
    for splits in (_PREDEFINED_SPLITS_LISA, _PREDEFINED_SPLITS_BULB):
        for key, (image_root, json_file) in splits.items():
            register_coco_instances(key, {}, os.path.join(root, json_file), os.path.join(root, image_root))


def register_all_lvis(root: str) -> None:
    for key, (image_root, json_file) in _PREDEFINED_SPLITS_LVIS.items():
        register_lvis_instances(key, {}, os.path.join(root, json_file), os.path.join(root, image_root))


def register_all_pascal_voc(root: str) -> None:
    for name, dirname, split, year in _PREDEFINED_VOC:
        register_pascal_voc(name, os.path.join(root, dirname), split, year)


def register_all_panoptic(root: str) -> None:
    """The "separated" panoptic format (reference ``register_coco.py:114``):
    the COCO instance json, each image's stuff raster named in
    ``sem_seg_file_name``."""
    for key, (image_root, json_file, sem_dir) in _PREDEFINED_PANOPTIC.items():
        json_path, image_path, sem_path = (os.path.join(root, p) for p in (json_file, image_root, sem_dir))

        def load(jf=json_path, ir=image_path, sd=sem_path, name=key):
            dicts = load_coco_json(jf, ir, name)
            for d in dicts:
                base = os.path.splitext(os.path.basename(d["file_name"]))[0]
                d["sem_seg_file_name"] = os.path.join(sd, base + ".png")
            return dicts

        DatasetCatalog.register(key, load)
        MetadataCatalog.get(key).set(evaluator_type="coco_panoptic_seg", json_file=json_path,
                                     image_root=image_path, sem_seg_root=sem_path,
                                     **get_builtin_metadata("coco"))


_registered = False


def register_builtin_datasets() -> None:
    """Register every builtin name once (``data/__init__.py`` calls it)."""
    global _registered
    if _registered:
        return
    _registered = True
    root = os.getenv("DETECTRON2_DATASETS", "datasets")
    register_all_coco(root)
    register_all_tl(root)
    register_all_lvis(root)
    register_all_pascal_voc(root)
    register_all_panoptic(root)
    register_cityscapes(root)
