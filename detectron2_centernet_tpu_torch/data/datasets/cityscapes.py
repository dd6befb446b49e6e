"""Cityscapes dataset loading (a copy of the JAX package's
``data/datasets/cityscapes.py``; the reference's
``detectron2/data/datasets/cityscapes.py``), without cityscapesscripts:
instances from the ``gtFine/<city>/*_gtFine_polygons.json`` files, one
record per ``leftImg8bit/<city>/*_leftImg8bit.png``.

A ``<class>group`` label is a crowd region of its class; polygons with
fewer than 3 points are dropped; labels outside the 8 thing classes are
left out. The image id is the image's file name, a string, and stays one
(ROADMAP C22). The sem-seg records name their ``*_gtFine_labelTrainIds.png``
rasters; their evaluator waits for segmentation (ROADMAP A15).
"""

import glob
import json
import os
from typing import List

import numpy as np

from ...structures import BoxMode
from ..catalog import DatasetCatalog, MetadataCatalog

__all__ = ["CITYSCAPES_STUFF_CLASSES", "CITYSCAPES_THING_CLASSES", "load_cityscapes_instances",
           "load_cityscapes_semantic", "register_cityscapes"]

# the 8 cityscapes labels with hasInstances=True
CITYSCAPES_THING_CLASSES = [
    "person", "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle",
]
# the 19 trainId classes of semantic segmentation
CITYSCAPES_STUFF_CLASSES = [
    "road", "sidewalk", "building", "wall", "fence", "pole", "traffic light",
    "traffic sign", "vegetation", "terrain", "sky", "person", "rider", "car",
    "truck", "bus", "train", "motorcycle", "bicycle",
]


def _files(image_dir: str, gt_dir: str):
    """(image, polygons json, trainId png) of every image, sorted."""
    out = []
    for img in sorted(glob.glob(os.path.join(image_dir, "*", "*_leftImg8bit.png"))):
        city = os.path.basename(os.path.dirname(img))
        base = os.path.basename(img)[: -len("_leftImg8bit.png")]
        out.append((img, os.path.join(gt_dir, city, base + "_gtFine_polygons.json"),
                    os.path.join(gt_dir, city, base + "_gtFine_labelTrainIds.png")))
    return out


def load_cityscapes_instances(image_dir: str, gt_dir: str) -> List[dict]:
    dicts = []
    name_to_id = {n: i for i, n in enumerate(CITYSCAPES_THING_CLASSES)}
    for img_file, poly_file, _ in _files(image_dir, gt_dir):
        with open(poly_file) as f:
            ann = json.load(f)
        objs = []
        for obj in ann["objects"]:
            label = obj["label"]
            iscrowd = int(label.endswith("group"))
            if iscrowd:
                label = label[: -len("group")]
            if label not in name_to_id:
                continue
            poly = np.asarray(obj["polygon"], np.float64)
            if len(poly) < 3:
                continue
            objs.append({
                "category_id": name_to_id[label],
                "bbox": [float(poly[:, 0].min()), float(poly[:, 1].min()),
                         float(poly[:, 0].max()), float(poly[:, 1].max())],
                "bbox_mode": BoxMode.XYXY_ABS,
                "segmentation": [poly.reshape(-1).tolist()],
                "iscrowd": iscrowd,
            })
        dicts.append({"file_name": img_file, "image_id": os.path.basename(img_file),
                      "height": ann["imgHeight"], "width": ann["imgWidth"], "annotations": objs})
    return dicts


def load_cityscapes_semantic(image_dir: str, gt_dir: str) -> List[dict]:
    return [{"file_name": img_file, "sem_seg_file_name": label_file, "image_id": os.path.basename(img_file),
             "height": 1024, "width": 2048}
            for img_file, _, label_file in _files(image_dir, gt_dir)]


def register_cityscapes(root: str) -> None:
    """``cityscapes_fine_{instance_seg,sem_seg}_{train,val,test}`` under
    ``root/cityscapes/{leftImg8bit,gtFine}/<split>``, loaded at first use."""
    for split in ("train", "val", "test"):
        image_dir = os.path.join(root, "cityscapes", "leftImg8bit", split)
        gt_dir = os.path.join(root, "cityscapes", "gtFine", split)
        inst_name = f"cityscapes_fine_instance_seg_{split}"
        sem_name = f"cityscapes_fine_sem_seg_{split}"
        DatasetCatalog.register(inst_name, lambda i=image_dir, g=gt_dir: load_cityscapes_instances(i, g))
        MetadataCatalog.get(inst_name).set(thing_classes=list(CITYSCAPES_THING_CLASSES),
                                           evaluator_type="cityscapes_instance", image_dir=image_dir, gt_dir=gt_dir)
        DatasetCatalog.register(sem_name, lambda i=image_dir, g=gt_dir: load_cityscapes_semantic(i, g))
        MetadataCatalog.get(sem_name).set(stuff_classes=list(CITYSCAPES_STUFF_CLASSES),
                                          evaluator_type="cityscapes_sem_seg", ignore_label=255,
                                          image_dir=image_dir, gt_dir=gt_dir)
