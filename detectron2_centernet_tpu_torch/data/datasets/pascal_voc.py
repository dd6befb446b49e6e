"""Pascal VOC dataset loading (a copy of the JAX package's
``data/datasets/pascal_voc.py``; the reference's
``detectron2/data/datasets/pascal_voc.py``): a split's file ids from
``ImageSets/Main/<split>.txt``, each image's ``Annotations/<id>.xml`` read
through ``xml.etree``. VOC's boxes are 1-based pixel indices: xmin and ymin
move by -1 to the 0.5-origin convention. ``difficult`` objects are kept and
flagged (the evaluator neither counts nor penalises them). The image id is
the file id, a string such as "000005", and stays one (ROADMAP C22).
"""

import os
import xml.etree.ElementTree as ET
from typing import List

from ...structures import BoxMode
from ..catalog import DatasetCatalog, MetadataCatalog

__all__ = ["CLASS_NAMES", "load_voc_instances", "register_pascal_voc"]

CLASS_NAMES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


def load_voc_instances(dirname: str, split: str, class_names=CLASS_NAMES) -> List[dict]:
    """``dirname`` such as VOC2007/, holding Annotations/, ImageSets/ and
    JPEGImages/; objects of other classes are left out."""
    with open(os.path.join(dirname, "ImageSets", "Main", split + ".txt")) as f:
        fileids = [line.strip() for line in f if line.strip()]

    dicts = []
    for fileid in fileids:
        tree = ET.parse(os.path.join(dirname, "Annotations", fileid + ".xml"))
        r = {
            "file_name": os.path.join(dirname, "JPEGImages", fileid + ".jpg"),
            "image_id": fileid,
            "height": int(tree.findall("./size/height")[0].text),
            "width": int(tree.findall("./size/width")[0].text),
        }
        instances = []
        for obj in tree.findall("object"):
            cls = obj.find("name").text
            if cls not in class_names:
                continue
            box = obj.find("bndbox")
            bbox = [float(box.find(x).text) for x in ("xmin", "ymin", "xmax", "ymax")]
            bbox[0] -= 1.0
            bbox[1] -= 1.0
            difficult = obj.find("difficult")
            instances.append({
                "category_id": class_names.index(cls),
                "bbox": bbox,
                "bbox_mode": BoxMode.XYXY_ABS,
                "difficult": int(difficult.text) if difficult is not None else 0,
                "iscrowd": 0,
            })
        r["annotations"] = instances
        dicts.append(r)
    return dicts


def register_pascal_voc(name: str, dirname: str, split: str, year: int) -> None:
    """Register ``name`` as ``split`` of the VOC tree ``dirname``, loaded at
    first use, ``evaluator_type`` "pascal_voc" (2007 scores the 11-point AP)."""
    DatasetCatalog.register(name, lambda: load_voc_instances(dirname, split))
    MetadataCatalog.get(name).set(thing_classes=list(CLASS_NAMES), dirname=dirname, year=year, split=split,
                                  evaluator_type="pascal_voc")
