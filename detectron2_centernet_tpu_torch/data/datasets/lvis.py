"""LVIS dataset loading (a copy of the JAX package's ``data/datasets/lvis.py``;
the reference's ``detectron2/data/datasets/lvis.py``).

LVIS json is COCO-shaped, with per-image ``not_exhaustive_category_ids``
and ``neg_category_ids`` (the federated annotation: a category is judged on
an image only where it is annotated or known absent) and 1-indexed
contiguous category ids, which become 0-indexed here. An image without a
``file_name`` takes its split folder and name from ``coco_url``. The
metadata gains each category's ``frequency`` bucket (``r``are, ``c``ommon,
``f``requent) as ``class_frequencies``, which the evaluator reads for
APr, APc and APf.
"""

import json
import os
from typing import List, Optional

from ...structures import BoxMode
from ..catalog import DatasetCatalog, MetadataCatalog

__all__ = ["load_lvis_json", "register_lvis_instances"]


def load_lvis_json(json_file: str, image_root: str, dataset_name: Optional[str] = None) -> List[dict]:
    with open(json_file) as f:
        lvis = json.load(f)

    if dataset_name is not None:
        meta = MetadataCatalog.get(dataset_name)
        cats = sorted(lvis["categories"], key=lambda c: c["id"])
        meta.thing_classes = [c.get("synonyms", [c.get("name", "")])[0] for c in cats]
        meta.class_frequencies = [c.get("frequency", "f") for c in cats]
        meta.json_file = json_file
        meta.image_root = image_root

    imgs = {img["id"]: img for img in lvis["images"]}
    anns_per_img = {i: [] for i in imgs}
    for ann in lvis["annotations"]:
        anns_per_img[ann["image_id"]].append(ann)

    dataset_dicts = []
    for img_id, img in sorted(imgs.items()):
        if "file_name" in img:
            file_name = os.path.join(image_root, img["file_name"])
        else:  # e.g. ".../train2017/000000123.jpg"
            split_folder, name = img["coco_url"].split("/")[-2:]
            file_name = os.path.join(image_root, split_folder, name)
        dataset_dicts.append({
            "file_name": file_name,
            "height": img["height"],
            "width": img["width"],
            "image_id": img_id,
            "not_exhaustive_category_ids": img.get("not_exhaustive_category_ids", []),
            "neg_category_ids": img.get("neg_category_ids", []),
            "annotations": [{
                "bbox": ann["bbox"],
                "bbox_mode": BoxMode.XYWH_ABS,
                "category_id": ann["category_id"] - 1,
                "segmentation": ann.get("segmentation", []),
                "iscrowd": 0,
            } for ann in anns_per_img[img_id]],
        })
    return dataset_dicts


def register_lvis_instances(name: str, metadata: dict, json_file: str, image_root: str) -> None:
    """Register ``name`` as the LVIS json ``json_file`` over ``image_root``,
    loaded at first use, ``evaluator_type`` "lvis"."""
    DatasetCatalog.register(name, lambda: load_lvis_json(json_file, image_root, name))
    MetadataCatalog.get(name).set(json_file=json_file, image_root=image_root, evaluator_type="lvis", **metadata)
