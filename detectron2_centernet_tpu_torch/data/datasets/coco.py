"""COCO-format json, read and written (a copy of the JAX package's
``data/datasets/coco.py``, without pycocotools).

``load_coco_json`` (reference ``coco.py:28``) returns the standard
list[dict] with ``file_name/height/width/image_id/annotations``, each
annotation with ``bbox`` (XYWH_ABS), ``bbox_mode``, ``category_id``
(contiguous), ``iscrowd``, and ``segmentation``/``keypoints`` when present;
``register_coco_instances`` registers one lazily. ``convert_to_coco_dict``
and ``convert_to_coco_json`` (reference ``coco.py:300-409``) turn a
registered dataset back into COCO json for evaluation.
"""

import json
import logging
import os
from typing import Dict, List, Optional

import numpy as np

from ...structures import BoxMode
from ..catalog import DatasetCatalog, MetadataCatalog

logger = logging.getLogger(__name__)

__all__ = ["convert_to_coco_dict", "convert_to_coco_json", "load_coco_json", "register_coco_instances"]


def load_coco_json(json_file: str, image_root: str, dataset_name: Optional[str] = None,
                   extra_annotation_keys: Optional[List[str]] = None) -> List[dict]:
    """A COCO instance-annotation json as dataset dicts, images in id order.
    With ``dataset_name`` its metadata gains ``thing_classes``,
    ``thing_dataset_id_to_contiguous_id`` (the sorted category ids to 0..C-1),
    ``json_file`` and ``image_root``. Polygons with fewer than 3 points are
    dropped, and an annotation left with none; visible keypoints move by
    +0.5 px to the pixel-center convention (reference ``:148-156``)."""
    with open(json_file) as f:
        coco = json.load(f)
    cats = sorted(coco.get("categories", []), key=lambda c: c["id"])
    id_map = {c["id"]: i for i, c in enumerate(cats)}
    if dataset_name is not None:
        meta = MetadataCatalog.get(dataset_name)
        meta.thing_classes = [c["name"] for c in cats]
        meta.thing_dataset_id_to_contiguous_id = id_map
        meta.json_file = json_file
        meta.image_root = image_root

    imgs = {img["id"]: img for img in coco.get("images", [])}
    anns_per_img: Dict[int, List[dict]] = {img_id: [] for img_id in imgs}
    n_skipped = 0
    for ann in coco.get("annotations", []):
        if ann["image_id"] not in anns_per_img:
            n_skipped += 1
            continue
        anns_per_img[ann["image_id"]].append(ann)
    if n_skipped:
        logger.warning("%d annotations point at missing images; dropped", n_skipped)

    ann_keys = ["iscrowd", "bbox", "keypoints", "category_id"] + (extra_annotation_keys or [])
    dataset_dicts = []
    for img_id, img in sorted(imgs.items()):
        record = {"file_name": os.path.join(image_root, img["file_name"]), "height": img["height"],
                  "width": img["width"], "image_id": img_id}
        objs = []
        for ann in anns_per_img[img_id]:
            obj = {k: ann[k] for k in ann_keys if k in ann}
            segm = ann.get("segmentation")
            if segm:
                if not isinstance(segm, dict):  # an RLE stays as it is
                    segm = [p for p in segm if len(p) % 2 == 0 and len(p) >= 6]
                    if not segm:
                        continue
                obj["segmentation"] = segm
            if obj.get("keypoints"):
                obj["keypoints"] = [v + 0.5 if i % 3 != 2 else v for i, v in enumerate(obj["keypoints"])]
            obj["bbox_mode"] = BoxMode.XYWH_ABS
            obj["category_id"] = id_map[obj["category_id"]]
            objs.append(obj)
        record["annotations"] = objs
        dataset_dicts.append(record)
    return dataset_dicts


def register_coco_instances(name: str, metadata: dict, json_file: str, image_root: str) -> None:
    """Register ``name`` as the COCO json ``json_file`` over ``image_root``,
    loaded at first use, ``evaluator_type`` "coco" (reference
    ``register_coco.py:16``)."""
    if not isinstance(name, str):
        raise TypeError(f"a dataset name must be a str, got {name!r}")
    DatasetCatalog.register(name, lambda: load_coco_json(json_file, image_root, name))
    MetadataCatalog.get(name).set(json_file=json_file, image_root=image_root, evaluator_type="coco", **metadata)


def convert_to_coco_dict(dataset_name: str) -> dict:
    """Registered dataset -> COCO-format dict (reference coco.py:300-409)."""
    dataset_dicts = DatasetCatalog.get(dataset_name)
    metadata = MetadataCatalog.get(dataset_name)

    if hasattr(metadata, "thing_dataset_id_to_contiguous_id"):
        reverse_id_mapping = {
            v: k for k, v in metadata.thing_dataset_id_to_contiguous_id.items()
        }
    else:
        reverse_id_mapping = None

    categories = [
        {"id": reverse_id_mapping[i] if reverse_id_mapping else i, "name": name}
        for i, name in enumerate(metadata.thing_classes)
    ]
    coco_images = []
    coco_annotations = []
    for image_dict in dataset_dicts:
        coco_image = {
            "id": image_dict.get("image_id", len(coco_images)),
            "width": image_dict["width"],
            "height": image_dict["height"],
            "file_name": os.path.basename(image_dict.get("file_name", "")),
        }
        coco_images.append(coco_image)
        for annotation in image_dict.get("annotations", []):
            coco_annotation = {}
            bbox = annotation["bbox"]
            bbox_mode = annotation["bbox_mode"]
            bbox = BoxMode.convert(bbox, bbox_mode, BoxMode.XYWH_ABS)
            bbox = [round(float(x), 3) for x in bbox]
            area = (
                annotation["segmentation"]
                and _polygon_area(annotation["segmentation"])
                or bbox[2] * bbox[3]
                if "segmentation" in annotation
                else bbox[2] * bbox[3]
            )
            coco_annotation["id"] = len(coco_annotations) + 1
            coco_annotation["image_id"] = coco_image["id"]
            coco_annotation["bbox"] = bbox
            coco_annotation["area"] = float(area)
            coco_annotation["iscrowd"] = int(annotation.get("iscrowd", 0))
            coco_annotation["category_id"] = (
                reverse_id_mapping[annotation["category_id"]]
                if reverse_id_mapping
                else annotation["category_id"]
            )
            if "segmentation" in annotation:
                coco_annotation["segmentation"] = annotation["segmentation"]
            if "keypoints" in annotation:
                kp = np.asarray(annotation["keypoints"], np.float64).reshape(-1, 3)
                kp[:, :2] -= 0.5
                coco_annotation["keypoints"] = kp.reshape(-1).tolist()
                coco_annotation["num_keypoints"] = int((kp[:, 2] > 0).sum())
            coco_annotations.append(coco_annotation)

    return {
        "info": {"description": "Converted from a registered dataset."},
        "images": coco_images,
        "annotations": coco_annotations,
        "categories": categories,
        "licenses": None,
    }


def _polygon_area(segmentation) -> float:
    if isinstance(segmentation, dict):
        return 0.0
    area = 0.0
    for poly in segmentation:
        p = np.asarray(poly, np.float64).reshape(-1, 2)
        x, y = p[:, 0], p[:, 1]
        area += 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))
    return area


def convert_to_coco_json(dataset_name: str, output_file: str, allow_cached: bool = True) -> None:
    if os.path.exists(output_file) and allow_cached:
        return
    coco_dict = convert_to_coco_dict(dataset_name)
    os.makedirs(os.path.dirname(output_file) or ".", exist_ok=True)
    tmp = output_file + ".tmp"
    with open(tmp, "w") as f:
        json.dump(coco_dict, f)
    os.replace(tmp, output_file)
