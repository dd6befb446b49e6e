"""A registered dataset as COCO json, for evaluation (a copy of
``convert_to_coco_dict`` and ``convert_to_coco_json`` of the JAX package's
``data/datasets/coco.py``, the reference's ``coco.py:300-409``). Loading
COCO json (``load_coco_json``) is not ported yet: the port runs on the
synthetic stand-ins.
"""

import json
import os

import numpy as np

from ...structures import BoxMode
from ..catalog import DatasetCatalog, MetadataCatalog

__all__ = ["convert_to_coco_dict", "convert_to_coco_json"]


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
