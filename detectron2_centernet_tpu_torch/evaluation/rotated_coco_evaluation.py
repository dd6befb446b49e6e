"""Rotated-box COCO-style evaluation (a copy of the JAX package's
``evaluation/rotated_coco_evaluation.py``; reference
``detectron2/evaluation/rotated_coco_evaluation.py``): the COCO AP protocol
with the exact rotated IoU (``COCOEval(iou_type="rotated_bbox")``); boxes are
5-tuples (cx, cy, w, h, angle). The ground truth comes from the registered
dataset, an axis-aligned box becoming its rectangle at angle 0. The port
runs in one process: every prediction is the main process's."""

import logging
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from ..data import DatasetCatalog, MetadataCatalog
from ..structures import BoxMode
from .cocoeval_np import COCOEval
from .evaluator import DatasetEvaluator

logger = logging.getLogger(__name__)

__all__ = ["RotatedCOCOEvaluator"]


def _to_xywha(bbox, mode) -> List[float]:
    if len(bbox) == 5:
        return [float(v) for v in bbox]
    b = BoxMode.convert(bbox, mode, BoxMode.XYXY_ABS)
    return [
        (b[0] + b[2]) / 2.0, (b[1] + b[3]) / 2.0,
        b[2] - b[0], b[3] - b[1], 0.0,
    ]


class RotatedCOCOEvaluator(DatasetEvaluator):
    def __init__(self, dataset_name: str, output_dir: Optional[str] = None) -> None:
        self._dataset_name = dataset_name
        self._metadata = MetadataCatalog.get(dataset_name)
        self._predictions: List[dict] = []
        # gt from the registered dataset (axis-aligned gts become angle-0)
        self._gt_anns: List[dict] = []
        self._img_ids: List = []
        cat_ids = set()
        for d in DatasetCatalog.get(dataset_name):
            self._img_ids.append(d["image_id"])
            for a in d.get("annotations", []):
                self._gt_anns.append(
                    {
                        "image_id": d["image_id"],
                        "category_id": a["category_id"],
                        "bbox": _to_xywha(a["bbox"], a.get("bbox_mode", 0)),
                        "iscrowd": int(a.get("iscrowd", 0)),
                    }
                )
                cat_ids.add(a["category_id"])
        self._cat_ids = sorted(cat_ids)

    def reset(self) -> None:
        self._predictions = []

    def process(self, inputs, outputs) -> None:
        for inp, out in zip(inputs, outputs):
            inst = out["instances"]
            boxes = np.asarray(inst.pred_boxes.tensor)
            scores = np.asarray(inst.scores)
            classes = np.asarray(inst.pred_classes)
            for b, s, c in zip(boxes, scores, classes):
                self._predictions.append(
                    {
                        "image_id": inp["image_id"],
                        "category_id": int(c),
                        "bbox": [float(v) for v in b],
                        "score": float(s),
                    }
                )

    def evaluate(self) -> Optional[Dict]:
        ev = COCOEval(self._gt_anns, self._predictions, self._img_ids, self._cat_ids,
                      iou_type="rotated_bbox")
        ev.evaluate()
        stats = ev.summarize()
        out = {
            "AP": float(stats[0] * 100), "AP50": float(stats[1] * 100),
            "AP75": float(stats[2] * 100),
        }
        logger.info("Rotated bbox results: %s", out)
        return OrderedDict({"bbox": out})
