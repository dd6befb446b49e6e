"""Pascal VOC detection AP (a copy of the JAX package's
``evaluation/pascal_voc_evaluation.py``; the reference's
``detectron2/evaluation/pascal_voc_evaluation.py``): per class, detections
ranked by score are matched greedily to the ground truth of their image at
IoU > 0.5 (and 0.75) in VOC's +1 pixel convention; a match to a
``difficult`` box counts neither way, a second match to a box is a false
positive. AP is the 11-point interpolation for VOC 2007 and the area under
the monotone precision envelope otherwise; the result is AP50, AP75 and
their mean as AP, over the classes with ground truth or detections.

The ground truth is keyed by the dataset's own image ids, the file ids
such as "000005" (ROADMAP C22). The port runs in one process, so nothing
is gathered across ranks.
"""

from collections import OrderedDict, defaultdict
from typing import Dict, List

import numpy as np

from ..data import DatasetCatalog, MetadataCatalog
from ..structures import BoxMode
from .evaluator import DatasetEvaluator

__all__ = ["PascalVOCDetectionEvaluator", "voc_ap"]


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = False) -> float:
    """AP of a recall/precision curve (reference :219-250)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1]))


def _voc_eval_class(gt_by_img: Dict, dets: List, iou_thresh: float, use_07: bool) -> float:
    """AP of one class: ``gt_by_img`` {image id: (boxes (G, 4) XYXY,
    difficult (G,) bool)}, ``dets`` [(image id, score, box)]; NaN without
    ground truth or detections."""
    npos = 0
    matched = {}
    for img, (boxes, difficult) in gt_by_img.items():
        matched[img] = np.zeros(len(boxes), bool)
        npos += int((~difficult).sum())
    if not dets:
        return float("nan") if npos == 0 else 0.0
    dets = sorted(dets, key=lambda d: -d[1])
    tp = np.zeros(len(dets))
    fp = np.zeros(len(dets))
    for i, (img, score, bb) in enumerate(dets):
        boxes, difficult = gt_by_img.get(img, (np.zeros((0, 4)), np.zeros(0, bool)))
        iou_max, j_max = -np.inf, -1
        if len(boxes):
            ixmin = np.maximum(boxes[:, 0], bb[0])
            iymin = np.maximum(boxes[:, 1], bb[1])
            ixmax = np.minimum(boxes[:, 2], bb[2])
            iymax = np.minimum(boxes[:, 3], bb[3])
            iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
            ih = np.maximum(iymax - iymin + 1.0, 0.0)
            inters = iw * ih
            uni = ((bb[2] - bb[0] + 1.0) * (bb[3] - bb[1] + 1.0)
                   + (boxes[:, 2] - boxes[:, 0] + 1.0) * (boxes[:, 3] - boxes[:, 1] + 1.0) - inters)
            overlaps = inters / np.maximum(uni, 1e-12)
            j_max = int(np.argmax(overlaps))
            iou_max = overlaps[j_max]
        if iou_max > iou_thresh:
            if not difficult[j_max]:
                if not matched[img][j_max]:
                    tp[i] = 1.0
                    matched[img][j_max] = True
                else:
                    fp[i] = 1.0
        else:
            fp[i] = 1.0
    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / max(npos, 1)
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return voc_ap(rec, prec, use_07)


class PascalVOCDetectionEvaluator(DatasetEvaluator):
    def __init__(self, dataset_name: str) -> None:
        self._dataset_name = dataset_name
        meta = MetadataCatalog.get(dataset_name)
        self._class_names = meta.thing_classes
        self._is_2007 = meta.get("year", 2012) == 2007
        self._predictions: Dict[int, List] = defaultdict(list)
        self._gt: Dict[int, Dict] = defaultdict(dict)
        for d in DatasetCatalog.get(dataset_name):
            per_class = defaultdict(lambda: ([], []))
            for a in d.get("annotations", []):
                box = BoxMode.convert(a["bbox"], a["bbox_mode"], BoxMode.XYXY_ABS)
                per_class[a["category_id"]][0].append(box)
                per_class[a["category_id"]][1].append(bool(a.get("difficult", 0)))
            for c, (boxes, diff) in per_class.items():
                self._gt[c][d["image_id"]] = (np.asarray(boxes, np.float64), np.asarray(diff, bool))

    def reset(self) -> None:
        self._predictions = defaultdict(list)

    def process(self, inputs, outputs) -> None:
        for inp, out in zip(inputs, outputs):
            inst = out["instances"]
            for box, score, cls in zip(np.asarray(inst.pred_boxes.tensor), np.asarray(inst.scores),
                                       np.asarray(inst.pred_classes)):
                self._predictions[int(cls)].append((inp["image_id"], float(score), box.astype(np.float64)))

    def evaluate(self) -> Dict:
        aps = {iou: [] for iou in (50, 75)}
        for c in range(len(self._class_names)):
            for iou in aps:
                aps[iou].append(_voc_eval_class(self._gt.get(c, {}), self._predictions.get(c, []), iou / 100.0,
                                                self._is_2007))
        mean = {iou: float(np.nanmean(v)) * 100 for iou, v in aps.items()}
        return OrderedDict({"bbox": {"AP": (mean[50] + mean[75]) / 2, "AP50": mean[50], "AP75": mean[75]}})
