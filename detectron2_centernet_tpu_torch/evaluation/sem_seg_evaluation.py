"""Semantic segmentation evaluation (a copy of the JAX package's
``evaluation/sem_seg_evaluation.py``; reference
``detectron2/evaluation/sem_seg_evaluation.py``): mIoU, fwIoU, mACC and pACC
from a confusion matrix of predicted against ground-truth labels, numpy on
the host. The ground truth is each record's ``sem_seg`` array or its
``sem_seg_file_name`` PNG (PIL, imported when a file is read: the card's
machine may lack it). One process: nothing is gathered.
"""

import logging
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np

from ..data import DatasetCatalog, MetadataCatalog
from .evaluator import DatasetEvaluator

logger = logging.getLogger(__name__)

__all__ = ["SemSegEvaluator"]


class SemSegEvaluator(DatasetEvaluator):
    def __init__(self, dataset_name: str, num_classes: Optional[int] = None,
                 ignore_label: Optional[int] = None) -> None:
        self._dataset_name = dataset_name
        meta = MetadataCatalog.get(dataset_name)
        stuff = meta.get("stuff_classes")
        self._num_classes = num_classes or (len(stuff) if stuff else None)
        if not self._num_classes:
            raise ValueError(f"{dataset_name}: give num_classes or the metadata's stuff_classes")
        self._ignore_label = ignore_label if ignore_label is not None else meta.get("ignore_label", 255)
        # each image's ground truth: a PNG path or the record's label array
        self._gt = {}
        for d in DatasetCatalog.get(dataset_name):
            if "sem_seg_file_name" in d:
                self._gt[d["image_id"]] = d["sem_seg_file_name"]
            elif "sem_seg" in d:
                self._gt[d["image_id"]] = np.asarray(d["sem_seg"])
        self._conf: Optional[np.ndarray] = None

    def reset(self) -> None:
        n = self._num_classes
        self._conf = np.zeros((n + 1, n + 1), np.int64)

    def process(self, inputs, outputs) -> None:
        n = self._num_classes
        for inp, out in zip(inputs, outputs):
            gt_src = self._gt.get(inp["image_id"])
            if gt_src is None:
                continue
            pred = np.asarray(out["sem_seg"], np.int64)
            if isinstance(gt_src, str):
                from ..data.detection_utils import read_sem_seg

                gt = read_sem_seg(gt_src).astype(np.int64)
            else:
                gt = gt_src.astype(np.int64)  # a copy: the catalog's array stays
            gt[gt == self._ignore_label] = n
            self._conf += np.bincount((n + 1) * pred.reshape(-1) + gt.reshape(-1),
                                      minlength=(n + 1) ** 2).reshape(n + 1, n + 1)

    def evaluate(self) -> Dict:
        n = self._num_classes
        conf = self._conf[:, :n]  # the ignored ground truth's column dropped
        acc = np.full(n, np.nan)
        iou = np.full(n, np.nan)
        tp = conf.diagonal()[:n].astype(np.float64)
        pos_gt = conf[: n + 1, :n].sum(0).astype(np.float64)
        pos_pred = conf[:n, :n].sum(1).astype(np.float64)
        class_weights = pos_gt / max(pos_gt.sum(), 1)
        valid = pos_gt > 0
        acc[valid] = tp[valid] / pos_gt[valid]
        union = pos_gt + pos_pred - tp
        iou_valid = np.logical_and(valid, union > 0)
        iou[iou_valid] = tp[iou_valid] / union[iou_valid]
        results = {
            "mIoU": 100 * np.nanmean(iou),
            "fwIoU": 100 * float((iou[iou_valid] * class_weights[iou_valid]).sum()),
            "mACC": 100 * np.nanmean(acc),
            "pACC": 100 * float(tp.sum() / max(pos_gt.sum(), 1)),
        }
        logger.info("SemSeg results: %s", results)
        return OrderedDict({"sem_seg": results})
