"""Cityscapes instance-segmentation AP (a copy of the JAX package's
``CityscapesInstanceEvaluator``, ``evaluation/cityscapes_evaluation.py:51-210``;
the protocol of cityscapesscripts' ``evalInstanceLevelSemanticLabeling``,
computed in process from the dataset dicts, no files written):

* overlap thresholds 0.50:0.05:0.95; AP is the mean over thresholds and
  classes, AP50 the first threshold's, and AP-<class> each class's;
* per class and threshold, predictions by descending score, each matched
  greedily to the unmatched ground truth of its class with the best IoU
  above the threshold;
* ground truth under ``min_region_size`` pixels (100) is not matchable;
  with the class's crowd (``*group``) regions it forms the class's ignore
  set, and an unmatched prediction whose share inside that set exceeds the
  threshold is left out rather than counted false (the void rule);
* AP from the all-point interpolated precision envelope.

The ground-truth polygons are filled at the prediction's image size by the
port's ``polygons_to_bitmask`` (cv2's ``fillPoly`` without cv2). The images
are keyed by the dataset's own ids, the image file names (ROADMAP C22).
The sem-seg evaluator waits for DeepLab (ROADMAP A15.2). The port runs in
one process, so nothing is gathered across ranks.
"""

import logging
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from ..data.catalog import DatasetCatalog, MetadataCatalog
from ..structures.masks import polygons_to_bitmask
from .evaluator import DatasetEvaluator

logger = logging.getLogger(__name__)

__all__ = ["CityscapesInstanceEvaluator"]

_OVERLAPS = np.arange(0.5, 1.0, 0.05)
_MIN_REGION_SIZE = 100  # the official minRegionSizes[0]


class CityscapesInstanceEvaluator(DatasetEvaluator):
    def __init__(self, dataset_name: str, min_region_size: int = _MIN_REGION_SIZE) -> None:
        self._dataset_name = dataset_name
        self._metadata = MetadataCatalog.get(dataset_name)
        self._min_region = int(min_region_size)
        self._gt_lookup = None
        self.reset()

    def reset(self) -> None:
        self._images = []  # per image: {"preds", "gts", "crowd"}

    def _gt_for(self, inp: dict):
        annos = inp.get("annotations")
        if annos is None:
            if self._gt_lookup is None:
                self._gt_lookup = {d["image_id"]: d for d in DatasetCatalog.get(self._dataset_name)}
            annos = self._gt_lookup[inp["image_id"]].get("annotations", [])
        return annos

    def process(self, inputs: List[dict], outputs: List[dict]) -> None:
        for inp, out in zip(inputs, outputs):
            if "instances" not in out:
                continue
            inst = out["instances"]
            h, w = inst.image_size
            gts, crowd_masks = [], []
            for a in self._gt_for(inp):
                seg = a.get("segmentation")
                if seg is None:
                    continue
                mask = np.asarray(seg, bool) if isinstance(seg, np.ndarray) else polygons_to_bitmask(seg, h, w)
                (crowd_masks if a.get("iscrowd", 0) else gts).append((int(a["category_id"]), mask))
            preds = []
            if len(inst):
                masks = np.asarray(inst.pred_masks) if inst.has("pred_masks") else np.zeros((len(inst), h, w), bool)
                preds = [(int(inst.pred_classes[i]), float(inst.scores[i]), masks[i].astype(bool))
                         for i in range(len(inst))]
            self._images.append({"preds": preds, "gts": gts, "crowd": crowd_masks})

    @staticmethod
    def _ap_from_curve(tp_flags: np.ndarray, scores: np.ndarray, n_gt: int) -> float:
        if n_gt == 0:
            return float("nan")
        if len(scores) == 0:
            return 0.0
        order = np.argsort(-scores)
        tp = tp_flags[order].astype(np.float64)
        fp = 1.0 - tp
        tp_c, fp_c = np.cumsum(tp), np.cumsum(fp)
        recall = tp_c / n_gt
        precision = tp_c / np.maximum(tp_c + fp_c, 1e-9)
        mrec = np.concatenate([[0.0], recall, [recall[-1]]])
        mpre = np.concatenate([[1.0], precision, [0.0]])
        for i in range(len(mpre) - 2, -1, -1):
            mpre[i] = max(mpre[i], mpre[i + 1])
        idx = np.nonzero(mrec[1:] != mrec[:-1])[0]
        return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))

    def evaluate(self) -> Optional[Dict]:
        images = self._images
        classes = self._metadata.get("thing_classes") or []
        ap_per_cls = np.full((len(classes), len(_OVERLAPS)), np.nan)
        for c in range(len(classes)):
            for oi, thr in enumerate(_OVERLAPS):
                flags, scores, n_gt = [], [], 0
                for im in images:
                    cls_gts = [m for cls, m in im["gts"] if cls == c]
                    gts = [m for m in cls_gts if m.sum() >= self._min_region]
                    n_gt += len(gts)
                    ignore_masks = [m for cls, m in im["crowd"] if cls == c] + \
                        [m for m in cls_gts if m.sum() < self._min_region]
                    ignore = np.any(np.stack(ignore_masks), axis=0) if ignore_masks else None
                    preds = sorted([p for p in im["preds"] if p[0] == c], key=lambda p: -p[1])
                    taken = np.zeros(len(gts), bool)
                    for _, score, pm in preds:
                        area = pm.sum()
                        if area == 0:
                            continue
                        best, best_iou = -1, thr
                        for gi, gm in enumerate(gts):
                            if taken[gi]:
                                continue
                            inter = np.logical_and(pm, gm).sum()
                            iou = inter / max(area + gm.sum() - inter, 1)
                            if iou > best_iou:
                                best, best_iou = gi, iou
                        if best >= 0:
                            taken[best] = True
                            flags.append(1.0)
                            scores.append(score)
                        else:
                            if ignore is not None and np.logical_and(pm, ignore).sum() / area > thr:
                                continue  # the void rule
                            flags.append(0.0)
                            scores.append(score)
                ap_per_cls[c, oi] = self._ap_from_curve(np.asarray(flags), np.asarray(scores), n_gt)

        def nanmean(a: np.ndarray) -> float:
            vals = a[np.isfinite(a)]
            return float(vals.mean()) if vals.size else float("nan")

        ap, ap50 = nanmean(ap_per_cls) * 100.0, nanmean(ap_per_cls[:, 0]) * 100.0
        res = OrderedDict({"segm": {"AP": ap, "AP50": ap50}})
        for c, name in enumerate(classes):
            res["segm"][f"AP-{name}"] = nanmean(ap_per_cls[c]) * 100.0
        logger.info("Cityscapes instance AP: %.2f  AP50: %.2f", ap, ap50)
        return res
