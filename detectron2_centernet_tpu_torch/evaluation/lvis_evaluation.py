"""LVIS box AP (a copy of the JAX package's ``evaluation/lvis_evaluation.py``;
the reference's ``detectron2/evaluation/lvis_evaluation.py``), through the
port's numpy ``COCOEval`` set up as LVIS scores: up to 300 detections an
image, no crowd regions, and the federated rule: on each image a detection
counts only if its category is annotated there or listed in the image's
``neg_category_ids``; any other is left out, neither true nor false.
Besides AP, AP50, AP75, APs, APm and APl it gives APr, APc and APf over the
rare, common and frequent categories (the metadata's
``class_frequencies``). Boxes only, as in the JAX package. The port runs in
one process, so nothing is gathered across ranks.
"""

import itertools
import logging
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from ..data import DatasetCatalog, MetadataCatalog
from .coco_evaluation import instances_to_coco_json
from .cocoeval_np import COCOEval
from .evaluator import DatasetEvaluator

logger = logging.getLogger(__name__)

__all__ = ["LVISEvaluator"]


class _LVISEval(COCOEval):
    MAX_DETS = (300,)

    def summarize(self) -> np.ndarray:
        self.stats = np.array([
            self._summarize(True, max_dets=300),
            self._summarize(True, iou_thr=0.5, max_dets=300),
            self._summarize(True, iou_thr=0.75, max_dets=300),
            self._summarize(True, area="small", max_dets=300),
            self._summarize(True, area="medium", max_dets=300),
            self._summarize(True, area="large", max_dets=300),
        ])
        return self.stats


class LVISEvaluator(DatasetEvaluator):
    def __init__(self, dataset_name: str, output_dir: Optional[str] = None) -> None:
        self._dataset_name = dataset_name
        self._metadata = MetadataCatalog.get(dataset_name)
        self._output_dir = output_dir
        self._predictions: List[dict] = []

    def reset(self) -> None:
        self._predictions = []

    def process(self, inputs, outputs) -> None:
        for inp, out in zip(inputs, outputs):
            if "instances" in out:
                self._predictions.append({"image_id": inp["image_id"],
                                          "instances": instances_to_coco_json(out["instances"], inp["image_id"])})

    def evaluate(self) -> Optional[Dict]:
        if not self._predictions:
            return {"bbox": {"AP": float("nan")}}
        # back to LVIS's 1-indexed ids, in copies: evaluate() may run again
        results = [dict(r, category_id=r["category_id"] + 1)
                   for r in itertools.chain(*[p["instances"] for p in self._predictions])]

        gt_anns, img_ids, cat_ids = [], [], set()
        allowed = {}  # the federated rule: the categories judged on each image
        for d in DatasetCatalog.get(self._dataset_name):
            img_ids.append(d["image_id"])
            pos = set()
            for a in d["annotations"]:
                gt_anns.append({"image_id": d["image_id"], "category_id": a["category_id"] + 1, "bbox": a["bbox"],
                                "iscrowd": 0})
                cat_ids.add(a["category_id"] + 1)
                pos.add(a["category_id"] + 1)
            neg = set(d.get("neg_category_ids", []))
            if pos or neg:
                allowed[d["image_id"]] = pos | neg
        if allowed:
            results = [r for r in results if r["category_id"] in allowed.get(r["image_id"], set())]

        ev = _LVISEval(gt_anns, results, img_ids, sorted(cat_ids))
        ev.evaluate()
        stats = ev.summarize()
        out = {k: float(stats[i] * 100) for i, k in enumerate(("AP", "AP50", "AP75", "APs", "APm", "APl"))}
        out.update(self._frequency_breakdown(ev, sorted(cat_ids)))
        logger.info("LVIS bbox results: %s", out)
        return OrderedDict({"bbox": out})

    def _frequency_breakdown(self, ev, cat_ids) -> Dict[str, float]:
        """APr / APc / APf: the mean precision over the IoUs, recalls and
        categories of each bucket (all areas, 300 detections)."""
        freqs = self._metadata.get("class_frequencies")
        if not freqs or ev.eval is None:
            return {}
        prec = ev.eval["precision"][:, :, :, 0, -1]  # (T, R, K): K in cat_ids' order
        out = {}
        for key, bucket in (("APr", "r"), ("APc", "c"), ("APf", "f")):
            sel = [k for k, cid in enumerate(cat_ids) if 0 <= cid - 1 < len(freqs) and freqs[cid - 1] == bucket]
            if not sel:
                continue
            s = prec[:, :, sel]
            valid = s[s > -1]
            out[key] = float(valid.mean() * 100) if valid.size else float("nan")
        return out
