"""COCOEvaluator (counterpart of the JAX package's
``evaluation/coco_evaluation.py``; the reference's
``detectron2/evaluation/coco_evaluation.py:29``).

``process`` turns each image's predicted ``Instances`` into COCO-json
records (``instances_to_coco_json``, reference :321-354); ``evaluate`` maps
the contiguous class ids back to the dataset's category ids, optionally
dumps the json, and runs the COCO evaluation: ``ops.fast_cocoeval``'s C++
matcher when ``use_fast_impl`` (the reference's ``COCOeval_opt``; a failed
build raises), else the numpy ``COCOEval``. The port runs in one process,
so nothing is gathered across ranks.

Box results are evaluated. Predicted masks and keypoints raise: no port
model makes them yet (ROADMAP A14, A15).
"""

import copy
import itertools
import json
import logging
import os
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from ..data import MetadataCatalog
from ..data.datasets.coco import convert_to_coco_dict, convert_to_coco_json
from .cocoeval_np import COCOEval
from .evaluator import DatasetEvaluator

logger = logging.getLogger(__name__)

__all__ = ["COCOEvaluator", "instances_to_coco_json"]


def instances_to_coco_json(instances, img_id: int) -> List[dict]:
    """Instances -> list of COCO-format detection dicts (reference :321-354)."""
    num_instance = len(instances)
    if num_instance == 0:
        return []
    if instances.has("pred_masks") or instances.has("pred_keypoints"):
        raise NotImplementedError("mask and keypoint results are not ported yet (ROADMAP A14, A15)")
    boxes = np.asarray(instances.pred_boxes.tensor, np.float64).copy()
    # XYXY -> XYWH
    boxes[:, 2] -= boxes[:, 0]
    boxes[:, 3] -= boxes[:, 1]
    scores = np.asarray(instances.scores).tolist()
    classes = np.asarray(instances.pred_classes).tolist()
    return [
        {"image_id": img_id, "category_id": classes[k], "bbox": boxes[k].tolist(), "score": scores[k]}
        for k in range(num_instance)
    ]


class COCOEvaluator(DatasetEvaluator):
    """COCO AP of a registered dataset. A dataset without ``json_file`` in
    its metadata is converted to COCO json: cached under ``output_dir`` (and
    its path recorded in the metadata) when there is one, else kept in
    memory."""

    def __init__(self, dataset_name: str, output_dir: Optional[str] = None,
                 use_fast_impl: bool = True) -> None:
        self._dataset_name = dataset_name
        self._output_dir = output_dir
        self._use_fast_impl = use_fast_impl
        self._metadata = MetadataCatalog.get(dataset_name)
        self._predictions: List[dict] = []

        json_file = self._metadata.get("json_file")
        if json_file is None and output_dir:
            # reference :84-96
            json_file = os.path.join(output_dir, f"{dataset_name}_coco_format.json")
            convert_to_coco_json(dataset_name, json_file)
            self._metadata.json_file = json_file
        if json_file is None:
            self._coco_gt = convert_to_coco_dict(dataset_name)
        else:
            with open(json_file) as f:
                self._coco_gt = json.load(f)

    def reset(self) -> None:
        self._predictions = []

    def process(self, inputs: List[dict], outputs: List[dict]) -> None:
        for inp, out in zip(inputs, outputs):
            prediction = {"image_id": inp["image_id"]}
            if "instances" in out:
                prediction["instances"] = instances_to_coco_json(out["instances"], inp["image_id"])
            if len(prediction) > 1:
                self._predictions.append(prediction)

    def evaluate(self) -> Optional[Dict]:
        predictions = self._predictions
        if len(predictions) == 0:
            logger.warning("[COCOEvaluator] Did not receive valid predictions.")
            return {"bbox": {"AP": float("nan")}}

        coco_results = list(itertools.chain(*[p["instances"] for p in predictions]))

        # contiguous class ids -> dataset category ids (reference :137-150)
        reverse_id_mapping = None
        if self._metadata.get("thing_dataset_id_to_contiguous_id") is not None:
            reverse_id_mapping = {
                v: k for k, v in self._metadata.thing_dataset_id_to_contiguous_id.items()
            }
        if reverse_id_mapping:
            coco_results = copy.deepcopy(coco_results)
            for r in coco_results:
                r["category_id"] = reverse_id_mapping[r["category_id"]]

        if self._output_dir:
            os.makedirs(self._output_dir, exist_ok=True)
            file_path = os.path.join(self._output_dir, "coco_instances_results.json")
            logger.info("Saving results to %s", file_path)
            with open(file_path, "w") as f:
                json.dump(coco_results, f)

        img_ids = [img["id"] for img in self._coco_gt["images"]]
        cat_ids = [c["id"] for c in self._coco_gt["categories"]]
        out = OrderedDict()
        coco_eval = self._evaluate_predictions_on_coco(
            self._coco_gt["annotations"], coco_results, img_ids, cat_ids
        )
        out["bbox"] = self._derive_coco_results(coco_eval)
        return out

    def _evaluate_predictions_on_coco(self, gt_anns, coco_results, img_ids, cat_ids):
        # imported here: ops.fast_cocoeval imports this package's cocoeval_np
        from ..ops.fast_cocoeval import FastCOCOEval

        ev = (FastCOCOEval if self._use_fast_impl else COCOEval)(gt_anns, coco_results, img_ids, cat_ids)
        ev.evaluate()
        ev.summarize()
        return ev

    def _derive_coco_results(self, coco_eval) -> Dict[str, float]:
        metrics = ["AP", "AP50", "AP75", "APs", "APm", "APl"]
        results = {metric: float(coco_eval.stats[idx] * 100) for idx, metric in enumerate(metrics)}
        logger.info("Evaluation results for bbox:\n" + str(results))

        # per-category table (reference :262-300)
        thing_classes = self._metadata.get("thing_classes")
        if thing_classes is not None:
            per_cat = coco_eval.per_category_ap()
            id_map = self._metadata.get("thing_dataset_id_to_contiguous_id")
            for cat_id, ap in per_cat.items():
                idx = id_map[cat_id] if id_map else cat_id
                if 0 <= idx < len(thing_classes):
                    results["AP-" + thing_classes[idx]] = float(ap * 100)
        return results
