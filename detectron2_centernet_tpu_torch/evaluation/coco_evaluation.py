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

Boxes are evaluated always; with predicted masks (uncompressed RLE in the
results json) the ``segm`` IoU type too, against the ground truth's polygons
filled at the image's size (``_gt_segm_rles``, pycocotools' ``annToRLE``);
with predicted keypoints the ``keypoints`` type (OKS, with
``TEST.KEYPOINT_OKS_SIGMAS`` when the config gives them, else COCO's 17),
through the numpy ``COCOEval`` as the JAX package and the reference do.
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
from ..structures.masks import polygons_to_bitmask
from ..structures.rle import mask_to_rle
from .cocoeval_np import COCOEval
from .evaluator import DatasetEvaluator

logger = logging.getLogger(__name__)

__all__ = ["COCOEvaluator", "instances_to_coco_json"]


def instances_to_coco_json(instances, img_id: int) -> List[dict]:
    """Instances -> list of COCO-format detection dicts (reference :321-354);
    masks as uncompressed COCO RLE, keypoints with -0.5 on x and y (the
    reference's pixel-index convention, :371-378)."""
    num_instance = len(instances)
    if num_instance == 0:
        return []
    boxes = np.asarray(instances.pred_boxes.tensor, np.float64).copy()
    # XYXY -> XYWH
    boxes[:, 2] -= boxes[:, 0]
    boxes[:, 3] -= boxes[:, 1]
    scores = np.asarray(instances.scores).tolist()
    classes = np.asarray(instances.pred_classes).tolist()
    results = [
        {"image_id": img_id, "category_id": classes[k], "bbox": boxes[k].tolist(), "score": scores[k]}
        for k in range(num_instance)
    ]
    if instances.has("pred_masks"):
        for r, m in zip(results, instances.pred_masks):
            r["segmentation"] = mask_to_rle(np.asarray(m))
    if instances.has("pred_keypoints"):
        kpts = np.asarray(instances.pred_keypoints, np.float64).copy()
        kpts[:, :, :2] -= 0.5
        for r, k in zip(results, kpts):
            r["keypoints"] = k.flatten().tolist()
    return results


class COCOEvaluator(DatasetEvaluator):
    """COCO AP of a registered dataset. A dataset without ``json_file`` in
    its metadata is converted to COCO json: cached under ``output_dir`` (and
    its path recorded in the metadata) when there is one, else kept in
    memory."""

    def __init__(self, dataset_name: str, output_dir: Optional[str] = None,
                 use_fast_impl: bool = True, cfg=None) -> None:
        self._dataset_name = dataset_name
        self._output_dir = output_dir
        self._use_fast_impl = use_fast_impl
        self._kpt_oks_sigmas = (list(cfg.TEST.KEYPOINT_OKS_SIGMAS)
                                if cfg is not None and len(cfg.TEST.KEYPOINT_OKS_SIGMAS) else None)
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
        if any("segmentation" in r for r in coco_results):
            dt_segm = [r for r in coco_results if "segmentation" in r]
            segm_eval = self._evaluate_predictions_on_coco(self._gt_segm_rles(), dt_segm, img_ids, cat_ids,
                                                           iou_type="segm")
            out["segm"] = self._derive_coco_results(segm_eval)
        if any("keypoints" in r for r in coco_results):
            gt_kp = [a for a in self._coco_gt["annotations"] if a.get("keypoints")]
            dt_kp = [r for r in coco_results if "keypoints" in r]
            kp_eval = self._evaluate_predictions_on_coco(gt_kp, dt_kp, img_ids, cat_ids, iou_type="keypoints")
            out["keypoints"] = self._derive_coco_results(kp_eval, iou_type="keypoints")
        return out

    def _gt_segm_rles(self) -> List[dict]:
        """The ground truth's annotations with a segmentation, polygons filled
        at the image's size as RLE (pycocotools' ``annToRLE``)."""
        sizes = {im["id"]: (im["height"], im["width"]) for im in self._coco_gt["images"]}
        out = []
        for a in self._coco_gt["annotations"]:
            segm = a.get("segmentation")
            if not segm:
                continue
            g = dict(a)
            if isinstance(segm, list):
                g["segmentation"] = mask_to_rle(polygons_to_bitmask(segm, *sizes[a["image_id"]]))
            out.append(g)
        return out

    def _evaluate_predictions_on_coco(self, gt_anns, coco_results, img_ids, cat_ids, iou_type="bbox"):
        if iou_type == "keypoints":
            # the C++ matcher covers bbox and segm; keypoints go through the
            # numpy evaluator, as in the JAX package and the reference
            nk = len(coco_results[0]["keypoints"]) // 3
            if self._kpt_oks_sigmas is not None and len(self._kpt_oks_sigmas) != nk:
                raise ValueError(f"TEST.KEYPOINT_OKS_SIGMAS has {len(self._kpt_oks_sigmas)} entries but "
                                 f"predictions carry {nk} keypoints")
            ev = COCOEval(gt_anns, coco_results, img_ids, cat_ids, iou_type, kpt_oks_sigmas=self._kpt_oks_sigmas)
        else:
            # imported here: ops.fast_cocoeval imports this package's cocoeval_np
            from ..ops.fast_cocoeval import FastCOCOEval

            ev = (FastCOCOEval if self._use_fast_impl else COCOEval)(gt_anns, coco_results, img_ids, cat_ids,
                                                                      iou_type)
        ev.evaluate()
        ev.summarize()
        return ev

    def _derive_coco_results(self, coco_eval, iou_type: str = "bbox") -> Dict[str, float]:
        metrics = ["AP", "AP50", "AP75", "APm", "APl"] if iou_type == "keypoints" else \
            ["AP", "AP50", "AP75", "APs", "APm", "APl"]
        results = {metric: float(coco_eval.stats[idx] * 100) for idx, metric in enumerate(metrics)}
        logger.info(f"Evaluation results for {iou_type}:\n" + str(results))

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
