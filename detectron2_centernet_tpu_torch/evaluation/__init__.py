"""Evaluation of the port (counterpart of the JAX package's
``evaluation/``): COCO (bbox, segm, keypoints), LVIS (bbox), Pascal VOC
(bbox) and Cityscapes instances (segm). The sem-seg, panoptic and Cityscapes
sem-seg evaluators wait for segmentation (ROADMAP A15), the rotated-COCO one
for rotated boxes (A16)."""

from .cityscapes_evaluation import CityscapesInstanceEvaluator
from .coco_evaluation import COCOEvaluator, instances_to_coco_json
from .cocoeval_np import COCOEval
from .evaluator import DatasetEvaluator, DatasetEvaluators, inference_on_dataset
from .lvis_evaluation import LVISEvaluator
from .pascal_voc_evaluation import PascalVOCDetectionEvaluator
from .testing import flatten_results_dict, print_csv_format, verify_results

__all__ = [
    "COCOEval",
    "COCOEvaluator",
    "CityscapesInstanceEvaluator",
    "DatasetEvaluator",
    "DatasetEvaluators",
    "LVISEvaluator",
    "PascalVOCDetectionEvaluator",
    "flatten_results_dict",
    "inference_on_dataset",
    "instances_to_coco_json",
    "print_csv_format",
    "verify_results",
]
