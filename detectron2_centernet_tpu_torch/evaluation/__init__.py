"""COCO evaluation of the port (counterpart of the JAX package's
``evaluation/``). The LVIS, Pascal VOC, sem-seg, panoptic, Cityscapes and
rotated-COCO evaluators wait for their model families (ROADMAP A13-A16)."""

from .coco_evaluation import COCOEvaluator, instances_to_coco_json
from .cocoeval_np import COCOEval
from .evaluator import DatasetEvaluator, DatasetEvaluators, inference_on_dataset
from .testing import flatten_results_dict, print_csv_format, verify_results

__all__ = [
    "COCOEval",
    "COCOEvaluator",
    "DatasetEvaluator",
    "DatasetEvaluators",
    "flatten_results_dict",
    "inference_on_dataset",
    "instances_to_coco_json",
    "print_csv_format",
    "verify_results",
]
