"""Evaluation of the port (counterpart of the JAX package's
``evaluation/``): COCO (bbox, segm, keypoints), LVIS (bbox), Pascal VOC
(bbox), Cityscapes instances (segm), semantic segmentation (mIoU, fwIoU,
mACC, pACC), Cityscapes' sem-seg IoU and Panoptic Quality. The rotated-COCO
evaluator waits for rotated boxes (ROADMAP A16)."""

from .cityscapes_evaluation import CityscapesInstanceEvaluator, CityscapesSemSegEvaluator
from .coco_evaluation import COCOEvaluator, instances_to_coco_json
from .cocoeval_np import COCOEval
from .evaluator import DatasetEvaluator, DatasetEvaluators, inference_on_dataset
from .lvis_evaluation import LVISEvaluator
from .panoptic_evaluation import PanopticEvaluator, pq_compute_single_image
from .pascal_voc_evaluation import PascalVOCDetectionEvaluator
from .sem_seg_evaluation import SemSegEvaluator
from .testing import flatten_results_dict, print_csv_format, verify_results

__all__ = [
    "COCOEval",
    "COCOEvaluator",
    "CityscapesInstanceEvaluator",
    "CityscapesSemSegEvaluator",
    "DatasetEvaluator",
    "DatasetEvaluators",
    "LVISEvaluator",
    "PanopticEvaluator",
    "PascalVOCDetectionEvaluator",
    "SemSegEvaluator",
    "flatten_results_dict",
    "inference_on_dataset",
    "instances_to_coco_json",
    "pq_compute_single_image",
    "print_csv_format",
    "verify_results",
]
