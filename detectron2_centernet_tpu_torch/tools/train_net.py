#!/usr/bin/env python3
"""Training and evaluation from a config file (counterpart of the JAX
package's ``tools/train_net.py``; the reference's ``tools/train_net.py``).

Usage:
  python -m detectron2_centernet_tpu_torch.tools.train_net \\
      --config-file configs/COCO-Detection/ctdet_res_18_1x.yaml [--resume] [KEY VALUE ...]
  python -m detectron2_centernet_tpu_torch.tools.train_net \\
      --config-file ... --eval-only [--resume | MODEL.WEIGHTS path.pth]

It runs on ``MODEL.DEVICE`` (``cuda`` by default; it raises without a card
unless ``MODEL.DEVICE cpu`` is given). With ``DETECTRON2_SYNTH_DATA`` set, a
dataset that is not registered gets a synthetic stand-in
(``data.datasets.ensure_synthetic_datasets``). Training ends, and
``--eval-only`` ends, in ``verify_results`` against
``TEST.EXPECTED_RESULTS`` (exit code 1 on a miss).
"""

import os

from ..config import get_cfg
from ..data import MetadataCatalog
from ..engine import DefaultTrainer, default_argument_parser, default_setup, launch
from ..evaluation import (CityscapesInstanceEvaluator, COCOEvaluator, DatasetEvaluators, LVISEvaluator,
                          PascalVOCDetectionEvaluator, SemSegEvaluator, verify_results)

# evaluator_type -> the ROADMAP item that ports its evaluator
QUEUED_EVALUATORS = {"cityscapes_sem_seg": "A15.2"}


class Trainer(DefaultTrainer):
    """``DefaultTrainer`` with the evaluator of each dataset's
    ``evaluator_type`` (JAX ``tools/train_net.py:30-63``):
    ``coco_panoptic_seg`` gets COCO's and the sem-seg one together."""

    @classmethod
    def build_evaluator(cls, cfg, dataset_name, output_folder=None):
        if output_folder is None:
            output_folder = os.path.join(cfg.OUTPUT_DIR, "inference")
        evaluator_type = MetadataCatalog.get(dataset_name).get("evaluator_type", "coco")
        if evaluator_type in QUEUED_EVALUATORS:
            raise RuntimeError(
                f"dataset {dataset_name}: the evaluator of evaluator_type '{evaluator_type}' is not "
                f"ported yet (ROADMAP {QUEUED_EVALUATORS[evaluator_type]})")
        evaluators = []
        if evaluator_type in ("coco", "coco_panoptic_seg"):
            evaluators.append(COCOEvaluator(dataset_name, output_dir=output_folder, cfg=cfg))
        if evaluator_type in ("sem_seg", "coco_panoptic_seg"):
            evaluators.append(SemSegEvaluator(dataset_name))
        if evaluator_type == "lvis":
            evaluators.append(LVISEvaluator(dataset_name, output_dir=output_folder))
        if evaluator_type == "pascal_voc":
            evaluators.append(PascalVOCDetectionEvaluator(dataset_name))
        if evaluator_type == "cityscapes_instance":
            evaluators.append(CityscapesInstanceEvaluator(dataset_name))
        if not evaluators:
            raise NotImplementedError(
                f"No evaluator implemented for evaluator_type '{evaluator_type}' (dataset {dataset_name})")
        return evaluators[0] if len(evaluators) == 1 else DatasetEvaluators(evaluators)


def setup(args):
    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts or [])
    cfg.freeze()
    if cfg.TEST.AUG.ENABLED:
        raise NotImplementedError("TEST.AUG.ENABLED: test-time augmentation is not ported yet (ROADMAP A17)")
    default_setup(cfg, args)
    if os.environ.get("DETECTRON2_SYNTH_DATA"):
        from ..data.datasets import ensure_synthetic_datasets

        ensure_synthetic_datasets(tuple(cfg.DATASETS.TRAIN) + tuple(cfg.DATASETS.TEST))
    return cfg


def main(args):
    cfg = setup(args)
    trainer = Trainer(cfg)
    trainer.resume_or_load(resume=args.resume)
    if args.eval_only:
        trainer.data_loader.close()  # no training: the train loader's threads stop
        res = Trainer.test(cfg, trainer)
        verify_results(cfg, res)
        return res
    return trainer.train()


if __name__ == "__main__":
    args = default_argument_parser().parse_args()
    launch(main, args.num_gpus, num_machines=args.num_machines, machine_rank=args.machine_rank,
           dist_url=args.dist_url, args=(args,))
