"""Inference, training and evaluation from a config (counterpart of the JAX
package's ``engine/defaults.py``): the command-line plumbing
(``default_argument_parser``, ``default_setup``, ``launch``),
``DefaultPredictor`` and ``DefaultTrainer`` with its ``test``.
"""

import argparse
import logging
import os
from collections import OrderedDict
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..checkpoint import Checkpointer, PeriodicCheckpointer
from ..checkpoint.torch_import import load_model_weights
from ..config import CfgNode
from ..data import (
    build_detection_test_loader,
    build_detection_train_loader,
    letterbox_transform,
    warp_image,
)
from ..evaluation import (
    COCOEvaluator,
    DatasetEvaluator,
    inference_on_dataset,
    print_csv_format,
    verify_results,
)
from ..models import build_model
from ..solver import build_lr_scheduler, build_optimizer
from ..utils.env import seed_all_rng
from ..utils.events import CommonMetricPrinter, JSONWriter
from ..utils.logger import setup_logger
from . import hooks
from .train_loop import SimpleTrainer

logger = logging.getLogger(__name__)

__all__ = ["DefaultPredictor", "DefaultTrainer", "default_argument_parser", "default_setup", "launch"]


def default_argument_parser(epilog: Optional[str] = None) -> argparse.ArgumentParser:
    """The reference's (and the JAX package's) flags: ``--config-file``,
    ``--resume``, ``--eval-only``, ``--num-gpus``, ``--num-machines``,
    ``--machine-rank``, ``--dist-url``, then "KEY VALUE" config overrides."""
    parser = argparse.ArgumentParser(epilog=epilog or "detectron2_centernet_tpu_torch")
    parser.add_argument("--config-file", default="", metavar="FILE", help="path to config file")
    parser.add_argument("--resume", action="store_true", help="resume from OUTPUT_DIR")
    parser.add_argument("--eval-only", action="store_true", help="perform evaluation only")
    parser.add_argument("--num-gpus", type=int, default=1, help="cards per machine")
    parser.add_argument("--num-machines", type=int, default=1, help="total number of machines")
    parser.add_argument("--machine-rank", type=int, default=0, help="rank of this machine")
    parser.add_argument("--dist-url", default="auto", help="address of the first machine")
    parser.add_argument("opts", help="Modify config options using the command-line 'KEY VALUE' pairs",
                        default=None, nargs=argparse.REMAINDER)
    return parser


def _devices(cfg: CfgNode) -> str:
    device = torch.device(cfg.MODEL.DEVICE)
    if device.type != "cuda":
        return str(device)
    if not torch.cuda.is_available():
        return "cuda (no CUDA device available)"
    return f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"


def default_setup(cfg: CfgNode, args) -> None:
    """Create ``OUTPUT_DIR``, log to the console and ``OUTPUT_DIR/log.txt``,
    log the card (name and count) and the full config, write it to
    ``OUTPUT_DIR/config.yaml`` (``CfgNode.dump``; ``merge_from_file`` reads
    it back), and seed every generator from ``SEED`` (from the clock when
    negative). One process: rank 0."""
    output_dir = cfg.OUTPUT_DIR
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
    setup_logger(output_dir)  # the package's logger, which this module's logs through
    logger.info("Rank of current process: 0. World size: 1")
    logger.info("Devices: %s (MODEL.DEVICE %s); torch %s, CUDA %s", _devices(cfg), cfg.MODEL.DEVICE,
                torch.__version__, torch.version.cuda)
    if getattr(args, "config_file", ""):
        logger.info("Contents of args.config_file=%s", args.config_file)
    logger.info("Running with full config:\n%s", cfg)
    if output_dir:
        path = os.path.join(output_dir, "config.yaml")
        with open(path, "w") as f:
            f.write(cfg.dump())
        logger.info("Full config saved to %s", os.path.abspath(path))
    seed_all_rng(None if cfg.SEED < 0 else cfg.SEED)


def launch(main_func: Callable, num_gpus_per_machine: int = 1, num_machines: int = 1,
           machine_rank: int = 0, dist_url: str = "auto", args=()):
    """Run ``main_func(*args)`` in this process on one card and return what
    it returns. More machines or cards raise: the multi-process path (the
    JAX package's ``parallel/comm.py`` and ``jax.distributed``; DDP here)
    is not ported yet (ROADMAP A19)."""
    if num_machines > 1 or num_gpus_per_machine > 1:
        raise NotImplementedError(
            f"launch with {num_machines} machines and {num_gpus_per_machine} cards per machine: the "
            "multi-process path (parallel/comm.py, DDP) is not ported yet (ROADMAP A19); run one card")
    return main_func(*args)


def load_weights(model: torch.nn.Module, path: str) -> None:
    """``MODEL.WEIGHTS`` for the predictor: a checkpoint of this network (a
    bare state dict, or one under "model" or "state_dict"; a DataParallel
    "module." prefix dropped) loads strictly; any other ``.pth`` or ``.pkl``
    (an ImageNet trunk, a partial checkpoint) is aligned by shape and name
    as the JAX package's predictor aligns it, one tree
    (``checkpoint/torch_import.py``), and what nothing matches keeps its
    init."""
    load_model_weights(model, path, per_collection=False)


class DefaultPredictor:
    """One image per call, with the config's test transform: BGR/RGB per
    ``INPUT.FORMAT``, the ctdet letterbox warped on the model's device, one
    forward, the decode, and ``{"instances": Instances}`` in the image's own
    pixels (a segmentor's ``{"sem_seg"}``, PanopticFPN's with both and
    ``"panoptic_seg"``). Batches go through ``CenterNet.predict_fn``
    directly. Under ``MODEL.LOAD_PROPOSALS`` it raises, as the JAX package's predictor
    cannot pass proposals either: evaluate Fast R-CNN through the test
    loader (``DefaultTrainer.test``), whose mapper reads the proposal file."""

    def __init__(self, cfg: CfgNode) -> None:
        if cfg.MODEL.LOAD_PROPOSALS:
            raise ValueError("DefaultPredictor takes one image and no proposals: MODEL.LOAD_PROPOSALS (Fast R-CNN) "
                             "needs DATASETS.PROPOSAL_FILES_TEST through the test loader (DefaultTrainer.test, "
                             "inference_on_dataset)")
        self.cfg = cfg.clone()
        self.model = build_model(self.cfg)
        self.input_format = cfg.INPUT.FORMAT
        if self.input_format not in ("RGB", "BGR"):
            raise ValueError(f"INPUT.FORMAT must be RGB or BGR, got {self.input_format}")
        if cfg.MODEL.WEIGHTS:
            load_weights(self.model.model, cfg.MODEL.WEIGHTS)
        self._size = tuple(cfg.INPUT.TEST_SIZE)

    def __call__(self, original_image: np.ndarray) -> Dict:
        """original_image: (H, W, C) uint8 in BGR (the cv2 convention)."""
        if self.input_format == "RGB":
            original_image = original_image[:, :, ::-1]
        h, w = original_image.shape[:2]
        m = letterbox_transform(h, w, self._size)
        warped = warp_image(original_image, m, self._size, device=self.model.device)
        dets = self.model.predict_fn(warped.permute(2, 0, 1)[None])
        if hasattr(self.model, "device_postprocess"):  # the segmentors' label maps, made on the device
            dets = self.model.device_postprocess(dets, [m], [(h, w)])
        dets = {k: v.cpu().numpy() for k, v in dets.items()}
        return self.model.postprocess(dets, [m], [(h, w)])[0]


class DefaultTrainer(SimpleTrainer):
    """The train-from-config workflow on one device (``cfg.MODEL.DEVICE``):
    the model, the optimizer and its LR schedule, the train loader over
    ``DATASETS.TRAIN`` (register it first, e.g. with
    ``data.datasets.ensure_synthetic_datasets``; ``DATASETS.TEST`` too), the
    checkpointer and the hooks, in the JAX package's order: PreciseBN (when
    ``TEST.PRECISE_BN.ENABLED``) before the checkpointer, so the final
    checkpoint and the evaluation see its statistics, then ``EvalHook``,
    always registered, so ``DATASETS.TEST`` is evaluated after the last step
    even at ``TEST.EVAL_PERIOD`` 0. ``resume_or_load()``, then ``train()``,
    which ends in ``verify_results`` (``TEST.EXPECTED_RESULTS``) and returns
    the last evaluation's results."""

    def __init__(self, cfg: CfgNode) -> None:
        self.cfg = cfg
        model = build_model(cfg)
        optimizer, scheduler = build_optimizer(cfg, model.model)
        super().__init__(model, self.build_train_loader(cfg), optimizer, scheduler)
        self.schedule = build_lr_scheduler(cfg)
        self.checkpointer = Checkpointer(model.model, cfg.OUTPUT_DIR, optimizer=optimizer,
                                         scheduler=scheduler)
        self.start_iter = 0
        self.max_iter = int(cfg.SOLVER.MAX_ITER)
        self.register_hooks(self.build_hooks())

    def resume_or_load(self, resume: bool = True) -> None:
        """Resume from OUTPUT_DIR's last checkpoint (``resume``), else load
        ``MODEL.WEIGHTS`` when set."""
        self.start_iter = self.checkpointer.resume_or_load(self.cfg.MODEL.WEIGHTS, resume=resume)

    def build_hooks(self):
        cfg = self.cfg
        ret = [hooks.IterationTimer(), hooks.LRSchedulerHook(self.schedule)]
        if cfg.TEST.PRECISE_BN.ENABLED:
            ret.append(hooks.PreciseBN(cfg.TEST.EVAL_PERIOD, lambda: self.build_train_loader(cfg),
                                       cfg.TEST.PRECISE_BN.NUM_ITER))
        if cfg.OUTPUT_DIR:
            ret.append(hooks.PeriodicCheckpointerHook(PeriodicCheckpointer(
                self.checkpointer, cfg.SOLVER.CHECKPOINT_PERIOD, cfg.SOLVER.MAX_ITER)))

        def test_and_save_results():
            self._last_eval_results = self.test(self.cfg, self)
            return self._last_eval_results

        ret.append(hooks.EvalHook(cfg.TEST.EVAL_PERIOD, test_and_save_results))
        ret.append(hooks.PeriodicWriter(self.build_writers(), period=20))
        return ret

    def build_writers(self):
        writers = [CommonMetricPrinter(self.max_iter)]
        if self.cfg.OUTPUT_DIR:
            writers.append(JSONWriter(os.path.join(self.cfg.OUTPUT_DIR, "metrics.json")))
        return writers

    def train(self):
        try:
            super().train(self.start_iter, self.max_iter)
        finally:
            self.data_loader.close()
        if hasattr(self, "_last_eval_results"):
            verify_results(self.cfg, self._last_eval_results)
            return self._last_eval_results

    @classmethod
    def build_train_loader(cls, cfg: CfgNode):
        return build_detection_train_loader(cfg)

    @classmethod
    def build_test_loader(cls, cfg: CfgNode, dataset_name: str):
        return build_detection_test_loader(cfg, dataset_name)

    @classmethod
    def build_evaluator(cls, cfg: CfgNode, dataset_name: str) -> DatasetEvaluator:
        return COCOEvaluator(dataset_name, output_dir=cfg.OUTPUT_DIR, cfg=cfg)

    @classmethod
    def test(cls, cfg: CfgNode, trainer_or_model, evaluators=None):
        """Evaluate on every ``cfg.DATASETS.TEST`` (reference
        ``defaults.py:483-533``) in one process. ``trainer_or_model`` is a
        DefaultTrainer (its model as trained so far) or a CenterNet; the
        network runs in eval mode and gets its mode back. Returns the
        results of the one dataset, or an OrderedDict by dataset name."""
        model = trainer_or_model.model if isinstance(trainer_or_model, DefaultTrainer) else trainer_or_model
        was_training = model.model.training
        model.model.eval()
        results = OrderedDict()
        try:
            for idx, dataset_name in enumerate(cfg.DATASETS.TEST):
                if evaluators is not None:
                    evaluator = evaluators[idx]
                else:
                    try:
                        evaluator = cls.build_evaluator(cfg, dataset_name)
                    except NotImplementedError:
                        logger.warning("No evaluator for %s", dataset_name)
                        results[dataset_name] = {}
                        continue
                data_loader = cls.build_test_loader(cfg, dataset_name)
                try:
                    results_i = inference_on_dataset(model.predict_fn, data_loader, evaluator,
                                                     postprocess=model.postprocess, device=model.device,
                                                     device_postprocess=getattr(model, "device_postprocess", None))
                finally:
                    data_loader.close()
                results[dataset_name] = results_i
                assert isinstance(results_i, dict), results_i
                logger.info("Evaluation results for %s in csv format:", dataset_name)
                print_csv_format(results_i)
        finally:
            model.model.train(was_training)
        if len(results) == 1:
            results = list(results.values())[0]
        return results
