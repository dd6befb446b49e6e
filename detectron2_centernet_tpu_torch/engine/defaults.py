"""Inference and training from a config (counterpart of the JAX package's
``engine/defaults.py``: ``DefaultPredictor`` and ``DefaultTrainer``).

Evaluation (``DefaultTrainer.test``, ``EvalHook``, ``PreciseBN``) is not
ported yet (ROADMAP A10).
"""

import logging
import os
from typing import Dict

import numpy as np
import torch

from ..checkpoint import Checkpointer, PeriodicCheckpointer
from ..config import CfgNode
from ..data import build_detection_train_loader, letterbox_transform, warp_image
from ..models import build_model
from ..solver import build_lr_scheduler, build_optimizer
from ..utils.events import CommonMetricPrinter, JSONWriter
from . import hooks
from .train_loop import SimpleTrainer

logger = logging.getLogger(__name__)


def load_weights(model: torch.nn.Module, path: str) -> None:
    """Load a torch checkpoint whose keys are the reference fork's (a bare
    state dict, or one under "model" or "state_dict"; a DataParallel
    "module." prefix is dropped). Every key must match."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    for wrapper in ("model", "state_dict"):
        if isinstance(data, dict) and wrapper in data:
            data = data[wrapper]
    model.load_state_dict({k.removeprefix("module."): v for k, v in data.items()})


class DefaultPredictor:
    """One image per call, with the config's test transform: BGR/RGB per
    ``INPUT.FORMAT``, the ctdet letterbox warped on the model's device, one
    forward, the decode, and ``{"instances": Instances}`` in the image's own
    pixels. Batches go through ``CenterNet.predict_fn`` directly."""

    def __init__(self, cfg: CfgNode) -> None:
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
        dets = {k: v.cpu().numpy() for k, v in dets.items()}
        return self.model.postprocess(dets, [m], [(h, w)])[0]


class DefaultTrainer(SimpleTrainer):
    """The train-from-config workflow on one device (``cfg.MODEL.DEVICE``):
    the model, the optimizer and its LR schedule, the train loader over
    ``DATASETS.TRAIN`` (register it first, e.g. with
    ``data.datasets.ensure_synthetic_datasets``), the checkpointer and the
    hooks. ``resume_or_load()``, then ``train()``."""

    def __init__(self, cfg: CfgNode) -> None:
        if cfg.TEST.PRECISE_BN.ENABLED:
            raise NotImplementedError("PreciseBN is not ported yet (ROADMAP A10)")
        self.cfg = cfg
        model = build_model(cfg)
        optimizer, scheduler = build_optimizer(cfg, model.model)
        super().__init__(model, build_detection_train_loader(cfg), optimizer, scheduler)
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
        if cfg.OUTPUT_DIR:
            ret.append(hooks.PeriodicCheckpointerHook(PeriodicCheckpointer(
                self.checkpointer, cfg.SOLVER.CHECKPOINT_PERIOD, cfg.SOLVER.MAX_ITER)))
        ret.append(hooks.PeriodicWriter(self.build_writers(), period=20))
        return ret

    def build_writers(self):
        writers = [CommonMetricPrinter(self.max_iter)]
        if self.cfg.OUTPUT_DIR:
            writers.append(JSONWriter(os.path.join(self.cfg.OUTPUT_DIR, "metrics.json")))
        return writers

    def train(self) -> None:
        try:
            super().train(self.start_iter, self.max_iter)
        finally:
            self.data_loader.close()

    @classmethod
    def test(cls, cfg: CfgNode, model, evaluators=None):
        raise NotImplementedError(
            "evaluation (inference_on_dataset, COCOEvaluator) is not ported yet (ROADMAP A10)"
        )
