"""Training loop: the hook protocol, the trainer base and ``SimpleTrainer``
(counterpart of the JAX package's ``engine/train_loop.py``; the reference's
``detectron2/engine/train_loop.py`` contract).

``SimpleTrainer.run_step`` is one eager PyTorch step: the batch to the
device, the color jitter there (drawn from the step's generator, which
``loss_fn`` gets as ``batch["generator"]`` for its own draws), the forward at the model's width with f32
parameters, ``loss_fn``, the backward (through the DCN backward kernels on a
card; its f32 convolutions in IEEE f32, as the forward's), the optimizer
step and the scheduler step. Loss values stay on the
device and are copied to the host together every ``metrics_period`` steps,
where the NaN check runs (``FloatingPointError``, as the reference's
``_detect_anomaly``), so the loop does not wait on the card every step.
"""

import logging
import time
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.layers import ieee_f32
from ..utils.events import EventStorage

logger = logging.getLogger(__name__)

__all__ = ["HookBase", "TrainerBase", "SimpleTrainer"]

AUGMENT_SEED = 23  # the per-step jitter stream is seeded from (AUGMENT_SEED, iteration)


class HookBase:
    """The four-phase hook protocol; ``self.trainer`` is set by
    ``TrainerBase.register_hooks``."""

    trainer: "TrainerBase"

    def before_train(self) -> None:
        pass

    def after_train(self) -> None:
        pass

    def before_step(self) -> None:
        pass

    def after_step(self) -> None:
        pass


class TrainerBase:
    def __init__(self) -> None:
        self._hooks: List[HookBase] = []
        self.iter: int = 0
        self.start_iter: int = 0
        self.max_iter: int = 0
        self.storage: Optional[EventStorage] = None

    def register_hooks(self, hooks) -> None:
        hooks = [h for h in hooks if h is not None]
        for h in hooks:
            if not isinstance(h, HookBase):
                raise TypeError(f"{h!r} is not a HookBase")
            # a weak back-pointer, as the reference: no hook <-> trainer cycle
            h.trainer = weakref.proxy(self)
        self._hooks.extend(hooks)

    def train(self, start_iter: int, max_iter: int) -> None:
        logger.info("Starting training from iteration %d", start_iter)
        self.iter = self.start_iter = start_iter
        self.max_iter = max_iter
        with EventStorage(start_iter) as self.storage:
            try:
                self.before_train()
                for self.iter in range(start_iter, max_iter):
                    self.before_step()
                    self.run_step()
                    self.after_step()
                # the reference leaves iter at max_iter after a full run
                self.iter += 1
            finally:
                self.after_train()

    def before_train(self) -> None:
        for h in self._hooks:
            h.before_train()

    def after_train(self) -> None:
        if self.storage is not None:
            self.storage._iter = self.iter
        for h in self._hooks:
            h.after_train()

    def before_step(self) -> None:
        if self.storage is not None:
            self.storage._iter = self.iter
        for h in self._hooks:
            h.before_step()

    def after_step(self) -> None:
        for h in self._hooks:
            h.after_step()

    def run_step(self) -> None:
        raise NotImplementedError


class SimpleTrainer(TrainerBase):
    """One model, one device.

    model: a meta-architecture with ``model`` (the nn.Module), ``device``,
      ``loss_fn(batch)`` and ``device_augment`` (None or a batch jitter);
    data_loader: an iterator of host batches (stacked numpy arrays; image
      (N, H, W, 3) uint8);
    optimizer, scheduler: from ``solver.build_optimizer``.
    """

    BATCH_KEYS = ("gt_boxes", "gt_classes", "gt_valid")
    # the mapper's, with MODEL.MASK_ON / KEYPOINT_ON / LOAD_PROPOSALS, and sem_seg when the records carry labels
    OPTIONAL_KEYS = ("gt_masks", "gt_keypoints", "proposal_boxes", "proposal_valid", "sem_seg")

    def __init__(self, model, data_loader, optimizer, scheduler, metrics_period: int = 20) -> None:
        super().__init__()
        self.model = model
        self.data_loader = data_loader
        self._data_loader_iter = iter(data_loader)
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.metrics_period = max(1, metrics_period)
        self._pending: List[Dict] = []
        self._generator = torch.Generator(device=model.device)
        # every gradient exists and starts at 0: a parameter the step does not
        # reach (a Tree's projection when it is handed a residual) still gets
        # its weight decay and momentum, as under optax, where its gradient is 0
        for group in optimizer.param_groups:
            for p in group["params"]:
                p.grad = torch.zeros_like(p)

    def to_device(self, data: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The host batch as the loss takes it: image (N, 3, H, W) f32, the
        gt arrays as they are (masks, keypoints, precomputed proposals and
        the sem-seg labels when the mapper made them; the labels shipped as
        the mapper's int32 and widened to int64 on the device)."""
        dev = self.model.device
        keys = self.BATCH_KEYS + tuple(k for k in self.OPTIONAL_KEYS if k in data)
        batch = {k: torch.from_numpy(data[k]).to(dev, non_blocking=True) for k in keys}
        if "sem_seg" in batch:
            batch["sem_seg"] = batch["sem_seg"].long()
        image = torch.from_numpy(data["image"]).to(dev, non_blocking=True)
        batch["image"] = image.permute(0, 3, 1, 2).to(torch.float32)
        return batch

    def run_step(self) -> None:
        start = time.perf_counter()
        data = next(self._data_loader_iter)
        data_time = time.perf_counter() - start

        batch = self.to_device(data)
        self._generator.manual_seed(AUGMENT_SEED * 1_000_003 + self.iter)
        if self.model.device_augment is not None:
            batch["image"] = self.model.device_augment(batch["image"], self._generator)
        batch["generator"] = self._generator  # the step's further draws (R-CNN's samplers)
        self.model.model.train()
        total, losses = self.model.loss_fn(batch)
        self.optimizer.zero_grad(set_to_none=False)
        with ieee_f32():  # the backward's f32 convolutions too
            total.backward()
        self.optimizer.step()
        self.scheduler.step()

        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        self._pending.append({"iter": self.iter, "data_time": data_time, "metrics": metrics})
        if len(self._pending) >= self.metrics_period or self.iter >= self.max_iter - 1:
            self._flush_metrics()

    def _flush_metrics(self) -> None:
        """Copy the buffered loss values to the host at once, check them and
        put them into the storage under their own iterations."""
        if not self._pending:
            return
        names = list(self._pending[0]["metrics"])
        values = torch.stack([torch.stack([e["metrics"][k].float() for k in names])
                              for e in self._pending]).cpu().numpy()
        storage = self.storage
        saved_iter = storage._iter if storage is not None else None
        for entry, row in zip(self._pending, values):
            host = dict(zip(names, row.tolist()))
            if not np.isfinite(host["total_loss"]):
                raise FloatingPointError(
                    f"Loss became infinite or NaN at iteration={entry['iter']}!\nloss_dict = {host}"
                )
            if storage is not None:
                storage._iter = entry["iter"]
                storage.put_scalar("data_time", entry["data_time"])
                for k, v in host.items():
                    storage.put_scalar(k, v)
        if storage is not None:
            storage._iter = saved_iter
        self._pending = []

    def after_train(self) -> None:
        self._flush_metrics()
        super().after_train()
