"""The training hooks on the port's path (counterpart of the JAX package's
``engine/hooks.py``; the reference's ``detectron2/engine/hooks.py``):
``IterationTimer``, ``LRSchedulerHook``, ``PeriodicWriter`` and
``PeriodicCheckpointerHook``. ``EvalHook`` and ``PreciseBN`` wait for
evaluation (ROADMAP A10).
"""

import logging
import time
from typing import Callable

from ..utils.events import get_event_storage
from .train_loop import HookBase

logger = logging.getLogger(__name__)

__all__ = ["IterationTimer", "LRSchedulerHook", "PeriodicCheckpointerHook", "PeriodicWriter"]


class IterationTimer(HookBase):
    """Wall time of each step after ``warmup_iter`` steps, as "time". A step
    ends when its work is enqueued; the loss flush every ``metrics_period``
    steps waits for the card, so the mean over a window is the step time."""

    def __init__(self, warmup_iter: int = 3):
        self._warmup_iter = warmup_iter
        self._start_time = time.perf_counter()
        self._step_start = None

    def before_train(self):
        self._start_time = time.perf_counter()

    def after_train(self):
        total = time.perf_counter() - self._start_time
        if self.trainer.iter + 1 - self.trainer.start_iter - self._warmup_iter > 0:
            try:
                avg = self.trainer.storage.history("time").global_avg()
            except KeyError:
                return
            logger.info("Total training time: %.4f s (%.4f s / it avg)", total, avg)

    def before_step(self):
        self._step_start = time.perf_counter()

    def after_step(self):
        if self.trainer.iter - self.trainer.start_iter + 1 > self._warmup_iter:
            get_event_storage().put_scalar("time", time.perf_counter() - self._step_start)


class LRSchedulerHook(HookBase):
    """Record the learning rate the step used, ``schedule(iter)``."""

    def __init__(self, schedule: Callable[[int], float]):
        self._schedule = schedule

    def after_step(self):
        get_event_storage().put_scalar("lr", self._schedule(self.trainer.iter), smoothing_hint=False)


class PeriodicWriter(HookBase):
    """Flush the trainer's pending losses and run the writers every
    ``period`` steps and at the end."""

    def __init__(self, writers, period: int = 20):
        self._writers = writers
        self._period = period

    def after_step(self):
        it = self.trainer.iter
        if (it + 1) % self._period == 0 or it == self.trainer.max_iter - 1:
            self.trainer._flush_metrics()
            for writer in self._writers:
                writer.write()

    def after_train(self):
        for writer in self._writers:
            writer.write()
            writer.close()


class PeriodicCheckpointerHook(HookBase):
    """Drive a ``checkpoint.PeriodicCheckpointer`` from the loop."""

    def __init__(self, periodic_checkpointer):
        self._pc = periodic_checkpointer

    def before_train(self):
        self._pc.max_iter = self.trainer.max_iter

    def after_step(self):
        self._pc.step(self.trainer.iter)
