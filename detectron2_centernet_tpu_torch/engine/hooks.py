"""The training hooks on the port's path (counterpart of the JAX package's
``engine/hooks.py``; the reference's ``detectron2/engine/hooks.py``):
``IterationTimer``, ``LRSchedulerHook``, ``PeriodicWriter``,
``PeriodicCheckpointerHook``, ``EvalHook`` and ``PreciseBN``.
"""

import logging
import time
from typing import Callable, Iterable

import numpy as np
import torch

from ..evaluation.testing import flatten_results_dict
from ..utils.events import get_event_storage
from .train_loop import HookBase

logger = logging.getLogger(__name__)

__all__ = ["EvalHook", "IterationTimer", "LRSchedulerHook", "PeriodicCheckpointerHook",
           "PeriodicWriter", "PreciseBN"]


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


class EvalHook(HookBase):
    """Run ``eval_function`` every ``eval_period`` steps and after the last
    step, also when ``eval_period`` is 0 (reference ``hooks.py:300-355``);
    the flattened results go to the EventStorage."""

    def __init__(self, eval_period: int, eval_function: Callable):
        self._period = eval_period
        self._func = eval_function

    def _do_eval(self):
        results = self._func()
        if results:
            assert isinstance(results, dict), f"Eval function must return a dict. Got {results} instead."
            storage = get_event_storage()
            for k, v in flatten_results_dict(results).items():
                try:
                    storage.put_scalar(k, float(v), smoothing_hint=False)
                except (ValueError, TypeError) as e:
                    raise ValueError(
                        f"[EvalHook] eval_function should return a nested dict of float. Got '{k}: {v}' instead."
                    ) from e

    def after_step(self):
        next_iter = self.trainer.iter + 1
        if self._period > 0 and next_iter % self._period == 0 and next_iter != self.trainer.max_iter:
            self._do_eval()

    def after_train(self):
        if self.trainer.iter + 1 >= self.trainer.max_iter:
            self._do_eval()
        del self._func


class PreciseBN(HookBase):
    """Recompute every BatchNorm's running statistics as a true average over
    ``num_iter`` train batches (reference ``hooks.py:357-418``; the JAX
    package's ``PreciseBN``, ``engine/hooks.py:214-275``), every ``period``
    steps and at the last step, before the checkpointer and the evaluation.

    Each batch runs the network forward only, without gradients, in train
    mode (BatchNorm on batch statistics), on the normalized images and no
    color jitter, as the JAX package's ``forward_stats``. Every BatchNorm's
    input gives this batch's mean and *biased* variance, the statistics
    flax's BatchNorm folds; the ``num_iter`` batches are averaged with equal
    weight and written into ``running_mean`` and ``running_var``. The modules'
    ``momentum`` is not touched: with ``momentum=None`` torch would average
    the unbiased variance instead. The mode and ``num_batches_tracked`` are
    restored.

    ``build_data_loader`` makes the batches' loader (host batches with a
    uint8 (N, H, W, 3) ``image``) at the first update, so it does not
    prefetch while nothing reads it; it is closed after training."""

    def __init__(self, period: int, build_data_loader: Callable[[], Iterable], num_iter: int = 200):
        self._period = period
        self._build_data_loader = build_data_loader
        self._num_iter = num_iter
        self._data_loader = None
        self._data_iter = None

    @torch.no_grad()
    def update_stats(self) -> None:
        model = self.trainer.model
        net = model.model
        bns = [m for m in net.modules() if isinstance(m, torch.nn.BatchNorm2d) and m.track_running_stats]
        if not bns:
            return
        if self._data_iter is None:
            self._data_loader = self._build_data_loader()
            self._data_iter = iter(self._data_loader)
        sums = {bn: [0.0, 0.0] for bn in bns}

        def accumulate(bn, inputs):
            var, mean = torch.var_mean(inputs[0].float(), dim=(0, 2, 3), unbiased=False)
            sums[bn][0] = sums[bn][0] + mean
            sums[bn][1] = sums[bn][1] + var

        handles = [bn.register_forward_pre_hook(accumulate) for bn in bns]
        tracked = [bn.num_batches_tracked.clone() for bn in bns]
        was_training = net.training
        net.train()
        try:
            for _ in range(self._num_iter):
                batch = next(self._data_iter)
                images = torch.from_numpy(np.ascontiguousarray(batch["image"])).to(model.device, non_blocking=True)
                net(model.normalize(images.permute(0, 3, 1, 2)))
        finally:
            for h in handles:
                h.remove()
            net.train(was_training)
        for bn, count in zip(bns, tracked):
            bn.running_mean.copy_(sums[bn][0] / self._num_iter)
            bn.running_var.copy_(sums[bn][1] / self._num_iter)
            bn.num_batches_tracked.copy_(count)
        logger.info("PreciseBN updated the statistics of %d BatchNorms over %d batches", len(bns), self._num_iter)

    def after_step(self):
        next_iter = self.trainer.iter + 1
        if (self._period > 0 and next_iter % self._period == 0) or next_iter == self.trainer.max_iter:
            self.update_stats()

    def after_train(self):
        close = getattr(self._data_loader, "close", None)
        if close is not None:
            close()
