"""Checkpointing with ``torch.save`` (counterpart of the JAX package's
``checkpoint/checkpointer.py``; the reference's ``DetectionCheckpointer`` and
``PeriodicCheckpointer``).

A checkpoint is one file ``<name>.pth`` holding ``{"model": state_dict,
"optimizer": state_dict, "scheduler": state_dict, "iteration": int}``, with a
``last_checkpoint`` file naming the newest. ``resume_or_load`` resumes from
it, or loads weights alone from ``MODEL.WEIGHTS``: a checkpoint of the same
network (the port's, a reference ``.pth`` with its keys, a JAX tree saved
through ``checkpoint/from_jax.py::state_dict_from_jax``) strictly; any other
``.pth`` or ``.pkl`` (an ImageNet trunk, a partial checkpoint) aligned by
shape and name as the JAX package's trainer aligns it, its ``params`` and
``batch_stats`` apart (``checkpoint/torch_import.py``).
"""

import logging
import os
from typing import Optional

import torch

from .torch_import import load_model_weights, own_checkpoint

logger = logging.getLogger(__name__)

__all__ = ["Checkpointer", "PeriodicCheckpointer"]


class Checkpointer:
    def __init__(self, model: torch.nn.Module, save_dir: str = "", *, optimizer=None,
                 scheduler=None) -> None:
        self.model = model
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.save_dir = os.path.abspath(save_dir) if save_dir else ""

    def save(self, name: str, iteration: int) -> str:
        """Write ``<save_dir>/<name>.pth`` and point ``last_checkpoint`` at it."""
        if not self.save_dir:
            raise ValueError("a Checkpointer without save_dir cannot save")
        os.makedirs(self.save_dir, exist_ok=True)
        path = os.path.join(self.save_dir, f"{name}.pth")
        data = {"model": self.model.state_dict(), "iteration": int(iteration)}
        if self.optimizer is not None:
            data["optimizer"] = self.optimizer.state_dict()
        if self.scheduler is not None:
            data["scheduler"] = self.scheduler.state_dict()
        logger.info("Saving checkpoint to %s", path)
        torch.save(data, path + ".tmp")
        os.replace(path + ".tmp", path)
        with open(os.path.join(self.save_dir, "last_checkpoint"), "w") as f:
            f.write(os.path.basename(path))
        return path

    def load(self, path: str, weights_only: bool = False) -> int:
        """Load ``path`` into the model (and, unless ``weights_only``, the
        optimizer and scheduler); returns the iteration to start from (0 for
        weights alone). A checkpoint of this network (a bare state dict, or
        one under "model" or "state_dict", with or without a DataParallel
        "module." prefix) loads strictly; with ``weights_only`` any other
        file is aligned (``torch_import.load_model_weights``)."""
        if weights_only:
            data = load_model_weights(self.model, path, per_collection=True)
        else:
            data = torch.load(path, map_location="cpu", weights_only=True)
            state = own_checkpoint(self.model, data)
            if state is None:
                raise ValueError(f"{path} is not a checkpoint of this network: resume takes the port's own")
            self.model.load_state_dict(state)
        if weights_only or not isinstance(data, dict) or "iteration" not in data:
            return 0
        if self.optimizer is not None and "optimizer" in data:
            self.optimizer.load_state_dict(data["optimizer"])
        if self.scheduler is not None and "scheduler" in data:
            self.scheduler.load_state_dict(data["scheduler"])
        return int(data["iteration"]) + 1

    def has_checkpoint(self) -> bool:
        return bool(self.save_dir) and os.path.exists(os.path.join(self.save_dir, "last_checkpoint"))

    def get_checkpoint_file(self) -> str:
        with open(os.path.join(self.save_dir, "last_checkpoint")) as f:
            return os.path.join(self.save_dir, f.read().strip())

    def resume_or_load(self, path: str, *, resume: bool = True) -> int:
        """Resume from the newest checkpoint when ``resume`` and there is one;
        else load the weights of ``path`` (none when empty). Returns the
        iteration to start from."""
        if resume and self.has_checkpoint():
            return self.load(self.get_checkpoint_file())
        if path:
            return self.load(path, weights_only=True)
        logger.info("No checkpoint given; using random initialization.")
        return 0


class PeriodicCheckpointer:
    """Save every ``period`` iterations and at the last one."""

    def __init__(self, checkpointer: Checkpointer, period: int, max_iter: Optional[int] = None) -> None:
        self.checkpointer = checkpointer
        self.period = int(period)
        self.max_iter = max_iter

    def step(self, iteration: int) -> None:
        if self.period > 0 and (iteration + 1) % self.period == 0:
            self.checkpointer.save(f"model_{iteration:07d}", iteration)
        if self.max_iter is not None and iteration >= self.max_iter - 1:
            self.checkpointer.save("model_final", iteration)
