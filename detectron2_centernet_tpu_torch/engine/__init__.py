from . import hooks
from .defaults import DefaultPredictor, DefaultTrainer
from .train_loop import HookBase, SimpleTrainer, TrainerBase

__all__ = ["DefaultPredictor", "DefaultTrainer", "HookBase", "SimpleTrainer", "TrainerBase", "hooks"]
