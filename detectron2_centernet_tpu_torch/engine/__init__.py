from . import hooks
from .defaults import DefaultPredictor, DefaultTrainer, default_argument_parser, default_setup, launch
from .train_loop import HookBase, SimpleTrainer, TrainerBase

__all__ = ["DefaultPredictor", "DefaultTrainer", "HookBase", "SimpleTrainer", "TrainerBase",
           "default_argument_parser", "default_setup", "hooks", "launch"]
