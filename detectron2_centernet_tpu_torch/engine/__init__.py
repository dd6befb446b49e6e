from .defaults import DefaultPredictor

__all__ = ["DefaultPredictor"]
