from .centernet import CenterNet, CenterNetModel

__all__ = ["CenterNet", "CenterNetModel"]
