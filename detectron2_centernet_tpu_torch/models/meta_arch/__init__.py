from .centernet import CenterNet, CenterNetModel
from .retinanet import RetinaNet, RetinaNetModel

__all__ = ["CenterNet", "CenterNetModel", "RetinaNet", "RetinaNetModel"]
