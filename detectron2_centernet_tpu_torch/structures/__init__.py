from .boxes import Boxes, BoxMode
from .instances import Instances
from .rotated_boxes import RotatedBoxes

__all__ = ["BoxMode", "Boxes", "Instances", "RotatedBoxes"]
