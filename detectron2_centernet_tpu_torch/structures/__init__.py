from .boxes import Boxes, BoxMode
from .instances import Instances

__all__ = ["BoxMode", "Boxes", "Instances"]
