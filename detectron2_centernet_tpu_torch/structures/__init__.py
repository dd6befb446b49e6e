from .boxes import Boxes
from .instances import Instances

__all__ = ["Boxes", "Instances"]
