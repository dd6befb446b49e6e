from .dla import DLA34, build_dla34_backbone

__all__ = ["DLA34", "build_dla34_backbone"]
