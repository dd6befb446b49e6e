"""Models of the port. Importing this package registers the DLA-34 backbone
and the CenterNet meta-architecture."""

from . import backbones, meta_arch  # noqa: F401  (registration)
from .build import build_model, resolve_device
from .registry import BACKBONE_REGISTRY, META_ARCH_REGISTRY

__all__ = ["BACKBONE_REGISTRY", "META_ARCH_REGISTRY", "build_model", "resolve_device"]
