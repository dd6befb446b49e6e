"""Models of the port. Importing this package registers the backbones
(DLA-34, ResNet, ResNet-deconv, ResNet-FPN, VoVNet, TridentNet's ResNet) and
the CenterNet, RetinaNet, GeneralizedRCNN, ProposalNetwork, RotatedRCNN,
TridentRCNN, SemanticSegmentor and PanopticFPN meta-architectures."""

from . import backbones, meta_arch  # noqa: F401  (registration)
from .build import build_model, resolve_device
from .registry import BACKBONE_REGISTRY, META_ARCH_REGISTRY

__all__ = ["BACKBONE_REGISTRY", "META_ARCH_REGISTRY", "build_model", "resolve_device"]
