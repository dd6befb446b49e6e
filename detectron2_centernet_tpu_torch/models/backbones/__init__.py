from .dla import DLA34, build_dla34_backbone
from .fpn import FPN, build_resnet_fpn_backbone, build_retinanet_resnet_fpn_backbone
from .resnet import ResNet, build_resnet_backbone, build_resnet_deconv_backbone
from .trident import TridentResNet, build_trident_resnet_backbone
from .vovnet import VoVNet, build_vovnet_backbone

__all__ = ["DLA34", "FPN", "ResNet", "TridentResNet", "VoVNet", "build_dla34_backbone", "build_resnet_backbone",
           "build_resnet_deconv_backbone", "build_resnet_fpn_backbone", "build_retinanet_resnet_fpn_backbone",
           "build_trident_resnet_backbone", "build_vovnet_backbone"]
