from .dla import DLA34, build_dla34_backbone
from .resnet import ResNet, build_resnet_backbone, build_resnet_deconv_backbone
from .vovnet import VoVNet, build_vovnet_backbone

__all__ = ["DLA34", "ResNet", "VoVNet", "build_dla34_backbone", "build_resnet_backbone",
           "build_resnet_deconv_backbone", "build_vovnet_backbone"]
