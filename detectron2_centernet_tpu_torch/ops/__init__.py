from .dcn import modulated_deform_conv, modulated_deform_conv_ad
from .decode import ctdet_decode, heat_nms

__all__ = ["ctdet_decode", "heat_nms", "modulated_deform_conv", "modulated_deform_conv_ad"]
