from .dcn import modulated_deform_conv, modulated_deform_conv_ad
from .decode import ctdet_decode, heat_nms
from .nms import batched_nms_fixed, nms_fixed, pairwise_iou_xyxy

__all__ = ["batched_nms_fixed", "ctdet_decode", "heat_nms", "modulated_deform_conv", "modulated_deform_conv_ad",
           "nms_fixed", "pairwise_iou_xyxy"]
