from .box_head import F32Linear, FastRCNNConvFCHead, FastRCNNOutputLayers
from .keypoint_head import KRCNNConvDeconvUpsampleHead, encode_keypoint_targets, keypoint_rcnn_loss
from .mask_head import MaskRCNNConvUpsampleHead, crop_gt_masks, mask_rcnn_loss
from .roi_heads import fast_rcnn_inference, fast_rcnn_losses, label_and_sample_proposals

__all__ = ["F32Linear", "FastRCNNConvFCHead", "FastRCNNOutputLayers", "KRCNNConvDeconvUpsampleHead",
           "MaskRCNNConvUpsampleHead", "crop_gt_masks", "encode_keypoint_targets", "fast_rcnn_inference",
           "fast_rcnn_losses", "keypoint_rcnn_loss", "label_and_sample_proposals", "mask_rcnn_loss"]
