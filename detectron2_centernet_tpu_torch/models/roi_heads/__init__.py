from .box_head import F32Linear, FastRCNNConvFCHead, FastRCNNOutputLayers
from .roi_heads import fast_rcnn_inference, fast_rcnn_losses, label_and_sample_proposals

__all__ = ["F32Linear", "FastRCNNConvFCHead", "FastRCNNOutputLayers", "fast_rcnn_inference", "fast_rcnn_losses",
           "label_and_sample_proposals"]
