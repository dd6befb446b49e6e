from .centernet import CenterNet, CenterNetModel
from .panoptic_fpn import PanopticFPN, combine_semantic_and_instance_outputs
from .rcnn import GeneralizedRCNN, ProposalNetwork, RCNNModel
from .retinanet import RetinaNet, RetinaNetModel
from .rotated_rcnn import RotatedRCNN
from .semantic_seg import SemanticSegmentor, SemSegFPNHead, sem_seg_loss
from .trident_rcnn import TridentRCNN

__all__ = ["CenterNet", "CenterNetModel", "GeneralizedRCNN", "PanopticFPN", "ProposalNetwork", "RCNNModel",
           "RetinaNet", "RetinaNetModel", "RotatedRCNN", "SemSegFPNHead", "SemanticSegmentor", "TridentRCNN",
           "combine_semantic_and_instance_outputs", "sem_seg_loss"]
