from .centernet import CenterNet, CenterNetModel
from .rcnn import GeneralizedRCNN, ProposalNetwork, RCNNModel
from .retinanet import RetinaNet, RetinaNetModel

__all__ = ["CenterNet", "CenterNetModel", "GeneralizedRCNN", "ProposalNetwork", "RCNNModel", "RetinaNet",
           "RetinaNetModel"]
