"""Model zoo accessors (counterpart of the JAX package's
``model_zoo/model_zoo.py``; reference ``detectron2/model_zoo/model_zoo.py``):
the config lookup.

Config paths map to the repository's ``configs/`` tree, read by the port's
own YAML reader, and to the reference's published checkpoints (the port
keeps its own copy of the table). There is no network here: ``get(...,
trained=True)`` needs the checkpoint on disk (``weights_path``), which the
port's ``MODEL.WEIGHTS`` loader aligns (``checkpoint/torch_import.py``), and
raises naming the file to fetch otherwise.
"""

import os
from typing import Optional

from ..config import CfgNode, get_cfg

__all__ = ["get", "get_checkpoint_url", "get_config", "get_config_file"]

_CONFIG_ROOT = os.path.join(os.path.dirname(__file__), "..", "..", "configs")

_S3_PREFIX = "https://dl.fbaipublicfiles.com/detectron2/"

# config path -> model_id/model_final_{commit}.pkl — the complete released
# artifact table from the reference (model_zoo/model_zoo.py:19-86); with it,
# every zoo checkpoint can be batch-validated through the torch-weight
# aligner the moment the files are mounted locally.
_URL_SUFFIXES = {
    # COCO Detection with Faster R-CNN
    "COCO-Detection/faster_rcnn_R_50_C4_1x.yaml": "137257644/model_final_721ade.pkl",
    "COCO-Detection/faster_rcnn_R_50_DC5_1x.yaml": "137847829/model_final_51d356.pkl",
    "COCO-Detection/faster_rcnn_R_50_FPN_1x.yaml": "137257794/model_final_b275ba.pkl",
    "COCO-Detection/faster_rcnn_R_50_C4_3x.yaml": "137849393/model_final_f97cb7.pkl",
    "COCO-Detection/faster_rcnn_R_50_DC5_3x.yaml": "137849425/model_final_68d202.pkl",
    "COCO-Detection/faster_rcnn_R_50_FPN_3x.yaml": "137849458/model_final_280758.pkl",
    "COCO-Detection/faster_rcnn_R_101_C4_3x.yaml": "138204752/model_final_298dad.pkl",
    "COCO-Detection/faster_rcnn_R_101_DC5_3x.yaml": "138204841/model_final_3e0943.pkl",
    "COCO-Detection/faster_rcnn_R_101_FPN_3x.yaml": "137851257/model_final_f6e8b1.pkl",
    "COCO-Detection/faster_rcnn_X_101_32x8d_FPN_3x.yaml": "139173657/model_final_68b088.pkl",
    # COCO Detection with RetinaNet
    "COCO-Detection/retinanet_R_50_FPN_1x.yaml": "190397773/model_final_bfca0b.pkl",
    "COCO-Detection/retinanet_R_50_FPN_3x.yaml": "190397829/model_final_5bd44e.pkl",
    "COCO-Detection/retinanet_R_101_FPN_3x.yaml": "190397697/model_final_971ab9.pkl",
    # COCO Detection with RPN and Fast R-CNN
    "COCO-Detection/rpn_R_50_C4_1x.yaml": "137258005/model_final_450694.pkl",
    "COCO-Detection/rpn_R_50_FPN_1x.yaml": "137258492/model_final_02ce48.pkl",
    "COCO-Detection/fast_rcnn_R_50_FPN_1x.yaml": "137635226/model_final_e5f7ce.pkl",
    # COCO Instance Segmentation with Mask R-CNN
    "COCO-InstanceSegmentation/mask_rcnn_R_50_C4_1x.yaml": "137259246/model_final_9243eb.pkl",
    "COCO-InstanceSegmentation/mask_rcnn_R_50_DC5_1x.yaml": "137260150/model_final_4f86c3.pkl",
    "COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.yaml": "137260431/model_final_a54504.pkl",
    "COCO-InstanceSegmentation/mask_rcnn_R_50_C4_3x.yaml": "137849525/model_final_4ce675.pkl",
    "COCO-InstanceSegmentation/mask_rcnn_R_50_DC5_3x.yaml": "137849551/model_final_84107b.pkl",
    "COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_3x.yaml": "137849600/model_final_f10217.pkl",
    "COCO-InstanceSegmentation/mask_rcnn_R_101_C4_3x.yaml": "138363239/model_final_a2914c.pkl",
    "COCO-InstanceSegmentation/mask_rcnn_R_101_DC5_3x.yaml": "138363294/model_final_0464b7.pkl",
    "COCO-InstanceSegmentation/mask_rcnn_R_101_FPN_3x.yaml": "138205316/model_final_a3ec72.pkl",
    "COCO-InstanceSegmentation/mask_rcnn_X_101_32x8d_FPN_3x.yaml": "139653917/model_final_2d9806.pkl",
    # COCO Person Keypoint Detection with Keypoint R-CNN
    "COCO-Keypoints/keypoint_rcnn_R_50_FPN_1x.yaml": "137261548/model_final_04e291.pkl",
    "COCO-Keypoints/keypoint_rcnn_R_50_FPN_3x.yaml": "137849621/model_final_a6e10b.pkl",
    "COCO-Keypoints/keypoint_rcnn_R_101_FPN_3x.yaml": "138363331/model_final_997cc7.pkl",
    "COCO-Keypoints/keypoint_rcnn_X_101_32x8d_FPN_3x.yaml": "139686956/model_final_5ad38f.pkl",
    # COCO Panoptic Segmentation with Panoptic FPN
    "COCO-PanopticSegmentation/panoptic_fpn_R_50_1x.yaml": "139514544/model_final_dbfeb4.pkl",
    "COCO-PanopticSegmentation/panoptic_fpn_R_50_3x.yaml": "139514569/model_final_c10459.pkl",
    "COCO-PanopticSegmentation/panoptic_fpn_R_101_3x.yaml": "139514519/model_final_cafdb1.pkl",
    # LVIS Instance Segmentation with Mask R-CNN
    "LVIS-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.yaml": "144219072/model_final_571f7c.pkl",
    "LVIS-InstanceSegmentation/mask_rcnn_R_101_FPN_1x.yaml": "144219035/model_final_824ab5.pkl",
    "LVIS-InstanceSegmentation/mask_rcnn_X_101_32x8d_FPN_1x.yaml": "144219108/model_final_5e3439.pkl",
    # Cityscapes & Pascal VOC
    "Cityscapes/mask_rcnn_R_50_FPN.yaml": "142423278/model_final_af9cf5.pkl",
    "PascalVOC-Detection/faster_rcnn_R_50_C4.yaml": "142202221/model_final_b1acc2.pkl",
    # Other settings
    "Misc/mask_rcnn_R_50_FPN_1x_dconv_c3-c5.yaml": "138602867/model_final_65c703.pkl",
    "Misc/mask_rcnn_R_50_FPN_3x_dconv_c3-c5.yaml": "144998336/model_final_821d0b.pkl",
    "Misc/cascade_mask_rcnn_R_50_FPN_1x.yaml": "138602847/model_final_e9d89b.pkl",
    "Misc/cascade_mask_rcnn_R_50_FPN_3x.yaml": "144998488/model_final_480dd8.pkl",
    "Misc/mask_rcnn_R_50_FPN_3x_syncbn.yaml": "169527823/model_final_3b3c51.pkl",
    "Misc/mask_rcnn_R_50_FPN_3x_gn.yaml": "138602888/model_final_dc5d9e.pkl",
    "Misc/scratch_mask_rcnn_R_50_FPN_3x_gn.yaml": "138602908/model_final_01ca85.pkl",
    "Misc/panoptic_fpn_R_101_dconv_cascade_gn_3x.yaml": "139797668/model_final_be35db.pkl",
    "Misc/cascade_mask_rcnn_X_152_32x8d_FPN_IN5k_gn_dconv.yaml": "18131413/model_0039999_e76410.pkl",
    # Detectron1 comparisons
    "Detectron1-Comparisons/faster_rcnn_R_50_FPN_noaug_1x.yaml": "137781054/model_final_7ab50c.pkl",
    "Detectron1-Comparisons/mask_rcnn_R_50_FPN_noaug_1x.yaml": "137781281/model_final_62ca52.pkl",
    "Detectron1-Comparisons/keypoint_rcnn_R_50_FPN_1x.yaml": "137781195/model_final_cce136.pkl",
}

_MODEL_URLS = {
    cfg: _S3_PREFIX + cfg.replace(".yaml", "") + "/" + suffix
    for cfg, suffix in _URL_SUFFIXES.items()
}


def get_config_file(config_path: str) -> str:
    """The absolute path of ``configs/<config_path>``; raises when it is not there."""
    path = os.path.abspath(os.path.join(_CONFIG_ROOT, config_path))
    if not os.path.exists(path):
        raise RuntimeError(f"{config_path} not available in configs/!")
    return path


def get_checkpoint_url(config_path: str) -> str:
    """The reference's published checkpoint of ``config_path``."""
    if config_path not in _MODEL_URLS:
        raise RuntimeError(f"{config_path} not available in Model Zoo!")
    return _MODEL_URLS[config_path]


def get_config(config_path: str) -> CfgNode:
    """The config of ``config_path``, through the port's YAML reader."""
    cfg = get_cfg()
    cfg.merge_from_file(get_config_file(config_path))
    return cfg


def get(config_path: str, trained: bool = False, weights_path: Optional[str] = None):
    """The meta-architecture of a zoo config, built on its
    ``cfg.MODEL.DEVICE``. With ``trained=True``, ``weights_path`` must name
    the reference checkpoint on disk (there is no download); it loads
    through the ``MODEL.WEIGHTS`` loader."""
    from ..checkpoint.torch_import import load_model_weights
    from ..models import build_model

    cfg = get_config(config_path)
    model = build_model(cfg)
    if trained:
        url = get_checkpoint_url(config_path)
        if not weights_path or not os.path.exists(weights_path):
            raise FileNotFoundError(
                f"trained=True needs a local checkpoint; download {url} and pass weights_path"
                + (f" ({weights_path} does not exist)" if weights_path else ""))
        load_model_weights(model.model, weights_path, per_collection=False)
    return model
