"""DatasetMapper: dataset dict → fixed-shape model-input arrays
(counterpart of the JAX package's ``data/dataset_mapper.py``, ``:128-206``
and ``:240-251``).

Train: one affine warp (random scale, shift and flip) to
``INPUT.TRAIN_SIZE``, the boxes through the same matrix, clipped, filtered
and padded to ``MODEL.CENTERNET.MAX_OBJS`` slots with a validity mask. The
gaussian targets are rendered on the device in the train step
(``ops/target_gen.py``) and the color jitter runs there too
(``ops/photometric.py``).

Eval: the ctdet letterbox to ``INPUT.TEST_SIZE``, by resize and paste
(``fast_letterbox``) when ``INPUT.FAST_LETTERBOX`` is on, the image is uint8
and ``TEST.EXACT_MODE`` is off, else by the exact affine warp; the output
carries the warp actually applied, for un-mapping the boxes.

The warps are the port's PyTorch ones (the card's machine has no cv2),
rounded to uint8 as cv2 rounds a uint8 warp, so a batch ships 1 byte per
pixel. Masks, keypoints, sem-seg, crop, extent, rotation and proposals are
not ported: nothing on the port's path reads them.
"""

import copy
from typing import Dict, Optional

import numpy as np
import torch

from ..config import CfgNode
from . import detection_utils as utils
from .transforms import CenterAffineAug, letterbox_transform

__all__ = ["DatasetMapper"]


class DatasetMapper:
    def __init__(self, cfg: CfgNode, is_train: bool = True) -> None:
        self.is_train = is_train
        self.image_format = cfg.INPUT.FORMAT
        self.max_objs = int(cfg.MODEL.CENTERNET.MAX_OBJS)
        self.train_size = tuple(cfg.INPUT.TRAIN_SIZE)
        self.test_size = tuple(cfg.INPUT.TEST_SIZE)
        # the exact mode keeps the affine warp, as in the JAX package
        self.fast_letterbox = bool(cfg.INPUT.FAST_LETTERBOX) and not bool(cfg.TEST.EXACT_MODE)
        self.affine_aug = CenterAffineAug(
            self.train_size,
            scale_range=tuple(cfg.INPUT.SCALE_RANGE),
            shift_range=float(cfg.INPUT.SHIFT_RANGE),
            flip_prob=0.5 if cfg.INPUT.RANDOM_FLIP != "none" else 0.0,
        )

    def __call__(self, dataset_dict: dict, rng: Optional[np.random.RandomState] = None) -> Dict[str, np.ndarray]:
        dataset_dict = copy.deepcopy(dataset_dict)
        if "image" in dataset_dict:
            image = np.asarray(dataset_dict.pop("image"))
        else:
            image = utils.read_image(dataset_dict["file_name"], format=self.image_format)
        utils.check_image_size(dataset_dict, image)
        h, w = image.shape[:2]
        if not self.is_train and self.fast_letterbox and image.dtype == np.uint8:
            warped, m = utils.fast_letterbox(image, self.test_size)
        else:
            if self.is_train:
                out_size = self.train_size
                m = self.affine_aug(h, w, rng if rng is not None else np.random.RandomState())
            else:
                out_size = self.test_size
                m = letterbox_transform(h, w, out_size)
            warped = utils.warp_image(image, m, out_size)
            if image.dtype == np.uint8:
                warped = warped.round_().clamp_(0, 255).to(torch.uint8)
            warped = warped.numpy()
        out: Dict[str, np.ndarray] = {
            "image": np.ascontiguousarray(warped),
            "warp": m.astype(np.float32),
            "height": np.int32(dataset_dict["height"]),
            "width": np.int32(dataset_dict["width"]),
            "image_id": np.int64(dataset_dict.get("image_id", -1)),
        }
        if not self.is_train:
            return out
        annos = [a for a in dataset_dict.get("annotations", []) if a.get("iscrowd", 0) == 0]
        boxes, classes = utils.annotations_to_boxes(annos)
        boxes = utils.apply_affine_to_boxes(m, boxes)
        if len(boxes):
            np.clip(boxes[:, 0::2], 0, out_size[1] - 1, out=boxes[:, 0::2])
            np.clip(boxes[:, 1::2], 0, out_size[0] - 1, out=boxes[:, 1::2])
        keep = (boxes[:, 2] - boxes[:, 0] > 1e-5) & (boxes[:, 3] - boxes[:, 1] > 1e-5)
        out.update(utils.pad_to_capacity(boxes[keep], classes[keep], self.max_objs))
        return out
