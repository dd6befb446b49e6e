"""DatasetMapper: dataset dict → fixed-shape model-input arrays
(counterpart of the JAX package's ``data/dataset_mapper.py``, ``:128-206``
and ``:240-251``).

Train: one affine warp (random scale, shift and flip) to
``INPUT.TRAIN_SIZE``, the boxes through the same matrix, clipped, filtered
and padded to ``MODEL.CENTERNET.MAX_OBJS`` slots with a validity mask. The
gaussian targets are rendered on the device in the train step
(``ops/target_gen.py``) and the color jitter runs there too
(``ops/photometric.py``). With ``MODEL.MASK_ON`` each kept instance's
polygons go through the same matrix and are filled into a fixed
``INPUT.MASK_RASTER``² raster relative to its box (``gt_masks``, uint8, the
JAX package's ``:253-271``); with ``MODEL.KEYPOINT_ON`` its keypoints go
through it too, a point warped off the image turning invisible, the left
and right ones swapped by the train dataset's ``keypoint_flip_map`` when
the warp mirrors (``gt_keypoints``, ``:273-293``).

Eval: the ctdet letterbox to ``INPUT.TEST_SIZE``, by resize and paste
(``fast_letterbox``) when ``INPUT.FAST_LETTERBOX`` is on, the image is uint8
and ``TEST.EXACT_MODE`` is off, else by the exact affine warp; the output
carries the warp actually applied, for un-mapping the boxes.

The warps are the port's PyTorch ones (the card's machine has no cv2),
rounded to uint8 as cv2 rounds a uint8 warp, so a batch ships 1 byte per
pixel. Sem-seg, crop, extent, rotation and proposals are not ported:
nothing on the port's path reads them.
"""

import copy
from typing import Dict, Optional

import numpy as np
import torch

from ..config import CfgNode
from ..structures.masks import rasterize_in_box
from . import detection_utils as utils
from .catalog import MetadataCatalog
from .transforms import CenterAffineAug, letterbox_transform

__all__ = ["DatasetMapper"]


class DatasetMapper:
    def __init__(self, cfg: CfgNode, is_train: bool = True) -> None:
        self.is_train = is_train
        self.image_format = cfg.INPUT.FORMAT
        self.max_objs = int(cfg.MODEL.CENTERNET.MAX_OBJS)
        self.mask_on = bool(cfg.MODEL.MASK_ON)
        self.mask_raster = int(cfg.INPUT.MASK_RASTER)
        self.keypoint_on = bool(cfg.MODEL.KEYPOINT_ON)
        self.num_keypoints = int(cfg.MODEL.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS)
        self.kp_flip_indices = None  # the permutation a mirroring warp applies, from the train set's metadata
        if self.keypoint_on and len(cfg.DATASETS.TRAIN):
            meta = MetadataCatalog.get(cfg.DATASETS.TRAIN[0])
            names, flip_map = meta.get("keypoint_names"), meta.get("keypoint_flip_map")
            if names and flip_map:
                idx = {name: i for i, name in enumerate(names)}
                perm = list(range(len(names)))
                for a, b in flip_map:
                    perm[idx[a]], perm[idx[b]] = idx[b], idx[a]
                self.kp_flip_indices = np.asarray(perm)
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
        boxes = boxes[keep]
        out.update(utils.pad_to_capacity(boxes, classes[keep], self.max_objs))
        kept = [a for a, k in zip(annos, keep) if k][: self.max_objs]
        if self.mask_on:
            out["gt_masks"] = self._masks(kept, boxes, m)
        if self.keypoint_on:
            out["gt_keypoints"] = self._keypoints(kept, m, out_size)
        return out

    def _masks(self, annos, boxes: np.ndarray, m: np.ndarray) -> np.ndarray:
        """(MAX_OBJS, R, R) uint8: each instance's warped polygons filled
        relative to its warped, clipped box (0 for an RLE or no polygon)."""
        r = self.mask_raster
        rasters = np.zeros((self.max_objs, r, r), np.uint8)
        for i, (a, box) in enumerate(zip(annos, boxes)):
            segm = a.get("segmentation")
            if not segm or isinstance(segm, dict):
                continue
            polys = [utils.apply_affine_to_points(m, np.asarray(p, np.float64).reshape(-1, 2)).reshape(-1)
                     for p in segm]
            rasters[i] = (rasterize_in_box(polys, box, r) > 0.5).astype(np.uint8)
        return rasters

    def _keypoints(self, annos, m: np.ndarray, out_size) -> np.ndarray:
        """(MAX_OBJS, K, 3) f32 warped (x, y, visibility)."""
        kp = np.zeros((self.max_objs, self.num_keypoints, 3), np.float32)
        for i, a in enumerate(annos):
            pts = a.get("keypoints")
            if not pts:
                continue
            arr = np.asarray(pts, np.float32).reshape(-1, 3)[: self.num_keypoints]
            xy = utils.apply_affine_to_points(m, arr[:, :2])
            inside = (xy[:, 0] >= 0) & (xy[:, 0] < out_size[1]) & (xy[:, 1] >= 0) & (xy[:, 1] < out_size[0])
            row = np.concatenate([xy, np.where(inside, arr[:, 2], 0)[:, None]], axis=1)
            if m[0, 0] < 0 and self.kp_flip_indices is not None:
                row = row[self.kp_flip_indices]  # a mirroring warp: left and right swap
            kp[i, : len(row)] = row
        return kp
