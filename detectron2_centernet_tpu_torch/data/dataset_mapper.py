"""DatasetMapper: dataset dict → fixed-shape model-input arrays
(counterpart of the JAX package's ``data/dataset_mapper.py``, ``:40-206``
and ``:240-293``).

Train: the host photometric jitter when ``INPUT.COLOR_JITTER`` is on and
``DATALOADER.DEVICE_PHOTOMETRIC`` off (else it runs on the device in the
train step, ``ops/photometric.py``), then one affine warp to
``INPUT.TRAIN_SIZE`` composed of ``INPUT.ROTATION``, ``INPUT.CROP`` or
``INPUT.EXTENT`` and the flip, or else the random scale, shift and flip
(``_train_geometry``, the JAX package's ``:128-161``); the boxes go through
the same matrix, clipped, filtered and padded to
``MODEL.CENTERNET.MAX_OBJS`` slots with a validity mask. Every draw comes
from the one ``RandomState`` in the JAX package's order (jitter, rotation,
crop or extent, flip), so a seed gives the JAX matrix. The gaussian targets
are rendered on the device in the train step (``ops/target_gen.py``). With
``MODEL.MASK_ON`` each kept instance's polygons go through the same matrix
and are filled into a fixed ``INPUT.MASK_RASTER``² raster relative to its
box (``gt_masks``, uint8, the JAX package's ``:253-271``); with
``MODEL.KEYPOINT_ON`` its keypoints go through it too, a point warped off
the image turning invisible, the left and right ones swapped by the train
dataset's ``keypoint_flip_map`` when the warp mirrors (``gt_keypoints``,
``:273-293``). With ``MODEL.LOAD_PROPOSALS``, in train and eval, the dict's
precomputed proposals all go through the matrix, are clipped and filtered,
and then the top ``DATASETS.PRECOMPUTED_PROPOSAL_TOPK_*`` by objectness fill
fixed slots (``proposal_boxes``, ``proposal_objectness_logits``,
``proposal_valid``; ``:208-238``), so a top-K box that the warp makes
degenerate is backfilled by the next one.

Eval: the ctdet letterbox to ``INPUT.TEST_SIZE``, by resize and paste
(``fast_letterbox``) when ``INPUT.FAST_LETTERBOX`` is on, the image is uint8
and ``TEST.EXACT_MODE`` is off, else by the exact affine warp; the output
carries the warp actually applied, for un-mapping the boxes.

The warps are the port's PyTorch ones (the card's machine has no cv2), a
uint8 image rounded to uint8 as cv2 rounds a uint8 warp, so a batch ships 1
byte per pixel; a jittered image is float32 and stays so. A train record with
a ``sem_seg`` array, or a ``sem_seg_file_name`` (read with PIL, imported
then), gives ``sem_seg``: its labels through the same matrix by nearest
neighbour, 255 off the source, int32 (H, W) (``:294-309``), by
``warp_labels_nearest``, cv2's fixed-point nearest warp written in numpy;
the crop's category constraint reads the same labels (``:139-145``).
"""

import copy
from typing import Dict, Optional

import numpy as np
import torch

from ..config import CfgNode
from ..structures.masks import rasterize_in_box
from . import detection_utils as utils
from .catalog import MetadataCatalog
from .transforms import (
    CenterAffineAug,
    PhotometricAug,
    RandomCropCategoryAreaConstraint,
    RandomExtentAug,
    RandomRotationAug,
    compose_affine,
    letterbox_transform,
    window_to_output_transform,
)

__all__ = ["DatasetMapper"]


class DatasetMapper:
    def __init__(self, cfg: CfgNode, is_train: bool = True) -> None:
        self.is_train = is_train
        self.image_format = cfg.INPUT.FORMAT
        self.max_objs = int(cfg.MODEL.CENTERNET.MAX_OBJS)
        self.mask_on = bool(cfg.MODEL.MASK_ON)
        self.mask_raster = int(cfg.INPUT.MASK_RASTER)
        self.keypoint_on = bool(cfg.MODEL.KEYPOINT_ON)
        self.load_proposals = bool(cfg.MODEL.LOAD_PROPOSALS)
        d = cfg.DATASETS
        self.proposal_topk = int(d.PRECOMPUTED_PROPOSAL_TOPK_TRAIN if is_train else d.PRECOMPUTED_PROPOSAL_TOPK_TEST)
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
        on_host = is_train and cfg.INPUT.COLOR_JITTER and not cfg.DATALOADER.DEVICE_PHOTOMETRIC
        self.photometric = PhotometricAug() if on_host else None
        self.flip_prob = 0.5 if cfg.INPUT.RANDOM_FLIP != "none" else 0.0
        i = cfg.INPUT
        self.rotation = RandomRotationAug(tuple(i.ROTATION.ANGLE), expand=bool(i.ROTATION.EXPAND),
                                          sample_style=str(i.ROTATION.SAMPLE_STYLE)) if i.ROTATION.ENABLED else None
        self.crop = RandomCropCategoryAreaConstraint(
            str(i.CROP.TYPE), tuple(i.CROP.SIZE), float(i.CROP.SINGLE_CATEGORY_MAX_AREA),
            ignored_category=255) if i.CROP.ENABLED else None
        self.extent = RandomExtentAug(tuple(i.EXTENT.SCALE_RANGE), tuple(i.EXTENT.SHIFT_RANGE)) \
            if i.EXTENT.ENABLED else None

    def _train_geometry(self, dataset_dict: dict, h: int, w: int, rng: np.random.RandomState,
                        out_size) -> np.ndarray:
        """The rotation, then the crop or extent and the flip, or else the
        scale/shift/flip, as ONE source → network 2x3 matrix (the JAX
        package's ``_train_geometry``, draw for draw)."""
        m_pre = np.array([[1.0, 0, 0], [0, 1.0, 0]], np.float64)
        cur_h, cur_w = h, w
        if self.rotation is not None:
            m_pre, (cur_h, cur_w) = self.rotation(h, w, rng)
        if self.crop is None and self.extent is None:
            return compose_affine(self.affine_aug(cur_h, cur_w, rng), m_pre)
        if self.crop is not None:
            sem = self._sem_seg(dataset_dict)
            # the category constraint reads the source frame: with a rotation the window is drawn unconstrained
            window = self.crop(cur_h, cur_w, rng, sem_seg=sem if self.rotation is None else None)
        else:
            window = self.extent(cur_h, cur_w, rng)
        m = compose_affine(window_to_output_transform(window, out_size), m_pre)
        if rng.rand() < self.flip_prob:
            m = compose_affine(np.array([[-1, 0, out_size[1] - 1], [0, 1, 0]], np.float64), m)
        return m

    @staticmethod
    def _sem_seg(dataset_dict: dict) -> Optional[np.ndarray]:
        """The record's sem-seg labels: its ``sem_seg`` array, or its
        ``sem_seg_file_name`` read once (kept in the record's copy), or None."""
        if dataset_dict.get("sem_seg") is None and "sem_seg_file_name" in dataset_dict:
            dataset_dict["sem_seg"] = utils.read_sem_seg(dataset_dict["sem_seg_file_name"])
        return dataset_dict.get("sem_seg")

    def __call__(self, dataset_dict: dict, rng: Optional[np.random.RandomState] = None) -> Dict[str, np.ndarray]:
        dataset_dict = copy.deepcopy(dataset_dict)
        if "image" in dataset_dict:
            image = np.asarray(dataset_dict.pop("image"))
        else:
            image = utils.read_image(dataset_dict["file_name"], format=self.image_format)
        utils.check_image_size(dataset_dict, image)
        h, w = image.shape[:2]
        out_size = self.train_size if self.is_train else self.test_size
        if not self.is_train and self.fast_letterbox and image.dtype == np.uint8:
            warped, m = utils.fast_letterbox(image, self.test_size)
        else:
            if self.is_train:
                rng = rng if rng is not None else np.random.RandomState()
                if self.photometric is not None:  # before the geometry, as the JAX mapper draws
                    image = self.photometric(image, rng)
                m = self._train_geometry(dataset_dict, h, w, rng, out_size)
            else:
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
            # as the dataset gave it (an int, or VOC's and Cityscapes' strings), never an array (ROADMAP C22)
            "image_id": dataset_dict.get("image_id", -1),
        }
        if self.load_proposals:
            out.update(self._proposals(dataset_dict, m, out_size))
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
        sem = self._sem_seg(dataset_dict)
        if sem is not None:
            out["sem_seg"] = utils.warp_labels_nearest(np.asarray(sem), m, out_size)
        return out

    def _proposals(self, dataset_dict: dict, m: np.ndarray, out_size) -> Dict[str, np.ndarray]:
        """The top ``proposal_topk`` of the dict's warped, clipped,
        non-degenerate proposals by objectness, in fixed slots: boxes (K, 4)
        f32, logits (K,) f32 (-1e9 in an empty slot), valid (K,) bool."""
        k = self.proposal_topk
        boxes = np.zeros((k, 4), np.float32)
        logits = np.full((k,), -1e9, np.float32)
        valid = np.zeros((k,), bool)
        raw = dataset_dict.get("proposal_boxes")
        if raw is not None and len(raw):
            raw = np.asarray(raw, np.float32).reshape(-1, 4)
            lg = np.asarray(dataset_dict.get("proposal_objectness_logits", np.zeros(len(raw))), np.float32)
            # warp, clip and filter all of them first, then take the top K: the
            # reference's transform_proposals backfills a top-K box the warp degenerates
            b = utils.apply_affine_to_boxes(m, raw)
            np.clip(b[:, 0::2], 0, out_size[1] - 1, out=b[:, 0::2])
            np.clip(b[:, 1::2], 0, out_size[0] - 1, out=b[:, 1::2])
            ok = (b[:, 2] - b[:, 0] > 1e-5) & (b[:, 3] - b[:, 1] > 1e-5)
            b, lg = b[ok], lg[ok]
            order = np.argsort(-lg)[:k]
            boxes[: len(order)] = b[order]
            logits[: len(order)] = lg[order]
            valid[: len(order)] = True
        return {"proposal_boxes": boxes, "proposal_objectness_logits": logits, "proposal_valid": valid}

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
