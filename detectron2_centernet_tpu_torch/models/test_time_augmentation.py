"""Test-time augmentation (counterpart of the JAX package's
``models/test_time_augmentation.py``; reference
``detectron2/modeling/test_time_augmentation.py``: ``DatasetMapperTTA``
multi-scale and flip inputs, ``GeneralizedRCNNWithTTA`` merged inference).

Every (size, flip) variant is its own square letterbox, warped on the
model's device, and one batch-1 ``predict_fn`` call there (on the card, a
ctdet variant launches K1 16 times). Each variant's detections go through
the model's ``postprocess`` with the variant's warp matrix, into the
original image's pixels (the flip is composed into the matrix), and the
variants' detections are merged on the host by class-aware greedy NMS,
``numpy_nms`` with JAX's offset trick, so that the merge keeps JAX's
indices. It takes any meta-architecture with ``predict_fn`` and
``postprocess`` (CenterNet, RetinaNet, the R-CNNs); the merged result has
boxes, scores and classes only, as in the JAX package.
"""

from typing import Dict, Sequence

import numpy as np

from ..config import CfgNode
from ..data.detection_utils import letterbox_and_flip_variants
from ..structures import Boxes, Instances

__all__ = ["GeneralizedRCNNWithTTA", "TTAPredictor", "numpy_nms"]


def numpy_nms(boxes: np.ndarray, scores: np.ndarray, thresh: float) -> np.ndarray:
    """Greedy NMS on the host; returns kept indices sorted by score (a copy
    of the JAX package's, ties in numpy's ``argsort`` order)."""
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
        iou = inter / np.maximum(areas[i] + areas[order[1:]] - inter, 1e-12)
        order = order[1:][iou <= thresh]
    return np.asarray(keep, np.int64)


class TTAPredictor:
    """Multi-scale and flip inference for any meta-architecture of the port,
    on its device. ``sizes`` (``TEST.AUG.MIN_SIZES``) are rounded up to the
    model's ``size_divisibility`` (CenterNet's ``SIZE_DIVISIBILITY``, 32;
    1 for a model without one) and deduplicated; ``flip`` is
    ``TEST.AUG.FLIP``; the merge keeps at most ``max_detections``
    (``TEST.DETECTIONS_PER_IMAGE``)."""

    def __init__(
        self,
        cfg: CfgNode,
        model,
        sizes: Sequence[int] = None,
        flip: bool = None,
        nms_thresh: float = 0.5,
        max_detections: int = None,
    ) -> None:
        self.model = model
        sizes = list(sizes if sizes is not None else cfg.TEST.AUG.MIN_SIZES)
        div = int(getattr(model, "size_divisibility", 1) or 1)
        self.sizes = sorted({((sz + div - 1) // div) * div for sz in sizes})
        self.flip = bool(cfg.TEST.AUG.FLIP if flip is None else flip)
        self.nms_thresh = nms_thresh
        self.max_detections = max_detections or cfg.TEST.DETECTIONS_PER_IMAGE

    def __call__(self, image: np.ndarray) -> Dict[str, Instances]:
        """image: (H, W, C) raw pixels in the model's ``INPUT.FORMAT`` order."""
        h, w = image.shape[:2]
        all_boxes, all_scores, all_classes = [], [], []
        for warped, m, _, _ in letterbox_and_flip_variants(image, self.sizes, self.flip, device=self.model.device):
            dets = self.model.predict_fn(warped.permute(2, 0, 1)[None])
            dets = {k: v.cpu().numpy() for k, v in dets.items()}
            out = self.model.postprocess(dets, [m], [(h, w)])[0]["instances"]
            # the flip is composed into the warp matrix: postprocess has already
            # un-mapped flipped boxes to original coordinates
            all_boxes.append(np.asarray(out.pred_boxes.tensor))
            all_scores.append(np.asarray(out.scores))
            all_classes.append(np.asarray(out.pred_classes))

        boxes = np.concatenate(all_boxes) if all_boxes else np.zeros((0, 4), np.float32)
        scores = np.concatenate(all_scores) if all_scores else np.zeros(0, np.float32)
        classes = np.concatenate(all_classes) if all_classes else np.zeros(0, np.int64)

        # class-aware merge by the offset trick
        if len(boxes):
            offset = classes[:, None].astype(np.float64) * (boxes.max() + 1.0)
            keep = numpy_nms(boxes + offset, scores, self.nms_thresh)
            keep = keep[: self.max_detections]
            boxes, scores, classes = boxes[keep], scores[keep], classes[keep]

        inst = Instances((h, w))
        bx = Boxes(boxes.astype(np.float32))
        bx.clip((h, w))
        inst.pred_boxes = bx
        inst.scores = scores.astype(np.float32)
        inst.pred_classes = classes.astype(np.int64)
        return {"instances": inst}


# the reference's name (test_time_augmentation.py:85); here TTA takes any
# meta-architecture, so it is the same predictor
GeneralizedRCNNWithTTA = TTAPredictor
