"""TridentNet's R-CNN, counterpart of the JAX package's
``models/meta_arch/trident_rcnn.py`` (the reference's ``projects/TridentNet``).

The C4 Faster R-CNN (``GeneralizedRCNN`` with ``Res5ROIHeads``) over the
trident trunk (``models/backbones/trident.py``). Training folds the three
branches into the batch: the ground truth is tiled per branch (branch-major,
as the trunk tiles res3), and ``GeneralizedRCNN`` takes its batch size from
the RPN's outputs, so every later stage (the RPN's and the ROI heads'
losses, the res5 head on the rois) runs on 3N images. Inference follows
``MODEL.TRIDENT.TEST_BRANCH_IDX``: >= 0 runs that branch alone (the Fast
mode of the reference's trident_fast configs, ``GeneralizedRCNN``'s
``predict_fn`` as it is); -1 tiles the images to 3N, runs every branch,
folds each image's branches' detections into one row (branch-major) and
merges them by class-aware NMS (``batched_nms_fixed``, the NMS kernel of
``ops/csrc/nms.cu`` on the card), the reference's
``merge_branch_instances`` (trident_rcnn.py:8-44).
"""

from typing import Dict

import torch

from ...config import CfgNode
from ...ops.nms import batched_nms_fixed
from ..registry import META_ARCH_REGISTRY
from .rcnn import GeneralizedRCNN

__all__ = ["TridentRCNN"]


@META_ARCH_REGISTRY.register()
class TridentRCNN(GeneralizedRCNN):
    def __init__(self, cfg: CfgNode) -> None:
        if cfg.MODEL.BACKBONE.NAME != "build_trident_resnet_backbone":
            raise ValueError(f"TridentRCNN needs the trident backbone (build_trident_resnet_backbone), got "
                             f"{cfg.MODEL.BACKBONE.NAME}")
        super().__init__(cfg)
        self.num_branch = self.model.backbone.num_branch
        self.test_branch_idx = int(cfg.MODEL.TRIDENT.TEST_BRANCH_IDX)

    def loss_fn(self, batch: Dict[str, torch.Tensor]):
        """``GeneralizedRCNN.loss_fn`` with the ground truth tiled per branch
        (the draws, when given, are for the 3N folded images)."""
        batch = dict(batch)
        for k in ("gt_boxes", "gt_classes", "gt_valid", "gt_masks"):
            if k in batch:
                batch[k] = batch[k].repeat(self.num_branch, *(1,) * (batch[k].dim() - 1))
        return super().loss_fn(batch)

    @torch.inference_mode()
    def predict_fn(self, images: torch.Tensor, **kw) -> Dict[str, torch.Tensor]:
        """Fast mode: ``GeneralizedRCNN.predict_fn``. Full mode: every branch
        on the tiled batch, each image's 3K detections merged to K (an empty
        slot, score 0, out of the merge)."""
        if self.test_branch_idx >= 0:
            return super().predict_fn(images, **kw)
        nb, n = self.num_branch, images.shape[0]
        dets = super().predict_fn(images.repeat(nb, 1, 1, 1), **kw)

        def fold(a):  # (nb·N, K, ...) → (N, nb·K, ...), branch-major
            return torch.cat(torch.split(a, n, dim=0), dim=1)

        boxes, scores, classes = fold(dets["boxes"]), fold(dets["scores"]), fold(dets["classes"])
        keep, valid = batched_nms_fixed(boxes, torch.where(scores > 0, scores, float("-inf")), classes,
                                        self.nms_threshold, self.max_detections)
        merged = {"boxes": torch.gather(boxes, 1, keep[..., None].expand(*keep.shape, 4)),
                  "scores": torch.where(valid, torch.gather(scores, 1, keep), 0.0),
                  "classes": torch.gather(classes, 1, keep)}
        mid = nb // 2  # outputs beyond the boxes (none in the trident configs): the middle branch's
        merged.update({k: v[mid * n:(mid + 1) * n] for k, v in dets.items() if k not in merged})
        return merged
