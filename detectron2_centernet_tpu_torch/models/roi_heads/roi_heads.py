"""ROI-head logic over fixed shapes, batched over the images: counterpart of
the JAX package's ``models/roi_heads/roi_heads.py`` (reference
``roi_heads/roi_heads.py`` :123-343 and ``fast_rcnn.py`` :46-370).

Proposals are fixed-P slots with a validity mask; sampling returns S slots
(the sampled proposal boxes with their labels and targets); inference
returns K detections per image through one ``greedy_nms`` call for the
batch. The sampler's draws are arguments (the uniforms JAX draws inside).
"""

from typing import Dict, Tuple

import torch

from ...ops.nms import batched_nms_fixed, pairwise_iou_xyxy
from ..box_regression import Box2BoxTransform
from ..matcher import Matcher
from ..proposal_generator.rpn import subsample_labels, top_k_indices

__all__ = ["fast_rcnn_inference", "fast_rcnn_losses", "label_and_sample_proposals"]


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t (N, P, ...) gathered at idx (N, S) along dim 1."""
    return torch.gather(t, 1, idx.view(*idx.shape, *[1] * (t.dim() - 2)).expand(*idx.shape, *t.shape[2:]))


def label_and_sample_proposals(proposals: torch.Tensor, proposal_valid: torch.Tensor, gt_boxes: torch.Tensor,
                               gt_classes: torch.Tensor, gt_valid: torch.Tensor, rand_sub: torch.Tensor,
                               rand_tie: torch.Tensor, matcher: Matcher, num_samples: int = 512,
                               positive_fraction: float = 0.25, num_classes: int = 80,
                               append_gt: bool = True) -> Dict[str, torch.Tensor]:
    """Fixed-S training rois per image: proposals (N, P, 4) with (N, P)
    validity, gt (N, M, ...), the sampler's draws ``rand_sub`` and
    ``rand_tie`` (N, P'), P' = max(P + M, S) with ``append_gt`` (the gt
    boxes join the proposals) and padding up to S. Returns (N, S) slots,
    positives first: boxes (N, S, 4), classes in [0, C] (C background),
    weights (0 in a padding slot), target_boxes (the matched gt),
    matched_idx and is_pos."""
    n = proposals.shape[0]
    if append_gt:
        proposals = torch.cat([proposals, gt_boxes.to(proposals.dtype)], 1)
        proposal_valid = torch.cat([proposal_valid, gt_valid.to(torch.bool)], 1)
    if proposals.shape[1] < num_samples:
        pad = num_samples - proposals.shape[1]
        proposals = torch.cat([proposals, proposals.new_zeros(n, pad, 4)], 1)
        proposal_valid = torch.cat([proposal_valid, proposal_valid.new_zeros(n, pad)], 1)
    iou = torch.where(proposal_valid[:, None, :], pairwise_iou_xyxy(gt_boxes, proposals), -1.0)
    matches, labels = matcher(iou, gt_valid)  # no ignore band: {0, 1}
    labels = torch.where(proposal_valid, labels.to(torch.int32), -1)
    sel = subsample_labels(labels, num_samples, positive_fraction, rand_sub)
    priority = torch.where(sel == 1, 2.0, torch.where(sel == 0, 1.0, 0.0)) + rand_tie * 1e-3
    idx = top_k_indices(priority, num_samples)  # (N, S)
    sel_s = torch.gather(sel, 1, idx)
    matched = torch.gather(matches, 1, idx)
    is_pos = sel_s == 1
    return {
        "boxes": _take(proposals, idx),
        "classes": torch.where(is_pos, torch.gather(gt_classes.to(torch.int64), 1, matched), num_classes),
        "weights": (sel_s >= 0).to(torch.float32),
        "target_boxes": _take(gt_boxes, matched),
        "matched_idx": matched,
        "is_pos": is_pos,
    }


def fast_rcnn_losses(scores: torch.Tensor, deltas: torch.Tensor, sampled: Dict[str, torch.Tensor],
                     box2box: Box2BoxTransform, num_classes: int,
                     smooth_l1_beta: float = 0.0) -> Dict[str, torch.Tensor]:
    """Softmax cross entropy over the sampled rois and smooth L1 on the
    foreground's class deltas (reference fast_rcnn.py:201-260), both over
    the count of non-padding slots; the (S, ...) inputs flattened over the
    batch."""
    cls, w = sampled["classes"], sampled["weights"]
    num_valid = torch.clamp(w.sum(), min=1.0)
    ce = -torch.gather(torch.log_softmax(scores, dim=-1), 1, cls[:, None])[:, 0]
    loss_cls = (ce * w).sum() / num_valid
    gt_deltas = box2box.get_deltas(sampled["boxes"], sampled["target_boxes"])
    if deltas.shape[-1] == 4:
        pred = deltas
    else:
        fg_cls = torch.clamp(cls, 0, num_classes - 1)
        pred = torch.gather(deltas.view(deltas.shape[0], num_classes, 4), 1,
                            fg_cls[:, None, None].expand(-1, 1, 4))[:, 0]
    diff = (pred - gt_deltas).abs()
    if smooth_l1_beta > 0:
        reg = torch.where(diff < smooth_l1_beta, 0.5 * diff * diff / smooth_l1_beta, diff - 0.5 * smooth_l1_beta)
    else:
        reg = diff
    pos_w = (sampled["is_pos"] & (w > 0)).to(torch.float32)
    loss_box = (reg.sum(-1) * pos_w).sum() / num_valid
    return {"loss_cls": loss_cls, "loss_box_reg": loss_box}


def fast_rcnn_inference(proposals: torch.Tensor, proposal_valid: torch.Tensor, scores: torch.Tensor,
                        deltas: torch.Tensor, box2box: Box2BoxTransform, num_classes: int,
                        image_hw: Tuple[int, int], score_thresh: float = 0.05, nms_thresh: float = 0.5,
                        topk_per_image: int = 100) -> Dict[str, torch.Tensor]:
    """Per-class decode and the class-aware fixed-K NMS (reference
    fast_rcnn.py:302-370) for (N, P) proposals with their (N, P, C+1)
    scores and (N, P, 4C or 4) deltas: boxes (N, K, 4), scores (N, K) (0
    in an invalid slot), classes (N, K). Every (proposal, class) pair above
    ``score_thresh`` is a candidate: one NMS row of P·C per image."""
    h, w = image_hw
    n, p = proposals.shape[:2]
    c = num_classes
    probs = torch.softmax(scores, dim=-1)[..., :c]  # (N, P, C)
    if deltas.shape[-1] == 4:
        boxes = box2box.apply_deltas(deltas, proposals)[:, :, None, :].expand(n, p, c, 4)
    else:
        boxes = box2box.apply_deltas(deltas, proposals).view(n, p, c, 4)
    boxes = torch.stack([boxes[..., 0].clamp(0, w), boxes[..., 1].clamp(0, h),
                         boxes[..., 2].clamp(0, w), boxes[..., 3].clamp(0, h)], dim=-1)
    flat_scores = torch.where(proposal_valid[:, :, None] & (probs > score_thresh), probs,
                              float("-inf")).reshape(n, p * c)
    flat_boxes = boxes.reshape(n, p * c, 4)
    flat_classes = torch.arange(c, device=proposals.device).repeat(p).expand(n, p * c)
    keep, valid = batched_nms_fixed(flat_boxes, flat_scores, flat_classes, nms_thresh, topk_per_image)
    return {"boxes": _take(flat_boxes, keep),
            "scores": torch.where(valid, torch.gather(flat_scores, 1, keep), 0.0),
            "classes": torch.gather(flat_classes, 1, keep)}
