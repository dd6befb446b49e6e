"""The rotated RPN (counterpart of the JAX package's
``models/proposal_generator/rrpn.py``; reference
``modeling/proposal_generator/rrpn.py``).

The structure of ``rpn.py`` on (cx, cy, w, h, angle) boxes: anchors matched
by the rotated IoU (``ops/roi_align_rotated.py::pairwise_iou_rotated``, R1
on the card), deltas by ``Box2BoxTransformRotated``, proposals selected per
level by the rotated NMS (``nms_rotated``, R2 on the card), every level of
every image one row of one call. The samplers take their uniforms as
arguments, as ``rpn.py``'s do.
"""

from typing import Dict, Sequence, Tuple

import torch

from ...ops.roi_align_rotated import nms_rotated, pairwise_iou_rotated
from ..box_regression import Box2BoxTransformRotated, _wrap_degrees
from ..matcher import Matcher
from .rpn import MATCH_CHUNK, subsample_labels, top_k_indices

__all__ = ["clip_rotated_boxes", "find_top_rrpn_proposals", "normalize_angles", "rrpn_losses"]


def normalize_angles(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 5) boxes with angles in [-180, 180) (reference
    structures/rotated_boxes.py:246-250)."""
    return torch.cat([boxes[..., :4], _wrap_degrees(boxes[..., 4:5])], dim=-1)


def clip_rotated_boxes(boxes: torch.Tensor, image_hw: Tuple[int, int],
                       clip_angle_threshold: float = 1.0) -> torch.Tensor:
    """``RotatedBoxes.clip`` (reference structures/rotated_boxes.py:252-300;
    JAX ``clip_rotated_boxes``): angles normalized, then the near-horizontal
    boxes (|angle| <= threshold) clipped to the image as axis-aligned
    rectangles, their w and h at most what they were; steeper boxes as
    they are."""
    h, w = image_hw
    boxes = normalize_angles(boxes)
    cx, cy, bw, bh, a = boxes.unbind(-1)
    x1 = torch.clamp(cx - bw / 2.0, 0, w)
    y1 = torch.clamp(cy - bh / 2.0, 0, h)
    x2 = torch.clamp(cx + bw / 2.0, 0, w)
    y2 = torch.clamp(cy + bh / 2.0, 0, h)
    near = a.abs() <= clip_angle_threshold
    return torch.stack([torch.where(near, (x1 + x2) / 2.0, cx), torch.where(near, (y1 + y2) / 2.0, cy),
                        torch.where(near, torch.minimum(bw, x2 - x1), bw),
                        torch.where(near, torch.minimum(bh, y2 - y1), bh), a], dim=-1)


def rrpn_losses(anchors: torch.Tensor, pred_logits: torch.Tensor, pred_deltas: torch.Tensor,
                gt_boxes: torch.Tensor, gt_valid: torch.Tensor, rand: torch.Tensor, matcher: Matcher,
                box2box: Box2BoxTransformRotated, batch_size_per_image: int = 256, positive_fraction: float = 0.5,
                smooth_l1_beta: float = 0.0) -> Dict[str, torch.Tensor]:
    """The RRPN's losses over the batch: anchors (R, 5), logits (N, R),
    deltas (N, R, 5), gt (N, M, 5) with (N, M) validity, the sampler's draws
    (N, R). The (gt, anchor) rotated IoUs of a few images at a time; both
    losses over ``batch_size_per_image · N``."""
    n = pred_logits.shape[0]
    labels, matched = [], []
    with torch.no_grad():
        chunk = max(1, MATCH_CHUNK // max(gt_boxes.shape[1] * anchors.shape[0], 1))
        for s in range(0, n, chunk):
            boxes = gt_boxes[s:s + chunk]
            matches, lab = matcher(pairwise_iou_rotated(boxes, anchors), gt_valid[s:s + chunk])
            labels.append(subsample_labels(lab, batch_size_per_image, positive_fraction, rand[s:s + chunk]))
            matched.append(torch.gather(boxes, 1, matches[..., None].expand(*matches.shape, 5)))
        labels, matched = torch.cat(labels), torch.cat(matched)
        gt_deltas = box2box.get_deltas(anchors[None], matched)
    pos, valid = labels == 1, labels >= 0
    normalizer = batch_size_per_image * n
    diff = (pred_deltas - gt_deltas).abs()
    if smooth_l1_beta > 0:
        reg = torch.where(diff < smooth_l1_beta, 0.5 * diff * diff / smooth_l1_beta, diff - 0.5 * smooth_l1_beta)
    else:
        reg = diff
    loss_loc = torch.where(pos[..., None], reg, 0.0).sum() / normalizer
    labels_f = pos.to(torch.float32)
    ce = torch.clamp(pred_logits, min=0) - pred_logits * labels_f + torch.log1p(torch.exp(-pred_logits.abs()))
    loss_cls = torch.where(valid, ce, 0.0).sum() / normalizer
    return {"loss_rpn_cls": loss_cls, "loss_rpn_loc": loss_loc}


def find_top_rrpn_proposals(logits_per_level: Sequence[torch.Tensor], deltas_per_level: Sequence[torch.Tensor],
                            anchors_per_level: Sequence[torch.Tensor], image_hw: Tuple[int, int],
                            box2box: Box2BoxTransformRotated, nms_thresh: float = 0.7, pre_nms_topk: int = 1000,
                            post_nms_topk: int = 1000, min_box_size: float = 0.0
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-size rotated proposals (JAX ``find_top_rrpn_proposals``;
    reference rrpn.py:92-105): per level (N, R_l) logits and (N, R_l, 5)
    deltas, its top ``pre_nms_topk`` (stable order), decoded on their
    anchors, clipped (``clip_rotated_boxes``), a side <= ``min_box_size``
    dead; every level of every image one row of one ``nms_rotated`` call
    (``min(post_nms_topk, k_l)`` picks each: cross-level boxes never
    suppress each other, as in the reference's level-batched NMS); then the
    global top ``post_nms_topk``. Returns boxes (N, P, 5), scores (N, P)
    (-inf in an invalid slot) and valid (N, P)."""
    n = logits_per_level[0].shape[0]
    dev = logits_per_level[0].device
    ks = [min(pre_nms_topk, lg.shape[1]) for lg in logits_per_level]
    keep_ks = [min(post_nms_topk, k) for k in ks]
    width, levels = max(ks), len(ks)
    row_boxes = torch.zeros(n, levels, width, 5, dtype=torch.float32, device=dev)
    row_scores = torch.full((n, levels, width), float("-inf"), dtype=torch.float32, device=dev)
    for level, (lg, dl, anc, k) in enumerate(zip(logits_per_level, deltas_per_level, anchors_per_level, ks)):
        idx = top_k_indices(lg, k)  # (N, k)
        scores = torch.gather(lg, 1, idx)
        boxes = box2box.apply_deltas(torch.gather(dl, 1, idx[..., None].expand(n, k, 5)), anc[idx])
        boxes = clip_rotated_boxes(boxes, image_hw)
        nonempty = (boxes[..., 2] > min_box_size) & (boxes[..., 3] > min_box_size)
        row_boxes[:, level, :k] = boxes
        row_scores[:, level, :k] = torch.where(nonempty, scores, float("-inf"))
    keep, valid = nms_rotated(row_boxes.view(n * levels, width, 5), row_scores.view(n * levels, width), nms_thresh,
                              keep_ks * n)
    keep, valid = keep.view(n, levels, -1), valid.view(n, levels, -1)
    all_boxes, all_scores = [], []
    for level, kk in enumerate(keep_ks):
        idx = keep[:, level, :kk]
        all_boxes.append(torch.gather(row_boxes[:, level], 1, idx[..., None].expand(n, kk, 5)))
        all_scores.append(torch.where(valid[:, level, :kk], torch.gather(row_scores[:, level], 1, idx),
                                      float("-inf")))
    boxes, scores = torch.cat(all_boxes, 1), torch.cat(all_scores, 1)
    top = top_k_indices(scores, min(post_nms_topk, scores.shape[1]))
    top_scores = torch.gather(scores, 1, top)
    return torch.gather(boxes, 1, top[..., None].expand(*top.shape, 5)), top_scores, torch.isfinite(top_scores)
