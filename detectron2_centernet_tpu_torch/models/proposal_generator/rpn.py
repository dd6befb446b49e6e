"""Region Proposal Network, counterpart of the JAX package's
``models/proposal_generator/rpn.py`` (reference
``modeling/proposal_generator/rpn.py`` and ``proposal_utils.py``).

``StandardRPNHead``: a shared 3x3 conv + ReLU, then the 1x1
``objectness_logits`` and ``anchor_deltas`` convs in IEEE f32 on an f32
cast of their input, on every level (NCHW; keys
``proposal_generator.rpn_head.{conv,objectness_logits,anchor_deltas}``).

``subsample_labels``, ``rpn_losses`` and ``find_top_rpn_proposals`` work on
fixed shapes, batched over the images: sampling returns a {-1, 0, 1} mask,
proposals are fixed-size slots with a validity mask.

Random draws are arguments: the samplers take the uniform tensors the JAX
package draws inside (``jax.random.uniform``), so a test can feed JAX's own
draws; the meta-architecture draws them from the step's ``torch.Generator``.

Tie order: ``jax.lax.top_k`` breaks ties by the lower index; ``torch.topk``
promises no order on CUDA. Every top-k here is ``top_k_indices``, a stable
descending sort, sliced.
"""

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.nms import greedy_nms, pairwise_iou_xyxy
from ..box_regression import Box2BoxTransform
from ..matcher import Matcher
from ..meta_arch.centernet import F32Conv2d

__all__ = ["StandardRPNHead", "find_top_rpn_proposals", "rpn_losses", "subsample_labels", "top_k_indices"]

# anchors matched at once in rpn_losses: about this many (gt slot, anchor) IoUs
MATCH_CHUNK = 2 ** 25


class StandardRPNHead(nn.Module):
    """3x3 conv (as wide as its input) + ReLU → f32 1x1 objectness (A) and
    deltas (A·box_dim) on every level."""

    def __init__(self, in_channels: int, num_anchors: int, box_dim: int = 4):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, in_channels, 3, padding=1)
        self.objectness_logits = F32Conv2d(in_channels, num_anchors, 1)
        self.anchor_deltas = F32Conv2d(in_channels, num_anchors * box_dim, 1)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's init: every kernel N(0, 0.01), biases 0."""
        for m in (self.conv, self.objectness_logits, self.anchor_deltas):
            m.weight.normal_(0.0, 0.01, generator=generator)
            m.bias.zero_()

    def forward(self, features: List[torch.Tensor]) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        logits, deltas = [], []
        for f in features:
            t = F.relu(self.conv(f))
            logits.append(self.objectness_logits(t))
            deltas.append(self.anchor_deltas(t))
        return logits, deltas


def top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries along the last dim, ties to the
    lower index (``jax.lax.top_k``'s order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True)[1][..., :k]


def subsample_labels(labels: torch.Tensor, num_samples: int, positive_fraction: float,
                     rand: torch.Tensor) -> torch.Tensor:
    """The static-shape sampler (reference ``sampling.py:9-55``), for
    (..., R) labels in {-1 ignore, 0 negative, 1 positive} with (..., R)
    uniforms ``rand``: at most ``num_samples · positive_fraction`` positives
    (those of the highest draws), negatives of the highest draws for the
    rest; a {-1, 0, 1} int8 mask."""
    r = labels.shape[-1]
    k_pos = min(int(num_samples * positive_fraction), r)
    k_neg = min(num_samples, r)
    pos, neg = labels == 1, labels == 0
    pos_idx = top_k_indices(torch.where(pos, rand, -1.0), k_pos)
    pos_take = torch.zeros_like(pos).scatter_(-1, pos_idx, True) & pos
    num_pos = pos_take.sum(-1, keepdim=True)
    neg_idx = top_k_indices(torch.where(neg, rand, -1.0), k_neg)
    ranks = torch.arange(k_neg, device=labels.device).expand(neg_idx.shape)
    neg_rank = torch.zeros(labels.shape, dtype=torch.int64, device=labels.device).scatter_(-1, neg_idx, ranks)
    neg_take = torch.zeros_like(neg).scatter_(-1, neg_idx, True) & neg & (neg_rank < num_samples - num_pos)
    return torch.where(pos_take, 1, torch.where(neg_take, 0, -1)).to(torch.int8)


def rpn_losses(anchors: torch.Tensor, pred_logits: torch.Tensor, pred_deltas: torch.Tensor,
               gt_boxes: torch.Tensor, gt_valid: torch.Tensor, rand: torch.Tensor, matcher: Matcher,
               box2box: Box2BoxTransform, batch_size_per_image: int = 256, positive_fraction: float = 0.5,
               smooth_l1_beta: float = 0.0) -> Dict[str, torch.Tensor]:
    """Reference ``RPN.losses`` (rpn.py:404-440) over the batch: anchors (R, 4),
    logits (N, R), deltas (N, R, 4), gt (N, M, 4) with (N, M) validity, the
    sampler's draws (N, R). Anchors are matched a few images at a time (the
    (N, M, R) IoU of a batch of 16 at 800² would take GBs). Both losses over
    ``batch_size_per_image · N``."""
    n = pred_logits.shape[0]
    labels, matched = [], []
    with torch.no_grad():
        chunk = max(1, MATCH_CHUNK // max(gt_boxes.shape[1] * anchors.shape[0], 1))
        for s in range(0, n, chunk):
            boxes = gt_boxes[s:s + chunk]
            matches, lab = matcher(pairwise_iou_xyxy(boxes, anchors), gt_valid[s:s + chunk])
            labels.append(subsample_labels(lab, batch_size_per_image, positive_fraction, rand[s:s + chunk]))
            matched.append(torch.gather(boxes, 1, matches[..., None].expand(*matches.shape, 4)))
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


def _clip(boxes: torch.Tensor, image_hw: Tuple[int, int]) -> torch.Tensor:
    h, w = image_hw
    return torch.stack([boxes[..., 0].clamp(0, w), boxes[..., 1].clamp(0, h),
                        boxes[..., 2].clamp(0, w), boxes[..., 3].clamp(0, h)], dim=-1)


def find_top_rpn_proposals(logits_per_level: Sequence[torch.Tensor], deltas_per_level: Sequence[torch.Tensor],
                           anchors_per_level: Sequence[torch.Tensor], image_hw: Tuple[int, int],
                           box2box: Box2BoxTransform, nms_thresh: float = 0.7, pre_nms_topk: int = 1000,
                           post_nms_topk: int = 1000, min_size: float = 0.0
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-size proposals (reference ``proposal_utils.py:13-113``): per
    level (N, R_l) logits and (N, R_l, 4) deltas, its top ``pre_nms_topk``
    (stable order), decoded on their anchors, clipped, those under
    ``min_size`` dead; every level of every image is one row of a single
    ``greedy_nms`` call (``min(post_nms_topk, k_l)`` picks each); each
    row's picks in the JAX package's concatenated layout, then the global
    top ``post_nms_topk``. Returns boxes (N, P, 4), scores (N, P) (-inf in
    an invalid slot) and valid (N, P)."""
    n = logits_per_level[0].shape[0]
    dev = logits_per_level[0].device
    ks = [min(pre_nms_topk, lg.shape[1]) for lg in logits_per_level]
    keep_ks = [min(post_nms_topk, k) for k in ks]
    width, levels = max(ks), len(ks)
    row_boxes = torch.zeros(n, levels, width, 4, dtype=torch.float32, device=dev)
    row_scores = torch.full((n, levels, width), float("-inf"), dtype=torch.float32, device=dev)
    for level, (lg, dl, anc, k) in enumerate(zip(logits_per_level, deltas_per_level, anchors_per_level, ks)):
        idx = top_k_indices(lg, k)  # (N, k)
        scores = torch.gather(lg, 1, idx)
        boxes = _clip(box2box.apply_deltas(torch.gather(dl, 1, idx[..., None].expand(n, k, 4)), anc[idx]), image_hw)
        too_small = (boxes[..., 2] - boxes[..., 0] < min_size) | (boxes[..., 3] - boxes[..., 1] < min_size)
        row_boxes[:, level, :k] = boxes
        row_scores[:, level, :k] = torch.where(too_small, float("-inf"), scores)
    keep, valid = greedy_nms(row_boxes.view(n * levels, width, 4), row_scores.view(n * levels, width), nms_thresh,
                             keep_ks * n)
    keep, valid = keep.view(n, levels, -1), valid.view(n, levels, -1)
    all_boxes, all_scores = [], []
    for level, kk in enumerate(keep_ks):
        idx = keep[:, level, :kk]
        all_boxes.append(torch.gather(row_boxes[:, level], 1, idx[..., None].expand(n, kk, 4)))
        all_scores.append(torch.where(valid[:, level, :kk], torch.gather(row_scores[:, level], 1, idx),
                                      float("-inf")))
    boxes, scores = torch.cat(all_boxes, 1), torch.cat(all_scores, 1)
    top = top_k_indices(scores, min(post_nms_topk, scores.shape[1]))
    top_scores = torch.gather(scores, 1, top)
    return torch.gather(boxes, 1, top[..., None].expand(*top.shape, 4)), top_scores, torch.isfinite(top_scores)
