"""Fixed-size greedy non-maximum suppression, batched over images
(counterpart of the JAX package's ``ops/nms.py``).

The JAX package writes NMS as a ``lax.fori_loop`` of K greedy picks per
image (vmapped over the batch): each pick takes the highest live score,
then kills every candidate whose IoU with it is above the threshold. Here
one loop of K iterations serves the whole batch: every step is a handful
of (N, C) tensor ops, so the launches do not grow with N. ``-inf`` marks a
dead candidate; a pick whose score is ``-inf`` is invalid, and its index is
that of the first maximal (``-inf``) entry, as JAX's ``argmax`` gives it.

There is no torchvision in the port: this is its own NMS, on whatever
device the candidates live on.
"""

from typing import Tuple

import torch

__all__ = ["batched_nms_fixed", "nms_fixed", "pairwise_iou_xyxy"]


def _areas(boxes: torch.Tensor) -> torch.Tensor:
    return torch.clamp(boxes[..., 2] - boxes[..., 0], min=0) * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0)


def _iou(inter: torch.Tensor, union: torch.Tensor) -> torch.Tensor:
    """``where(union > 0, inter / max(union, 1e-12), 0)``, the JAX package's
    guard for empty boxes."""
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-12), torch.zeros((), dtype=inter.dtype,
                                                                                        device=inter.device))


def pairwise_iou_xyxy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU between (..., N, 4) and (..., M, 4) XYXY boxes → (..., N, M)."""
    area_a, area_b = _areas(a), _areas(b)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return _iou(inter, union)


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
              max_out: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS of (N, C, 4) XYXY boxes by (N, C) scores (``-inf`` for an
    invalid candidate): ``max_out`` picks per image, always. Returns
    (keep_idx (N, K) int64, keep_valid (N, K) bool); suppression is
    ``iou > iou_threshold``."""
    n = scores.shape[0]
    dev = scores.device
    live = scores.clone()
    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype, device=dev)
    areas = _areas(boxes)  # (N, C)
    keep = torch.zeros(n, max_out, dtype=torch.int64, device=dev)
    valid = torch.zeros(n, max_out, dtype=torch.bool, device=dev)
    for i in range(max_out):
        j = torch.argmax(live, dim=1, keepdim=True)  # (N, 1): the first maximal entry
        ok = torch.gather(live, 1, j) > neg_inf  # (N, 1)
        keep[:, i:i + 1] = j
        valid[:, i:i + 1] = ok
        box = torch.gather(boxes, 1, j[:, :, None].expand(n, 1, 4))  # (N, 1, 4)
        lt = torch.maximum(box[..., :2], boxes[..., :2])
        rb = torch.minimum(box[..., 2:], boxes[..., 2:])
        wh = torch.clamp(rb - lt, min=0)
        inter = wh[..., 0] * wh[..., 1]
        union = torch.gather(areas, 1, j) + areas - inter
        suppress = (_iou(inter, union) > iou_threshold) & ok
        live = torch.where(suppress, neg_inf, live).scatter_(1, j, float("-inf"))
    return keep, valid


def batched_nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
                      iou_threshold: float, max_out: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-aware NMS by the coordinate-offset trick (reference
    ``layers/nms.py:10-31``): each image's boxes shifted by class × (its own
    largest finite coordinate + 1), as the JAX package's vmap computes it
    per image; (N, C, 4), (N, C), (N, C) → ``nms_fixed``'s pair."""
    finite = torch.where(torch.isfinite(boxes), boxes, torch.zeros((), dtype=boxes.dtype, device=boxes.device))
    max_coord = finite.flatten(1).amax(dim=1) + 1.0  # (N,)
    offsets = classes.to(boxes.dtype)[:, :, None] * max_coord[:, None, None]
    return nms_fixed(boxes + offsets, scores, iou_threshold, max_out)
