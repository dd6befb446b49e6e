"""Panoptic Quality (a copy of the JAX package's
``evaluation/panoptic_evaluation.py``; reference
``detectron2/evaluation/panoptic_evaluation.py``, which defers to
panopticapi, absent here as there): PQ, SQ and RQ from the published
definition, numpy on the host. Segments match when a ground truth and a
prediction of one category overlap at IoU > 0.5 (unique by construction);
PQ = sum(IoU of the matches) / (TP + FP/2 + FN/2), averaged over the
categories seen.
"""

import logging
from collections import OrderedDict
from typing import Dict, List, Tuple

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["PanopticEvaluator", "pq_compute_single_image"]


def pq_compute_single_image(pan_gt: np.ndarray, gt_segments: List[dict], pan_pred: np.ndarray,
                            pred_segments: List[dict]) -> Dict[int, Dict[str, float]]:
    """One image's {category: {tp, fp, fn, iou_sum}}: ``pan_gt`` and
    ``pan_pred`` (H, W) segment ids (0 void), their segments
    ``{id, category_id, iscrowd?}``. A prediction unmatched but more than
    half on void (or on a crowd region of its category) is no false
    positive."""
    gt_by_id = {s["id"]: s for s in gt_segments}
    pred_by_id = {s["id"]: s for s in pred_segments}
    stats: Dict[int, Dict[str, float]] = {}

    def stat(cat):
        return stats.setdefault(cat, {"tp": 0, "fp": 0, "fn": 0, "iou_sum": 0.0})

    # the joint histogram of (gt segment, predicted segment) overlaps
    base = int(pan_pred.max() + 2)
    ids, counts = np.unique(pan_gt.astype(np.int64) * base + pan_pred.astype(np.int64), return_counts=True)
    inter: Dict[Tuple[int, int], int] = {(int(v // base), int(v % base)): int(c) for v, c in zip(ids, counts)}
    gt_area = {int(i): int(c) for i, c in zip(*np.unique(pan_gt, return_counts=True))}
    pred_area = {int(i): int(c) for i, c in zip(*np.unique(pan_pred, return_counts=True))}

    matched_gt, matched_pred = set(), set()
    for (gid, pid), c in inter.items():
        if gid == 0 or pid == 0 or gid not in gt_by_id or pid not in pred_by_id:
            continue
        g, p = gt_by_id[gid], pred_by_id[pid]
        if g["category_id"] != p["category_id"] or g.get("iscrowd", 0):
            continue
        union = gt_area[gid] + pred_area[pid] - c
        iou = c / union if union > 0 else 0.0
        if iou > 0.5:
            s = stat(g["category_id"])
            s["tp"] += 1
            s["iou_sum"] += iou
            matched_gt.add(gid)
            matched_pred.add(pid)

    crowd_by_cat = {}
    for s in gt_segments:
        if s.get("iscrowd", 0):
            crowd_by_cat[s["category_id"]] = s["id"]
        elif s["id"] not in matched_gt:
            stat(s["category_id"])["fn"] += 1
    for s in pred_segments:
        pid = s["id"]
        if pid in matched_pred:
            continue
        void_overlap = inter.get((0, pid), 0)
        crowd_id = crowd_by_cat.get(s["category_id"])
        if crowd_id is not None:
            void_overlap += inter.get((crowd_id, pid), 0)
        if pred_area.get(pid, 0) and void_overlap / pred_area[pid] > 0.5:
            continue
        stat(s["category_id"])["fp"] += 1
    return stats


class PanopticEvaluator:
    """Sums the images' per-category stats and reports PQ, SQ and RQ (in %)."""

    def __init__(self) -> None:
        self._stats: Dict[int, Dict[str, float]] = {}

    def reset(self) -> None:
        self._stats = {}

    def update(self, image_stats: Dict[int, Dict[str, float]]) -> None:
        for cat, s in image_stats.items():
            agg = self._stats.setdefault(cat, {"tp": 0, "fp": 0, "fn": 0, "iou_sum": 0.0})
            for k in s:
                agg[k] += s[k]

    def summarize(self) -> Dict[str, float]:
        pqs, sqs, rqs = [], [], []
        for s in self._stats.values():
            tp, fp, fn = s["tp"], s["fp"], s["fn"]
            if tp + fp + fn == 0:
                continue
            sq = s["iou_sum"] / tp if tp else 0.0
            rq = tp / (tp + 0.5 * fp + 0.5 * fn)
            pqs.append(sq * rq)
            sqs.append(sq)
            rqs.append(rq)
        if not pqs:
            return {"PQ": float("nan"), "SQ": float("nan"), "RQ": float("nan")}
        out = OrderedDict(PQ=100 * float(np.mean(pqs)), SQ=100 * float(np.mean(sqs)), RQ=100 * float(np.mean(rqs)))
        logger.info("Panoptic results: %s", dict(out))
        return out
