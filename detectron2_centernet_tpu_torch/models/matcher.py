"""IoU-threshold matching (counterpart of the JAX package's
``models/matcher.py``; reference ``modeling/matcher.py``).

Each predicted element (an anchor) gets its best ground truth and a label
in {-1, 0, 1} by the threshold bands, with the low-quality rescue that
makes every gt's highest-IoU anchor(s) positive. Fixed shapes: gt slots are
masked by ``gt_valid`` (an invalid row is ``-inf``) instead of varying in
number. Works on one image or on a batch (leading dimensions).
"""

from typing import Sequence, Tuple

import torch

__all__ = ["Matcher"]


class Matcher:
    def __init__(self, thresholds: Sequence[float], labels: Sequence[int],
                 allow_low_quality_matches: bool = False) -> None:
        thresholds = [-float("inf")] + list(thresholds) + [float("inf")]
        if not (thresholds[1] > 0 and all(lo <= hi for lo, hi in zip(thresholds[:-1], thresholds[1:]))
                and all(label in (-1, 0, 1) for label in labels) and len(labels) == len(thresholds) - 1):
            raise ValueError(f"Matcher: IoU thresholds {thresholds[1:-1]} must be positive and sorted, with "
                             f"one label in {{-1, 0, 1}} per band, got labels {list(labels)}")
        self.thresholds = thresholds
        self.labels = list(labels)
        self.allow_low_quality_matches = allow_low_quality_matches

    def __call__(self, match_quality_matrix: torch.Tensor,
                 gt_valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """matrix (..., M_gt, N_pred) IoUs, gt_valid (..., M_gt) bool →
        (matches (..., N) int64 gt index, match_labels (..., N) int8).

        The first maximal gt wins (``argmax``, whose first index torch
        promises; ``max(dim)``'s index is not promised to be the first on
        CUDA). With no valid gt every label is 0."""
        valid = gt_valid.to(torch.bool)[..., :, None]
        q = torch.where(valid, match_quality_matrix,
                        torch.tensor(float("-inf"), dtype=match_quality_matrix.dtype,
                                     device=match_quality_matrix.device))
        matched_vals = q.amax(dim=-2)
        matches = torch.argmax(q, dim=-2)
        match_labels = torch.full(matches.shape, self.labels[0], dtype=torch.int8, device=q.device)
        for label, low, high in zip(self.labels, self.thresholds[:-1], self.thresholds[1:]):
            in_band = (matched_vals >= low) & (matched_vals < high)
            match_labels = torch.where(in_band, torch.tensor(label, dtype=torch.int8, device=q.device),
                                       match_labels)
        if self.allow_low_quality_matches:
            # for each gt, the anchors at exactly its best IoU become positives
            highest_per_gt = q.amax(dim=-1, keepdim=True)  # (..., M, 1)
            is_best = (q == highest_per_gt) & valid & (highest_per_gt > 0)
            match_labels = torch.where(is_best.any(dim=-2), torch.tensor(1, dtype=torch.int8, device=q.device),
                                       match_labels)
        any_gt = gt_valid.to(torch.bool).any(dim=-1, keepdim=True)
        return matches, torch.where(any_gt, match_labels, torch.zeros_like(match_labels))
