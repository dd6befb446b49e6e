"""PointRend's point head and its point sampling (counterpart of the JAX
package's ``models/roi_heads/point_head.py``; reference
``projects/PointRend``), batched over the rois or images, fixed shapes.

``point_sample`` (JAX ``:23-49``): bilinear samples of (B, C, H, W) maps at
(B, P, 2) normalized (x, y) in [0, 1] (pixel centres at (i + 0.5) / size),
the corners clamped into the map (the lower one to [0, size - 2], the
fraction to [0, 1]): the border value beyond the outer centres.

``sample_uncertain_points`` (JAX ``:52-71``): the paper's biased sampling
with its draws as arguments, k·P candidates (``cand``), the
``int(importance · P)`` whose coarse logit is nearest 0 (the first on
ties), then the uniform rest (``rand``).

``PointHead`` (JAX ``:74-94``): a shared MLP over [fine feature, coarse
logits] per point, the coarse logits appended again after every hidden
layer (``fc{i}``, ReLU), an f32 ``predictor``; nn.Linear, where the
reference's ``StandardPointHead`` has 1x1 Conv1d (a reference ``.pth``'s
(O, I, 1) kernels match no leaf in either package).

``refine_mask_with_points`` (JAX ``:97-123``): per step a 2x bilinear
upsample of the (R, H, W) logits, then the ``num_points`` most uncertain
(|logit| smallest, the first on ties) re-predicted in place from the fine
features sampled at their centres.
"""

from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..proposal_generator.rpn import top_k_indices

__all__ = ["PointHead", "point_sample", "refine_mask_with_points", "sample_uncertain_points"]


def point_sample(feat: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) maps at (B, P, 2) normalized points → (B, P, C)."""
    b, c, h, w = feat.shape
    x = coords[..., 0] * w - 0.5
    y = coords[..., 1] * h - 0.5
    x0 = torch.clamp(torch.floor(x), 0, w - 2)
    y0 = torch.clamp(torch.floor(y), 0, h - 2)
    lx = torch.clamp(x - x0, 0.0, 1.0)
    ly = torch.clamp(y - y0, 0.0, 1.0)
    idx = y0.to(torch.int64) * w + x0.to(torch.int64)  # (B, P)
    flat = feat.reshape(b, c, h * w)

    def g(offset):
        return torch.gather(flat, 2, (idx + offset)[:, None, :].expand(b, c, idx.shape[1])).transpose(1, 2)

    return (g(0) * ((1 - ly) * (1 - lx))[..., None] + g(1) * ((1 - ly) * lx)[..., None]
            + g(w) * (ly * (1 - lx))[..., None] + g(w + 1) * (ly * lx)[..., None])


def sample_uncertain_points(logits: torch.Tensor, cand: torch.Tensor, rand: torch.Tensor, num_points: int,
                            importance: float) -> torch.Tensor:
    """(R, H, W) coarse logits, (R, k·P, 2) uniform candidates and (R, P -
    int(importance · P), 2) uniform points, P ``num_points`` → (R, P, 2)
    points: the ``int(importance · P)`` candidates nearest the decision
    boundary, then ``rand``."""
    n_imp = int(importance * num_points)
    if rand.shape[1] != num_points - n_imp:
        raise ValueError(f"{num_points} points at importance {importance} take {num_points - n_imp} uniform ones, "
                         f"not {rand.shape[1]}")
    vals = point_sample(logits[:, None], cand)[..., 0]
    idx = top_k_indices(-torch.abs(vals), n_imp)
    picked = torch.gather(cand, 1, idx[..., None].expand(*idx.shape, 2))
    return torch.cat([picked, rand], 1)


class PointHead(nn.Module):
    """fine (..., P, Cf), coarse (..., P, C) → f32 point logits (..., P,
    num_classes). The hidden layers run at the caller's width under
    autocast, the predictor in f32."""

    def __init__(self, fine_channels: int, coarse_channels: int, num_classes: int, fc_dim: int = 256,
                 num_fc: int = 3):
        super().__init__()
        self.num_fc = num_fc
        c = fine_channels + coarse_channels
        for i in range(num_fc):
            self.add_module(f"fc{i + 1}", nn.Linear(c, fc_dim))
            c = fc_dim + coarse_channels
        self.predictor = nn.Linear(c, num_classes)

    def forward(self, fine: torch.Tensor, coarse: torch.Tensor) -> torch.Tensor:
        x = torch.cat([fine, coarse.to(fine.dtype)], -1)
        for i in range(self.num_fc):
            x = F.relu(getattr(self, f"fc{i + 1}")(x))
            x = torch.cat([x, coarse.to(x.dtype)], -1)
        with torch.autocast(x.device.type, enabled=False):
            return self.predictor(x.float())


def refine_mask_with_points(mask_logits: torch.Tensor, fine: torch.Tensor,
                            point_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor], num_points: int,
                            steps: int) -> torch.Tensor:
    """(R, H, W) logits of one class per roi, (R, C, Hf, Wf) fine features
    → (R, H·2^steps, W·2^steps) refined logits; ``point_fn(fine (R, K, C),
    coarse (R, K, 1))`` gives the (R, K, 1) re-predictions."""
    m = mask_logits
    for _ in range(steps):
        m = F.interpolate(m[:, None], scale_factor=2, mode="bilinear", align_corners=False)[:, 0]
        r, h, w = m.shape
        flat = m.reshape(r, h * w)
        idx = top_k_indices(-torch.abs(flat), min(num_points, h * w))
        coords = torch.stack([((idx % w).to(torch.float32) + 0.5) / w,
                              (torch.div(idx, w, rounding_mode="floor").to(torch.float32) + 0.5) / h], -1)
        coarse = torch.gather(flat, 1, idx)[..., None]
        refined = point_fn(point_sample(fine, coords), coarse)[..., 0]
        m = flat.scatter(1, idx, refined.to(flat.dtype)).view(r, h, w)
    return m
