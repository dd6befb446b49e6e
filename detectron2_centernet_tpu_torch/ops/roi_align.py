"""ROIAlign over one feature map or an FPN pyramid, in plain PyTorch with
autograd (counterpart of the JAX package's ``ops/roi_align.py``; reference
``layers/roi_align.py`` with ``aligned=True`` and ``modeling/poolers.py``).

Each output bin averages ``sampling_ratio``² bilinear samples, with the
``aligned=True`` half-pixel shift (the only mode the port has). A sample
with y or x outside (-1, H) or (-1, W) contributes 0; inside, its
coordinates are clamped to [0, H-1] × [0, W-1] and its upper corner to
``min(y0 + 1, H - 1)``, as in the JAX package (and the reference's CUDA).

Layout: features are NCHW, pooled rois come out (R, C, P, P). Every level
of the pyramid goes into one flat channels-last f32 table of
(Σ_l N·H_l·W_l, C) rows; each roi's sample rows are offset to its own
level's base, so one weighted gather serves all rois whatever their level.
Nothing is evaluated at a level a roi is not assigned to (the JAX package
pools every roi at every level and masks), and no feature is copied per
roi. Each output bin is one bag of S² × 4 (sample, corner) rows with their
bilinear weights (0 outside the map, 1/S² for the mean folded in), summed
in f32 by ``F.embedding_bag``: bf16 features are exact in the f32 table and
meet f32 weights, as JAX promotes them. Its backward scatters the features'
gradient into the f32 table (accumulated in f32, rounded to the features'
width once). Boxes get none: the proposals come from detached RPN outputs.

Memory: the table in f32 (16 × 800² images at p2-p5: 870 MB), the (R·P·P,
4·S²) rows and weights, and the f32 output, e.g. 16 × 512 rois × 49 bins ×
256 channels = 411 MB at training; no per-sample temporary of that size
(the JAX formulation holds all S² samples of a corner at once: 4 × that).
"""

import math
from typing import Sequence

import torch
import torch.nn.functional as F

__all__ = ["assign_boxes_to_levels", "multilevel_roi_align", "roi_align"]


def assign_boxes_to_levels(boxes: torch.Tensor, min_level: int, max_level: int,
                           canonical_box_size: int = 224, canonical_level: int = 4) -> torch.Tensor:
    """FPN level of each (R, 4) box (reference ``poolers.py:22-63``, eqn. 1
    of the FPN paper): ``floor(k0 + log2(sqrt(area) / 224 + 1e-8))`` with the
    area floored at 1e-12, clamped to [min_level, max_level]; int64."""
    area = torch.clamp(boxes[:, 2] - boxes[:, 0], min=0) * torch.clamp(boxes[:, 3] - boxes[:, 1], min=0)
    sqrt_area = torch.sqrt(torch.clamp(area, min=1e-12))
    level = torch.floor(canonical_level + torch.log2(sqrt_area / canonical_box_size + 1e-8))
    return torch.clamp(level, min_level, max_level).to(torch.int64)


def _pool(features: Sequence[torch.Tensor], scales: Sequence[float], boxes: torch.Tensor,
          batch_idx: torch.Tensor, level: torch.Tensor, output_size: int, sampling_ratio: int) -> torch.Tensor:
    """Pool each roi from ``features[level[r]]`` (NCHW, one N and C) at
    ``scales[level[r]]``: (R, C, P, P) f32."""
    if sampling_ratio <= 0:
        raise ValueError(f"sampling_ratio must be > 0, got {sampling_ratio}")
    p, s = output_size, sampling_ratio
    dev = boxes.device
    n, c = features[0].shape[:2]
    table = torch.cat([f.permute(0, 2, 3, 1).reshape(-1, c).float() for f in features])  # (Σ N·H·W, C) f32
    sizes = [f.shape[2] * f.shape[3] for f in features]
    bases = torch.tensor([0] + [n * hw for hw in sizes[:-1]], device=dev).cumsum(0)
    heights = torch.tensor([f.shape[2] for f in features], device=dev)
    widths = torch.tensor([f.shape[3] for f in features], device=dev)
    h_i, w_i = heights[level], widths[level]  # (R,) int64
    h_f, w_f = h_i.to(torch.float32)[:, None, None], w_i.to(torch.float32)[:, None, None]
    base = bases[level] + batch_idx.to(torch.int64) * h_i * w_i  # the roi's image in its level

    bx = boxes.to(torch.float32) * torch.tensor(scales, dtype=torch.float32, device=dev)[level][:, None]
    x0, y0, x1, y1 = (bx[:, i] - 0.5 for i in range(4))  # aligned: pixel centers at +0.5
    bin_h, bin_w = (y1 - y0) / p, (x1 - x0) / p
    grid = (torch.arange(p, device=dev)[:, None]
            + (torch.arange(s, device=dev, dtype=torch.float32)[None, :] + 0.5) / s)  # (P, S)
    ys = y0[:, None, None] + bin_h[:, None, None] * grid  # (R, P, S)
    xs = x0[:, None, None] + bin_w[:, None, None] * grid

    rows, weights = [], []  # per bin: S² samples × 4 corners, sample-major
    for sy in range(s):
        y = ys[:, :, sy, None]  # (R, P, 1)
        yc = torch.minimum(torch.clamp(y, min=0.0), h_f - 1)
        ya = torch.floor(yc)
        yb = torch.minimum(ya + 1, h_f - 1)
        ly = yc - ya
        for sx in range(s):
            x = xs[:, None, :, sx]  # (R, 1, P)
            valid = ((y > -1.0) & (y < h_f) & (x > -1.0) & (x < w_f)).to(torch.float32)  # (R, P, P)
            xc = torch.minimum(torch.clamp(x, min=0.0), w_f - 1)
            xa = torch.floor(xc)
            xb = torch.minimum(xa + 1, w_f - 1)
            lx = xc - xa
            for yy, xx, weight in ((ya, xa, (1 - ly) * (1 - lx)), (ya, xb, (1 - ly) * lx),
                                   (yb, xa, ly * (1 - lx)), (yb, xb, ly * lx)):
                rows.append(base[:, None, None] + yy.to(torch.int64) * w_i[:, None, None] + xx.to(torch.int64))
                weights.append(weight * valid / (s * s))
    rows = torch.stack(rows, -1).reshape(-1, 4 * s * s)  # (R·P·P, 4·S²)
    weights = torch.stack(weights, -1).reshape(rows.shape)
    out = F.embedding_bag(rows, table, per_sample_weights=weights, mode="sum")  # (R·P·P, C)
    return out.reshape(-1, p, p, c).permute(0, 3, 1, 2)


def roi_align(features: torch.Tensor, boxes: torch.Tensor, batch_idx: torch.Tensor, spatial_scale: float,
              output_size: int = 7, sampling_ratio: int = 2) -> torch.Tensor:
    """(R, C, P, P) f32 pooled features of (R, 4) XYXY boxes (input
    coordinates, ``spatial_scale`` times the map's) on the (N, C, H, W) map,
    roi r on image ``batch_idx[r]``, ``aligned=True`` (the only mode the
    JAX package's callers use). ``sampling_ratio`` must be > 0."""
    level = torch.zeros(boxes.shape[0], dtype=torch.int64, device=boxes.device)
    return _pool([features], [spatial_scale], boxes, batch_idx, level, output_size, sampling_ratio)


def multilevel_roi_align(features: Sequence[torch.Tensor], strides: Sequence[int], boxes: torch.Tensor,
                         batch_idx: torch.Tensor, output_size: int = 7, sampling_ratio: int = 2) -> torch.Tensor:
    """ROIAlign across an FPN pyramid (levels of consecutive power-of-two
    ``strides``, NCHW), each roi at the level ``assign_boxes_to_levels``
    gives it: (R, C, P, P) f32."""
    min_level, max_level = int(math.log2(strides[0])), int(math.log2(strides[-1]))
    level = assign_boxes_to_levels(boxes, min_level, max_level) - min_level
    return _pool(list(features), [1.0 / st for st in strides], boxes, batch_idx, level, output_size,
                 sampling_ratio)
