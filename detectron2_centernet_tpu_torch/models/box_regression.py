"""Box delta transforms (counterpart of the JAX package's
``models/box_regression.py``; reference ``modeling/box_regression.py``).

``Box2BoxTransform``: the weighted (dx, dy, dw, dh) deltas between source
and target XYXY boxes (sizes floored at 1e-8), and their inverse, with dw
and dh clamped at log(1000/16) from above. The rotated transform is not
ported yet (ROADMAP A16).
"""

import math
from typing import Sequence

import torch

__all__ = ["Box2BoxTransform"]

_DEFAULT_SCALE_CLAMP = math.log(1000.0 / 16)


class Box2BoxTransform:
    def __init__(self, weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
                 scale_clamp: float = _DEFAULT_SCALE_CLAMP):
        self.weights = tuple(float(w) for w in weights)
        self.scale_clamp = scale_clamp

    def get_deltas(self, src_boxes: torch.Tensor, target_boxes: torch.Tensor) -> torch.Tensor:
        """XYXY (..., 4) → weighted deltas (..., 4)."""
        src_w = src_boxes[..., 2] - src_boxes[..., 0]
        src_h = src_boxes[..., 3] - src_boxes[..., 1]
        src_cx = src_boxes[..., 0] + 0.5 * src_w
        src_cy = src_boxes[..., 1] + 0.5 * src_h
        tgt_w = target_boxes[..., 2] - target_boxes[..., 0]
        tgt_h = target_boxes[..., 3] - target_boxes[..., 1]
        tgt_cx = target_boxes[..., 0] + 0.5 * tgt_w
        tgt_cy = target_boxes[..., 1] + 0.5 * tgt_h

        wx, wy, ww, wh = self.weights
        eps = 1e-8
        dx = wx * (tgt_cx - src_cx) / torch.clamp(src_w, min=eps)
        dy = wy * (tgt_cy - src_cy) / torch.clamp(src_h, min=eps)
        dw = ww * torch.log(torch.clamp(tgt_w, min=eps) / torch.clamp(src_w, min=eps))
        dh = wh * torch.log(torch.clamp(tgt_h, min=eps) / torch.clamp(src_h, min=eps))
        return torch.stack([dx, dy, dw, dh], dim=-1)

    def apply_deltas(self, deltas: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """Deltas (..., k·4) applied to boxes (..., 4) → (..., k·4) XYXY."""
        boxes = boxes.to(deltas.dtype)
        widths = boxes[..., 2] - boxes[..., 0]
        heights = boxes[..., 3] - boxes[..., 1]
        ctr_x = boxes[..., 0] + 0.5 * widths
        ctr_y = boxes[..., 1] + 0.5 * heights

        wx, wy, ww, wh = self.weights
        shape = deltas.shape
        d = deltas.reshape(shape[:-1] + (-1, 4))
        dx = d[..., 0] / wx
        dy = d[..., 1] / wy
        dw = torch.clamp(d[..., 2] / ww, max=self.scale_clamp)
        dh = torch.clamp(d[..., 3] / wh, max=self.scale_clamp)

        pred_ctr_x = dx * widths[..., None] + ctr_x[..., None]
        pred_ctr_y = dy * heights[..., None] + ctr_y[..., None]
        pred_w = torch.exp(dw) * widths[..., None]
        pred_h = torch.exp(dh) * heights[..., None]
        out = torch.stack([pred_ctr_x - 0.5 * pred_w, pred_ctr_y - 0.5 * pred_h,
                           pred_ctr_x + 0.5 * pred_w, pred_ctr_y + 0.5 * pred_h], dim=-1)
        return out.reshape(shape)
