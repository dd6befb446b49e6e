"""Box delta transforms (counterpart of the JAX package's
``models/box_regression.py``; reference ``modeling/box_regression.py``).

``Box2BoxTransform``: the weighted (dx, dy, dw, dh) deltas between source
and target XYXY boxes (sizes floored at 1e-8), and their inverse, with dw
and dh clamped at log(1000/16) from above. ``Box2BoxTransformRotated``:
the (dx, dy, dw, dh, da) deltas of (cx, cy, w, h, angle) boxes, angles in
degrees, the angle difference wrapped to [-180, 180) by ``torch.remainder``
(whose sign follows the divisor, as ``%`` in jnp; ``torch.fmod`` would not),
da in radians times its weight.
"""

import math
from typing import Sequence

import torch

__all__ = ["Box2BoxTransform", "Box2BoxTransformRotated"]

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


def _wrap_degrees(a: torch.Tensor) -> torch.Tensor:
    """``(a + 180) % 360 - 180`` as jnp computes it: [-180, 180)."""
    return torch.remainder(a + 180.0, 360.0) - 180.0


class Box2BoxTransformRotated:
    """5-parameter deltas of rotated boxes (JAX ``Box2BoxTransformRotated``;
    reference box_regression.py:114-212)."""

    def __init__(self, weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0, 1.0),
                 scale_clamp: float = _DEFAULT_SCALE_CLAMP):
        self.weights = tuple(float(w) for w in weights)
        self.scale_clamp = scale_clamp

    def get_deltas(self, src: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """(..., 5) boxes → weighted (..., 5) deltas, sizes floored at 1e-8."""
        wx, wy, ww, wh, wa = self.weights
        eps = 1e-8
        dx = wx * (target[..., 0] - src[..., 0]) / torch.clamp(src[..., 2], min=eps)
        dy = wy * (target[..., 1] - src[..., 1]) / torch.clamp(src[..., 3], min=eps)
        dw = ww * torch.log(torch.clamp(target[..., 2], min=eps) / torch.clamp(src[..., 2], min=eps))
        dh = wh * torch.log(torch.clamp(target[..., 3], min=eps) / torch.clamp(src[..., 3], min=eps))
        da = _wrap_degrees(target[..., 4] - src[..., 4])
        return torch.stack([dx, dy, dw, dh, wa * da * math.pi / 180.0], dim=-1)

    def apply_deltas(self, deltas: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """(..., 5) deltas on (..., 5) boxes → (..., 5) boxes, dw and dh
        clamped at log(1000/16), the angle wrapped to [-180, 180)."""
        wx, wy, ww, wh, wa = self.weights
        boxes = boxes.to(deltas.dtype)
        dx = deltas[..., 0] / wx
        dy = deltas[..., 1] / wy
        dw = torch.clamp(deltas[..., 2] / ww, max=self.scale_clamp)
        dh = torch.clamp(deltas[..., 3] / wh, max=self.scale_clamp)
        da = deltas[..., 4] * 180.0 / math.pi / wa
        cx = dx * boxes[..., 2] + boxes[..., 0]
        cy = dy * boxes[..., 3] + boxes[..., 1]
        w = torch.exp(dw) * boxes[..., 2]
        h = torch.exp(dh) * boxes[..., 3]
        a = _wrap_degrees(boxes[..., 4] + da)
        return torch.stack([cx, cy, w, h, a], dim=-1)
