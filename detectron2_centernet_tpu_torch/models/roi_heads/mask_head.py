"""Mask head (counterpart of the JAX package's
``models/roi_heads/mask_head.py``; reference ``roi_heads/mask_head.py``).

``MaskRCNNConvUpsampleHead`` (:207): ``num_conv`` 3x3 convs + ReLU
(``mask_fcn{i}``), a 2x2 stride-2 transposed conv + ReLU (``deconv``) and a
1x1 per-class predictor (``predictor``), NCHW: (R, C, P, P) pooled rois →
(R, num_classes, 2P, 2P) logits, or only each roi's class's (R, 2P, 2P),
which is what inference and the loss read (at LVIS's 1203 classes the
whole tensor of a batch-16 call of 300 detections would be 18 GB). The
convs run at the model's width under autocast; the predictor in IEEE f32 on
an f32 cast of its input, as the JAX package's ``dtype=jnp.float32`` conv.

``crop_gt_masks``: each sampled roi's (M, M) target, bilinearly sampled out
of its matched gt's raster (``structures/masks.py::rasterize_in_box``, made
once in the mapper) on the roi's box, the sample grid ``linspace`` over the
roi including both ends, zero outside the raster; the JAX package's f32
arithmetic op for op (its ``jnp.linspace`` as XLA compiles it included).

``mask_rcnn_loss`` (reference :32-111): mean BCE of the logits at each
roi's gt class (the head's ``classes``) against the target > 0.5, over the
foreground rois.

``CoarseMaskHead`` (JAX ``:45-84``; reference PointRend's
``coarse_mask_head.py``): a 1x1 ``reduce_channel_dim_conv`` + ReLU when the
input is wider than ``conv_dim``, a 2x2 stride-2 ``reduce_spatial_dim_conv``
+ ReLU (flax's SAME: an odd side padded at its end), the map flattened
(C, H, W)-major, as the reference (JAX flattens (H, W, C); ``fc1``'s input
is permuted when weights cross, ``checkpoint/from_jax.py``), ``num_fc`` f32
``coarse_mask_fc{i}`` + ReLU and the f32 ``prediction`` of classes ×
side² logits, (class, y, x)-major: (R, C, P, P) → (R, classes, side, side).
"""

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..meta_arch.centernet import F32Conv2d

__all__ = ["CoarseMaskHead", "MaskRCNNConvUpsampleHead", "crop_gt_masks", "fan_out_normal_", "mask_rcnn_loss"]


@torch.no_grad()
def fan_out_normal_(weight: torch.Tensor, transposed: bool, generator: torch.Generator) -> None:
    """flax's ``variance_scaling(2.0, "fan_out", "normal")``: N(0, 2 / fan_out),
    fan_out the output channels times the kernel's area (a transposed conv's
    weight is (Cin, Cout, kh, kw), a conv's (Cout, Cin, kh, kw))."""
    fan_out = weight.shape[1 if transposed else 0] * weight[0, 0].numel()
    weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)


class MaskRCNNConvUpsampleHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: int, num_conv: int = 4, conv_dim: int = 256):
        super().__init__()
        self.num_conv = num_conv
        c = in_channels
        for i in range(num_conv):
            self.add_module(f"mask_fcn{i + 1}", nn.Conv2d(c, conv_dim, 3, padding=1))
            c = conv_dim
        self.deconv = nn.ConvTranspose2d(c, conv_dim, 2, stride=2)
        self.predictor = F32Conv2d(conv_dim, num_classes, 1)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's init: the convs and the deconv N(0, 2 / fan_out),
        the predictor N(0, 0.001), biases 0."""
        for i in range(self.num_conv):
            fan_out_normal_(getattr(self, f"mask_fcn{i + 1}").weight, False, generator)
        fan_out_normal_(self.deconv.weight, True, generator)
        self.predictor.weight.normal_(0.0, 0.001, generator=generator)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                m.bias.zero_()

    def forward(self, x: torch.Tensor, classes: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(R, C, P, P) → the (R, num_classes, 2P, 2P) logits, or with
        ``classes`` (R,) only each roi's class, (R, 2P, 2P): a 1x1 conv's
        output for class c reads only its weight row c and bias c, so the
        rows of the other classes (1202 of LVIS's 1203) are never made."""
        for i in range(self.num_conv):
            x = F.relu(getattr(self, f"mask_fcn{i + 1}")(x))
        x = F.relu(self.deconv(x))
        if classes is None:
            return self.predictor(x)
        with torch.autocast(x.device.type, enabled=False):
            w = self.predictor.weight[classes, :, 0, 0]  # (R, D), f32
            out = torch.bmm(w[:, None, :], x.float().flatten(2))[:, 0] + self.predictor.bias[classes][:, None]
        return out.view(x.shape[0], *x.shape[2:])


class CoarseMaskHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: int, input_side: int, conv_dim: int = 256,
                 fc_dim: int = 1024, num_fc: int = 2, output_side: int = 7):
        super().__init__()
        self.num_classes, self.num_fc, self.output_side = num_classes, num_fc, output_side
        c = in_channels
        self.reduce_channel_dim_conv = nn.Conv2d(c, conv_dim, 1) if c > conv_dim else None
        self.reduce_spatial_dim_conv = nn.Conv2d(conv_dim if c > conv_dim else c, conv_dim, 2, stride=2)
        d = conv_dim * (-(-input_side // 2)) ** 2
        for i in range(num_fc):
            self.add_module(f"coarse_mask_fc{i + 1}", nn.Linear(d, fc_dim))
            d = fc_dim
        self.prediction = nn.Linear(d, num_classes * output_side ** 2)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's init of ``prediction``: N(0, 0.001), bias 0."""
        self.prediction.weight.normal_(0.0, 0.001, generator=generator)
        self.prediction.bias.zero_()

    def forward(self, x: torch.Tensor, classes: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(R, C, P, P) → the (R, num_classes, side, side) f32 logits, or
        with ``classes`` (R,) each roi's class's, (R, side, side)."""
        if self.reduce_channel_dim_conv is not None:
            x = F.relu(self.reduce_channel_dim_conv(x))
        x = F.pad(x, (0, x.shape[-1] % 2, 0, x.shape[-2] % 2))  # flax's SAME at stride 2
        x = F.relu(self.reduce_spatial_dim_conv(x))
        with torch.autocast(x.device.type, enabled=False):
            x = x.float().flatten(1)
            for i in range(self.num_fc):
                x = F.relu(getattr(self, f"coarse_mask_fc{i + 1}")(x))
            x = self.prediction(x).view(-1, self.num_classes, self.output_side, self.output_side)
        return x if classes is None else x[torch.arange(x.shape[0], device=x.device), classes]


def _linspace(lo: torch.Tensor, hi: torch.Tensor, num: int) -> torch.Tensor:
    """``jnp.linspace(lo, hi, num)`` per row of (S,) ends, in f32 as XLA
    computes it: step = i · f32(1/(num-1)), then hi·step fused (one rounding)
    onto the rounded lo·(1 - step); the last one hi. The fused multiply-add
    is taken in f64, where the f32 product is exact."""
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=lo.device) * torch.tensor(1.0 / div, dtype=torch.float32)
    low = lo[:, None] * (1 - step)
    out = (hi[:, None].double() * step.double() + low.double()).float()
    return torch.cat([out, hi[:, None]], 1)


def crop_gt_masks(gt_rasters: torch.Tensor, gt_boxes: torch.Tensor, matched_idx: torch.Tensor,
                  roi_boxes: torch.Tensor, mask_size: int) -> torch.Tensor:
    """(S, mask_size, mask_size) f32 targets of S rois: gt rasters (N, M, R,
    R), gt boxes (N, M, 4), the rois' matched gt (N, S') and boxes (N, S', 4),
    S = N·S', image-major."""
    n, m, r = gt_rasters.shape[:3]
    s = matched_idx.shape[1]
    img = torch.arange(n, device=matched_idx.device)[:, None].expand(n, s)
    raster = gt_rasters.to(torch.float32)[img, matched_idx].reshape(n * s, r * r)
    gb = gt_boxes.to(torch.float32)[img, matched_idx].reshape(n * s, 4)
    roi = roi_boxes.to(torch.float32).reshape(n * s, 4)
    gw = torch.clamp(gb[:, 2] - gb[:, 0], min=1e-2)
    gh = torch.clamp(gb[:, 3] - gb[:, 1], min=1e-2)
    # a tensor divides r (torch's ``r / t`` multiplies by t's reciprocal, one more rounding)
    xs = (_linspace(roi[:, 0], roi[:, 2], mask_size) - gb[:, 0:1]) * (torch.full_like(gw, r) / gw)[:, None] - 0.5
    ys = (_linspace(roi[:, 1], roi[:, 3], mask_size) - gb[:, 1:2]) * (torch.full_like(gh, r) / gh)[:, None] - 0.5
    x0, y0 = torch.floor(xs), torch.floor(ys)
    out = torch.zeros((n * s, mask_size, mask_size), dtype=torch.float32, device=raster.device)
    for dy in (0, 1):
        for dx in (0, 1):
            yy, xx = y0 + dy, x0 + dx
            wy = (1.0 - torch.abs(ys - yy)) * ((yy >= 0) & (yy < r))
            wx = (1.0 - torch.abs(xs - xx)) * ((xx >= 0) & (xx < r))
            yi = torch.clamp(yy, 0, r - 1).to(torch.int64)
            xi = torch.clamp(xx, 0, r - 1).to(torch.int64)
            vals = torch.gather(raster, 1, (yi[:, :, None] * r + xi[:, None, :]).reshape(n * s, -1))
            out = out + vals.reshape(n * s, mask_size, mask_size) * (wy[:, :, None] * wx[:, None, :])
    return out


def mask_rcnn_loss(mask_logits: torch.Tensor, gt_masks: torch.Tensor, fg_weights: torch.Tensor) -> torch.Tensor:
    """(S, M, M) logits at each roi's gt class (the head's ``classes``; a
    background roi's any class, as it weighs 0), (S, M, M) targets, (S,)
    foreground weights → the mean BCE over the foreground rois."""
    targets = (gt_masks > 0.5).to(torch.float32)
    ce = torch.clamp(mask_logits, min=0) - mask_logits * targets + torch.log1p(torch.exp(-torch.abs(mask_logits)))
    per_roi = ce.mean(dim=(1, 2))
    num_fg = torch.clamp(fg_weights.sum(), min=1.0)
    return (per_roi * fg_weights).sum() / num_fg
