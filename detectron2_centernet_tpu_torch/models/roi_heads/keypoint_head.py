"""Keypoint head (counterpart of the JAX package's
``models/roi_heads/keypoint_head.py``; reference ``roi_heads/keypoint_head.py``).

``KRCNNConvDeconvUpsampleHead`` (:215): 3x3 convs + ReLU (``conv_fcn{i}``,
at the model's width), a 4x4 stride-2 transposed conv with padding 1 to the
keypoint count (``score_lowres``, in IEEE f32 on an f32 cast of its input,
as the JAX package's f32 ``ConvTranspose`` with ``transpose_kernel``), then
a 2x bilinear upsample (``align_corners=False``: ``jax.image.resize``'s
half-pixel grid, whose renormalised edge weights are the clamped border):
(R, C, P, P) → (R, K, 4P, 4P) logits.

``encode_keypoint_targets``: each matched keypoint's flat cell in its roi's
heatmap and its validity, on the device (the JAX package's jnp copy of
``structures/keypoints.py::keypoints_to_heatmap_targets``).
``keypoint_rcnn_loss`` (reference :40): softmax cross entropy over the
heatmap's cells at the visible keypoints of the foreground rois, over their
count.
"""

import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import TRUNC_NORMAL_STD
from .mask_head import fan_out_normal_

__all__ = ["KRCNNConvDeconvUpsampleHead", "encode_keypoint_targets", "keypoint_rcnn_loss"]


class F32ConvTranspose2d(nn.ConvTranspose2d):
    """A transposed conv that runs in f32 whatever the model's width."""

    def forward(self, x):
        with torch.autocast(x.device.type, enabled=False):
            return super().forward(x.float())


class KRCNNConvDeconvUpsampleHead(nn.Module):
    def __init__(self, in_channels: int, num_keypoints: int = 17, conv_dims: Sequence[int] = (512,) * 8):
        super().__init__()
        self.num_conv = len(conv_dims)
        c = in_channels
        for i, d in enumerate(conv_dims):
            self.add_module(f"conv_fcn{i + 1}", nn.Conv2d(c, d, 3, padding=1))
            c = d
        self.score_lowres = F32ConvTranspose2d(c, num_keypoints, 4, stride=2, padding=1)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's init: the convs N(0, 2 / fan_out); ``score_lowres``
        flax's lecun normal (its kernel (4, 4, K, C) has fan_in 16·K); biases 0."""
        for i in range(self.num_conv):
            fan_out_normal_(getattr(self, f"conv_fcn{i + 1}").weight, False, generator)
        w = self.score_lowres.weight  # (C, K, 4, 4)
        std = 1.0 / math.sqrt(w[0].numel()) / TRUNC_NORMAL_STD
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                m.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_conv):
            x = F.relu(getattr(self, f"conv_fcn{i + 1}")(x))
        x = self.score_lowres(x)
        return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


def encode_keypoint_targets(keypoints: torch.Tensor, rois: torch.Tensor,
                            heatmap_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S, K, 3) matched keypoints (x, y, visibility) and (S, 4) rois →
    (flat cell (S, K) int64, 0 where invalid; validity (S, K) f32)."""
    x, y = keypoints[..., 0], keypoints[..., 1]
    vis = keypoints[..., 2] > 0
    w = torch.clamp(rois[:, 2:3] - rois[:, 0:1], min=1e-6)
    h = torch.clamp(rois[:, 3:4] - rois[:, 1:2], min=1e-6)
    # a tensor divides the size (torch's ``size / t`` multiplies by t's reciprocal, one more rounding)
    sx, sy = torch.full_like(w, heatmap_size) / w, torch.full_like(h, heatmap_size) / h
    hx = (x - rois[:, 0:1]) * sx
    hy = (y - rois[:, 1:2]) * sy
    hx_i = torch.where(hx == heatmap_size, float(heatmap_size - 1), torch.floor(hx))
    hy_i = torch.where(hy == heatmap_size, float(heatmap_size - 1), torch.floor(hy))
    valid_loc = (hx_i >= 0) & (hy_i >= 0) & (hx_i < heatmap_size) & (hy_i < heatmap_size)
    valid = (valid_loc & vis).to(torch.float32)
    idx = (hy_i * heatmap_size + hx_i).to(torch.int64)
    return torch.where(valid > 0, idx, 0), valid


def keypoint_rcnn_loss(logits: torch.Tensor, kp_indices: torch.Tensor, kp_valid: torch.Tensor,
                       fg_weights: torch.Tensor) -> torch.Tensor:
    """(S, K, H, W) logits, (S, K) target cells and validity, (S,)
    foreground weights → -Σ log p(target) / the weighted count (at least 1)."""
    s, k = logits.shape[:2]
    logp = torch.log_softmax(logits.reshape(s, k, -1), dim=2)
    picked = torch.gather(logp, 2, kp_indices[..., None])[..., 0]
    wgt = kp_valid.to(torch.float32) * fg_weights[:, None]
    return -(picked * wgt).sum() / torch.clamp(wgt.sum(), min=1.0)
