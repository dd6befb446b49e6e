"""Box head modules, counterpart of the JAX package's
``models/roi_heads/box_head.py`` (reference ``roi_heads/box_head.py`` and
``fast_rcnn.py``).

``FastRCNNConvFCHead``: ``num_conv`` 3x3 convs + ReLU, then ``num_fc``
fully connected layers + ReLU (keys ``conv{i}``, ``fc{i}``) over pooled
(R, C, P, P) rois, at the model's compute width. The pooled maps are
flattened NCHW, as the reference flattens them, so a reference ``.pth``
loads as it is; the JAX package flattens NHWC, and
``checkpoint/from_jax.py`` permutes ``fc1``'s input dim from (H, W, C) to
(C, H, W) order when its weights cross.

``FastRCNNOutputLayers``: the (C+1)-way ``cls_score`` and the 4C (or 4,
class-agnostic) ``bbox_pred``, in IEEE f32 on an f32 cast of their input,
as the JAX package's ``dtype=jnp.float32`` Dense layers; a 4-D input (the
C4 res5 head's) is first averaged over its map (JAX ``box_head.py:47-48``).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["F32Linear", "FastRCNNConvFCHead", "FastRCNNOutputLayers"]


class F32Linear(nn.Linear):
    """A linear layer that runs in f32 whatever the model's width (CUDA
    matmuls are IEEE f32 unless TF32 is switched on for the process, which
    the port never does)."""

    def forward(self, x):
        with torch.autocast(x.device.type, enabled=False):
            return super().forward(x.float())


class FastRCNNConvFCHead(nn.Module):
    def __init__(self, in_channels: int, resolution: int, num_conv: int = 0, conv_dim: int = 256,
                 num_fc: int = 2, fc_dim: int = 1024):
        super().__init__()
        self.num_conv, self.num_fc = num_conv, num_fc
        c = in_channels
        for i in range(num_conv):
            self.add_module(f"conv{i + 1}", nn.Conv2d(c, conv_dim, 3, padding=1))
            c = conv_dim
        d = c * resolution * resolution
        for i in range(num_fc):
            self.add_module(f"fc{i + 1}", nn.Linear(d, fc_dim))
            d = fc_dim
        self.out_dim = d

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(R, C, P, P) → (R, out_dim)."""
        for i in range(self.num_conv):
            x = F.relu(getattr(self, f"conv{i + 1}")(x))
        x = x.flatten(1)
        for i in range(self.num_fc):
            x = F.relu(getattr(self, f"fc{i + 1}")(x))
        return x


class FastRCNNOutputLayers(nn.Module):
    def __init__(self, in_dim: int, num_classes: int, cls_agnostic_bbox_reg: bool = False, box_dim: int = 4):
        super().__init__()
        self.cls_score = F32Linear(in_dim, num_classes + 1)
        self.bbox_pred = F32Linear(in_dim, box_dim if cls_agnostic_bbox_reg else box_dim * num_classes)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's init: ``cls_score`` N(0, 0.01), ``bbox_pred``
        N(0, 0.001), biases 0."""
        self.cls_score.weight.normal_(0.0, 0.01, generator=generator)
        self.bbox_pred.weight.normal_(0.0, 0.001, generator=generator)
        self.cls_score.bias.zero_()
        self.bbox_pred.bias.zero_()

    def forward(self, x: torch.Tensor):
        """(R, D), or (R, D, P, P) averaged over its P² (the res5 head's
        output, C4) → (scores (R, C+1), deltas (R, 4C or 4)), f32."""
        if x.dim() > 2:
            x = x.mean(dim=(2, 3))
        return self.cls_score(x), self.bbox_pred(x)
