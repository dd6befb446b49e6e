"""Feature Pyramid Network (NCHW), counterpart of the JAX package's
``models/backbones/fpn.py`` (reference ``modeling/backbone/fpn.py``).

The ResNet trunk (``bottom_up``) → 1x1 laterals (``fpn_lateral{3,4,5}``),
the top-down sum with each coarser map upsampled by exactly 2× nearest (a
size that is not a multiple of the coarsest stride fails, as in JAX), 3x3
outputs (``fpn_output{3,4,5}``), then the top block: ``LastLevelMaxPool``
(P6 = 1x1 max pool, stride 2, of the last output; R-CNN) or
``LastLevelP6P7`` (RetinaNet: P6 a 3x3 stride-2 conv of **res5**, P7 one of
``relu(P6)``; keys ``top_block.p6``, ``top_block.p7``). ``fuse_type`` avg
halves each sum. Module names are the reference's, so its ``.pth`` keys
load as they are.
"""

from typing import Dict, List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...config import CfgNode
from ..registry import BACKBONE_REGISTRY
from .resnet import build_resnet

__all__ = ["FPN", "LastLevelMaxPool", "LastLevelP6P7", "build_resnet_fpn_backbone",
           "build_retinanet_resnet_fpn_backbone"]


def _upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


class LastLevelMaxPool(nn.Module):
    """P6 from the last FPN output by a 1x1 max pool of stride 2."""

    num_levels = 1
    in_feature = None  # the last FPN output

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        return [F.max_pool2d(x, kernel_size=1, stride=2)]


class LastLevelP6P7(nn.Module):
    """P6 and P7 of RetinaNet: 3x3 stride-2 convs, P6 from ``in_feature``
    (res5), P7 from ``relu(P6)``."""

    num_levels = 2

    def __init__(self, in_channels: int, out_channels: int, in_feature: str = "res5"):
        super().__init__()
        self.in_feature = in_feature
        self.p6 = nn.Conv2d(in_channels, out_channels, 3, 2, 1)
        self.p7 = nn.Conv2d(out_channels, out_channels, 3, 2, 1)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        p6 = self.p6(x)
        return [p6, self.p7(F.relu(p6))]


class FPN(nn.Module):
    """``bottom_up`` (a dict-output trunk) → {p3 … p7} (or p2 … p6)."""

    def __init__(self, bottom_up: nn.Module, in_features: Sequence[str], out_channels: int = 256,
                 top_block: nn.Module = None, fuse_type: str = "sum"):
        super().__init__()
        if fuse_type not in ("sum", "avg"):
            raise ValueError(f"FPN fuse_type must be sum or avg, got {fuse_type!r}")
        self.bottom_up = bottom_up
        self.in_features = tuple(in_features)
        self.fuse_type = fuse_type
        self.levels = [int(f[-1]) for f in self.in_features]
        for level, f in zip(self.levels, self.in_features):
            cin = bottom_up.out_feature_channels[f]
            self.add_module(f"fpn_lateral{level}", nn.Conv2d(cin, out_channels, 1))
            self.add_module(f"fpn_output{level}", nn.Conv2d(out_channels, out_channels, 3, 1, 1))
        self.top_block = top_block
        last = self.levels[-1]
        extra = top_block.num_levels if top_block is not None else 0
        self.out_features = [f"p{l}" for l in self.levels] + [f"p{last + i + 1}" for i in range(extra)]
        self.out_channels = out_channels

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        top_in = getattr(self.top_block, "in_feature", None)
        feats = self.bottom_up(x, self.in_features + ((top_in,) if top_in in self.bottom_up.out_feature_channels
                                                      and top_in not in self.in_features else ()))
        laterals = [getattr(self, f"fpn_lateral{l}")(feats[f]) for l, f in zip(self.levels, self.in_features)]
        results = [None] * len(laterals)
        prev = results[-1] = laterals[-1]
        for i in range(len(laterals) - 2, -1, -1):
            top_down = _upsample2x_nearest(prev)
            if top_down.shape != laterals[i].shape:
                raise ValueError(
                    f"FPN: the 2x upsampled p{self.levels[i + 1]} {tuple(top_down.shape[2:])} does not match "
                    f"the p{self.levels[i]} lateral {tuple(laterals[i].shape[2:])}: the input size must be "
                    f"a multiple of {2 ** self.levels[-1]}")
            prev = laterals[i] + top_down
            if self.fuse_type == "avg":
                prev = prev / 2.0
            results[i] = prev
        outs = [getattr(self, f"fpn_output{l}")(r) for l, r in zip(self.levels, results)]
        if self.top_block is not None:
            src = feats[top_in] if top_in in feats else outs[-1]
            outs.extend(self.top_block(src))
        return dict(zip(self.out_features, outs))


def _build(cfg: CfgNode, top_block_of) -> FPN:
    bottom_up = build_resnet(cfg, out_features=cfg.MODEL.RESNETS.OUT_FEATURES)
    in_features = tuple(cfg.MODEL.FPN.IN_FEATURES)
    out_channels = int(cfg.MODEL.FPN.OUT_CHANNELS)
    return FPN(bottom_up, in_features, out_channels, top_block_of(bottom_up, out_channels),
               fuse_type=cfg.MODEL.FPN.FUSE_TYPE)


@BACKBONE_REGISTRY.register()
def build_resnet_fpn_backbone(cfg: CfgNode) -> FPN:
    """R-CNN's FPN: the laterals of ``FPN.IN_FEATURES`` (res2-res5) and a max-pool P6."""
    return _build(cfg, lambda bottom_up, c: LastLevelMaxPool())


@BACKBONE_REGISTRY.register()
def build_retinanet_resnet_fpn_backbone(cfg: CfgNode) -> FPN:
    """RetinaNet's FPN: res3-res5 laterals, and P6/P7 convs from res5 (2048
    channels at ResNet-50)."""
    return _build(cfg, lambda bottom_up, c: LastLevelP6P7(bottom_up.out_feature_channels["res5"], c))
