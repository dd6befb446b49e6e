"""TridentNet's trunk (NCHW), counterpart of the JAX package's
``models/backbones/trident.py`` (the reference's ``projects/TridentNet``).

A C4 ResNet whose res4 stage is a trident stage: three branches with one
shared 3x3 kernel per block at dilations 1, 2 and 3 (padding = dilation),
so scale-specific receptive fields cost no extra parameters. The branches
are folded into the batch, branch-major: in training the res3 map is tiled
to 3N before res4 (each fold takes its branch's dilation); at eval,
``TEST_BRANCH_IDX`` >= 0 runs that one branch on the N images ("TridentNet
Fast"), -1 expects the caller to have tiled the images to 3N (full
TridentNet: stem, res2 and res3 run on every fold).

Module names are the reference's (``stem.conv1``, ``res2.0.conv1``,
``res4.{b}.conv2`` with its ``.norm``); a trident block's shared kernel is
``res4.{b}.conv2.weight``, the JAX package's ``res4_block{b}/conv2_kernel``.
"""

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...config import CfgNode
from ..registry import BACKBONE_REGISTRY
from .resnet import RESNET_SPECS, BasicStem, BottleneckBlock, ConvNorm

__all__ = ["TridentBottleneckBlock", "TridentResNet", "build_trident_resnet_backbone"]


class TridentBottleneckBlock(nn.Module):
    """The bottleneck whose 3x3 (``conv2``, one kernel) runs at each
    branch's dilation on its fold of the batch (JAX
    ``TridentBottleneckBlock``)."""

    def __init__(self, cin: int, cout: int, bottleneck: int, stride: int = 1, stride_in_1x1: bool = True,
                 dilations: Sequence[int] = (1, 2, 3), norm: str = "FrozenBN"):
        super().__init__()
        s1, self.s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.dilations = tuple(dilations)
        self.conv1 = ConvNorm(cin, bottleneck, 1, s1, norm=norm)
        self.conv2 = ConvNorm(bottleneck, bottleneck, 3, self.s3, norm=norm)  # its weight; dilation per branch
        self.conv3 = ConvNorm(bottleneck, cout, 1, norm=norm)
        self.shortcut = ConvNorm(cin, cout, 1, stride, norm=norm) if cin != cout or stride != 1 else None

    def _conv2(self, x: torch.Tensor, dilation: int) -> torch.Tensor:
        return F.conv2d(x, self.conv2.weight, None, self.s3, dilation, dilation)

    def forward(self, x: torch.Tensor, num_branch: int = 3, branch_idx: int = -1) -> torch.Tensor:
        """x: (B · num_branch, C, H, W) folded branch-major, or with
        ``num_branch`` 1 the batch of branch ``branch_idx`` (-1: the middle)."""
        out = F.relu_(self.conv1(x))
        if num_branch == 1:
            out = self._conv2(out, self.dilations[branch_idx if branch_idx >= 0 else len(self.dilations) // 2])
        else:
            b = out.shape[0] // num_branch
            out = torch.cat([self._conv2(out[i * b:(i + 1) * b], d)
                             for i, d in enumerate(self.dilations[:num_branch])])
        out = F.relu_(self.conv2.norm(out) if self.conv2.norm is not None else out)
        out = self.conv3(out)
        sc = self.shortcut(x) if self.shortcut is not None else x
        return F.relu_(out + sc)


class TridentResNet(nn.Module):
    """ResNet through res3, then the weight-shared trident res4 (JAX
    ``TridentResNet``): ``{"res4": map}``, at batch 3N in training (the
    batch tiled at res4) and in full test mode (the batch tiled by the
    caller), N in Fast mode."""

    def __init__(self, depth: int = 50, num_branch: int = 3, dilations: Sequence[int] = (1, 2, 3),
                 test_branch_idx: int = 1, res2_out_channels: int = 256, stem_out_channels: int = 64,
                 width_per_group: int = 64, stride_in_1x1: bool = True, norm: str = "FrozenBN", freeze_at: int = 0):
        super().__init__()
        block_type, stage_blocks = RESNET_SPECS[depth]
        if block_type != "bottleneck":
            raise ValueError(f"TridentNet needs a bottleneck ResNet, depth {depth} is {block_type}")
        self.num_branch, self.test_branch_idx, self.freeze_at = num_branch, test_branch_idx, freeze_at
        self.stem = BasicStem(3, stem_out_channels, norm)
        cin, cout, bottleneck = stem_out_channels, res2_out_channels, width_per_group
        for stage, blocks in ((2, stage_blocks[0]), (3, stage_blocks[1])):
            layers = []
            for b in range(blocks):
                layers.append(BottleneckBlock(cin, cout, bottleneck, 1 if stage == 2 or b else 2, stride_in_1x1,
                                              norm=norm))
                cin = cout
            self.add_module(f"res{stage}", nn.Sequential(*layers))
            cout, bottleneck = cout * 2, bottleneck * 2
        self.res4 = nn.ModuleList(
            TridentBottleneckBlock(cin if b == 0 else cout, cout, bottleneck, 2 if b == 0 else 1, stride_in_1x1,
                                   dilations, norm) for b in range(stage_blocks[2]))
        self.stage_names = ["res2", "res3", "res4"]
        self.out_features = ("res4",)
        self.out_feature_channels: Dict[str, int] = {"res4": cout}
        self.out_feature_strides: Dict[str, int] = {"res4": 16}

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.stem(x)
        if self.freeze_at >= 1:
            x = x.detach()
        for stage in (2, 3):
            x = getattr(self, f"res{stage}")(x)
            if self.freeze_at >= stage:
                x = x.detach()
        if self.training:
            nb = self.num_branch
            x = x.repeat(nb, 1, 1, 1)
        else:
            nb = self.num_branch if self.test_branch_idx < 0 else 1
        for block in self.res4:
            x = block(x, nb, self.test_branch_idx)
        return {"res4": x}


@BACKBONE_REGISTRY.register()
def build_trident_resnet_backbone(cfg: CfgNode) -> TridentResNet:
    """The trident trunk of ``cfg.MODEL.RESNETS`` and ``cfg.MODEL.TRIDENT``."""
    r, t = cfg.MODEL.RESNETS, cfg.MODEL.TRIDENT
    return TridentResNet(depth=r.DEPTH, num_branch=t.NUM_BRANCH, dilations=tuple(t.BRANCH_DILATIONS),
                         test_branch_idx=t.TEST_BRANCH_IDX, res2_out_channels=r.RES2_OUT_CHANNELS,
                         stem_out_channels=r.STEM_OUT_CHANNELS, width_per_group=r.WIDTH_PER_GROUP,
                         stride_in_1x1=r.STRIDE_IN_1X1, norm=r.NORM, freeze_at=cfg.MODEL.BACKBONE.FREEZE_AT)
