"""DLA-34 with DLAUp/IDAUp deformable upsampling (NCHW), counterpart of the
JAX package's ``models/backbones/dla.py``.

The trunk (base_layer, level0..5 with hierarchical Tree aggregation), the
DLAUp pyramid of IDAUps and the final IDAUp that gives the stride-4 map the
ctdet heads read. Attribute names are the reference fork's (``base``,
``level2.tree1.conv1``, ``root.conv``, ``project.0``, ``dla_up.ida_0.proj_1``,
``up_1``, ...), so its state-dict keys load as they are.

As in the JAX package, a Tree handed a residual uses it; its own projection
is computed all the same and its output dropped, so that projection's
BatchNorm statistics move at training as JAX's do.
"""

import itertools
from typing import List, Sequence

import torch
import torch.nn as nn

from ...config import CfgNode
from ..layers import BN_EPS, BN_MOMENTUM, BatchNorm2d, BilinearUpsample, ConvBnAct, DeformConvV2
from ..registry import BACKBONE_REGISTRY


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)


class BasicBlock(nn.Module):
    """3x3-3x3 residual block (JAX ``DLABasicBlock``)."""

    def __init__(self, cin: int, cout: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, dilation, dilation, bias=False)
        self.bn1 = _bn(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, dilation, dilation, bias=False)
        self.bn2 = _bn(cout)
        self.relu = nn.ReLU(inplace=True)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + residual)


class Root(nn.Module):
    """1x1 conv fusing a Tree's children (JAX ``Root``)."""

    def __init__(self, cin: int, cout: int, residual: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1, bias=False)
        self.bn = _bn(cout)
        self.relu = nn.ReLU(inplace=True)
        self.residual = residual

    def forward(self, children: List[torch.Tensor]):
        x = self.bn(self.conv(torch.cat(children, dim=1)))
        if self.residual:
            x = x + children[0]
        return self.relu(x)


class Tree(nn.Module):
    """Recursive deep-aggregation node (JAX ``Tree``)."""

    def __init__(
        self, levels: int, cin: int, cout: int, stride: int = 1,
        level_root: bool = False, root_dim: int = 0, root_residual: bool = False,
    ):
        super().__init__()
        root_dim = root_dim or 2 * cout
        if level_root:
            root_dim += cin
        self.levels = levels
        self.level_root = level_root
        if levels == 1:
            self.tree1 = BasicBlock(cin, cout, stride)
            self.tree2 = BasicBlock(cout, cout)
            self.root = Root(root_dim, cout, root_residual)
        else:
            self.tree1 = Tree(levels - 1, cin, cout, stride, root_residual=root_residual)
            self.tree2 = Tree(
                levels - 1, cout, cout, root_dim=root_dim + cout, root_residual=root_residual
            )
        self.downsample = nn.MaxPool2d(stride, stride) if stride > 1 else None
        self.project = ConvBnAct(cin, cout, 1, relu=False) if cin != cout else None

    def forward(self, x, residual=None, children=None):
        children = [] if children is None else list(children)
        bottom = self.downsample(x) if self.downsample is not None else x
        proj = self.project(bottom) if self.project is not None else bottom
        if residual is None:
            residual = proj
        if self.level_root:
            children.append(bottom)
        x1 = self.tree1(x, residual)
        if self.levels == 1:
            return self.root([self.tree2(x1), x1] + children)
        children.append(x1)
        return self.tree2(x1, None, children)


def _conv_level(cin: int, cout: int, convs: int, stride: int = 1) -> nn.Sequential:
    """[conv, bn, relu] * convs, flat, as the reference's _make_conv_level."""
    return nn.Sequential(*itertools.chain.from_iterable(
        ConvBnAct(cin if r == 0 else cout, cout, 3, stride if r == 0 else 1)
        for r in range(convs)
    ))


class DLABase(nn.Module):
    """The 6-level DLA body (JAX ``DLATrunk``); returns all 6 maps."""

    def __init__(self, levels: Sequence[int], channels: Sequence[int]):
        super().__init__()
        ch = list(channels)
        self.base_layer = ConvBnAct(3, ch[0], 7)
        self.level0 = _conv_level(ch[0], ch[0], levels[0])
        self.level1 = _conv_level(ch[0], ch[1], levels[1], stride=2)
        self.level2 = Tree(levels[2], ch[1], ch[2], 2, level_root=False)
        self.level3 = Tree(levels[3], ch[2], ch[3], 2, level_root=True)
        self.level4 = Tree(levels[4], ch[3], ch[4], 2, level_root=True)
        self.level5 = Tree(levels[5], ch[4], ch[5], 2, level_root=True)

    def forward(self, x) -> List[torch.Tensor]:
        x = self.base_layer(x)
        outs = []
        for i in range(6):
            x = getattr(self, f"level{i}")(x)
            outs.append(x)
        return outs


class IDAUp(nn.Module):
    """Iterative deep aggregation (JAX ``IDAUp``): for each level above
    ``startp``, project (DCN) → upsample → add the level below → node (DCN)."""

    def __init__(self, o: int, channels: Sequence[int], up_f: Sequence[int]):
        super().__init__()
        for i in range(1, len(channels)):
            setattr(self, f"proj_{i}", DeformConvV2(channels[i], o))
            setattr(self, f"up_{i}", BilinearUpsample(o, int(up_f[i])))
            setattr(self, f"node_{i}", DeformConvV2(o, o))

    def forward(self, layers: List[torch.Tensor], startp: int, endp: int) -> List[torch.Tensor]:
        layers = list(layers)
        for i in range(startp + 1, endp):
            j = i - startp
            up = getattr(self, f"up_{j}")(getattr(self, f"proj_{j}")(layers[i]))
            layers[i] = getattr(self, f"node_{j}")(up + layers[i - 1])
        return layers


class DLAUp(nn.Module):
    """Pyramid of IDAUps walking down the scales (JAX ``DLAUp``)."""

    def __init__(self, channels: Sequence[int], scales: Sequence[int]):
        super().__init__()
        channels = list(channels)
        in_channels = list(channels)
        scales = list(scales)
        for i in range(len(channels) - 1):
            j = -i - 2
            setattr(self, f"ida_{i}", IDAUp(
                channels[j], in_channels[j:], [s // scales[j] for s in scales[j:]]
            ))
            scales[j + 1:] = [scales[j]] * len(scales[j + 1:])
            in_channels[j + 1:] = [channels[j]] * len(channels[j + 1:])
        self.depth = len(channels) - 1

    def forward(self, layers: List[torch.Tensor]) -> List[torch.Tensor]:
        layers = list(layers)
        out = [layers[-1]]
        for i in range(self.depth):
            layers = getattr(self, f"ida_{i}")(layers, len(layers) - i - 2, len(layers))
            out.insert(0, layers[-1])
        return out


class DLA34(nn.Module):
    """Trunk → DLAUp → IDAUp → the (N, channels[first_level], H/4, W/4) map
    (the reference's DLASeg; CenterNet reads its last output)."""

    def __init__(
        self,
        levels: Sequence[int] = (1, 1, 1, 2, 2, 1),
        channels: Sequence[int] = (16, 32, 64, 128, 256, 512),
        down_ratio: int = 4,
        last_level: int = 5,
    ):
        super().__init__()
        fl = {2: 1, 4: 2, 8: 3, 16: 4}[down_ratio]
        self.first_level = fl
        self.last_level = last_level
        self.out_channels = channels[fl]
        self.base = DLABase(levels, channels)
        self.dla_up = DLAUp(channels[fl:], [2 ** i for i in range(len(channels) - fl)])
        self.ida_up = IDAUp(
            channels[fl], channels[fl:last_level], [2 ** i for i in range(last_level - fl)]
        )

    def forward(self, x):
        feats = self.base(x)
        y = self.dla_up(feats[self.first_level:])[: self.last_level - self.first_level]
        return self.ida_up(y, 0, len(y))[-1]


@BACKBONE_REGISTRY.register()
def build_dla34_backbone(cfg: CfgNode) -> DLA34:
    """The DLA-34 of ``cfg.MODEL.CENTERNET``. The TPU-only DCN knobs
    (``TPU.DCN_IMPL``, ``DCN_WINDOW``, ``DCN_V_WINDOW``) are read by no one:
    the port's DCN is always exact."""
    c = cfg.MODEL.CENTERNET
    if c.DOWN_RATIO not in (2, 4, 8, 16):
        raise ValueError(f"MODEL.CENTERNET.DOWN_RATIO must be 2, 4, 8 or 16, got {c.DOWN_RATIO}")
    return DLA34(tuple(c.LEVELS), tuple(c.CHANNELS), c.DOWN_RATIO, c.LAST_LEVEL)
