"""ResNet trunks (NCHW), counterpart of the JAX package's
``models/backbones/resnet.py``: ``BasicStem``, ``BasicBlock``,
``BottleneckBlock`` (``stride_in_1x1``, groups, dilation) and
``DeformBottleneckBlock`` (``DEFORM_ON_PER_STAGE``, ``DEFORM_MODULATED``),
stages for depths 18/34/50/101/152, ``OUT_FEATURES`` and ``FREEZE_AT``.

Module names are the reference detectron2 ResNet's (``stem.conv1``,
``res2.0.conv1``, ``res2.0.conv1.norm``, ``res3.0.shortcut``, ...): a conv
holds its normalization as ``.norm``, as detectron2's ``Conv2d`` does.
Padding is explicit and symmetric, as in the JAX code (a SAME pad would
differ at stride 2).

``FREEZE_AT`` stops the gradient after the stem (≥ 1) and after each stage
up to it, as the JAX package's ``stop_gradient`` does: the frozen
parameters stay trainable and in the optimizer, with a gradient of 0, so
weight decay and momentum still move them as they do under optax (ROADMAP
C12; the reference sets ``requires_grad=False`` instead).

CenterNet reads ``res4`` through its deconv neck (``meta_arch/centernet.py``):
``build_resnet_backbone`` and ``build_resnet_deconv_backbone`` both give
the trunk, the JAX package's ``DeconvNeck`` and ``ResNetDeconv`` compute the
same network. Not ported here: the DeepLab stem and dilated res4 (ROADMAP
A15.2); they raise.
"""

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...config import CfgNode
from ..layers import DeformConvNorm, ZeroInitConv2d, get_norm, ieee_f32
from ..registry import BACKBONE_REGISTRY

__all__ = ["RESNET_SPECS", "BasicBlock", "BasicStem", "BottleneckBlock", "ConvNorm", "DeformBottleneckBlock",
           "ResNet", "build_resnet", "build_resnet_backbone", "build_resnet_deconv_backbone"]

# depth -> (block type, blocks per stage res2..res5)
RESNET_SPECS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


class ConvNorm(nn.Conv2d):
    """A bias-free conv followed by its normalization ``.norm`` (none for
    NORM ""): detectron2's ``Conv2d(..., norm=...)``."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int = 1, padding: int = 0,
                 dilation: int = 1, groups: int = 1, norm: str = "FrozenBN"):
        super().__init__(cin, cout, kernel_size, stride, padding, dilation, groups, bias=False)
        self.norm = get_norm(norm, cout)

    def forward(self, x):
        x = super().forward(x)
        return self.norm(x) if self.norm is not None else x


class BasicStem(nn.Module):
    """7x7 s2 conv + norm + ReLU + 3x3 s2 max pool (JAX ``BasicStem``)."""

    def __init__(self, cin: int = 3, cout: int = 64, norm: str = "FrozenBN"):
        super().__init__()
        self.conv1 = ConvNorm(cin, cout, 7, stride=2, padding=3, norm=norm)

    def forward(self, x):
        return F.max_pool2d(F.relu_(self.conv1(x)), 3, 2, 1)


class BasicBlock(nn.Module):
    """Two 3x3 convs + identity or projection shortcut (JAX ``BasicBlock``)."""

    def __init__(self, cin: int, cout: int, stride: int = 1, norm: str = "FrozenBN"):
        super().__init__()
        self.conv1 = ConvNorm(cin, cout, 3, stride, 1, norm=norm)
        self.conv2 = ConvNorm(cout, cout, 3, 1, 1, norm=norm)
        self.shortcut = ConvNorm(cin, cout, 1, stride, norm=norm) if cin != cout or stride != 1 else None

    def forward(self, x):
        out = self.conv2(F.relu_(self.conv1(x)))
        sc = self.shortcut(x) if self.shortcut is not None else x
        return F.relu_(out + sc)


class BottleneckBlock(nn.Module):
    """1x1 - 3x3 - 1x1 bottleneck (JAX ``BottleneckBlock``); the stride goes
    in the first 1x1 when ``stride_in_1x1`` (the MSRA convention), else in
    the 3x3, which also carries the groups and the dilation."""

    def __init__(self, cin: int, cout: int, bottleneck: int, stride: int = 1,
                 stride_in_1x1: bool = True, dilation: int = 1, num_groups: int = 1,
                 norm: str = "FrozenBN"):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = ConvNorm(cin, bottleneck, 1, s1, norm=norm)
        self.conv2 = ConvNorm(bottleneck, bottleneck, 3, s3, dilation, dilation, num_groups, norm=norm)
        self.conv3 = ConvNorm(bottleneck, cout, 1, norm=norm)
        self.shortcut = ConvNorm(cin, cout, 1, stride, norm=norm) if cin != cout or stride != 1 else None

    def forward(self, x):
        out = self.conv3(F.relu_(self.conv2(F.relu_(self.conv1(x)))))
        sc = self.shortcut(x) if self.shortcut is not None else x
        return F.relu_(out + sc)


class DeformBottleneckBlock(nn.Module):
    """The bottleneck with a deformable 3x3 (JAX ``DeformBottleneckBlock``,
    resnet.py:179-232; reference resnet.py:214). ``conv2_offset`` (3x3, bias,
    zero init, 27 channels modulated or 18 not) predicts at the 3x3's stride
    with padding 1, in f32 on the f32 input with IEEE f32 convolutions; the
    DCN (``conv2``) runs at that stride and ``dilation`` (padding =
    dilation). Two points follow JAX, not the reference (ROADMAP C21): the
    offset conv takes no dilation (the reference's ``padding=dilation,
    dilation=dilation``), and the DCN is dense whatever ``NUM_GROUPS``, with
    one deformable group (the reference groups both and reads
    ``DEFORM_NUM_GROUPS``)."""

    def __init__(self, cin: int, cout: int, bottleneck: int, stride: int = 1, stride_in_1x1: bool = True,
                 dilation: int = 1, norm: str = "FrozenBN", deform_modulated: bool = False):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.deform_modulated = deform_modulated
        self.conv1 = ConvNorm(cin, bottleneck, 1, s1, norm=norm)
        self.conv2_offset = ZeroInitConv2d(bottleneck, 27 if deform_modulated else 18, 3, s3, 1)
        self.conv2 = DeformConvNorm(bottleneck, s3, dilation, norm)
        self.conv3 = ConvNorm(bottleneck, cout, 1, norm=norm)
        self.shortcut = ConvNorm(cin, cout, 1, stride, norm=norm) if cin != cout or stride != 1 else None

    def offset_mask(self, x: torch.Tensor):
        """(offset (N, 18, Ho, Wo) f32, sigmoided mask (N, 9, Ho, Wo) f32 or
        None) from the f32 offset conv."""
        with torch.autocast(x.device.type, enabled=False), ieee_f32():
            om = self.conv2_offset(x.float())
        if not self.deform_modulated:
            return om.contiguous(), None
        return om[:, :18].contiguous(), torch.sigmoid(om[:, 18:]).contiguous()

    def forward(self, x):
        out = F.relu_(self.conv1(x))
        out = F.relu_(self.conv2(out, *self.offset_mask(out)))
        out = self.conv3(out)
        sc = self.shortcut(x) if self.shortcut is not None else x
        return F.relu_(out + sc)


class ResNet(nn.Module):
    """The trunk: ``stem``, then ``res2`` ... up to the deepest stage of
    ``out_features`` (JAX ``ResNet``). ``forward`` returns
    ``{name: map}`` for ``out_features`` ⊆ {stem, res2, ..., res5}. A stage
    of a bottleneck depth whose ``deform_on_per_stage`` entry is set is made
    of ``DeformBottleneckBlock``s (basic depths ignore it, as in JAX).

    ``out_feature_strides`` are the strides the blocks take: a dilated
    stage's first block does not stride, so DC5's res5 stays at 16, as in
    the reference (the JAX package reports 32 for it whatever its dilation,
    ROADMAP C20)."""

    def __init__(self, depth: int = 50, out_features: Sequence[str] = ("res4",), num_groups: int = 1,
                 width_per_group: int = 64, stem_out_channels: int = 64, res2_out_channels: int = 256,
                 stride_in_1x1: bool = True, res5_dilation: int = 1, norm: str = "FrozenBN",
                 freeze_at: int = 0, deform_on_per_stage: Sequence[bool] = (False,) * 4,
                 deform_modulated: bool = False):
        super().__init__()
        block_type, stage_blocks = RESNET_SPECS[depth]
        self.out_features = tuple(out_features)
        self.freeze_at = freeze_at
        self.stem = BasicStem(3, stem_out_channels, norm)
        self.out_feature_channels: Dict[str, int] = {"stem": stem_out_channels}
        self.out_feature_strides: Dict[str, int] = {"stem": 4}
        feature_stride = 4
        max_stage = max([int(f[-1]) for f in self.out_features if f.startswith("res")] or [5])
        cin, cout, bottleneck = stem_out_channels, res2_out_channels, num_groups * width_per_group
        self.stage_names = []
        for idx, blocks in enumerate(stage_blocks):
            stage = idx + 2
            if stage > max_stage:
                break
            dilation = res5_dilation if stage == 5 else 1
            first_stride = 1 if stage == 2 or dilation > 1 else 2
            layers = []
            for b in range(blocks):
                stride = first_stride if b == 0 else 1
                if block_type == "basic":  # the JAX BasicBlock takes no dilation
                    layers.append(BasicBlock(cin, cout, stride, norm))
                elif deform_on_per_stage[idx]:
                    layers.append(DeformBottleneckBlock(cin, cout, bottleneck, stride, stride_in_1x1, dilation,
                                                        norm, deform_modulated))
                else:
                    layers.append(BottleneckBlock(cin, cout, bottleneck, stride, stride_in_1x1,
                                                  dilation, num_groups, norm))
                cin = cout
            self.add_module(f"res{stage}", nn.Sequential(*layers))
            self.stage_names.append(f"res{stage}")
            self.out_feature_channels[f"res{stage}"] = cout
            feature_stride *= first_stride
            self.out_feature_strides[f"res{stage}"] = feature_stride
            cout *= 2
            bottleneck *= 2

    def forward(self, x, features: Optional[Sequence[str]] = None) -> Dict[str, torch.Tensor]:
        """``features`` (default ``out_features``) by name. In eval mode the
        stages after the last one asked for are skipped; in training every
        stage runs, so BatchNorm statistics move in all of them, as in the
        JAX package."""
        features = tuple(features or self.out_features)
        x = self.stem(x)
        if self.freeze_at >= 1:
            x = x.detach()
        out = {"stem": x} if "stem" in features else {}
        for stage, name in enumerate(self.stage_names, 2):
            if not self.training and len(out) == len(features):
                break
            x = getattr(self, name)(x)
            if self.freeze_at >= stage:
                x = x.detach()
            if name in features:
                out[name] = x
        return out


def build_resnet(cfg: CfgNode, out_features: Optional[Sequence[str]] = None) -> ResNet:
    """The trunk of ``cfg.MODEL.RESNETS`` and ``MODEL.BACKBONE.FREEZE_AT``."""
    r = cfg.MODEL.RESNETS
    if r.STEM_TYPE != "basic" or r.RES4_DILATION != 1 or tuple(r.RES5_MULTI_GRID) != (1, 1, 1):
        raise NotImplementedError(
            "the DeepLab trunk (STEM_TYPE deeplab, RES4_DILATION, RES5_MULTI_GRID) is not ported yet "
            "(ROADMAP A15.2)")
    return ResNet(
        depth=r.DEPTH, out_features=tuple(out_features or r.OUT_FEATURES), num_groups=r.NUM_GROUPS,
        width_per_group=r.WIDTH_PER_GROUP, stem_out_channels=r.STEM_OUT_CHANNELS,
        res2_out_channels=r.RES2_OUT_CHANNELS, stride_in_1x1=r.STRIDE_IN_1X1,
        res5_dilation=r.RES5_DILATION, norm=r.NORM, freeze_at=cfg.MODEL.BACKBONE.FREEZE_AT,
        deform_on_per_stage=tuple(bool(d) for d in r.DEFORM_ON_PER_STAGE),
        deform_modulated=bool(r.DEFORM_MODULATED),
    )


@BACKBONE_REGISTRY.register()
def build_resnet_backbone(cfg: CfgNode) -> ResNet:
    return build_resnet(cfg)


@BACKBONE_REGISTRY.register()
def build_resnet_deconv_backbone(cfg: CfgNode) -> ResNet:
    """The trunk up to ``res4``, which CenterNet's deconv neck reads (JAX
    ``ResNetDeconv``: 2 × [ConvTranspose 256, k4 s2 + BN + ReLU] on res4)."""
    return build_resnet(cfg, out_features=("res4",))


@BACKBONE_REGISTRY.register()
def build_resnet_deeplab_backbone(cfg: CfgNode) -> ResNet:
    raise NotImplementedError("build_resnet_deeplab_backbone (DeepLabStem, dilated res4/res5) is not "
                              "ported yet (ROADMAP A15.2)")
