"""VoVNet(V2) trunks with OSA blocks and eSE attention (NCHW), counterpart of
the JAX package's ``models/backbones/vovnet.py``: the variant table, the
stem, OSA blocks (identity residual after the first block of a stage,
depthwise 3x3 in the ``dw`` variants) and the stride-2 max pools between
stages.

Module names are the reference vovnet-detectron2's where the structure is
the same (``stem.stem_1/conv``, ``stage2.OSA2_1.layers.0.OSA2_1_0/conv``,
``OSA2_1.concat.OSA2_1_concat/norm``, ``OSA2_1.ese.fc``); the JAX package's
own structure is kept where it differs from the reference (every block has
its eSE; a depthwise layer's 3x3 has its own norm, ``…/dw_norm``; a reduced
block concatenates its reduced input; the dw variants' stem is a grouped
3x3 and a dense 3x3), since the port is held to the JAX package.

The max pool between stages is flax's ``padding="SAME"``: at an even size
it pads one row and column after the map, none before (``MaxPool2d(3, 2,
padding=1)`` would shift every window by a pixel).
"""

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...config import CfgNode
from ..layers import BN_EPS, BN_MOMENTUM, BatchNorm2d
from ..registry import BACKBONE_REGISTRY

__all__ = ["VOVNET_SPECS", "MaxPoolSame", "OSABlock", "VoVNet", "build_vovnet_backbone", "eSEModule"]

# variant -> (stem, stage conv channels, stage out channels, layers per block,
#             blocks per stage, eSE, depthwise)
VOVNET_SPECS = {
    "V-19-slim-dw-eSE": ([64, 64, 64], [64, 80, 96, 112], [112, 256, 384, 512], 3, [1, 1, 1, 1], True, True),
    "V-19-dw-eSE": ([64, 64, 64], [128, 160, 192, 224], [256, 512, 768, 1024], 3, [1, 1, 1, 1], True, True),
    "V-19-slim-eSE": ([64, 64, 128], [64, 80, 96, 112], [112, 256, 384, 512], 3, [1, 1, 1, 1], True, False),
    "V-19-eSE": ([64, 64, 128], [128, 160, 192, 224], [256, 512, 768, 1024], 3, [1, 1, 1, 1], True, False),
    "V-39-eSE": ([64, 64, 128], [128, 160, 192, 224], [256, 512, 768, 1024], 5, [1, 1, 2, 2], True, False),
    "V-57-eSE": ([64, 64, 128], [128, 160, 192, 224], [256, 512, 768, 1024], 5, [1, 1, 4, 3], True, False),
    "V-99-eSE": ([64, 64, 128], [128, 160, 192, 224], [256, 512, 768, 1024], 5, [1, 3, 9, 3], True, False),
}


def conv_norm_act(name: str, cin: int, cout: int, kernel: int = 3, stride: int = 1, groups: int = 1,
                  conv: str = "conv", norm: str = "norm", relu: str = "relu") -> List[Tuple[str, nn.Module]]:
    """kxk conv (symmetric padding, no bias) → BatchNorm → ReLU as named
    (module name, module) pairs (JAX ``ConvNormAct``)."""
    return [
        (f"{name}/{conv}", nn.Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2, groups=groups, bias=False)),
        (f"{name}/{norm}", BatchNorm2d(cout, eps=BN_EPS, momentum=BN_MOMENTUM)),
        (f"{name}/{relu}", nn.ReLU(inplace=True)),
    ]


class eSEModule(nn.Module):
    """Effective squeeze-excite: global mean → 1x1 conv → hard sigmoid gate
    (JAX ``eSEModule``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc = nn.Conv2d(channels, channels, 1)

    def forward(self, x):
        gate = F.hardsigmoid(self.fc(x.mean((2, 3), keepdim=True)))
        return x * gate


class OSABlock(nn.Module):
    """One-shot aggregation (JAX ``OSABlock``, the reference's
    ``_OSA_module``): ``layer_per_block`` successive 3x3s, all of them and
    the block's input concatenated, a 1x1 to ``out_ch``, eSE, and the input
    added back when ``identity``."""

    def __init__(self, name: str, cin: int, conv_ch: int, out_ch: int, layer_per_block: int,
                 use_ese: bool = True, depthwise: bool = False, identity: bool = False):
        super().__init__()
        self.identity = identity
        c = cin
        if depthwise and cin != conv_ch:
            self.conv_reduction = nn.Sequential(OrderedDict(conv_norm_act(f"{name}_reduction_0", cin, conv_ch, 1)))
            c = conv_ch
        else:
            self.conv_reduction = None
        cat = c
        layers = []
        for i in range(layer_per_block):
            if depthwise:
                mods = (conv_norm_act(f"{name}_{i}", c, conv_ch, 3, groups=conv_ch, conv="dw_conv3x3",
                                      norm="dw_norm", relu="dw_relu")
                        + conv_norm_act(f"{name}_{i}", conv_ch, conv_ch, 1, conv="pw_conv1x1",
                                        norm="pw_norm", relu="pw_relu"))
            else:
                mods = conv_norm_act(f"{name}_{i}", c, conv_ch, 3)
            layers.append(nn.Sequential(OrderedDict(mods)))
            c = conv_ch
            cat += conv_ch
        self.layers = nn.ModuleList(layers)
        self.concat = nn.Sequential(OrderedDict(conv_norm_act(f"{name}_concat", cat, out_ch, 1)))
        self.ese = eSEModule(out_ch) if use_ese else None

    def forward(self, x):
        identity = x
        if self.conv_reduction is not None:
            x = self.conv_reduction(x)
        outputs = [x]
        for layer in self.layers:
            x = layer(x)
            outputs.append(x)
        out = self.concat(torch.cat(outputs, dim=1))
        if self.ese is not None:
            out = self.ese(out)
        return out + identity if self.identity else out


class MaxPoolSame(nn.Module):
    """3x3 stride-2 max pool with flax's ``padding="SAME"``: ceil(n/2)
    outputs, the padding (−inf) split as flax splits it, the larger half
    after the map."""

    def forward(self, x):
        pads = []
        for n in (x.shape[3], x.shape[2]):  # F.pad takes the last dim first
            total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
            pads += [total // 2, total - total // 2]
        return F.max_pool2d(F.pad(x, pads, value=float("-inf")), 3, 2)


class VoVNet(nn.Module):
    """The trunk: ``stem``, then ``stage2`` ... ``stage5`` (strides 4 to 32;
    each stage after the first begins with a ``Pooling``). ``forward``
    returns ``{name: map}`` for ``out_features``."""

    def __init__(self, variant: str = "V-39-eSE",
                 out_features: Sequence[str] = ("stage2", "stage3", "stage4", "stage5")):
        super().__init__()
        if variant not in VOVNET_SPECS:
            raise ValueError(f"Unknown VoVNet variant {variant!r}; the port has {sorted(VOVNET_SPECS)}")
        stem_ch, conv_ch, out_ch, layer_per_block, block_per_stage, ese, dw = VOVNET_SPECS[variant]
        self.out_features = tuple(out_features)
        self.stem = nn.Sequential(OrderedDict(
            conv_norm_act("stem_1", 3, stem_ch[0], stride=2)
            + conv_norm_act("stem_2", stem_ch[0], stem_ch[1], groups=stem_ch[1] if dw else 1)
            + conv_norm_act("stem_3", stem_ch[1], stem_ch[2], stride=2)))
        self.out_feature_channels: Dict[str, int] = {}
        cin = stem_ch[2]
        for s in range(4):
            stage = s + 2
            mods = [("Pooling", MaxPoolSame())] if s > 0 else []
            for b in range(block_per_stage[s]):
                name = f"OSA{stage}_{b + 1}"
                mods.append((name, OSABlock(name, cin, conv_ch[s], out_ch[s], layer_per_block,
                                            use_ese=ese, depthwise=dw, identity=b > 0)))
                cin = out_ch[s]
            self.add_module(f"stage{stage}", nn.Sequential(OrderedDict(mods)))
            self.out_feature_channels[f"stage{stage}"] = out_ch[s]

    def forward(self, x, features: Optional[Sequence[str]] = None) -> Dict[str, torch.Tensor]:
        """``features`` (default ``out_features``) by name. In eval mode the
        stages after the last one asked for are skipped; in training all four
        run, so BatchNorm statistics move in all of them, as in the JAX
        package."""
        features = tuple(features or self.out_features)
        x = self.stem(x)
        out = {}
        for stage in range(2, 6):
            if not self.training and len(out) == len(features):
                break
            x = getattr(self, f"stage{stage}")(x)
            if f"stage{stage}" in features:
                out[f"stage{stage}"] = x
        return out


@BACKBONE_REGISTRY.register()
def build_vovnet_backbone(cfg: CfgNode) -> VoVNet:
    """The VoVNet of ``MODEL.VOVNET.CONV_BODY`` (BatchNorm throughout, as in
    the JAX package, which reads neither ``VOVNET.NORM`` nor ``FREEZE_AT``)."""
    v = cfg.MODEL.VOVNET
    return VoVNet(v.CONV_BODY, tuple(v.OUT_FEATURES))
