"""Shared building blocks (NCHW), counterpart of the JAX package's
``models/layers.py``.

Module and attribute names follow the reference fork's torch modules, so the
state-dict keys are the reference's own (``ConvBnAct`` is a Sequential with
the conv at ``.0`` and the BatchNorm at ``.1``; ``DeformConvV2`` holds the DCN
at ``.conv`` and its BatchNorm + ReLU at ``.actf``).

Parameters are made on the CPU by ``init_weights`` from a ``torch.Generator``
with the JAX package's initializers (its values differ: the two frameworks'
generators give other numbers from one seed). Parameters and BatchNorm
statistics stay f32 whatever the model's compute width, as flax keeps them
(``CenterNetModel`` runs its convolutions under autocast).
"""

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.dcn import modulated_deform_conv, modulated_deform_conv_ad

BN_MOMENTUM = 0.1  # torch convention; the JAX package's flax momentum is 0.9
BN_EPS = 1e-5
# std of a unit normal truncated at ±2: flax's lecun_normal divides by it
TRUNC_NORMAL_STD = 0.87962566103423978


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training step folds the *biased* batch
    variance into ``running_var``, as flax's BatchNorm does (torch folds the
    unbiased one, n/(n-1) larger, n the values per channel). Torch's update
    is v' = (1-m)·v + m·u with u = n/(n-1)·b; it runs here on
    s = n/(n-1)·v, and ``running_var`` becomes (n-1)/n·s' = (1-m)·v + m·b.
    Two elementwise passes over the C-vector per call, none over the
    activations; the statistics tensor torch saves for its backward is s,
    which is not written again. State-dict keys are ``nn.BatchNorm2d``'s."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = x.numel() // x.shape[1]
        if not (self.training and self.track_running_stats and self.momentum is not None and n > 1):
            return super().forward(x)
        self._check_input_dim(x)
        self.num_batches_tracked.add_(1)
        scaled = self.running_var * (n / (n - 1))
        out = F.batch_norm(x, self.running_mean, scaled, self.weight, self.bias, True,
                           self.momentum, self.eps)
        with torch.no_grad():
            torch.mul(scaled, (n - 1) / n, out=self.running_var)
        return out


class ConvBnAct(nn.Sequential):
    """kxk conv (symmetric padding, no bias) → BatchNorm → optional ReLU
    (JAX ``ConvBnAct``, layers.py:34)."""

    def __init__(self, cin, cout, kernel_size=3, stride=1, dilation=1, relu=True):
        pad = dilation * (kernel_size - 1) // 2
        mods = [
            nn.Conv2d(cin, cout, kernel_size, stride, pad, dilation, bias=False),
            BatchNorm2d(cout, eps=BN_EPS, momentum=BN_MOMENTUM),
        ]
        if relu:
            mods.append(nn.ReLU(inplace=True))
        super().__init__(*mods)


class DCNv2(nn.Module):
    """The modulated deformable 3x3 conv's parameters: the DCN ``weight`` and
    ``bias`` and the 27-channel ``conv_offset_mask`` that predicts, per pixel,
    18 offsets (dy, dx per tap, taps row-major) and 9 mask logits."""

    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.conv_offset_mask = nn.Conv2d(cin, 27, 3, padding=1)

    def offset_mask(self, x):
        """(offset (N, 18, H, W) f32, sigmoided mask (N, 9, H, W) f32). The
        conv runs at the model's width; the coordinate math downstream is f32,
        where bf16 would cost whole pixels at x ~ 128."""
        om = self.conv_offset_mask(x).float()
        return om[:, :18].contiguous(), torch.sigmoid(om[:, 18:]).contiguous()


class DeformConvV2(nn.Module):
    """DCN → BatchNorm → ReLU, the block used 16 times in DLAUp/IDAUp (JAX
    ``DeformConvV2``, layers.py:83-189). The DCN runs at x's width with its
    f32 weight cast to it, as JAX casts its kernel.

    At training the DCN is differentiable (``modulated_deform_conv_ad``: the forward kernel
    without epilogue, the backward kernels) and the BatchNorm runs apart.
    At eval the conv bias and the BatchNorm fold into the DCN kernel's
    epilogue, ``relu(acc * scale + shift)`` with ``scale = γ/√(var+ε)`` and
    ``shift = scale·(bias − mean) + β``, so the output is written once."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = DCNv2(cin, cout)
        self.actf = nn.Sequential(
            BatchNorm2d(cout, eps=BN_EPS, momentum=BN_MOMENTUM), nn.ReLU(inplace=True)
        )

    def forward(self, x):
        x = x.contiguous()  # autocast's CPU convolutions may return channels-last
        offset, mask = self.conv.offset_mask(x)
        weight = self.conv.weight.to(x.dtype)
        if self.training:
            return self.actf(modulated_deform_conv_ad(x, offset, mask, weight, self.conv.bias))
        bn = self.actf[0]
        scale = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
        shift = scale * (self.conv.bias.float() - bn.running_mean.float()) + bn.bias.float()
        return modulated_deform_conv(
            x, offset, mask, weight,
            post_scale=scale, post_shift=shift, post_relu=True,
        )


def bilinear_kernel(f: int) -> np.ndarray:
    """(2f, 2f) bilinear interpolation stencil (reference fill_up_weights)."""
    size = 2 * f
    c = (2 * np.ceil(size / 2) - 1 - np.ceil(size / 2) % 2) / (2.0 * np.ceil(size / 2))
    og = np.ogrid[:size, :size]
    k = (1 - np.abs(og[0] / np.ceil(size / 2) - c)) * (1 - np.abs(og[1] / np.ceil(size / 2) - c))
    return k.astype(np.float32)


class BilinearUpsample(nn.ConvTranspose2d):
    """Depthwise ``ConvTranspose2d(k=2f, s=f, pad=f//2, groups=C)`` with the
    bilinear init (JAX ``BilinearUpsample``, layers.py:218-284).

    The JAX package correlates the input-dilated map with its kernel as
    stored; torch's transposed conv uses the kernel spatially flipped, so a
    JAX kernel crosses over flipped (``checkpoint/from_jax.py``)."""

    def __init__(self, channels: int, factor: int):
        super().__init__(
            channels, channels, 2 * factor, stride=factor, padding=factor // 2,
            groups=channels, bias=False,
        )

    def reset_parameters(self):
        k = torch.from_numpy(bilinear_kernel(self.kernel_size[0] // 2))
        with torch.no_grad():
            self.weight.copy_(k.expand_as(self.weight))


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initializers, drawn from ``generator``: conv kernels
    lecun-normal (flax's: a normal truncated at ±2σ, σ = 1/√fan_in / 0.8796
    so the variance is 1/fan_in) with zero bias; DCN kernels uniform within
    ±1/√fan_in with zero bias; ``conv_offset_mask`` zero (offsets start at 0,
    masks at 0.5); BatchNorm γ=1, β=0, mean 0, var 1; upsamplers bilinear."""
    for m in model.modules():
        if isinstance(m, BilinearUpsample):
            m.reset_parameters()
        elif isinstance(m, nn.Conv2d):
            std = 1.0 / math.sqrt(m.weight[0].numel()) / TRUNC_NORMAL_STD
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    for m in model.modules():  # after the generic pass, which reached its convs
        if isinstance(m, DCNv2):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.zero_()
            m.conv_offset_mask.weight.zero_()
            m.conv_offset_mask.bias.zero_()
