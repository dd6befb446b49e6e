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

import functools
import inspect
import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.dcn import modulated_deform_conv, modulated_deform_conv_ad

BN_MOMENTUM = 0.1  # torch convention; the JAX package's flax momentum is 0.9
BN_EPS = 1e-5
# std of a unit normal truncated at ±2: flax's lecun_normal divides by it
TRUNC_NORMAL_STD = 0.87962566103423978


@functools.lru_cache(maxsize=None)
def _cudnn_flag_names():
    return tuple(inspect.signature(torch.backends.cudnn.flags).parameters)


def ieee_f32():
    """A context in which cuDNN computes f32 convolutions in IEEE f32, not
    TF32: ``torch.backends.cudnn.flags`` with ``allow_tf32=False`` (and, where
    torch has it, ``fp32_precision="ieee"``), every other cuDNN flag passed
    at its current value (the context's defaults would turn cuDNN off). The
    flags are restored on exit; nothing is set for the process. bf16 and
    CPU convolutions are not affected."""
    cudnn = torch.backends.cudnn
    names = _cudnn_flag_names()
    kw = {k: getattr(cudnn, k) for k in ("enabled", "benchmark", "benchmark_limit",
                                          "deterministic", "depthwise_kernel")
          if k in names and getattr(cudnn, k, None) is not None}
    kw["allow_tf32"] = False
    if "fp32_precision" in names:
        kw["fp32_precision"] = "ieee"
    return cudnn.flags(**kw)


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


class ZeroInitConv2d(nn.Conv2d):
    """A conv whose kernel and bias ``init_weights`` sets to 0, as the JAX
    package initializes the offset predictors (offsets start at 0)."""


class DCNv2(nn.Module):
    """The modulated deformable 3x3 conv's parameters: the DCN ``weight`` and
    ``bias`` and the 27-channel ``conv_offset_mask`` that predicts, per pixel,
    18 offsets (dy, dx per tap, taps row-major) and 9 mask logits."""

    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.conv_offset_mask = ZeroInitConv2d(cin, 27, 3, padding=1)

    def offset_mask(self, x):
        """(offset (N, 18, H, W) f32, sigmoided mask (N, 9, H, W) f32). The
        conv runs at the model's width; the coordinate math downstream is f32,
        where bf16 would cost whole pixels at x ~ 128."""
        om = self.conv_offset_mask(x).float()
        return om[:, :18].contiguous(), torch.sigmoid(om[:, 18:]).contiguous()


class DeformConvNorm(nn.Module):
    """The deformable 3x3 (``weight``, no bias) and its normalization
    ``.norm``: the reference's ``conv2`` of a ``DeformBottleneckBlock``."""

    def __init__(self, channels: int, stride: int, dilation: int, norm: str):
        super().__init__()
        self.stride, self.dilation = stride, dilation
        self.weight = nn.Parameter(torch.empty(channels, channels, 3, 3))
        self.norm = get_norm(norm, channels)

    def forward(self, x: torch.Tensor, offset: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """x at the model's width; the DCN (K1, and K2 and K5 in the
        backward) at x's width with its f32 weight cast to it, as JAX casts
        its kernel; then the normalization, never folded into the kernel's
        epilogue (a FrozenBN's scale and bias are trainable)."""
        x = x.contiguous()  # autocast's CPU convolutions may return channels-last
        out = modulated_deform_conv_ad(x, offset, mask, self.weight.to(x.dtype), stride=self.stride,
                                       dilation=self.dilation)
        return self.norm(out) if self.norm is not None else out


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


class FrozenBatchNorm(nn.Module):
    """BatchNorm with fixed statistics (JAX ``FrozenBatchNorm``,
    layers.py:287-308): ``x · γ/√(var+ε) + (β − mean · γ/√(var+ε))``, the two
    factors cast to x's width. As in the JAX package, γ and β (``weight``,
    ``bias``) are trainable parameters; the statistics are buffers that
    nothing updates. State-dict keys are the reference's FrozenBatchNorm2d's
    (``weight``, ``bias``, ``running_mean``, ``running_var``)."""

    def __init__(self, num_features: int, eps: float = BN_EPS):
        super().__init__()
        self.num_features, self.eps = num_features, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # a BatchNorm's counter (in a checkpoint trained with BN, or from
        # state_dict_from_jax, which cannot tell the two apart) has no use here
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        shift = self.bias - self.running_mean * inv
        return x * inv.to(x.dtype).view(1, -1, 1, 1) + shift.to(x.dtype).view(1, -1, 1, 1)

    def extra_repr(self) -> str:
        return f"{self.num_features}, eps={self.eps}"


GN_EPS = 1e-6  # flax GroupNorm's epsilon


def get_norm(norm: str, channels: int):
    """The normalization a config names (JAX ``get_norm``, layers.py:311-323):
    ``BN``, ``SyncBN`` and ``NaiveSyncBN`` (one device here: plain batch
    statistics) → the port's ``BatchNorm2d`` (flax's biased running
    variance); ``FrozenBN`` → ``FrozenBatchNorm``; ``GN`` → 32 groups;
    ``""`` → None."""
    if norm == "":
        return None
    if norm in ("BN", "SyncBN", "NaiveSyncBN", "naiveSyncBN"):
        return BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)
    if norm == "FrozenBN":
        return FrozenBatchNorm(channels)
    if norm == "GN":
        return nn.GroupNorm(32, channels, eps=GN_EPS)
    raise ValueError(f"Unknown norm: {norm!r}")


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
    """The JAX package's initializers, drawn from ``generator``: conv,
    transposed-conv and linear kernels lecun-normal (flax's: a normal truncated at ±2σ,
    σ = 1/√fan_in / 0.8796 so the variance is 1/fan_in) with zero bias; DCN kernels uniform within
    ±1/√fan_in with zero bias; the offset convs (``ZeroInitConv2d``: the
    DCNs' ``conv_offset_mask``, the deformable blocks' ``conv2_offset``)
    zero (offsets start at 0, masks at 0.5), after the generic pass has
    drawn for them, so no other draw depends on which convs start at 0;
    BatchNorm, FrozenBatchNorm and GroupNorm γ=1, β=0 (mean 0, var 1);
    upsamplers bilinear."""
    for m in model.modules():
        if isinstance(m, BilinearUpsample):
            m.reset_parameters()
        elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            # fan_in of the kernel: a transposed conv's weight is (Cin, Cout/groups, kh, kw)
            fan_in = m.weight[:, 0].numel() if isinstance(m, nn.ConvTranspose2d) else m.weight[0].numel()
            std = 1.0 / math.sqrt(fan_in) / TRUNC_NORMAL_STD
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.GroupNorm, FrozenBatchNorm)):
            m.reset_parameters()
    for m in model.modules():  # after the generic pass, which reached their convs
        if isinstance(m, ZeroInitConv2d):
            m.weight.zero_()
            m.bias.zero_()
        if isinstance(m, (DeformConvNorm, DCNv2)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-bound, bound, generator=generator)
        if isinstance(m, DCNv2):
            m.bias.zero_()
