"""Photometric augmentation on the model's device, batched (counterpart of
the JAX package's ``ops/photometric.py``: ``device_color_jitter`` and
``device_color_aug_ssd``).

The host ships uint8 pixels and the augmentation runs in the train step, per
image with its own draws. ``INPUT.COLOR_JITTER``: contrast (blend with the
image mean), brightness, and saturation (blend with the gray image), each
applied with probability ``prob``, then PCA lighting. ``INPUT.COLOR_AUG_SSD``:
the SSD distortion (brightness shift, contrast scale, saturation as a luma
gray-blend, hue as a YIQ rotation), each gated at 0.5. Each has a
deterministic core that takes the draws (``color_jitter``,
``color_aug_ssd``) and a wrapper that draws them from a ``torch.Generator``.
The means are taken over the warped crop, as in JAX. Images are (N, 3, H, W)
with channels in the dataset's BGR order.
"""

import math
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["color_aug_ssd", "color_jitter", "device_color_aug_ssd", "device_color_jitter"]

_EIGVAL = (0.2141788, 0.01817699, 0.00341571)
_EIGVEC = (
    (-0.58752847, -0.69563484, 0.41340352),
    (-0.5832747, 0.00994535, -0.81221408),
    (-0.56089297, 0.71832671, 0.41158938),
)
_GRAY = (0.299, 0.587, 0.114)


def color_jitter(
    images: torch.Tensor,  # (N, 3, H, W) float 0..255
    contrast: torch.Tensor,  # (N,) factors, 1 where the gate is off
    brightness: torch.Tensor,  # (N,)
    saturation: torch.Tensor,  # (N,)
    lighting: torch.Tensor,  # (N, 3) PCA weights, 0 where the gate is off
) -> torch.Tensor:
    """The jitter of ``PhotometricAug`` given its draws; returns f32."""
    x = images.to(torch.float32)
    dev = x.device
    view = lambda t: t.to(dev, torch.float32).view(-1, 1, 1, 1)
    w = view(contrast)
    x = x.mean(dim=(1, 2, 3), keepdim=True) * (1.0 - w) + x * w
    x = x * view(brightness)
    w = view(saturation)
    gray = torch.einsum("nchw,c->nhw", x, torch.tensor(_GRAY, device=dev))[:, None]
    x = gray * (1.0 - w) + x * w
    eigvec = torch.tensor(_EIGVEC, device=dev)
    shift = (lighting.to(dev, torch.float32) * torch.tensor(_EIGVAL, device=dev)) @ eigvec.t() * 255.0
    return x + shift[:, :, None, None]


def device_color_jitter(
    images: torch.Tensor,  # (N, 3, H, W) float 0..255
    generator: Optional[torch.Generator] = None,
    prob: float = 0.4,
    contrast: Tuple[float, float] = (0.8, 1.2),
    brightness: Tuple[float, float] = (0.8, 1.2),
    saturation: Tuple[float, float] = (0.8, 1.2),
    lighting_scale: float = 0.1,
) -> torch.Tensor:
    """Batched ``PhotometricAug`` with draws from ``generator`` (which must
    live on the images' device)."""
    n = images.shape[0]
    dev = images.device
    u = torch.rand(7, n, generator=generator, device=dev)
    normal = torch.randn(n, 3, generator=generator, device=dev)

    def factor(gate, draw, lo_hi):
        lo, hi = lo_hi
        return torch.where(gate < prob, lo + (hi - lo) * draw, torch.ones((), device=dev))

    return color_jitter(
        images,
        factor(u[0], u[1], contrast),
        factor(u[2], u[3], brightness),
        factor(u[4], u[5], saturation),
        normal * lighting_scale * (u[6] < prob).to(torch.float32)[:, None],
    )


# hue rotation in YIQ space (JAX ``_RGB2YIQ``), and its exact inverse: the
# textbook YIQ->RGB constants are rounded to 3 decimals and would leave a
# ~0.3/255 residual even at hue angle 0
_RGB2YIQ = np.asarray([[0.299, 0.587, 0.114],
                       [0.596, -0.274, -0.322],
                       [0.211, -0.523, 0.312]], np.float32)
_YIQ2RGB = np.linalg.inv(_RGB2YIQ).astype(np.float32)


def color_aug_ssd(
    images: torch.Tensor,  # (N, 3, H, W) float 0..255, BGR
    brightness: torch.Tensor,  # (N,) additive delta, 0 where the gate is off
    contrast: torch.Tensor,  # (N,) factors, 1 where the gate is off
    saturation: torch.Tensor,  # (N,) factors, 1 where the gate is off
    hue: torch.Tensor,  # (N,) YIQ rotation angles in radians, 0 where the gate is off
) -> torch.Tensor:
    """The SSD distortion of the JAX package's ``device_color_aug_ssd`` given
    its gated draws, in its order: brightness, clip, contrast, clip,
    saturation (gray-blend with the BT.601 luma of the RGB image), hue (RGB →
    YIQ, rotate I/Q, back through the exact inverse), clip to [0, 255].
    Returns f32."""
    x = images.to(torch.float32)
    dev = x.device
    view = lambda t: t.to(dev, torch.float32).view(-1, 1, 1, 1)
    x = torch.clamp(x + view(brightness), 0.0, 255.0)
    x = torch.clamp(x * view(contrast), 0.0, 255.0)
    w = view(saturation)
    rgb_gray = torch.tensor(_GRAY, device=dev)
    gray = torch.einsum("nchw,c->nhw", x.flip(1), rgb_gray)[:, None]  # BGR → RGB for the luma
    x = gray * (1.0 - w) + x * w
    theta = hue.to(dev, torch.float32)
    cos, sin = torch.cos(theta), torch.sin(theta)
    zero, one = torch.zeros_like(cos), torch.ones_like(cos)
    rot = torch.stack([torch.stack([one, zero, zero], -1),
                       torch.stack([zero, cos, -sin], -1),
                       torch.stack([zero, sin, cos], -1)], 1)  # (N, 3, 3)
    m = torch.einsum("ij,njk,kl->nil", torch.from_numpy(_YIQ2RGB).to(dev), rot,
                     torch.from_numpy(_RGB2YIQ).to(dev))  # (N, 3, 3) rgb -> rgb
    rgb = torch.einsum("nchw,nkc->nkhw", x.flip(1), m)
    return torch.clamp(rgb.flip(1), 0.0, 255.0)


def device_color_aug_ssd(
    images: torch.Tensor,  # (N, 3, H, W) float 0..255, BGR
    generator: Optional[torch.Generator] = None,
    brightness_delta: float = 32.0,
    contrast: Tuple[float, float] = (0.5, 1.5),
    saturation: Tuple[float, float] = (0.5, 1.5),
    hue_delta_deg: float = 18.0,
) -> torch.Tensor:
    """Batched SSD distortion with draws from ``generator`` (which must live
    on the images' device): each of the four ops fires with probability
    0.5; the brightness delta is uniform in ±``brightness_delta``, the
    contrast and saturation factors in their ranges, and the hue rotation
    uniform in ±``hue_delta_deg`` HSV degrees, applied as twice that angle
    in YIQ (the JAX package's mapping)."""
    n = images.shape[0]
    dev = images.device
    u = torch.rand(8, n, generator=generator, device=dev)
    gate = lambda g: (g < 0.5).to(torch.float32)
    lerp = lambda draw, lo, hi: lo + (hi - lo) * draw
    return color_aug_ssd(
        images,
        gate(u[1]) * lerp(u[0], -brightness_delta, brightness_delta),
        1.0 + gate(u[3]) * (lerp(u[2], *contrast) - 1.0),
        1.0 + gate(u[5]) * (lerp(u[4], *saturation) - 1.0),
        lerp(u[6], -hue_delta_deg, hue_delta_deg) * (2.0 * math.pi / 180.0) * gate(u[7]),
    )
