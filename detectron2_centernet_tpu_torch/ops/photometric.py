"""Color jitter on the model's device, batched (counterpart of the JAX
package's ``ops/photometric.py::device_color_jitter``).

The host ships uint8 pixels and the jitter runs in the train step, per image
with its own draws: contrast (blend with the image mean), brightness, and
saturation (blend with the gray image), each applied with probability
``prob``, then PCA lighting. ``color_jitter`` is the deterministic core that
takes the draws; ``device_color_jitter`` draws them from a
``torch.Generator``. The means are taken over the warped crop, as in JAX.
"""

from typing import Optional, Tuple

import torch

__all__ = ["color_jitter", "device_color_jitter"]

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
