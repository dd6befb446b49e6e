"""Modulated deformable 3x3 convolution (DCNv2): the plain PyTorch version.

Same function as the JAX package's exact op (``ops/deform_conv.py::
modulated_deform_conv`` with ``window=0``) in the port's NCHW layout, plus the
inference epilogue of the Hopper kernel (``out * post_scale + post_shift``,
then ReLU). It runs every DCN on the CPU, and it is what ``chip_smoke.py``
holds the CUDA kernel (``ops/dcn.py``) against on the card.

Channel convention (DCNv2, so torch checkpoints import): for tap ``k`` in
row-major (ky, kx) order, ``offset[:, 2k]`` is the **y** displacement and
``offset[:, 2k+1]`` the **x** displacement; ``mask[:, k]`` is the (already
sigmoided) modulation scalar. Output pixel (i, j), tap (ky, kx) samples the
input at (i - 1 + ky + dy, j - 1 + kx + dx).

Bilinear corners are written in the floor form of the reference im2col
(``y0 = floor(py)``, weights ``1 - (py - y0)`` and ``py - y0``); a corner
outside the image reads 0. On the forward this equals the JAX package's
``max(0, 1 - |d|)`` tents; the two differ only in the offset gradient at
integer sample positions, where the floor form gives the one-sided
derivative the reference CUDA gives.
"""

from typing import Optional

import torch


def _sample_columns(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Modulated bilinear samples (im2col columns), (N, Cin * 9, H * W) f32.

    Row ``c * 9 + k`` holds channel ``c`` at tap ``k``: the order of a
    flattened OIHW weight, so the convolution is one matrix product."""
    n, cin, h, w = x.shape
    dev = x.device
    f32 = torch.float32
    tap = torch.arange(9, device=dev)
    ky = (tap // 3).to(f32).view(1, 9, 1, 1)
    kx = (tap % 3).to(f32).view(1, 9, 1, 1)
    oy = torch.arange(h, device=dev, dtype=f32).view(1, 1, h, 1)
    ox = torch.arange(w, device=dev, dtype=f32).view(1, 1, 1, w)
    off = offset.to(f32).view(n, 9, 2, h, w)
    py = oy - 1 + ky + off[:, :, 0]  # (N, 9, H, W)
    px = ox - 1 + kx + off[:, :, 1]
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    ly = py - y0
    lx = px - x0
    xf = x.to(f32).reshape(n, cin, h * w)
    cols = torch.zeros(n, cin, 9 * h * w, device=dev, dtype=f32)
    for dy, dx, wgt in (
        (0, 0, (1 - ly) * (1 - lx)),
        (0, 1, (1 - ly) * lx),
        (1, 0, ly * (1 - lx)),
        (1, 1, ly * lx),
    ):
        yy = y0 + dy
        xx = x0 + dx
        valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long().view(n, 1, 9 * h * w)
        v = torch.gather(xf, 2, idx.expand(n, cin, 9 * h * w))
        cols = cols + v * (wgt * valid).view(n, 1, 9 * h * w)
    cols = cols * mask.to(f32).reshape(n, 1, 9 * h * w)
    return cols.view(n, cin * 9, h * w)


def modulated_deform_conv(
    x: torch.Tensor,  # (N, Cin, H, W) f32 or bf16
    offset: torch.Tensor,  # (N, 18, H, W) f32
    mask: torch.Tensor,  # (N, 9, H, W) f32, already sigmoided
    weight: torch.Tensor,  # (Cout, Cin, 3, 3), x's dtype
    bias: Optional[torch.Tensor] = None,  # (Cout,)
    post_scale: Optional[torch.Tensor] = None,  # (Cout,) f32
    post_shift: Optional[torch.Tensor] = None,  # (Cout,) f32
    post_relu: bool = False,
) -> torch.Tensor:
    """3x3 stride-1 SAME modulated deformable conv; returns (N, Cout, H, W)
    in x's dtype.

    The samples are rounded to x's dtype before the contraction and the
    weight is used in x's dtype, as the kernel does; products accumulate in
    f32 and the epilogue (bias, then ``* post_scale + post_shift``, then
    ReLU) runs in f32 before the one rounding to x's dtype."""
    n, cin, h, w = x.shape
    cout = weight.shape[0]
    cols = _sample_columns(x, offset, mask).to(x.dtype).to(torch.float32)
    wmat = weight.reshape(cout, cin * 9).to(x.dtype).to(torch.float32)
    out = torch.matmul(wmat, cols)  # (N, Cout, H*W)
    if bias is not None:
        out = out + bias.to(torch.float32).view(1, cout, 1)
    if post_scale is not None:
        out = out * post_scale.to(torch.float32).view(1, cout, 1)
        out = out + post_shift.to(torch.float32).view(1, cout, 1)
    if post_relu:
        out = torch.relu(out)
    return out.view(n, cout, h, w).to(x.dtype)
