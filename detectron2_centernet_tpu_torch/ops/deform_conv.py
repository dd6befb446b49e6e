"""Modulated deformable 3x3 convolution (DCNv2): the plain PyTorch versions of
the forward and of the four backward kernels.

Same function as the JAX package's exact op (``ops/deform_conv.py::
modulated_deform_conv`` with ``window=0``) in the port's NCHW layout, plus the
inference epilogue of the Hopper kernel (``out * post_scale + post_shift``,
then ReLU). They run every DCN on the CPU, and they are what ``chip_smoke.py``
holds the CUDA kernels (``ops/dcn.py``) against on the card: one function per
kernel, returning exactly that kernel's outputs.

Channel convention (DCNv2, so torch checkpoints import): for tap ``k`` in
row-major (ky, kx) order, ``offset[:, 2k]`` is the **y** displacement and
``offset[:, 2k+1]`` the **x** displacement; ``mask[:, k]`` is the (already
sigmoided) modulation scalar. Output pixel (i, j), tap (ky, kx) samples the
input at (i - 1 + ky + dy, j - 1 + kx + dx).

Bilinear corners are written in the floor form of the reference im2col
(``y0 = floor(py)``, weights ``1 - (py - y0)`` and ``py - y0``); a corner
outside the image reads 0. On the forward this equals the JAX package's
``max(0, 1 - |d|)`` tents; the two differ only in the offset gradient at
integer sample positions, where the floor form gives the one-sided (right)
derivative the reference CUDA gives.

Arithmetic of the backward, as the kernels do it: ``dcol = Wᵀ·g`` and every
sum in f32 from operands in x's type; ``dW`` contracts g with the modulated
samples rounded to x's type, as the forward rounds them.
"""

from typing import List, Optional, Tuple

import torch

_F32 = torch.float32
# the four floor corners (dy, dx) of a bilinear sample
_CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))


def _corners(offset: torch.Tensor, h: int, w: int):
    """Floor corners of every (tap, pixel) sample of an (N, 18, H, W) offset
    map: ``[(index, valid)] * 4`` as (N, 9·H·W) long / f32 (index clamped
    into the image, valid 0 where the corner is padding), and the fractions
    ``ly, lx`` (N, 9·H·W) f32."""
    n = offset.shape[0]
    dev = offset.device
    tap = torch.arange(9, device=dev)
    ky = (tap // 3).to(_F32).view(1, 9, 1, 1)
    kx = (tap % 3).to(_F32).view(1, 9, 1, 1)
    oy = torch.arange(h, device=dev, dtype=_F32).view(1, 1, h, 1)
    ox = torch.arange(w, device=dev, dtype=_F32).view(1, 1, 1, w)
    off = offset.to(_F32).view(n, 9, 2, h, w)
    py = (oy - 1 + ky + off[:, :, 0]).reshape(n, 9 * h * w)
    px = (ox - 1 + kx + off[:, :, 1]).reshape(n, 9 * h * w)
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    corners = []
    for dy, dx in _CORNERS:
        yy = y0 + dy
        xx = x0 + dx
        valid = ((yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)).to(_F32)
        idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()
        corners.append((idx, valid))
    return corners, py - y0, px - x0


def _corner_weights(ly: torch.Tensor, lx: torch.Tensor) -> List[torch.Tensor]:
    return [(1 - ly) * (1 - lx), (1 - ly) * lx, ly * (1 - lx), ly * lx]


def _corner_values(x: torch.Tensor, corners) -> List[torch.Tensor]:
    """x at the four corners of every sample, (N, Cin, 9·H·W) f32 each, 0
    where the corner is padding."""
    n, cin, h, w = x.shape
    xf = x.to(_F32).reshape(n, cin, h * w)
    return [
        torch.gather(xf, 2, idx.view(n, 1, -1).expand(n, cin, idx.shape[1])) * valid.view(n, 1, -1)
        for idx, valid in corners
    ]


def _sample_columns(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Modulated bilinear samples (im2col columns), (N, Cin * 9, H * W) f32.

    Row ``c * 9 + k`` holds channel ``c`` at tap ``k``: the order of a
    flattened OIHW weight, so the convolution is one matrix product."""
    n, cin, h, w = x.shape
    corners, ly, lx = _corners(offset, h, w)
    vals = _corner_values(x, corners)
    wgts = _corner_weights(ly, lx)
    cols = sum(v * wt.view(n, 1, -1) for v, wt in zip(vals, wgts))
    cols = cols * mask.to(_F32).reshape(n, 1, 9 * h * w)
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
    cols = _sample_columns(x, offset, mask).to(x.dtype).to(_F32)
    wmat = weight.reshape(cout, cin * 9).to(x.dtype).to(_F32)
    out = torch.matmul(wmat, cols)  # (N, Cout, H*W)
    if bias is not None:
        out = out + bias.to(_F32).view(1, cout, 1)
    if post_scale is not None:
        out = out * post_scale.to(_F32).view(1, cout, 1)
        out = out + post_shift.to(_F32).view(1, cout, 1)
    if post_relu:
        out = torch.relu(out)
    return out.view(n, cout, h, w).to(x.dtype)


def _dcol(weight: torch.Tensor, g: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Wᵀ·g, (N, Cin, 9·H·W) f32: the cotangent of the column matrix."""
    n, cout, h, w = g.shape
    cin = weight.shape[1]
    wmat = weight.reshape(cout, cin * 9).to(dtype).to(_F32)
    dcol = torch.matmul(wmat.t(), g.to(dtype).to(_F32).reshape(n, cout, h * w))
    return dcol.view(n, cin, 9 * h * w)


def dcn_bwd_dx(x, offset, mask, weight, g) -> torch.Tensor:
    """K2, dX: ``dcol · mask`` scattered into the four corners of every
    sample with the bilinear weights (col2im). Returns (N, Cin, H, W) in x's
    dtype, summed in f32."""
    n, cin, h, w = x.shape
    corners, ly, lx = _corners(offset, h, w)
    d = _dcol(weight, g, x.dtype) * mask.to(_F32).reshape(n, 1, 9 * h * w)
    dx = torch.zeros(n, cin, h * w, device=x.device, dtype=_F32)
    for (idx, valid), wt in zip(corners, _corner_weights(ly, lx)):
        dx.scatter_add_(2, idx.view(n, 1, -1).expand(n, cin, idx.shape[1]),
                        d * (wt * valid).view(n, 1, -1))
    return dx.view(n, cin, h, w).to(x.dtype)


def dcn_bwd_dq(x, offset, mask, weight, g) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3, (d offset (N, 18, H, W), d mask (N, 9, H, W)), both f32: the sums
    over Cin of ``dcol · mask · ∂sample/∂(py, px)`` (floor corners: the right
    derivative) and of ``dcol · sample`` (the unmodulated sample)."""
    n, cin, h, w = x.shape
    corners, ly, lx = _corners(offset, h, w)
    v00, v01, v10, v11 = _corner_values(x, corners)
    dcol = _dcol(weight, g, x.dtype)
    ly, lx = ly.view(n, 1, -1), lx.view(n, 1, -1)
    s = (1 - ly) * ((1 - lx) * v00 + lx * v01) + ly * ((1 - lx) * v10 + lx * v11)
    d_ly = (dcol * ((1 - lx) * (v10 - v00) + lx * (v11 - v01))).sum(1)
    d_lx = (dcol * ((1 - ly) * (v01 - v00) + ly * (v11 - v10))).sum(1)
    m = mask.to(_F32).reshape(n, 9 * h * w)
    doffset = torch.stack([d_ly * m, d_lx * m], 1).view(n, 2, 9, h, w).transpose(1, 2)
    dmask = (dcol * s).sum(1).view(n, 9, h, w)
    return doffset.reshape(n, 18, h, w), dmask


def dcn_bwd_dw(x, offset, mask, g) -> torch.Tensor:
    """K4, dW (Cout, Cin, 3, 3) in x's dtype: g times the modulated samples
    rounded to x's dtype, summed over the batch and the pixels in f32."""
    n, cin, h, w = x.shape
    cout = g.shape[1]
    cols = _sample_columns(x, offset, mask).to(x.dtype).to(_F32)
    gf = g.to(x.dtype).to(_F32).reshape(n, cout, h * w)
    dw = torch.einsum("ncp,nkp->ck", gf, cols)
    return dw.reshape(cout, cin, 3, 3).to(x.dtype)


def dcn_bwd_dqdw(x, offset, mask, weight, g):
    """K5: K3 and K4 together, (d offset, d mask, dW)."""
    doffset, dmask = dcn_bwd_dq(x, offset, mask, weight, g)
    return doffset, dmask, dcn_bwd_dw(x, offset, mask, g)
