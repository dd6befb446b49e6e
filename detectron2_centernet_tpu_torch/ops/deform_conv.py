"""Deformable 3x3 convolution (DCNv2, and DCNv1 without a mask): the plain
PyTorch versions of the forward and of the four backward kernels.

Same function as the JAX package's exact op (``ops/deform_conv.py::
modulated_deform_conv`` with ``window=0``, a 3x3 kernel, stride 1 or 2,
dilation 1 or 2, padding = dilation) in the port's NCHW layout, plus the
inference epilogue of the Hopper kernel (``out * post_scale + post_shift``,
then ReLU). They run every DCN on the CPU, and they are what ``chip_smoke.py``
holds the CUDA kernels (``ops/dcn.py``) against on the card: one function per
kernel, returning exactly that kernel's outputs.

Channel convention (DCNv2, so torch checkpoints import): for tap ``k`` in
row-major (ky, kx) order, ``offset[:, 2k]`` is the **y** displacement and
``offset[:, 2k+1]`` the **x** displacement; ``mask[:, k]`` is the (already
sigmoided) modulation scalar; ``mask=None`` is the unmodulated form (a mask
of ones, no d mask). x is (N, Cin, H, W); offset, mask, g and the output are
on the output grid Ho × Wo, ``Ho = (H - 1) // stride + 1``. Output pixel
(i, j), tap (ky, kx) samples the input at
(i·s - d + ky·d + dy, j·s - d + kx·d + dx), s the stride, d the dilation.

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


def out_size(h: int, w: int, stride: int = 1) -> Tuple[int, int]:
    """The output grid (Ho, Wo) of a 3x3 DCN at ``stride`` with padding =
    dilation on an H × W map."""
    return (h - 1) // stride + 1, (w - 1) // stride + 1


def _corners(offset: torch.Tensor, h: int, w: int, stride: int = 1, dilation: int = 1):
    """Floor corners of every (tap, pixel) sample of an (N, 18, Ho, Wo)
    offset map on an H × W input: ``[(index, valid)] * 4`` as (N, 9·Ho·Wo)
    long / f32 (index clamped into the input, valid 0 where the corner is
    padding), and the fractions ``ly, lx`` (N, 9·Ho·Wo) f32."""
    n, _, ho, wo = offset.shape
    dev = offset.device
    tap = torch.arange(9, device=dev)
    ky = (tap // 3 * dilation).to(_F32).view(1, 9, 1, 1)
    kx = (tap % 3 * dilation).to(_F32).view(1, 9, 1, 1)
    oy = (torch.arange(ho, device=dev) * stride - dilation).to(_F32).view(1, 1, ho, 1)
    ox = (torch.arange(wo, device=dev) * stride - dilation).to(_F32).view(1, 1, 1, wo)
    off = offset.to(_F32).view(n, 9, 2, ho, wo)
    py = (oy + ky + off[:, :, 0]).reshape(n, 9 * ho * wo)
    px = (ox + kx + off[:, :, 1]).reshape(n, 9 * ho * wo)
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
    """x at the four corners of every sample, (N, Cin, 9·Ho·Wo) f32 each, 0
    where the corner is padding."""
    n, cin, h, w = x.shape
    xf = x.to(_F32).reshape(n, cin, h * w)
    return [
        torch.gather(xf, 2, idx.view(n, 1, -1).expand(n, cin, idx.shape[1])) * valid.view(n, 1, -1)
        for idx, valid in corners
    ]


def _mask_flat(mask: Optional[torch.Tensor], n: int) -> Optional[torch.Tensor]:
    return None if mask is None else mask.to(_F32).reshape(n, -1)


def _sample_columns(x: torch.Tensor, offset: torch.Tensor, mask: Optional[torch.Tensor],
                    stride: int = 1, dilation: int = 1) -> torch.Tensor:
    """Modulated bilinear samples (im2col columns), (N, Cin * 9, Ho * Wo) f32.

    Row ``c * 9 + k`` holds channel ``c`` at tap ``k``: the order of a
    flattened OIHW weight, so the convolution is one matrix product."""
    n, cin, h, w = x.shape
    ho, wo = offset.shape[2:]
    corners, ly, lx = _corners(offset, h, w, stride, dilation)
    vals = _corner_values(x, corners)
    wgts = _corner_weights(ly, lx)
    cols = sum(v * wt.view(n, 1, -1) for v, wt in zip(vals, wgts))
    if mask is not None:
        cols = cols * _mask_flat(mask, n).view(n, 1, -1)
    return cols.view(n, cin * 9, ho * wo)


def modulated_deform_conv(
    x: torch.Tensor,  # (N, Cin, H, W) f32 or bf16
    offset: torch.Tensor,  # (N, 18, Ho, Wo) f32
    mask: Optional[torch.Tensor],  # (N, 9, Ho, Wo) f32, already sigmoided; None: unmodulated
    weight: torch.Tensor,  # (Cout, Cin, 3, 3), x's dtype
    bias: Optional[torch.Tensor] = None,  # (Cout,)
    post_scale: Optional[torch.Tensor] = None,  # (Cout,) f32
    post_shift: Optional[torch.Tensor] = None,  # (Cout,) f32
    post_relu: bool = False,
    stride: int = 1,
    dilation: int = 1,
) -> torch.Tensor:
    """3x3 deformable conv at ``stride`` and ``dilation`` (padding =
    dilation); returns (N, Cout, Ho, Wo) in x's dtype.

    The samples are rounded to x's dtype before the contraction and the
    weight is used in x's dtype, as the kernel does; products accumulate in
    f32 and the epilogue (bias, then ``* post_scale + post_shift``, then
    ReLU) runs in f32 before the one rounding to x's dtype."""
    n, cin = x.shape[:2]
    ho, wo = offset.shape[2:]
    cout = weight.shape[0]
    cols = _sample_columns(x, offset, mask, stride, dilation).to(x.dtype).to(_F32)
    wmat = weight.reshape(cout, cin * 9).to(x.dtype).to(_F32)
    out = torch.matmul(wmat, cols)  # (N, Cout, Ho*Wo)
    if bias is not None:
        out = out + bias.to(_F32).view(1, cout, 1)
    if post_scale is not None:
        out = out * post_scale.to(_F32).view(1, cout, 1)
        out = out + post_shift.to(_F32).view(1, cout, 1)
    if post_relu:
        out = torch.relu(out)
    return out.view(n, cout, ho, wo).to(x.dtype)


def _dcol(weight: torch.Tensor, g: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Wᵀ·g, (N, Cin, 9·Ho·Wo) f32: the cotangent of the column matrix."""
    n, cout, ho, wo = g.shape
    cin = weight.shape[1]
    wmat = weight.reshape(cout, cin * 9).to(dtype).to(_F32)
    dcol = torch.matmul(wmat.t(), g.to(dtype).to(_F32).reshape(n, cout, ho * wo))
    return dcol.view(n, cin, 9 * ho * wo)


def dcn_bwd_dx(x, offset, mask, weight, g, stride: int = 1, dilation: int = 1) -> torch.Tensor:
    """K2, dX: ``dcol · mask`` scattered into the four corners of every
    sample with the bilinear weights (col2im). Returns (N, Cin, H, W) in x's
    dtype, summed in f32."""
    n, cin, h, w = x.shape
    corners, ly, lx = _corners(offset, h, w, stride, dilation)
    d = _dcol(weight, g, x.dtype)
    if mask is not None:
        d = d * _mask_flat(mask, n).view(n, 1, -1)
    dx = torch.zeros(n, cin, h * w, device=x.device, dtype=_F32)
    for (idx, valid), wt in zip(corners, _corner_weights(ly, lx)):
        dx.scatter_add_(2, idx.view(n, 1, -1).expand(n, cin, idx.shape[1]),
                        d * (wt * valid).view(n, 1, -1))
    return dx.view(n, cin, h, w).to(x.dtype)


def dcn_bwd_dq(x, offset, mask, weight, g, stride: int = 1,
               dilation: int = 1) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K3, (d offset (N, 18, Ho, Wo), d mask (N, 9, Ho, Wo)), both f32: the
    sums over Cin of ``dcol · mask · ∂sample/∂(py, px)`` (floor corners: the
    right derivative) and of ``dcol · sample`` (the unmodulated sample).
    Without a mask, d mask is None."""
    n, cin, h, w = x.shape
    ho, wo = offset.shape[2:]
    corners, ly, lx = _corners(offset, h, w, stride, dilation)
    v00, v01, v10, v11 = _corner_values(x, corners)
    dcol = _dcol(weight, g, x.dtype)
    ly, lx = ly.view(n, 1, -1), lx.view(n, 1, -1)
    d_ly = (dcol * ((1 - lx) * (v10 - v00) + lx * (v11 - v01))).sum(1)
    d_lx = (dcol * ((1 - ly) * (v01 - v00) + ly * (v11 - v10))).sum(1)
    if mask is None:
        doffset = torch.stack([d_ly, d_lx], 1)
        dmask = None
    else:
        m = _mask_flat(mask, n)
        doffset = torch.stack([d_ly * m, d_lx * m], 1)
        s = (1 - ly) * ((1 - lx) * v00 + lx * v01) + ly * ((1 - lx) * v10 + lx * v11)
        dmask = (dcol * s).sum(1).view(n, 9, ho, wo)
    doffset = doffset.view(n, 2, 9, ho, wo).transpose(1, 2)
    return doffset.reshape(n, 18, ho, wo), dmask


def dcn_bwd_dw(x, offset, mask, g, stride: int = 1, dilation: int = 1) -> torch.Tensor:
    """K4, dW (Cout, Cin, 3, 3) in x's dtype: g times the modulated samples
    rounded to x's dtype, summed over the batch and the pixels in f32."""
    n, cin = x.shape[:2]
    cout = g.shape[1]
    cols = _sample_columns(x, offset, mask, stride, dilation).to(x.dtype).to(_F32)
    gf = g.to(x.dtype).to(_F32).reshape(n, cout, -1)
    dw = torch.einsum("ncp,nkp->ck", gf, cols)
    return dw.reshape(cout, cin, 3, 3).to(x.dtype)


def dcn_bwd_dqdw(x, offset, mask, weight, g, stride: int = 1, dilation: int = 1):
    """K5: K3 and K4 together, (d offset, d mask or None, dW)."""
    doffset, dmask = dcn_bwd_dq(x, offset, mask, weight, g, stride, dilation)
    return doffset, dmask, dcn_bwd_dw(x, offset, mask, g, stride, dilation)
