"""Deformable 3x3 conv (DCNv2, and DCNv1 without a mask): the Hopper kernels'
wrappers and the autograd Function that trains through them.

Replaces the TPU kernels of ``detectron2_centernet_tpu/ops/pallas_dcn.py``:
the forward ``_kernel`` (entry ``dcn_conv_pallas``), which every
``DeformConvV2`` of DLAUp/IDAUp runs, and the backward ``_bwd_dx_kernel``,
``_bwd_dq_kernel``, ``_bwd_dw_kernel`` and ``_bwd_dqdw_kernel`` behind the
custom VJP ``_dcn_ad``. The same kernels run the deformable 3x3 of the ResNet
trunks' ``DeformBottleneckBlock``, which the JAX package computes with its
exact op (``ops/deform_conv.py::modulated_deform_conv``): at stride 1 or 2,
dilation 1 or 2 (padding = dilation), modulated or not (``mask=None``: a
mask of ones, which the kernels never read, and no d mask). x is
(N, Cin, H, W); offset, mask, g and the output lie on the output grid
Ho × Wo, ``Ho = (H - 1) // stride + 1``.

* A CUDA tensor launches a hand-written kernel (CUDA C++ for sm_90a:
  ``csrc/dcn_fwd.cu`` for the forward, ``csrc/dcn_bwd.cu`` for the four
  backward kernels; see the note at the top of each for what bounds it and
  what the design does about it), or raises (a stride or dilation other
  than 1 or 2 among them). There is no fallback.
* A CPU tensor runs the plain PyTorch version of the same function
  (``ops/deform_conv.py``).

Every wrapper counts its kernel launches in ``<wrapper>.launches``.

The forward is the custom op ``torch.ops.d2ct.dcn_fwd`` (``torch.library``:
the kernel its CUDA implementation, the plain version its CPU one, a fake
that gives the output's shape, and a FLOP formula), so that
``torch.export`` traces it as one node and an exported program launches
the same kernel (``export/api.py``). The backward kernels are called
directly: export is inference only.

The kernels compute exact DCNv2: every sample is bilinear with zero padding,
wherever its offset points. The TPU kernels' "drop-far" rule (samples beyond
|dy| > 3 read 0) was a VMEM limit of that chip and has no counterpart here.

The libraries are built at first use with ``nvcc`` into ``_build/`` beside
this package (a plain C interface loaded with ``ctypes``), one process per
source, all started together, and cached by the hash of source and flags
(``ops/cuda_lib.py``, which builds the NMS kernel beside them).
"""

import ctypes
import functools
from typing import Dict, Optional

import torch
import torch.utils.flop_counter

from . import cuda_lib
from . import deform_conv as plain
from .cuda_lib import build_libraries  # noqa: F401  (tools/dcn_ab.py calls it on parent trees too)
from .deform_conv import modulated_deform_conv as modulated_deform_conv_plain

__all__ = [
    "build_libraries",
    "bwd_plan",
    "fwd_plan",
    "dcn_bwd_dq",
    "dcn_bwd_dqdw",
    "dcn_bwd_dw",
    "dcn_bwd_dx",
    "dcn_fwd_flops",
    "dcn_fwd_op",
    "kernel_resources",
    "modulated_deform_conv",
    "modulated_deform_conv_ad",
    "modulated_deform_conv_plain",
]

_DTYPES = (torch.float32, torch.bfloat16)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signatures: pointers (a null mask: unmodulated), then ints (the input's
# n, cin, h, w, cout, then stride and dilation, ...), then the stream
_SIGNATURES = {
    "fwd": {
        "dcn_fwd": [_P] * 8 + [_I] * 12 + [_L, _P],
        "dcn_fwd_info": [_I, _I, _P],  # Cout tile, is_bf16, int[3] out
    },
    "bwd": {
        "dcn_bwd_dx": [_P] * 6 + [_I] * 8 + [_P],
        "dcn_bwd_dq": [_P] * 7 + [_I] * 10 + [_P],
        "dcn_bwd_dw": [_P] * 6 + [_I] * 10 + [_P],
        "dcn_bwd_dqdw": [_P] * 9 + [_I] * 10 + [_P],
        "dcn_bwd_info": [_I, _I, _P],  # which kernel, is_bf16, int[3] out
    },
}
# Tiling of K3-K5 (csrc/dcn_bwd.cu): pixel tiles, channel chunks, Cout tiles
BWD_TILE_PIXELS, BWD_CHUNK_CHANNELS, BWD_COUT_TILE = 64, 16, 64
# blocks of K3-K5 aimed at per SM: two resident blocks, two waves
BWD_BLOCKS_PER_SM = 4
# K1 (csrc/dcn_fwd.cu): the side of its square pixel tiles, bytes of
# channels per chunk, the blocks aimed at per SM (two waves of one resident
# block), the cap on the split partials (bytes)
FWD_TILE, FWD_CHUNK_BYTES = 8, 32
FWD_BLOCKS_PER_SM = 2
FWD_PARTIAL_CAP = 16 << 20


def _library(name: str) -> ctypes.CDLL:
    return cuda_lib.library(name, _SIGNATURES[name])


# the strides and dilations the kernels take
KERNEL_STRIDES = KERNEL_DILATIONS = (1, 2)


def _check(x, offset, mask, weight=None, g=None, cout=None, stride=1, dilation=1) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (N, Cin, H, W), got {tuple(x.shape)}")
    n, cin, h, w = x.shape
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not (isinstance(stride, int) and isinstance(dilation, int) and stride >= 1 and dilation >= 1):
        raise ValueError(f"stride and dilation must be positive ints, got {stride!r}, {dilation!r}")
    if x.device.type == "cuda" and (stride not in KERNEL_STRIDES or dilation not in KERNEL_DILATIONS):
        raise ValueError(f"the DCN kernels take stride and dilation in {KERNEL_STRIDES}, got stride {stride}, "
                         f"dilation {dilation}")
    if weight is not None:
        cout = weight.shape[0]
        if weight.shape != (cout, cin, 3, 3) or weight.dtype != x.dtype:
            raise ValueError(
                f"weight must be (Cout, {cin}, 3, 3) in {x.dtype}, got "
                f"{tuple(weight.shape)} {weight.dtype}"
            )
    ho, wo = plain.out_size(h, w, stride)
    named = [("offset", offset, 18, torch.float32)]
    if mask is not None:
        named.append(("mask", mask, 9, torch.float32))
    if g is not None:
        named.append(("g", g, cout, x.dtype))
    for name, t, c, dtype in named:
        if tuple(t.shape) != (n, c, ho, wo) or t.dtype != dtype:
            raise ValueError(
                f"{name} must be ({n}, {c}, {ho}, {wo}) {dtype}, got {tuple(t.shape)} {t.dtype}"
            )
    for t in (offset, mask, weight, g):
        if t is not None and t.device != x.device:
            raise ValueError(f"all inputs must be on {x.device}, got one on {t.device}")
        if t is not None and not t.is_contiguous():
            raise ValueError("x, offset, mask, weight and g must be contiguous")
    if not x.is_contiguous():
        raise ValueError("x, offset, mask, weight and g must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no DCN kernel for device {x.device}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(lib: str, fn: str, x: torch.Tensor, *args) -> None:
    """Call a kernel's C entry point on x's device and current stream."""
    cuda_lib.launch(_library(lib), fn, x.device, *args)


def fwd_plan(n: int, cin: int, h: int, w: int, cout: int, sms: int, itemsize: int = 2,
             stride: int = 1) -> Dict[str, int]:
    """How K1 cuts its work on an H × W input at ``stride``. A block owns an
    8 x 8 tile of output pixels of one image (``tiles`` per image, over
    Ho × Wo) and a Cout tile of ``bm`` = 64, 128 or 256 rows (the smallest
    that holds Cout; ``cout_tiles`` of them). The Cin axis goes in ``chunks``
    of 32 bytes of channels (16 bf16 or 8 f32 for ``itemsize`` 2 or 4), and
    the chunks in ``splits`` spans of ``span``, split s owning chunks
    [s·span, min((s + 1)·span, chunks)). Where the n·tiles·cout_tiles blocks
    are fewer than ``FWD_BLOCKS_PER_SM · sms`` (two waves), the span is cut so
    that ``blocks`` = that product × splits reaches it, or to one chunk per
    split where there are too few chunks, with the [splits, N, Cout, Ho·Wo]
    f32 partial buffer (``partial_bytes``) at most ``FWD_PARTIAL_CAP``.
    ``scratch_bytes``: x channels-last with Cin padded to ``cin_pad``, the
    weight as its W tiles (rows padded by 16 bytes, as in shared memory), and
    the partials, each 256-byte aligned."""
    ck = FWD_CHUNK_BYTES // itemsize
    ho, wo = plain.out_size(h, w, stride)
    bm = 64 if cout <= 64 else 128 if cout <= 128 else 256
    tiles = -(-ho // FWD_TILE) * -(-wo // FWD_TILE)
    cout_tiles = -(-cout // bm)
    chunks = -(-cin // ck)
    base = n * tiles * cout_tiles
    aim = FWD_BLOCKS_PER_SM * sms
    per_split = n * cout * ho * wo * 4
    span = chunks
    if base < aim:
        most = max(1, FWD_PARTIAL_CAP // per_split)
        span = max(chunks // -(-aim // base), -(-chunks // most), 1)
    splits = -(-chunks // span)
    cin_pad = chunks * ck
    partial = splits * per_split if splits > 1 else 0
    aligned = lambda b: -(-b // 256) * 256
    ldk = 9 * ck + 16 // itemsize  # a W tile row in shared memory, padded by 16 bytes
    scratch = aligned(n * h * w * cin_pad * itemsize) + aligned(cout_tiles * bm * chunks * ldk * itemsize) + partial
    return dict(bm=bm, tiles=tiles, cout_tiles=cout_tiles, chunks=chunks, cin_pad=cin_pad, span=span,
                splits=splits, blocks=base * splits, partial_bytes=partial, scratch_bytes=scratch)


def modulated_deform_conv(
    x: torch.Tensor,  # (N, Cin, H, W) f32 or bf16
    offset: torch.Tensor,  # (N, 18, Ho, Wo) f32, (dy, dx) per tap, taps row-major
    mask: Optional[torch.Tensor],  # (N, 9, Ho, Wo) f32, already sigmoided; None: unmodulated
    weight: torch.Tensor,  # (Cout, Cin, 3, 3), x's dtype
    bias: Optional[torch.Tensor] = None,  # (Cout,)
    post_scale: Optional[torch.Tensor] = None,  # (Cout,): fused epilogue
    post_shift: Optional[torch.Tensor] = None,  # (Cout,)
    post_relu: bool = False,
    stride: int = 1,
    dilation: int = 1,
) -> torch.Tensor:
    """K1: the 3x3 deformable conv forward at ``stride`` and ``dilation``
    (padding = dilation), NCHW.

    Returns ``relu?((conv + bias) * post_scale + post_shift)`` as
    (N, Cout, Ho, Wo) in x's dtype; products accumulate in f32 and the
    epilogue runs in f32 before the one rounding to x's dtype.

    The call goes through the custom op ``torch.ops.d2ct.dcn_fwd``
    (``dcn_fwd_op``), so that ``torch.export`` records it as one node: its
    CUDA implementation launches the kernel (``modulated_deform_conv.launches``
    counts the launches, from eager code and exported programs alike), its
    CPU implementation is the plain version. The op has no gradient: a call
    that needs one raises on the card and runs the plain version, outside
    the op, on the CPU. Training goes through ``modulated_deform_conv_ad``."""
    _check(x, offset, mask, weight, stride=stride, dilation=dilation)
    if (post_scale is None) != (post_shift is None):
        raise ValueError("post_scale and post_shift go together")
    cout = weight.shape[0]
    for t in (bias, post_scale, post_shift):
        if t is not None and (tuple(t.shape) != (cout,) or t.device != x.device):
            raise ValueError(f"bias/post_scale/post_shift must be ({cout},) on {x.device}")
    tensors = (x, offset, mask, weight, bias, post_scale, post_shift)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        if x.device.type == "cpu":
            return modulated_deform_conv_plain(
                x, offset, mask, weight, bias, post_scale, post_shift, post_relu, stride, dilation
            )
        raise RuntimeError(
            "the kernel's output has no gradient; train through modulated_deform_conv_ad"
        )
    return dcn_fwd_op(x, offset, mask, weight, bias, post_scale, post_shift, post_relu, stride, dilation)


@torch.library.custom_op("d2ct::dcn_fwd", mutates_args=(), device_types="cpu")
def dcn_fwd_op(x: torch.Tensor, offset: torch.Tensor, mask: Optional[torch.Tensor], weight: torch.Tensor,
               bias: Optional[torch.Tensor], post_scale: Optional[torch.Tensor],
               post_shift: Optional[torch.Tensor], post_relu: bool, stride: int, dilation: int) -> torch.Tensor:
    """K1 as a custom op, for inputs ``modulated_deform_conv`` checked. On
    the CPU: the plain version."""
    return modulated_deform_conv_plain(
        x, offset, mask, weight, bias, post_scale, post_shift, post_relu, stride, dilation
    )


@dcn_fwd_op.register_kernel("cuda")
def _dcn_fwd_cuda(x, offset, mask, weight, bias, post_scale, post_shift, post_relu, stride, dilation):
    """On the card: the hand-written kernel of ``csrc/dcn_fwd.cu``."""
    n, cin, h, w = x.shape
    cout = weight.shape[0]
    # fold the bias into the epilogue: (acc + b) * s + t = acc * s + (t + s * b)
    scale = shift = None
    if post_scale is not None:
        scale = post_scale.to(torch.float32).contiguous()
        shift = post_shift.to(torch.float32)
        if bias is not None:
            shift = shift + scale * bias.to(torch.float32)
        shift = shift.contiguous()
    elif bias is not None:
        shift = bias.to(torch.float32).contiguous()
    bm, span, splits, scratch_bytes = _fwd_launch_plan(n, cin, h, w, cout, _sms(x.device), x.element_size(),
                                                       stride)
    scratch = torch.empty(scratch_bytes, dtype=torch.uint8, device=x.device)
    out = torch.empty((n, cout, *offset.shape[2:]), dtype=x.dtype, device=x.device)
    _launch(
        "fwd", "dcn_fwd", x, x.data_ptr(), offset.data_ptr(), _ptr(mask), weight.data_ptr(),
        _ptr(scale), _ptr(shift), out.data_ptr(), scratch.data_ptr(), n, cin, h, w, cout, stride, dilation,
        int(post_relu), _is_bf16(x), bm, span, splits, scratch_bytes,
    )
    modulated_deform_conv.launches += 1
    return out


@dcn_fwd_op.register_fake
def _dcn_fwd_fake(x, offset, mask, weight, bias, post_scale, post_shift, post_relu, stride, dilation):
    return x.new_empty((x.shape[0], weight.shape[0], offset.shape[2], offset.shape[3]))


def dcn_fwd_flops(x_shape, offset_shape, mask_shape, weight_shape, *args, out_shape=None, **kwargs) -> int:
    """K1's operations for ``torch.utils.flop_counter``: the contraction,
    2·N·Cout·Cin·9·Ho·Wo, and the bilinear sampling of each (image, channel,
    tap, output pixel), 8 apiece (four corner products, three sums and the
    mask's product; the corner weights, shared by every channel, are left
    out), the count ``chip_smoke.py::dcn_bound`` takes for the gather."""
    n, cin = x_shape[0], x_shape[1]
    cout = weight_shape[0]
    samples = n * cin * 9 * offset_shape[2] * offset_shape[3]
    return 2 * samples * cout + 8 * samples


torch.utils.flop_counter.register_flop_formula(torch.ops.d2ct.dcn_fwd)(dcn_fwd_flops)


def _dims(x, g):
    n, cin, h, w = x.shape
    return n, cin, h, w, g.shape[1]


def _is_bf16(x) -> int:
    return int(x.dtype == torch.bfloat16)


def bwd_plan(n: int, cin: int, h: int, w: int, cout: int, sms: int) -> Dict[str, int]:
    """How K3-K5 cut their work on an output grid of H × W (Ho × Wo where
    the DCN strides): the ``tiles`` pixel tiles (``n`` images of
    ceil(H·W / 64) tiles each; a tile never crosses an image) go in
    ``splits`` spans of ``span`` consecutive tiles, split s owning tiles
    [s·span, min((s + 1)·span, tiles)). The grid is chunks × cout_tiles ×
    splits blocks; the span is picked so that it is about
    ``BWD_BLOCKS_PER_SM · sms`` blocks (two waves of two resident blocks per
    SM), or one split per tile where there are fewer tiles. Every split owns
    at least one tile. dW's partial buffer holds splits × Cout × 9·Cin f32."""
    tiles = n * -(-(h * w) // BWD_TILE_PIXELS)
    chunks = -(-cin // BWD_CHUNK_CHANNELS)
    cout_tiles = -(-cout // BWD_COUT_TILE)
    want = max(1, -(-BWD_BLOCKS_PER_SM * sms // (chunks * cout_tiles)))
    span = -(-tiles // min(want, tiles))
    splits = -(-tiles // span)
    return dict(tiles=tiles, chunks=chunks, cout_tiles=cout_tiles, span=span, splits=splits)


@functools.lru_cache(maxsize=1024)
def _fwd_launch_plan(n, cin, h, w, cout, sms, itemsize, stride):
    """(bm, span, splits, scratch_bytes) of ``fwd_plan``, once per shape."""
    plan = fwd_plan(n, cin, h, w, cout, sms, itemsize, stride)
    return plan["bm"], plan["span"], plan["splits"], plan["scratch_bytes"]


_SMS: Dict[int, int] = {}


def _sms(device) -> int:
    if device.index not in _SMS:
        _SMS[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device.index]


def _plan(x, g):
    """K3-K5's plan over g's (the output's) pixel grid."""
    return bwd_plan(x.shape[0], x.shape[1], g.shape[2], g.shape[3], g.shape[1], _sms(x.device))


def kernel_resources() -> Dict[str, Dict[str, dict]]:
    """{kernel: {dtype: {"smem_bytes", "blocks_per_sm", "warps_per_sm"}}} of
    K1's main kernel at each Cout tile (``dcn_fwd_bm64`` ...) and the four
    backward kernels on the current card (CUDA's occupancy calculator with
    the launch's dynamic shared memory)."""
    queries = [(f"dcn_fwd_bm{bm}", "fwd", "dcn_fwd_info", bm) for bm in (64, 128, 256)]
    queries += [(name, "bwd", "dcn_bwd_info", which) for which, name in
                enumerate(("dcn_bwd_dx", "dcn_bwd_dq", "dcn_bwd_dw", "dcn_bwd_dqdw"))]
    out = {}
    for name, lib, fn, which in queries:
        for dtype in ("float32", "bfloat16"):
            res = (ctypes.c_int * 3)()
            err = getattr(_library(lib), fn)(which, int(dtype == "bfloat16"), res)
            if err != 0:
                raise RuntimeError(f"{fn}({name}) failed with CUDA error {err}")
            out.setdefault(name, {})[dtype] = dict(
                smem_bytes=res[0], blocks_per_sm=res[1], warps_per_sm=res[1] * res[2] // 32)
    return out


def dcn_bwd_dx(x, offset, mask, weight, g, stride: int = 1, dilation: int = 1) -> torch.Tensor:
    """K2: dX (N, Cin, H, W) in x's dtype, from the output cotangent g
    (N, Cout, Ho, Wo, x's dtype)."""
    _check(x, offset, mask, weight, g, stride=stride, dilation=dilation)
    if x.device.type == "cpu":
        return plain.dcn_bwd_dx(x, offset, mask, weight, g, stride, dilation)
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    _launch("bwd", "dcn_bwd_dx", x, x.data_ptr(), offset.data_ptr(), _ptr(mask),
            weight.data_ptr(), g.data_ptr(), dx.data_ptr(), *_dims(x, g), stride, dilation, _is_bf16(x))
    dcn_bwd_dx.launches += 1
    return dx.to(x.dtype)


def dcn_bwd_dq(x, offset, mask, weight, g, stride: int = 1, dilation: int = 1):
    """K3: (d offset (N, 18, Ho, Wo), d mask (N, 9, Ho, Wo)), f32; d mask
    is None without a mask."""
    _check(x, offset, mask, weight, g, stride=stride, dilation=dilation)
    if x.device.type == "cpu":
        return plain.dcn_bwd_dq(x, offset, mask, weight, g, stride, dilation)
    plan = _plan(x, g)
    doffset = torch.zeros_like(offset)
    dmask = None if mask is None else torch.zeros_like(mask)
    _launch("bwd", "dcn_bwd_dq", x, x.data_ptr(), offset.data_ptr(), _ptr(mask),
            weight.data_ptr(), g.data_ptr(), doffset.data_ptr(), _ptr(dmask), *_dims(x, g),
            stride, dilation, plan["span"], plan["splits"], _is_bf16(x))
    dcn_bwd_dq.launches += 1
    return doffset, dmask


def dcn_bwd_dw(x, offset, mask, g, stride: int = 1, dilation: int = 1) -> torch.Tensor:
    """K4: dW (Cout, Cin, 3, 3) in x's dtype, summed over the batch."""
    _check(x, offset, mask, g=g, cout=g.shape[1], stride=stride, dilation=dilation)
    if x.device.type == "cpu":
        return plain.dcn_bwd_dw(x, offset, mask, g, stride, dilation)
    n, cin, h, w, cout = _dims(x, g)
    plan = _plan(x, g)
    partial = torch.empty((plan["splits"], cout, cin * 9), dtype=torch.float32, device=x.device)
    dw = torch.empty((cout, cin, 3, 3), dtype=x.dtype, device=x.device)
    _launch("bwd", "dcn_bwd_dw", x, x.data_ptr(), offset.data_ptr(), _ptr(mask),
            g.data_ptr(), dw.data_ptr(), partial.data_ptr(), n, cin, h, w, cout, stride, dilation,
            plan["span"], plan["splits"], _is_bf16(x))
    dcn_bwd_dw.launches += 1
    return dw


def dcn_bwd_dqdw(x, offset, mask, weight, g, stride: int = 1, dilation: int = 1):
    """K5: K3 and K4 on one gather, (d offset, d mask or None, dW)."""
    _check(x, offset, mask, weight, g, stride=stride, dilation=dilation)
    if x.device.type == "cpu":
        return plain.dcn_bwd_dqdw(x, offset, mask, weight, g, stride, dilation)
    n, cin, h, w, cout = _dims(x, g)
    plan = _plan(x, g)
    doffset = torch.zeros_like(offset)
    dmask = None if mask is None else torch.zeros_like(mask)
    partial = torch.empty((plan["splits"], cout, cin * 9), dtype=torch.float32, device=x.device)
    dw = torch.empty(weight.shape, dtype=x.dtype, device=x.device)
    _launch("bwd", "dcn_bwd_dqdw", x, x.data_ptr(), offset.data_ptr(), _ptr(mask),
            weight.data_ptr(), g.data_ptr(), doffset.data_ptr(), _ptr(dmask),
            dw.data_ptr(), partial.data_ptr(), n, cin, h, w, cout, stride, dilation,
            plan["span"], plan["splits"], _is_bf16(x))
    dcn_bwd_dqdw.launches += 1
    return doffset, dmask, dw


for _fn in (modulated_deform_conv, dcn_bwd_dx, dcn_bwd_dq, dcn_bwd_dw, dcn_bwd_dqdw):
    _fn.launches = 0


class _DeformConv(torch.autograd.Function):
    """The custom VJP ``_dcn_ad`` (``pallas_dcn.py:1101-1118``): K1 forward
    without epilogue; the backward picks its kernels from what needs a
    gradient. K2 runs whenever x does; K5 when offset or mask and the weight
    both do; K3 alone when the weight needs none; K4 alone when offset and
    mask need none. Each gradient comes back in its input's dtype; a missing
    mask (the unmodulated DCN) gets none."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, stride, dilation):
        ctx.save_for_backward(x, offset, mask, weight)
        ctx.geometry = (stride, dilation)
        # the types are the caller's: an enclosing autocast must not recast the
        # plain version's f32 products (the backward runs outside autocast)
        with torch.autocast(x.device.type, enabled=False):
            return modulated_deform_conv(x, offset, mask, weight, stride=stride, dilation=dilation)

    @staticmethod
    def backward(ctx, g):
        x, offset, mask, weight = ctx.saved_tensors
        geo = ctx.geometry
        g = g.to(x.dtype).contiguous()
        need_x, need_off, need_mask, need_w = ctx.needs_input_grad[:4]
        dx = doffset = dmask = dw = None
        if need_x:
            dx = dcn_bwd_dx(x, offset, mask, weight, g, *geo)
        if (need_off or need_mask) and need_w:
            doffset, dmask, dw = dcn_bwd_dqdw(x, offset, mask, weight, g, *geo)
        elif need_off or need_mask:
            doffset, dmask = dcn_bwd_dq(x, offset, mask, weight, g, *geo)
        elif need_w:
            dw = dcn_bwd_dw(x, offset, mask, g, *geo)
        return dx, doffset if need_off else None, dmask if need_mask else None, dw, None, None


def modulated_deform_conv_ad(
    x: torch.Tensor,  # (N, Cin, H, W) f32 or bf16
    offset: torch.Tensor,  # (N, 18, Ho, Wo) f32
    mask: Optional[torch.Tensor],  # (N, 9, Ho, Wo) f32, already sigmoided; None: unmodulated
    weight: torch.Tensor,  # (Cout, Cin, 3, 3), x's dtype
    bias: Optional[torch.Tensor] = None,  # (Cout,), any float dtype
    stride: int = 1,
    dilation: int = 1,
) -> torch.Tensor:
    """The differentiable DCN (``dcn_conv_pallas_ad``): K1 forward, K2-K5
    backward on a CUDA tensor, their plain versions on a CPU tensor. The bias
    is added outside the Function, so autograd gives its gradient, as JAX
    does (``pallas_dcn.py:1141-1142``)."""
    out = _DeformConv.apply(x, offset, mask, weight, stride, dilation)
    if bias is not None:
        out = out + bias.to(out.dtype).view(1, -1, 1, 1)
    return out
