"""Modulated deformable 3x3 conv (DCNv2): the Hopper kernels' wrappers and the
autograd Function that trains through them.

Replaces the TPU kernels of ``detectron2_centernet_tpu/ops/pallas_dcn.py``:
the forward ``_kernel`` (entry ``dcn_conv_pallas``), which every
``DeformConvV2`` of DLAUp/IDAUp runs, and the backward ``_bwd_dx_kernel``,
``_bwd_dq_kernel``, ``_bwd_dw_kernel`` and ``_bwd_dqdw_kernel`` behind the
custom VJP ``_dcn_ad``.

* A CUDA tensor launches a hand-written kernel (CUDA C++ for sm_90a:
  ``csrc/dcn_fwd.cu`` for the forward, ``csrc/dcn_bwd.cu`` for the four
  backward kernels; see the note at the top of each for what bounds it and
  what the design does about it), or raises. There is no fallback.
* A CPU tensor runs the plain PyTorch version of the same function
  (``ops/deform_conv.py``).

Every wrapper counts its kernel launches in ``<wrapper>.launches``.

The kernels compute exact DCNv2: every sample is bilinear with zero padding,
wherever its offset points. The TPU kernels' "drop-far" rule (samples beyond
|dy| > 3 read 0) was a VMEM limit of that chip and has no counterpart here.

The libraries are built at first use with ``nvcc`` into ``_build/`` beside
this package (a plain C interface loaded with ``ctypes``), one process per
source, all started together, and cached by the hash of source and flags.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from . import deform_conv as plain
from .deform_conv import modulated_deform_conv as modulated_deform_conv_plain

__all__ = [
    "build_libraries",
    "bwd_plan",
    "dcn_bwd_dq",
    "dcn_bwd_dqdw",
    "dcn_bwd_dw",
    "dcn_bwd_dx",
    "kernel_resources",
    "modulated_deform_conv",
    "modulated_deform_conv_ad",
    "modulated_deform_conv_plain",
]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"fwd": CSRC / "dcn_fwd.cu", "bwd": CSRC / "dcn_bwd.cu"}
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_DTYPES = (torch.float32, torch.bfloat16)
_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures: pointers, then ints, then the stream
_SIGNATURES = {
    "fwd": {"dcn_fwd": [_P] * 7 + [_I] * 7 + [_P]},
    "bwd": {
        "dcn_bwd_dx": [_P] * 6 + [_I] * 6 + [_P],
        "dcn_bwd_dq": [_P] * 7 + [_I] * 8 + [_P],
        "dcn_bwd_dw": [_P] * 6 + [_I] * 8 + [_P],
        "dcn_bwd_dqdw": [_P] * 9 + [_I] * 8 + [_P],
        "dcn_bwd_info": [_I, _I, _P],  # which kernel, is_bf16, int[3] out
    },
}
# Tiling of K3-K5 (csrc/dcn_bwd.cu): pixel tiles, channel chunks, Cout tiles
BWD_TILE_PIXELS, BWD_CHUNK_CHANNELS, BWD_COUT_TILE = 64, 16, 64
# blocks of K3-K5 aimed at per SM: two resident blocks, two waves
BWD_BLOCKS_PER_SM = 4


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _library_path(name: str) -> Path:
    source = SOURCES[name]
    tag = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}_{tag}.so"


def build_libraries() -> Dict[str, dict]:
    """Compile every source in ``SOURCES`` that has no library built from the
    same source and flags, one ``nvcc`` each, all at once. Returns
    {name: {"path", "seconds", "log"}}: ``log`` is nvcc's ``-Xptxas -v``
    report (registers, shared memory, spills), empty for a cached library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, running = {}, {}
    t0 = time.perf_counter()
    for name, source in SOURCES.items():
        path = _library_path(name)
        if path.exists():
            out[name] = {"path": path, "seconds": 0.0, "log": ""}
            continue
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        running[name] = (proc, tmp, path)
    failures = []
    for name, (proc, tmp, path) in running.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {SOURCES[name].name}:\n{stdout}{stderr}")
            continue
        os.replace(tmp, path)  # atomic: a concurrent build never loads a partial file
        out[name] = {"path": path, "seconds": time.perf_counter() - t0, "log": stderr}
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


_LIBS: Dict[str, ctypes.CDLL] = {}


def _library(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        path = _library_path(name)
        if not path.exists():
            path = build_libraries()[name]["path"]
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return _LIBS[name]


def _check(x, offset, mask, weight=None, g=None, cout=None) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (N, Cin, H, W), got {tuple(x.shape)}")
    n, cin, h, w = x.shape
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if weight is not None:
        cout = weight.shape[0]
        if weight.shape != (cout, cin, 3, 3) or weight.dtype != x.dtype:
            raise ValueError(
                f"weight must be (Cout, {cin}, 3, 3) in {x.dtype}, got "
                f"{tuple(weight.shape)} {weight.dtype}"
            )
    named = [("offset", offset, 18, torch.float32), ("mask", mask, 9, torch.float32)]
    if g is not None:
        named.append(("g", g, cout, x.dtype))
    for name, t, c, dtype in named:
        if tuple(t.shape) != (n, c, h, w) or t.dtype != dtype:
            raise ValueError(
                f"{name} must be ({n}, {c}, {h}, {w}) {dtype}, got {tuple(t.shape)} {t.dtype}"
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


def _launch(lib: str, fn: str, x: torch.Tensor, *args) -> None:
    """Call a kernel's C entry point on x's device and current stream."""
    with torch.cuda.device(x.device):
        err = getattr(_library(lib), fn)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed with CUDA error {err}")


def modulated_deform_conv(
    x: torch.Tensor,  # (N, Cin, H, W) f32 or bf16
    offset: torch.Tensor,  # (N, 18, H, W) f32, (dy, dx) per tap, taps row-major
    mask: torch.Tensor,  # (N, 9, H, W) f32, already sigmoided
    weight: torch.Tensor,  # (Cout, Cin, 3, 3), x's dtype
    bias: Optional[torch.Tensor] = None,  # (Cout,)
    post_scale: Optional[torch.Tensor] = None,  # (Cout,): fused epilogue
    post_shift: Optional[torch.Tensor] = None,  # (Cout,)
    post_relu: bool = False,
) -> torch.Tensor:
    """K1: the 3x3 stride-1 SAME modulated deformable conv forward, NCHW.

    Returns ``relu?((conv + bias) * post_scale + post_shift)`` as
    (N, Cout, H, W) in x's dtype; products accumulate in f32 and the
    epilogue runs in f32 before the one rounding to x's dtype.

    CUDA tensors launch the kernel (``modulated_deform_conv.launches`` counts
    the launches); CPU tensors take the plain version. This is the forward
    alone: training goes through ``modulated_deform_conv_ad``."""
    _check(x, offset, mask, weight)
    if (post_scale is None) != (post_shift is None):
        raise ValueError("post_scale and post_shift go together")
    cout = weight.shape[0]
    for t in (bias, post_scale, post_shift):
        if t is not None and (tuple(t.shape) != (cout,) or t.device != x.device):
            raise ValueError(f"bias/post_scale/post_shift must be ({cout},) on {x.device}")
    if x.device.type == "cpu":
        return modulated_deform_conv_plain(
            x, offset, mask, weight, bias, post_scale, post_shift, post_relu
        )
    tensors = (x, offset, mask, weight, bias, post_scale, post_shift)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            "the kernel's output has no gradient; train through modulated_deform_conv_ad"
        )
    n, cin, h, w = x.shape
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
    out = torch.empty((n, cout, h, w), dtype=x.dtype, device=x.device)
    _launch(
        "fwd", "dcn_fwd", x, x.data_ptr(), offset.data_ptr(), mask.data_ptr(), weight.data_ptr(),
        None if scale is None else scale.data_ptr(), None if shift is None else shift.data_ptr(),
        out.data_ptr(), n, cin, h, w, cout, int(post_relu), int(x.dtype == torch.bfloat16),
    )
    modulated_deform_conv.launches += 1
    return out


def _dims(x, g):
    n, cin, h, w = x.shape
    return n, cin, h, w, g.shape[1]


def _is_bf16(x) -> int:
    return int(x.dtype == torch.bfloat16)


def bwd_plan(n: int, cin: int, h: int, w: int, cout: int, sms: int) -> Dict[str, int]:
    """How K3-K5 cut their work: the ``tiles`` pixel tiles (``n`` images of
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


def _plan(x, g):
    n, cin, h, w, cout = _dims(x, g)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return bwd_plan(n, cin, h, w, cout, sms)


def kernel_resources() -> Dict[str, Dict[str, dict]]:
    """{kernel: {dtype: {"smem_bytes", "blocks_per_sm", "warps_per_sm"}}} of
    the four backward kernels on the current card (CUDA's occupancy
    calculator with the launch's dynamic shared memory)."""
    out = {}
    for which, name in enumerate(("dcn_bwd_dx", "dcn_bwd_dq", "dcn_bwd_dw", "dcn_bwd_dqdw")):
        for dtype in ("float32", "bfloat16"):
            res = (ctypes.c_int * 3)()
            err = _library("bwd").dcn_bwd_info(which, int(dtype == "bfloat16"), res)
            if err != 0:
                raise RuntimeError(f"dcn_bwd_info({name}) failed with CUDA error {err}")
            out.setdefault(name, {})[dtype] = dict(
                smem_bytes=res[0], blocks_per_sm=res[1], warps_per_sm=res[1] * res[2] // 32)
    return out


def dcn_bwd_dx(x, offset, mask, weight, g) -> torch.Tensor:
    """K2: dX (N, Cin, H, W) in x's dtype, from the output cotangent g
    (N, Cout, H, W, x's dtype)."""
    _check(x, offset, mask, weight, g)
    if x.device.type == "cpu":
        return plain.dcn_bwd_dx(x, offset, mask, weight, g)
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    _launch("bwd", "dcn_bwd_dx", x, x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
            weight.data_ptr(), g.data_ptr(), dx.data_ptr(), *_dims(x, g), _is_bf16(x))
    dcn_bwd_dx.launches += 1
    return dx.to(x.dtype)


def dcn_bwd_dq(x, offset, mask, weight, g):
    """K3: (d offset (N, 18, H, W), d mask (N, 9, H, W)), f32."""
    _check(x, offset, mask, weight, g)
    if x.device.type == "cpu":
        return plain.dcn_bwd_dq(x, offset, mask, weight, g)
    plan = _plan(x, g)
    doffset = torch.zeros_like(offset)
    dmask = torch.zeros_like(mask)
    _launch("bwd", "dcn_bwd_dq", x, x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
            weight.data_ptr(), g.data_ptr(), doffset.data_ptr(), dmask.data_ptr(), *_dims(x, g),
            plan["span"], plan["splits"], _is_bf16(x))
    dcn_bwd_dq.launches += 1
    return doffset, dmask


def dcn_bwd_dw(x, offset, mask, g) -> torch.Tensor:
    """K4: dW (Cout, Cin, 3, 3) in x's dtype, summed over the batch."""
    _check(x, offset, mask, g=g, cout=g.shape[1])
    if x.device.type == "cpu":
        return plain.dcn_bwd_dw(x, offset, mask, g)
    n, cin, h, w, cout = _dims(x, g)
    plan = _plan(x, g)
    partial = torch.empty((plan["splits"], cout, cin * 9), dtype=torch.float32, device=x.device)
    dw = torch.empty((cout, cin, 3, 3), dtype=x.dtype, device=x.device)
    _launch("bwd", "dcn_bwd_dw", x, x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
            g.data_ptr(), dw.data_ptr(), partial.data_ptr(), n, cin, h, w, cout,
            plan["span"], plan["splits"], _is_bf16(x))
    dcn_bwd_dw.launches += 1
    return dw


def dcn_bwd_dqdw(x, offset, mask, weight, g):
    """K5: K3 and K4 on one gather, (d offset, d mask, dW)."""
    _check(x, offset, mask, weight, g)
    if x.device.type == "cpu":
        return plain.dcn_bwd_dqdw(x, offset, mask, weight, g)
    n, cin, h, w, cout = _dims(x, g)
    plan = _plan(x, g)
    doffset = torch.zeros_like(offset)
    dmask = torch.zeros_like(mask)
    partial = torch.empty((plan["splits"], cout, cin * 9), dtype=torch.float32, device=x.device)
    dw = torch.empty(weight.shape, dtype=x.dtype, device=x.device)
    _launch("bwd", "dcn_bwd_dqdw", x, x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
            weight.data_ptr(), g.data_ptr(), doffset.data_ptr(), dmask.data_ptr(),
            dw.data_ptr(), partial.data_ptr(), n, cin, h, w, cout,
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
    mask need none. Each gradient comes back in its input's dtype."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight):
        ctx.save_for_backward(x, offset, mask, weight)
        # the types are the caller's: an enclosing autocast must not recast the
        # plain version's f32 products (the backward runs outside autocast)
        with torch.autocast(x.device.type, enabled=False):
            return modulated_deform_conv(x, offset, mask, weight)

    @staticmethod
    def backward(ctx, g):
        x, offset, mask, weight = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        need_x, need_off, need_mask, need_w = ctx.needs_input_grad
        dx = doffset = dmask = dw = None
        if need_x:
            dx = dcn_bwd_dx(x, offset, mask, weight, g)
        if (need_off or need_mask) and need_w:
            doffset, dmask, dw = dcn_bwd_dqdw(x, offset, mask, weight, g)
        elif need_off or need_mask:
            doffset, dmask = dcn_bwd_dq(x, offset, mask, weight, g)
        elif need_w:
            dw = dcn_bwd_dw(x, offset, mask, g)
        return (
            dx,
            doffset if need_off else None,
            dmask if need_mask else None,
            dw,
        )


def modulated_deform_conv_ad(
    x: torch.Tensor,  # (N, Cin, H, W) f32 or bf16
    offset: torch.Tensor,  # (N, 18, H, W) f32
    mask: torch.Tensor,  # (N, 9, H, W) f32, already sigmoided
    weight: torch.Tensor,  # (Cout, Cin, 3, 3), x's dtype
    bias: Optional[torch.Tensor] = None,  # (Cout,), any float dtype
) -> torch.Tensor:
    """The differentiable DCN (``dcn_conv_pallas_ad``): K1 forward, K2-K5
    backward on a CUDA tensor, their plain versions on a CPU tensor. The bias
    is added outside the Function, so autograd gives its gradient, as JAX
    does (``pallas_dcn.py:1141-1142``)."""
    out = _DeformConv.apply(x, offset, mask, weight)
    if bias is not None:
        out = out + bias.to(out.dtype).view(1, -1, 1, 1)
    return out
