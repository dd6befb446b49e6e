"""Modulated deformable 3x3 conv (DCNv2) forward: the Hopper kernel's wrapper.

Replaces the TPU kernel ``detectron2_centernet_tpu/ops/pallas_dcn.py::_kernel``
(entry ``dcn_conv_pallas``), which every ``DeformConvV2`` of DLAUp/IDAUp runs
at inference with the fused BN + bias + ReLU epilogue.

* A CUDA tensor launches the hand-written kernel in ``csrc/dcn_fwd.cu``
  (CUDA C++ for sm_90a, an implicit GEMM whose column tile is gathered in
  shared memory; see the note at the top of that file for what bounds it
  and what the design does about it), or raises. There is no fallback.
* A CPU tensor runs the plain PyTorch version
  (``ops/deform_conv.py::modulated_deform_conv``), the same function.

The kernel computes exact DCNv2: every sample is bilinear with zero padding,
wherever its offset points. The TPU kernel's "drop-far" rule (samples beyond
|dy| > 3 read 0) was a VMEM limit of that chip and has no counterpart here.

The library is built at first use with ``nvcc`` into ``_build/`` beside this
package (a plain C interface loaded with ``ctypes``) and cached by the hash of
its source and flags.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

from .deform_conv import modulated_deform_conv as modulated_deform_conv_plain

__all__ = [
    "build_library",
    "modulated_deform_conv",
    "modulated_deform_conv_plain",
]

SOURCE = Path(__file__).resolve().parent / "csrc" / "dcn_fwd.cu"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_DTYPES = (torch.float32, torch.bfloat16)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def build_library() -> dict:
    """Compile ``csrc/dcn_fwd.cu`` unless a library built from the same source
    and flags exists. Returns {"path", "seconds", "log"}: ``log`` is nvcc's
    ``-Xptxas -v`` report (registers, shared memory, spills), empty when the
    library came from the cache."""
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    path = BUILD_DIR / f"libdcn_fwd_{tag}.so"
    if path.exists():
        return {"path": path, "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True, check=False,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: concurrent builders never load a partial file
    return {"path": path, "seconds": seconds, "log": proc.stderr}


_LIB: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library()["path"]))
        lib.dcn_fwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.dcn_fwd.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(x, offset, mask, weight, bias, post_scale, post_shift) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (N, Cin, H, W), got {tuple(x.shape)}")
    n, cin, h, w = x.shape
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if weight.shape != (weight.shape[0], cin, 3, 3) or weight.dtype != x.dtype:
        raise ValueError(
            f"weight must be (Cout, {cin}, 3, 3) in {x.dtype}, got "
            f"{tuple(weight.shape)} {weight.dtype}"
        )
    cout = weight.shape[0]
    for name, t, c in (("offset", offset, 18), ("mask", mask, 9)):
        if tuple(t.shape) != (n, c, h, w) or t.dtype != torch.float32:
            raise ValueError(
                f"{name} must be ({n}, {c}, {h}, {w}) float32, got {tuple(t.shape)} {t.dtype}"
            )
    if (post_scale is None) != (post_shift is None):
        raise ValueError("post_scale and post_shift go together")
    vectors = [t for t in (bias, post_scale, post_shift) if t is not None]
    for t in vectors:
        if tuple(t.shape) != (cout,):
            raise ValueError(f"bias/post_scale/post_shift must be ({cout},), got {tuple(t.shape)}")
    for t in (offset, mask, weight, *vectors):
        if t.device != x.device:
            raise ValueError(f"all inputs must be on {x.device}, got one on {t.device}")
    for t in (x, offset, mask, weight):
        if not t.is_contiguous():
            raise ValueError("x, offset, mask and weight must be contiguous")


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
    """3x3 stride-1 SAME modulated deformable conv, NCHW.

    Returns ``relu?((conv + bias) * post_scale + post_shift)`` as
    (N, Cout, H, W) in x's dtype; products accumulate in f32 and the
    epilogue runs in f32 before the one rounding to x's dtype.

    CUDA tensors launch the kernel (``modulated_deform_conv.launches`` counts
    the launches); CPU tensors take the plain version. The CUDA path is
    inference only: its backward kernels are not ported yet, so it raises
    when autograd would need one."""
    _check(x, offset, mask, weight, bias, post_scale, post_shift)
    if x.device.type == "cpu":
        return modulated_deform_conv_plain(
            x, offset, mask, weight, bias, post_scale, post_shift, post_relu
        )
    if x.device.type != "cuda":
        raise ValueError(f"no DCN kernel for device {x.device}")
    tensors = (x, offset, mask, weight, bias, post_scale, post_shift)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the CUDA DCN has no backward kernel yet; run it under torch.no_grad()"
        )
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
    out = torch.empty((n, cout, h, w), dtype=x.dtype, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.dcn_fwd(
            x.data_ptr(), offset.data_ptr(), mask.data_ptr(), weight.data_ptr(),
            None if scale is None else scale.data_ptr(),
            None if shift is None else shift.data_ptr(),
            out.data_ptr(), n, cin, h, w, cout, int(post_relu),
            int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"dcn_fwd kernel launch failed with CUDA error {err}")
    modulated_deform_conv.launches += 1
    return out


modulated_deform_conv.launches = 0
