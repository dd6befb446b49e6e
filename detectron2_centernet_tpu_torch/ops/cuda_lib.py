"""Build and load the port's CUDA kernels: every source under ``csrc/`` goes
through ``nvcc`` into a shared library with a plain C interface, loaded with
``ctypes`` (seconds to build, where ``torch.utils.cpp_extension.load`` takes
minutes).

The libraries are built at first use into ``_build/`` beside this package,
one ``nvcc`` process per source, all started together, and cached by the
hash of the source, the headers beside it (``*.cuh``) and its flags.
``SOURCES`` names them: the DCN forward (``fwd``, ``ops/dcn.py``), the four
DCN backward kernels (``bwd``), the fixed-K NMS of axis-aligned and rotated
boxes (``nms``, ``ops/nms.py`` and ``ops/roi_align_rotated.py``), which
launches kernels from the card and so is built as relocatable device code
against the device runtime, and the pairwise rotated IoU (``iou_rotated``,
``ops/roi_align_rotated.py``). The two that compute the rotated IoU
(``iou_rotated.cuh``) are built with ``-fmad=false``, so that it rounds as
its plain version's tensor ops do (``SOURCE_FLAGS``).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

import torch

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "SOURCES", "SOURCE_FLAGS", "build_libraries", "launch", "library"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"fwd": CSRC / "dcn_fwd.cu", "bwd": CSRC / "dcn_bwd.cu", "nms": CSRC / "nms.cu",
           "iou_rotated": CSRC / "iou_rotated.cu"}
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# after the source on the command line: the NMS's rounds after the first are tail launches from the card; the
# rotated IoU's multiplies and adds are never contracted into FMAs
SOURCE_FLAGS = {"nms": ("-fmad=false", "-rdc=true", "-lcudadevrt"), "iou_rotated": ("-fmad=false",)}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _library_path(name: str) -> Path:
    source = SOURCES[name]
    flags = " ".join(NVCC_FLAGS + SOURCE_FLAGS.get(name, ()))
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(source.read_bytes() + headers + flags.encode()).hexdigest()[:16]
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
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source), *SOURCE_FLAGS.get(name, ())],
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


def library(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library of ``SOURCES[name]`` (built first when missing),
    its C functions typed by ``signatures`` ({function: argtypes}, each
    returning an int CUDA error code)."""
    if name not in _LIBS:
        path = _library_path(name)
        if not path.exists():
            path = build_libraries()[name]["path"]
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return _LIBS[name]


def launch(lib: ctypes.CDLL, fn: str, device: torch.device, *args) -> None:
    """Call a kernel's C entry point on ``device`` and its current stream
    (the last argument); raise when it returns a CUDA error."""
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return launch(lib, fn, device, *args)
    # the raw stream handle, without building a torch.cuda.Stream per call
    err = getattr(lib, fn)(*args, torch._C._cuda_getCurrentRawStream(device.index))
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed with CUDA error {err}")
