"""Where the DCN kernels spend their time: K1 (``dcn_fwd`` of
``ops/csrc/dcn_fwd.cu``), K2 (``dcn_bwd_dx``) and K5 (``dcn_bwd_dqdw``) of
``ops/csrc/dcn_bwd.cu`` built again with one phase cut out at a time, and
timed, bf16, in three offset regimes (0, normal σ = 1 px, uniform ±8 px):
K2 and K5 at the three DLA-34 shapes that take most of a batch-32 train
step's DCN time, K1 at 64->64 @128² and 256->256 @32² at batch 16 and
512->256 @16² at batch 1 (the eval epilogue on). A variant computes wrong
outputs; only its time means something: the time a phase costs is the full
kernel's less the variant's. Also prints the shared and global atomic
instructions of the full backward build (``cuobjdump -sass``).

Needs a card and nvcc; the variants are built (all at once) into
``_build/phases/``. Run from the repository root::

    PYTHONPATH=. python3 detectron2_centernet_tpu_torch/tools/dcn_phases.py [--json PATH] [--kernels dcn_fwd]
"""
import argparse
import collections
import ctypes
import json
import math
import re
import subprocess
from pathlib import Path

import torch

from detectron2_centernet_tpu_torch.ops import cuda_lib, dcn

BWD_SHAPES = [(64, 64, 128, 32), (128, 64, 64, 32), (256, 256, 32, 32)]  # (Cin, Cout, H = W, batch)
FWD_SHAPES = [(64, 64, 128, 16), (256, 256, 32, 16), (512, 256, 16, 1)]
SPLIT = "// K2: dX through"  # in dcn_bwd.cu K3-K5's body comes before this line, K2's after
X_READS = ("const float v00 = to_f32(raw[u][0]), v01 = to_f32(raw[u][1]);\n"
           "          const float v10 = to_f32(raw[u][2]), v11 = to_f32(raw[u][3]);")
USE_WIN = "const bool use_win = wh * ww <= XCAP && 4 * *count >= 3 * PAIRS;"
NO_WIN = "const bool use_win = false;"
FWD_X_READS = ("r[j][0] = ld16(xc + o.x); r[j][1] = ld16(xc + o.y); r[j][2] = ld16(xc + o.z); "
               "r[j][3] = ld16(xc + o.w);")
FWD_MMA = "wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);"
FWD_NO_GATHER = [("fwd", f"{call};", ";") for call in (
    "load_units(k_begin, r)", "store_units(0, r)", "load_units(kc + 1, r)", "store_units(b ^ 1, r)")]
FWD_STAGE = "dcn_fwd_stage_kernel<T><<<"
FWD_REDUCE = "dcn_fwd_reduce_kernel<T><<<"
# name: (kernel, [(part, text, replacement)]) with part "wq" (K3-K5's body in
# dcn_bwd.cu), "dx" (K2's) or "fwd" (dcn_fwd.cu)
VARIANTS = {
    "all phases": ("all", []),
    "K5 no x reads (window or global)": ("dcn_bwd_dqdw", [
        ("wq", X_READS, "const float v00 = 0.25f, v01 = 0.5f, v10 = 0.75f, v11 = 1.f;"), ("wq", USE_WIN, NO_WIN)]),
    "K5 no x window": ("dcn_bwd_dqdw", [("wq", USE_WIN, NO_WIN)]),
    "K5 no d offset / d mask atomics": ("dcn_bwd_dqdw", [
        ("wq", "if (oy_ != 0.f)", "if (false)"), ("wq", "if (ox_ != 0.f)", "if (false)"),
        ("wq", "if (a_m != 0.f)", "if (false)")]),
    "K5 no products (dcol, dW)": ("dcn_bwd_dqdw", [
        ("wq", "wmma::mma_sync(dacc[i], a, b, dacc[i]);", ""), ("wq", "wmma::mma_sync(acc[i], a, b, acc[i]);", "")]),
    "K2 no scatter": ("dcn_bwd_dx", [("dx", "if (code < 0 || m == 0.f) continue;", "continue;")]),
    "K2 no scatter, no product": ("dcn_bwd_dx", [
        ("dx", "if (code < 0 || m == 0.f) continue;", "continue;"), ("dx", "wmma::mma_sync(acc[i], a, b, acc[i]);", "")]),
    "K2 no flush": ("dcn_bwd_dx", [("dx", "if ((v.x | v.y | v.z | v.w) == 0) continue;", "continue;")]),
    "K1 no x reads": ("dcn_fwd", [
        ("fwd", FWD_X_READS, "r[j][0] = r[j][1] = r[j][2] = r[j][3] = make_uint4(o.x, o.y, o.z, o.w);")]),
    "K1 no product": ("dcn_fwd", [("fwd", FWD_MMA, ";")]),
    "K1 no gather (x reads, blend, column stores)": ("dcn_fwd", FWD_NO_GATHER),
    "K1 no gather, no product": ("dcn_fwd", FWD_NO_GATHER + [("fwd", FWD_MMA, ";")]),
    "K1 no staging (transpose, weight order)": ("dcn_fwd", [("fwd", FWD_STAGE, "if (false) " + FWD_STAGE)]),
    "K1 no split sum": ("dcn_fwd", [("fwd", FWD_REDUCE, "if (false) " + FWD_REDUCE)]),
    "K1 one block per SM at BM 64 (255 registers)": ("dcn_fwd", [("fwd", "BM <= 64 ? 2 : 1", "1")]),
}
REGIMES = ("zero", "1px", "8px")


def patched(source: str, edits, fwd: bool) -> str:
    if fwd:
        parts, names = [source], ["fwd"]
    else:
        cut = source.index(SPLIT)
        parts, names = [source[:cut], source[cut:]], ["wq", "dx"]
    for part, old, new in edits:
        if part not in names:
            continue
        i = names.index(part)
        if old not in parts[i]:
            raise SystemExit(f"the kernel source changed: {old!r} is gone; update VARIANTS")
        parts[i] = parts[i].replace(old, new)
    return "".join(parts)


def build_all(kernels):
    """{(variant, "fwd" | "bwd"): CDLL} for every variant of ``kernels`` that
    touches that source (and "all phases" for both), and the full backward
    build's path (None when no backward kernel is timed)."""
    out_dir = cuda_lib.BUILD_DIR / "phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (kernel, edits)) in enumerate(VARIANTS.items()):
        for lib in ("fwd", "bwd"):
            # K1 lives in dcn_fwd.cu, K2 and K5 in dcn_bwd.cu
            timed = kernels if kernel == "all" else [kernel] if kernel in kernels else []
            if not any((k == "dcn_fwd") == (lib == "fwd") for k in timed):
                continue
            cu, so = out_dir / f"v{i}_{lib}.cu", out_dir / f"v{i}_{lib}.so"
            cu.write_text(patched(cuda_lib.SOURCES[lib].read_text(), edits, lib == "fwd"))
            procs[name, lib] = (subprocess.Popen([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(so), str(cu)],
                                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), so)
    libs = {}
    for (name, lib), (proc, so) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on variant {name!r}:\n{err[-4000:]}")
        cdll = ctypes.CDLL(str(so))
        for fn, argtypes in dcn._SIGNATURES[lib].items():
            getattr(cdll, fn).argtypes = argtypes
        libs[name, lib] = cdll
    return libs, procs["all phases", "bwd"][1] if ("all phases", "bwd") in procs else None


def inputs(b, cin, cout, hw, regime):
    g = torch.Generator(device="cuda").manual_seed(7)
    randn = lambda *s: torch.randn(*s, generator=g, device="cuda")
    x = randn(b, cin, hw, hw).bfloat16()
    offset = {"zero": lambda: torch.zeros(b, 18, hw, hw, device="cuda"),
              "1px": lambda: randn(b, 18, hw, hw),
              "8px": lambda: (torch.rand(b, 18, hw, hw, generator=g, device="cuda") * 2 - 1) * 8.0}[regime]()
    mask = torch.rand(b, 9, hw, hw, generator=g, device="cuda")
    weight = (randn(cout, cin, 3, 3) / math.sqrt(9 * cin)).bfloat16()
    return x, offset, mask, weight, randn(b, cout, hw, hw).bfloat16()


def bwd_calls(lib, b, cin, cout, hw, x, off, mask, w, g, stream):
    """{kernel: launch} of K2 and K5 on one case through one variant's library."""
    plan = dcn.bwd_plan(b, cin, hw, hw, cout, torch.cuda.get_device_properties(0).multi_processor_count)
    dx = torch.zeros(x.shape, device="cuda")
    doff, dmask = torch.zeros_like(off), torch.zeros_like(mask)
    part = torch.empty((plan["splits"], cout, cin * 9), device="cuda")
    dw = torch.empty(w.shape, dtype=w.dtype, device="cuda")
    return {
        "dcn_bwd_dx": lambda: lib.dcn_bwd_dx(
            x.data_ptr(), off.data_ptr(), mask.data_ptr(), w.data_ptr(), g.data_ptr(),
            dx.data_ptr(), b, cin, hw, hw, cout, 1, 1, 1, stream),
        "dcn_bwd_dqdw": lambda: lib.dcn_bwd_dqdw(
            x.data_ptr(), off.data_ptr(), mask.data_ptr(), w.data_ptr(), g.data_ptr(),
            doff.data_ptr(), dmask.data_ptr(), dw.data_ptr(), part.data_ptr(), b, cin, hw,
            hw, cout, 1, 1, plan["span"], plan["splits"], 1, stream),
    }


def fwd_calls(lib, b, cin, cout, hw, x, off, mask, w, g, stream):
    """{"dcn_fwd": launch} of K1 with the eval epilogue through one variant's library."""
    plan = dcn.fwd_plan(b, cin, hw, hw, cout, torch.cuda.get_device_properties(0).multi_processor_count)
    scratch = torch.empty(plan["scratch_bytes"], dtype=torch.uint8, device="cuda")
    scale, shift = torch.ones(cout, device="cuda"), torch.zeros(cout, device="cuda")
    out = torch.empty((b, cout, hw, hw), dtype=x.dtype, device="cuda")
    return {"dcn_fwd": lambda: lib.dcn_fwd(
        x.data_ptr(), off.data_ptr(), mask.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), b, cin, hw, hw, cout, 1, 1, 1, 1, plan["bm"], plan["span"],
        plan["splits"], plan["scratch_bytes"], stream)}


def cuda_ms(fn, iters=5):
    err = fn()
    if err:
        raise SystemExit(f"a variant's launch failed with CUDA error {err}")
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--json", help="also write the times to this file")
    parser.add_argument("--kernels", default="dcn_fwd,dcn_bwd_dx,dcn_bwd_dqdw",
                        help="comma-separated kernels whose variants to build and time")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("dcn_phases.py needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kernels = args.kernels.split(",")
    libs, full = build_all(kernels)
    sass = "" if full is None else subprocess.run(
        [str(Path(cuda_lib._nvcc()).parent / "cuobjdump"), "-sass", str(full)], capture_output=True, text=True).stdout
    atomics = collections.Counter(re.findall(r"\b((?:ATOMS|ATOMG|ATOM|REDG|RED)\.[A-Z0-9_.]+)", sass))
    print(f"atomic instructions in the full build: {dict(atomics)}")
    stream = torch.cuda.current_stream().cuda_stream
    result = dict(card=card, atomics=dict(atomics), ms={})
    cases = [("bwd", shape, bwd_calls) for shape in BWD_SHAPES] + [("fwd", shape, fwd_calls) for shape in FWD_SHAPES]
    for regime in REGIMES:
        for lib_name, (cin, cout, hw, b), make_calls in cases:
            data = inputs(b, cin, cout, hw, regime)
            for name, (kernel, _) in VARIANTS.items():
                if (name, lib_name) not in libs:
                    continue
                for k, fn in make_calls(libs[name, lib_name], b, cin, cout, hw, *data, stream).items():
                    if kernel in ("all", k) and k in kernels:
                        ms = cuda_ms(fn)
                        result["ms"][f"{regime} {cin}->{cout}@{hw} b{b} {k} | {name}"] = ms
                        print(f"{regime:4s} {cin:3d}->{cout:<3d} @{hw:3d}^2 b{b:<2d} {k:12s} {name:40s} {ms:8.4f} ms",
                              flush=True)
            del data
    print(card)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
