"""Where the DCN backward kernels spend their time: K2 (``dcn_bwd_dx``) and
K5 (``dcn_bwd_dqdw``) of ``ops/csrc/dcn_bwd.cu`` built again with one phase
cut out at a time, and timed at the three DLA-34 shapes that take most of a
batch-32 train step's DCN time, bf16, in three offset regimes (0, normal
σ = 1 px, uniform ±8 px). A variant computes wrong gradients; only its time
means something: the time a phase costs is the full kernel's less the
variant's. Also prints the shared and global atomic instructions of the
full build (``cuobjdump -sass``).

Needs a card and nvcc; the variants are built (all at once) into
``_build/phases/``. Run from the repository root::

    PYTHONPATH=. python3 detectron2_centernet_tpu_torch/tools/dcn_bwd_phases.py [--json PATH]
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

from detectron2_centernet_tpu_torch.ops import dcn

SHAPES = [(64, 64, 128), (128, 64, 64), (256, 256, 32)]  # (Cin, Cout, H = W)
BATCH = 32
SPLIT = "// K2: dX through"  # K3-K5's body comes before this line, K2's after
X_READS = ("const float v00 = to_f32(raw[u][0]), v01 = to_f32(raw[u][1]);\n"
           "          const float v10 = to_f32(raw[u][2]), v11 = to_f32(raw[u][3]);")
USE_WIN = "const bool use_win = wh * ww <= XCAP && 4 * *count >= 3 * PAIRS;"
NO_WIN = "const bool use_win = false;"
# name: (kernel, [(text, replacement)] in K3-K5's part, [...] in K2's part)
VARIANTS = {
    "all phases": ("both", [], []),
    "K5 no x reads (window or global)": ("dcn_bwd_dqdw", [
        (X_READS, "const float v00 = 0.25f, v01 = 0.5f, v10 = 0.75f, v11 = 1.f;"), (USE_WIN, NO_WIN)], []),
    "K5 no x window": ("dcn_bwd_dqdw", [(USE_WIN, NO_WIN)], []),
    "K5 no d offset / d mask atomics": ("dcn_bwd_dqdw", [
        ("if (oy_ != 0.f)", "if (false)"), ("if (ox_ != 0.f)", "if (false)"), ("if (a_m != 0.f)", "if (false)")], []),
    "K5 no products (dcol, dW)": ("dcn_bwd_dqdw", [
        ("wmma::mma_sync(dacc[i], a, b, dacc[i]);", ""), ("wmma::mma_sync(acc[i], a, b, acc[i]);", "")], []),
    "K2 no scatter": ("dcn_bwd_dx", [], [("if (code < 0 || m == 0.f) continue;", "continue;")]),
    "K2 no scatter, no product": ("dcn_bwd_dx", [], [
        ("if (code < 0 || m == 0.f) continue;", "continue;"), ("wmma::mma_sync(acc[i], a, b, acc[i]);", "")]),
    "K2 no flush": ("dcn_bwd_dx", [], [("if ((v.x | v.y | v.z | v.w) == 0) continue;", "continue;")]),
}
REGIMES = ("zero", "1px", "8px")


def patched(source: str, wq, dx) -> str:
    cut = source.index(SPLIT)
    parts = [source[:cut], source[cut:]]
    for i, edits in enumerate((wq, dx)):
        for old, new in edits:
            if old not in parts[i]:
                raise SystemExit(f"dcn_bwd.cu changed: {old!r} is gone; update VARIANTS")
            parts[i] = parts[i].replace(old, new)
    return "".join(parts)


def build_all():
    out_dir = dcn.BUILD_DIR / "phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = dcn.SOURCES["bwd"].read_text()
    procs = {}
    for i, (name, (_, wq, dx)) in enumerate(VARIANTS.items()):
        cu = out_dir / f"v{i}.cu"
        cu.write_text(patched(source, wq, dx))
        procs[name] = (subprocess.Popen([dcn._nvcc(), *dcn.NVCC_FLAGS, "-o", str(out_dir / f"v{i}.so"), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
                       out_dir / f"v{i}.so")
    libs = {}
    for name, (proc, so) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on variant {name!r}:\n{err[-4000:]}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in dcn._SIGNATURES["bwd"].items():
            getattr(lib, fn).argtypes = argtypes
        libs[name] = lib
    return libs, procs["all phases"][1]


def inputs(cin, cout, hw, regime):
    g = torch.Generator(device="cuda").manual_seed(7)
    randn = lambda *s: torch.randn(*s, generator=g, device="cuda")
    x = randn(BATCH, cin, hw, hw).bfloat16()
    offset = {"zero": lambda: torch.zeros(BATCH, 18, hw, hw, device="cuda"),
              "1px": lambda: randn(BATCH, 18, hw, hw),
              "8px": lambda: (torch.rand(BATCH, 18, hw, hw, generator=g, device="cuda") * 2 - 1) * 8.0}[regime]()
    mask = torch.rand(BATCH, 9, hw, hw, generator=g, device="cuda")
    weight = (randn(cout, cin, 3, 3) / math.sqrt(9 * cin)).bfloat16()
    return x, offset, mask, weight, randn(BATCH, cout, hw, hw).bfloat16()


def cuda_ms(fn, iters=5):
    fn()
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
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("dcn_bwd_phases.py needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    libs, full = build_all()
    sass = subprocess.run([str(Path(dcn._nvcc()).parent / "cuobjdump"), "-sass", str(full)],
                          capture_output=True, text=True).stdout
    atomics = collections.Counter(re.findall(r"\b((?:ATOMS|ATOMG|ATOM|REDG|RED)\.[A-Z0-9_.]+)", sass))
    print(f"atomic instructions in the full build: {dict(atomics)}")
    stream = torch.cuda.current_stream().cuda_stream
    result = dict(card=card, atomics=dict(atomics), ms={})
    for regime in REGIMES:
        for cin, cout, hw in SHAPES:
            x, off, mask, w, g = inputs(cin, cout, hw, regime)
            plan = dcn.bwd_plan(BATCH, cin, hw, hw, cout, torch.cuda.get_device_properties(0).multi_processor_count)
            dx = torch.zeros(x.shape, device="cuda")
            doff, dmask = torch.zeros_like(off), torch.zeros_like(mask)
            part = torch.empty((plan["splits"], cout, cin * 9), device="cuda")
            dw = torch.empty(w.shape, dtype=w.dtype, device="cuda")
            for name, (kernel, _, _) in VARIANTS.items():
                lib = libs[name]
                calls = {
                    "dcn_bwd_dx": lambda: lib.dcn_bwd_dx(
                        x.data_ptr(), off.data_ptr(), mask.data_ptr(), w.data_ptr(), g.data_ptr(),
                        dx.data_ptr(), BATCH, cin, hw, hw, cout, 1, stream),
                    "dcn_bwd_dqdw": lambda: lib.dcn_bwd_dqdw(
                        x.data_ptr(), off.data_ptr(), mask.data_ptr(), w.data_ptr(), g.data_ptr(),
                        doff.data_ptr(), dmask.data_ptr(), dw.data_ptr(), part.data_ptr(), BATCH, cin, hw,
                        hw, cout, plan["span"], plan["splits"], 1, stream),
                }
                for k, fn in calls.items():
                    if kernel in ("both", k):
                        ms = cuda_ms(fn)
                        result["ms"][f"{regime} {cin}->{cout}@{hw} {k} | {name}"] = ms
                        print(f"{regime:4s} {cin:3d}->{cout:<3d} @{hw:3d}^2 b{BATCH} {k:12s} {name:34s} {ms:8.4f} ms",
                              flush=True)
            del x, off, mask, w, g, dx, doff, dmask, part, dw
    print(card)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
