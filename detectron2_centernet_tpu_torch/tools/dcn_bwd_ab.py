"""Times of the DCN backward kernels of one checkout of the PyTorch port, for
A/B runs on one card: K2 (``dcn_bwd_dx``) and K5 (``dcn_bwd_dqdw``), the two
of every train step, and K3 / K4 (``dcn_bwd_dq`` / ``dcn_bwd_dw``), summed
over the 16 DCN launches of one DLA-34 pass at 512² (the shapes of
``chip_smoke.py``), bf16, at batch 1 and 32, in three offset regimes: 0 (the
zero-initialised offset convs every DCN starts training with), about a pixel
(normal, σ = 1 px, as the seeded train step's) and uniform within ±8 px. K3
and K4 run at ±8 px only. CUDA events over repeated launches after warm-up,
inputs made on the card from a seed.

The checkout measured is the one on PYTHONPATH, whatever checkout this file
comes from: to compare two, unpack one with ``git archive`` into a directory
git ignores and run them in turns in one call (a, b, b, a)::

    for t in output/parent . . output/parent; do
        PYTHONPATH=$t python3 detectron2_centernet_tpu_torch/tools/dcn_bwd_ab.py \\
            --json output/dcn_bwd_ab.jsonl; done

Each run prints one line per (kernel, batch, regime) and, with ``--json``,
appends one JSON object to the file.
"""
import argparse
import json
import math
import subprocess

import torch

import detectron2_centernet_tpu_torch as pkg
from detectron2_centernet_tpu_torch.ops import dcn

# DLA-34 at 512x512: the 16 DCN launches of one pass as (Cin, Cout, H=W, count)
DLA_SHAPES = [
    (512, 256, 16, 1), (256, 256, 32, 1), (256, 128, 32, 2), (256, 64, 32, 1),
    (128, 128, 64, 2), (128, 64, 64, 4), (64, 64, 128, 5),
]
REGIMES = ("zero", "1px", "8px")


def inputs(b, cin, cout, hw, regime, seed=7):
    g = torch.Generator(device="cuda").manual_seed(seed)
    randn = lambda *s: torch.randn(*s, generator=g, device="cuda")
    rand = lambda *s: torch.rand(*s, generator=g, device="cuda")
    x = randn(b, cin, hw, hw).bfloat16()
    offset = {"zero": lambda: torch.zeros(b, 18, hw, hw, device="cuda"),
              "1px": lambda: randn(b, 18, hw, hw),
              "8px": lambda: (rand(b, 18, hw, hw) * 2 - 1) * 8.0}[regime]()
    mask = rand(b, 9, hw, hw)
    weight = (randn(cout, cin, 3, 3) / math.sqrt(9 * cin)).bfloat16()
    cot = randn(b, cout, hw, hw).bfloat16()
    return x, offset, mask, weight, cot


def cuda_ms(fn, iters, warmup=2):
    for _ in range(warmup):
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
    parser.add_argument("--json", help="append this run's numbers to this JSON-lines file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("dcn_bwd_ab.py needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    tree = pkg.__file__.split("/detectron2_centernet_tpu_torch")[0]
    dcn.build_libraries()
    calls = {
        "dcn_bwd_dx": lambda a: dcn.dcn_bwd_dx(*a),
        "dcn_bwd_dqdw": lambda a: dcn.dcn_bwd_dqdw(*a),
        "dcn_bwd_dq": lambda a: dcn.dcn_bwd_dq(*a),
        "dcn_bwd_dw": lambda a: dcn.dcn_bwd_dw(*a[:3], a[4]),
    }
    result = dict(tree=tree, card=card, totals={}, per_shape={})
    for name, call in calls.items():
        for b in (1, 32):
            for regime in (REGIMES if name in ("dcn_bwd_dx", "dcn_bwd_dqdw") else ("8px",)):
                total, rows = 0.0, []
                for cin, cout, hw, count in DLA_SHAPES:
                    a = inputs(b, cin, cout, hw, regime)
                    ms = cuda_ms(lambda: call(a), iters=20 if b == 1 else 5)
                    rows.append(ms)
                    total += ms * count
                    del a
                key = f"{name} b{b} {regime}"
                result["totals"][key] = total
                result["per_shape"][key] = rows
                print(f"{tree}: {key}: 16 launches {total:.4f} ms; per shape "
                      + " ".join(f"{r:.4f}" for r in rows), flush=True)
    print(f"{tree}: {card}", flush=True)
    if args.json:
        with open(args.json, "a") as f:
            f.write(json.dumps(result) + "\n")


if __name__ == "__main__":
    main()
