"""Times of the DCN kernels of one checkout of the PyTorch port, for A/B runs
on one card, summed over the 16 DCN launches of one DLA-34 pass at 512² (the
shapes of ``chip_smoke.py``), bf16:

* K1 (``modulated_deform_conv``) at batch 1 and 16 with the eval epilogue
  (BN scale / shift + ReLU, as ``DeformConvV2`` at inference calls it) and
  at batch 32 without (as the train step calls it); at batch 1 also the
  wrapper's host time per call (the enqueue of a loop of launches, on the
  host clock, against the launches' CUDA-event time);
* K2 (``dcn_bwd_dx``) and K5 (``dcn_bwd_dqdw``), the two backward kernels of
  every train step, at batch 1 and 32;
* K3 / K4 (``dcn_bwd_dq`` / ``dcn_bwd_dw``) at batch 1 and 32;

in three offset regimes: 0 (the zero-initialised offset convs every DCN
starts training with), about a pixel (normal, σ = 1 px, as the seeded train
step's) and uniform within ±8 px (K3 and K4 at ±8 px only). CUDA events over
repeated launches after warm-up, inputs made on the card from a seed.

The checkout measured is the one on PYTHONPATH, whatever checkout this file
comes from: to compare two, unpack one with ``git archive`` into a directory
git ignores and run them in turns in one call (a, b, b, a)::

    for t in output/parent . . output/parent; do
        PYTHONPATH=$t python3 detectron2_centernet_tpu_torch/tools/dcn_ab.py \\
            --json output/dcn_ab.jsonl; done

``--kernels dcn_fwd`` (a comma-separated list) times only those. Each run
prints one line per (kernel, batch, regime) and, with ``--json``, appends one
JSON object to the file.
"""
import argparse
import json
import math
import subprocess
import time

import torch

import detectron2_centernet_tpu_torch as pkg
from detectron2_centernet_tpu_torch.ops import dcn

# DLA-34 at 512x512: the 16 DCN launches of one pass as (Cin, Cout, H=W, count)
DLA_SHAPES = [
    (512, 256, 16, 1), (256, 256, 32, 1), (256, 128, 32, 2), (256, 64, 32, 1),
    (128, 128, 64, 2), (128, 64, 64, 4), (64, 64, 128, 5),
]
REGIMES = ("zero", "1px", "8px")
# kernel: ((batch, with the eval epilogue), ...), regimes
PLAN = {
    "dcn_fwd": (((1, True), (16, True), (32, False)), REGIMES),
    "dcn_bwd_dx": (((1, False), (32, False)), REGIMES),
    "dcn_bwd_dqdw": (((1, False), (32, False)), REGIMES),
    "dcn_bwd_dq": (((1, False), (32, False)), ("8px",)),
    "dcn_bwd_dw": (((1, False), (32, False)), ("8px",)),
}


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
    scale = rand(cout) + 0.5
    epilogue = dict(post_scale=scale, post_shift=randn(cout) * 0.1, post_relu=True)
    return (x, offset, mask, weight, cot), epilogue


def cuda_ms(fn, iters, warmup=2):
    """(CUDA-event ms per call, host-clock ms per call of the enqueue)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--json", help="append this run's numbers to this JSON-lines file")
    parser.add_argument("--kernels", default=",".join(PLAN), help="comma-separated kernels to time")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("dcn_ab.py needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    tree = pkg.__file__.split("/detectron2_centernet_tpu_torch")[0]
    dcn.build_libraries()
    calls = {
        "dcn_fwd": lambda a, kw: dcn.modulated_deform_conv(*a[:4], **kw),
        "dcn_bwd_dx": lambda a, kw: dcn.dcn_bwd_dx(*a),
        "dcn_bwd_dqdw": lambda a, kw: dcn.dcn_bwd_dqdw(*a),
        "dcn_bwd_dq": lambda a, kw: dcn.dcn_bwd_dq(*a),
        "dcn_bwd_dw": lambda a, kw: dcn.dcn_bwd_dw(*a[:3], a[4]),
    }
    result = dict(tree=tree, card=card, totals={}, per_shape={}, host_ms_per_call={})
    for name in args.kernels.split(","):
        batches, regimes = PLAN[name]
        for b, with_epilogue in batches:
            for regime in regimes:
                total, rows, host = 0.0, [], []
                for cin, cout, hw, count in DLA_SHAPES:
                    a, epilogue = inputs(b, cin, cout, hw, regime)
                    kw = epilogue if with_epilogue else {}
                    ms, host_ms = cuda_ms(lambda: calls[name](a, kw), iters=20 if b == 1 else 5)
                    rows.append(ms)
                    host.append(host_ms)
                    total += ms * count
                    del a
                key = f"{name} b{b} {regime}"
                result["totals"][key] = total
                result["per_shape"][key] = rows
                line = f"{tree}: {key}: 16 launches {total:.4f} ms; per shape " + " ".join(f"{r:.4f}" for r in rows)
                if b == 1:
                    result["host_ms_per_call"][key] = host
                    line += "; host ms per call " + " ".join(f"{h:.4f}" for h in host)
                print(line, flush=True)
    print(f"{tree}: {card}", flush=True)
    if args.json:
        with open(args.json, "a") as f:
            f.write(json.dumps(result) + "\n")


if __name__ == "__main__":
    main()
