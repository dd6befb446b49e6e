#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``detectron2_centernet_tpu_torch``) on
one NVIDIA card: ctdet DLA-34 inference at full width through the port's
``DefaultPredictor``, with every DCN on the hand-written Hopper kernel.

Phases (any failure raises and the script exits non-zero):
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build the DCN kernel (``ops/csrc/dcn_fwd.cu``) with nvcc;
  3. the kernel against its plain PyTorch version at the seven DCN shapes of
     DLA-34 at 512x512, batch 2, offsets up to ±8 px, f32 and bf16, the
     epilogue on and off;
  4. the main path: ``DefaultPredictor`` on three seeded images of different
     sizes and ``CenterNet.predict_fn`` on one batch of TEST.BATCH_SIZE (16),
     in bf16, with the launch count of every forward; then the f32 head
     outputs of one image on the card against the same model on the CPU;
  5. times from CUDA events after warm-up: the kernel and its plain version at
     each shape, the predictor's request latency and predict_fn's img/s, and
     a torch.profiler table of device time by kernel for batch-1 forwards;
  6. one JSON line for the kernel, the card's name and power limit, and a
     last line ``{"ok": true, "device": {...}}``.

Weights are random, made from a seed (no trained checkpoint is in the repo);
the offset convs get random weights too, so the DCNs sample off the grid.

Usage: python3 chip_smoke.py [--json PATH]
  --json PATH  also write every number of the run to PATH
"""

import argparse
import collections
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from detectron2_centernet_tpu_torch.config import get_cfg
from detectron2_centernet_tpu_torch.data import letterbox_transform, warp_image
from detectron2_centernet_tpu_torch.engine import DefaultPredictor
from detectron2_centernet_tpu_torch.models import build_model
from detectron2_centernet_tpu_torch.models.layers import DCNv2, DeformConvV2
from detectron2_centernet_tpu_torch.ops import dcn

# DLA-34 at 512x512: the 16 DCN launches of one forward as (Cin, Cout, H=W, count)
DLA_SHAPES = [
    (512, 256, 16, 1), (256, 256, 32, 1), (256, 128, 32, 2), (256, 64, 32, 1),
    (128, 128, 64, 2), (128, 64, 64, 4), (64, 64, 128, 5),
]
# Published H100 SXM peaks (dense): bf16 tensor cores, f32 off the tensor cores, HBM
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}  # max |err| / max |plain|
HEAD_TOL = 1e-3  # f32 card vs CPU, per head, relative to the head's max |value|
SOURCE = "detectron2_centernet_tpu_torch/ops/csrc/dcn_fwd.cu"
REPLACES = "detectron2_centernet_tpu/ops/pallas_dcn.py:76"


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def ctdet_dla34_cfg(dtype: str):
    """configs/COCO-Detection/ctdet_dla_34_1x.yaml (over Base-CenterNet.yaml),
    built in code: the card's machine has no YAML parser."""
    cfg = get_cfg()
    cfg.merge_from_list([
        "MODEL.META_ARCHITECTURE", "CenterNet",
        "MODEL.BACKBONE.NAME", "build_dla34_backbone",
        "MODEL.PIXEL_MEAN", [0.408, 0.447, 0.470],
        "MODEL.PIXEL_STD", [0.289, 0.274, 0.278],
        "MODEL.CENTERNET.FOCAL_LOSS_ALPHA", [1],
        "INPUT.FORMAT", "BGR",
        "INPUT.TEST_SIZE", (512, 512),
        "TEST.BATCH_SIZE", 16,
        "TPU.DTYPE", dtype,
        "SEED", 0,
    ])
    return cfg


def seeded_weights(cfg, images: torch.Tensor, seed: int) -> dict:
    """Random weights from ``seed``, on the CPU in f32: the model's own init,
    random offset convs (N(0, 1/fan_in): offsets of about a pixel), and
    BatchNorm statistics measured on ``images`` so activations keep their
    scale through the 40 layers (with identity statistics they fade, and the
    heatmap is flat). Returns the state dict for every model of the run."""
    cfg = cfg.clone()
    cfg.MODEL.DEVICE = "cpu"
    cfg.TPU.DTYPE = "float32"
    host = build_model(cfg)
    g = torch.Generator().manual_seed(seed)
    bns = [m for m in host.model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        for m in host.model.modules():
            if isinstance(m, DCNv2):
                w = m.conv_offset_mask.weight
                w.copy_(torch.randn(w.shape, generator=g) / math.sqrt(w[0].numel()))
        for bn in bns:
            bn.momentum = 1.0  # running statistics := this batch's
        host.model.train()
        host.model(host.normalize(images))
    for bn in bns:
        bn.momentum = 0.1
    return host.model.state_dict()


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
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


def dcn_case(b, cin, cout, hw, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.rand(*s, generator=g, device="cuda")
    n = lambda *s: torch.randn(*s, generator=g, device="cuda")
    x = n(b, cin, hw, hw).to(dtype)
    offset = (r(b, 18, hw, hw) * 2 - 1) * 8.0
    mask = r(b, 9, hw, hw)
    weight = (n(cout, cin, 3, 3) / math.sqrt(9 * cin)).to(dtype)
    bias = n(cout) * 0.1
    scale = r(cout) + 0.5
    shift = n(cout) * 0.1
    epilogue = dict(post_scale=scale, post_shift=shift + scale * bias, post_relu=True)
    return (x, offset, mask, weight), dict(bias=bias), epilogue


def dcn_bound(b, cin, cout, hw, dtype):
    """Least time of one launch, (ops_ms, bytes_ms, gemm_flops): operations
    over peak rate (the 9·Cin → Cout contraction on the tensor cores in bf16,
    on the f32 pipes in f32; the bilinear samples, 4 FMAs each, on the f32
    pipes) and bytes over HBM rate (each input read once, the output written
    once). The bound is the larger of the two."""
    es = torch.tensor([], dtype=dtype).element_size()
    pix = b * hw * hw
    nbytes = pix * cin * es + pix * 27 * 4 + cout * cin * 9 * es + 2 * cout * 4 + pix * cout * es
    gemm = 2.0 * 9 * cin * cout * pix
    sample = 8.0 * 9 * cin * pix
    if dtype == torch.bfloat16:
        ops_s = max(gemm / PEAK_BF16, sample / PEAK_F32)
    else:
        ops_s = (gemm + sample) / PEAK_F32
    return ops_s * 1e3, nbytes / PEAK_BYTES * 1e3, gemm


def bound_of(ops_ms, bytes_ms):
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def phase_kernel_vs_plain(report):
    print("== 3. dcn_fwd against its plain version (batch 2, offsets up to ±8 px)")
    rows = []
    for cin, cout, hw, _ in DLA_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for epilogue in (False, True):
                args, kw_plain, kw_epi = dcn_case(2, cin, cout, hw, dtype, seed=cin + cout + hw)
                kw = kw_epi if epilogue else kw_plain
                got = dcn.modulated_deform_conv(*args, **kw)
                ref = dcn.modulated_deform_conv_plain(*args, **kw)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs().max().item()
                rel = err / max(ref.float().abs().max().item(), 1e-30)
                ok = bool(torch.isfinite(got).all().item()) and rel <= TOL[dtype]
                row = dict(cin=cin, cout=cout, hw=hw, dtype=str(dtype).split(".")[1],
                           epilogue=epilogue, max_abs_err=err, max_rel_err=rel, tol=TOL[dtype], ok=ok)
                rows.append(row)
                print(f"  {cin:4d}->{cout:<4d} @{hw:3d}^2 {row['dtype']:8s} epilogue={epilogue!s:5s} "
                      f"max_abs_err={err:.3e} max_rel_err={rel:.3e} tol={TOL[dtype]:.0e} {'ok' if ok else 'FAIL'}")
    report["kernel_vs_plain"] = rows
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise SystemExit(f"dcn_fwd disagrees with its plain version: {bad}")
    return max(r["max_abs_err"] for r in rows if r["dtype"] == "bfloat16" and r["epilogue"])


def phase_main_path(report, seed=0):
    print("== 4. main path: ctdet DLA-34, 512x512, 80 classes, bf16, DefaultPredictor")
    cfg = ctdet_dla34_cfg("bfloat16")
    size = tuple(cfg.INPUT.TEST_SIZE)
    rng = np.random.RandomState(seed)
    letterbox = lambda im, dev: warp_image(
        im, letterbox_transform(*im.shape[:2], size), size, device=dev).permute(2, 0, 1)
    calib = torch.stack([letterbox(rng.randint(0, 256, (480, 640, 3)).astype(np.uint8), "cpu")
                         for _ in range(2)])
    weights = seeded_weights(cfg, calib, seed)
    predictor = DefaultPredictor(cfg)
    model = predictor.model
    model.model.load_state_dict(weights)
    shapes = collections.Counter()
    hooks = [
        m.register_forward_pre_hook(
            lambda mod, inp: shapes.update([(inp[0].shape[1], mod.conv.weight.shape[0], inp[0].shape[2])]))
        for m in model.model.modules() if isinstance(m, DeformConvV2)
    ]
    images = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for h, w in ((480, 640), (512, 512), (375, 500))]
    batch = torch.stack([letterbox(rng.randint(0, 256, (480, 640, 3)).astype(np.uint8), model.device)
                         for _ in range(cfg.TEST.BATCH_SIZE)])

    dcn.modulated_deform_conv.launches = 0
    per_forward = []
    outputs = []
    for img in images:
        before = dcn.modulated_deform_conv.launches
        outputs.append(predictor(img)["instances"])
        per_forward.append(dcn.modulated_deform_conv.launches - before)
    before = dcn.modulated_deform_conv.launches
    dets = model.predict_fn(batch)
    torch.cuda.synchronize()
    per_forward.append(dcn.modulated_deform_conv.launches - before)
    launches = dcn.modulated_deform_conv.launches
    for h in hooks:
        h.remove()

    print(f"  dcn_fwd launches: {launches} in {len(per_forward)} forwards, per forward {per_forward}")
    if per_forward != [16] * len(per_forward):
        raise SystemExit(f"expected 16 dcn_fwd launches per forward, got {per_forward}")
    want = collections.Counter({(c, o, s): 4 * k for c, o, s, k in DLA_SHAPES})
    if shapes != want:
        raise SystemExit(f"the main path's DCN shapes {dict(shapes)} are not the table's {dict(want)}")
    for img, inst in zip(images, outputs):
        b = inst.pred_boxes.tensor
        h, w = img.shape[:2]
        if not (len(inst) > 0 and np.isfinite(b).all() and np.isfinite(inst.scores).all()
                and (b[:, [0, 2]] <= w).all() and (b[:, [1, 3]] <= h).all() and (b >= 0).all()
                and (inst.scores > model.score_threshold).all() and (inst.pred_classes < 80).all()):
            raise SystemExit(f"bad detections for a {h}x{w} image: {inst}")
        print(f"  request {h}x{w}: {len(inst)} detections, top score {inst.scores.max():.4f}")
    n = cfg.TEST.BATCH_SIZE
    if not (dets["boxes"].shape == (n, 100, 4) and dets["scores"].shape == (n, 100)
            and bool(torch.isfinite(dets["boxes"]).all()) and bool(torch.isfinite(dets["scores"]).all())):
        raise SystemExit("predict_fn returned malformed detections")
    print(f"  predict_fn batch {n}: boxes {tuple(dets['boxes'].shape)}, all finite")
    report["main_path"] = dict(launches=launches, per_forward=per_forward,
                               detections=[len(i) for i in outputs])

    print("== 4b. f32 head outputs of one image: card against CPU (TF32 off)")
    cfg32 = ctdet_dla34_cfg("float32")
    card = build_model(cfg32)
    cfg32.MODEL.DEVICE = "cpu"
    host = build_model(cfg32)
    for m in (card, host):
        m.model.load_state_dict(weights)
    x = batch[:1]
    with torch.inference_mode():
        zc = card.model(card.normalize(x))
        zh = host.model(host.normalize(x.cpu()))
    head_err = {}
    for k in ("hm", "wh", "reg"):
        err = (zc[k].float().cpu() - zh[k]).abs().max().item()
        scale = zh[k].abs().max().item()
        head_err[k] = dict(max_abs_err=err, scale=scale)
        ok = bool(torch.isfinite(zc[k]).all()) and err <= HEAD_TOL * max(scale, 1.0)
        print(f"  {k}: shape {tuple(zc[k].shape)} max_abs_err={err:.3e} (scale {scale:.3e}, "
              f"tol {HEAD_TOL:.0e} x max(scale, 1)) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"the card's {k} head differs from the CPU's")
    report["heads_card_vs_cpu"] = head_err
    return predictor, batch, images, launches


def phase_timing(report, predictor, batch, images):
    print("== 5. times (CUDA events after warm-up; bf16; batch 1 is the predictor's)")
    rows = []
    for cin, cout, hw, count in DLA_SHAPES:
        args, _, kw = dcn_case(1, cin, cout, hw, torch.bfloat16, seed=7)
        ms = cuda_ms(lambda: dcn.modulated_deform_conv(*args, **kw), iters=50)
        plain_ms = cuda_ms(lambda: dcn.modulated_deform_conv_plain(*args, **kw), iters=10, warmup=2)
        ops_ms, bytes_ms, gemm = dcn_bound(1, cin, cout, hw, torch.bfloat16)
        bound_ms, bound_by = bound_of(ops_ms, bytes_ms)
        args16, _, kw16 = dcn_case(16, cin, cout, hw, torch.bfloat16, seed=7)
        ms16 = cuda_ms(lambda: dcn.modulated_deform_conv(*args16, **kw16), iters=10)
        bound16, by16 = bound_of(*dcn_bound(16, cin, cout, hw, torch.bfloat16)[:2])
        del args16
        row = dict(cin=cin, cout=cout, hw=hw, count=count, ms=ms, plain_ms=plain_ms,
                   ops_ms=ops_ms, bytes_ms=bytes_ms, bound_ms=bound_ms, bound_by=bound_by,
                   tflops=gemm / ms / 1e9, ms_b16=ms16, bound_ms_b16=bound16, bound_by_b16=by16,
                   tflops_b16=16 * gemm / ms16 / 1e9)
        rows.append(row)
        print(f"  {cin:4d}->{cout:<4d} @{hw:3d}^2 x{count}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}), {row['tflops']:.2f} TFLOP/s | batch 16: "
              f"{ms16:.4f} ms, bound {bound16:.4f} ms ({by16}), {row['tflops_b16']:.2f} TFLOP/s")
    fwd = {k: sum(r[k] * r["count"] for r in rows)
           for k in ("ms", "plain_ms", "ops_ms", "bytes_ms", "ms_b16", "bound_ms_b16")}
    # one forward's 16 launches run one after another: their bounds add up
    fwd["bound_ms"] = sum(r["bound_ms"] * r["count"] for r in rows)
    fwd["bound_by"] = bound_of(fwd["ops_ms"], fwd["bytes_ms"])[1]
    print(f"  one batch-1 forward's 16 launches: kernel {fwd['ms']:.4f} ms, plain {fwd['plain_ms']:.4f} ms, "
          f"bound {fwd['bound_ms']:.4f} ms ({fwd['bound_by']}); batch 16: kernel {fwd['ms_b16']:.4f} ms, "
          f"bound {fwd['bound_ms_b16']:.4f} ms")

    img = images[0]
    for _ in range(3):
        predictor(img)
    lat = []
    for _ in range(20):
        t0 = time.perf_counter()
        predictor(img)  # returns host arrays: the device work is done
        lat.append((time.perf_counter() - t0) * 1e3)
    model = predictor.model
    batch_ms = cuda_ms(lambda: model.predict_fn(batch), iters=10, warmup=2)
    ips = batch.shape[0] * 1e3 / batch_ms
    one = batch[:1].contiguous()
    fwd1_ms = cuda_ms(lambda: model.predict_fn(one), iters=20)
    print(f"  DefaultPredictor request ({img.shape[0]}x{img.shape[1]}): median {statistics.median(lat):.3f} ms, "
          f"mean {statistics.mean(lat):.3f} ms, min {min(lat):.3f} ms over 20")
    print(f"  predict_fn batch 1: {fwd1_ms:.3f} ms; batch {batch.shape[0]}: {batch_ms:.3f} ms = {ips:.1f} img/s")
    report["timing"] = dict(per_shape=rows, per_forward=fwd, predictor_ms=lat,
                            predict_fn_b1_ms=fwd1_ms, predict_fn_b16_ms=batch_ms, img_per_s=ips)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            model.predict_fn(one)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=15)
    print("  device time by op over 3 batch-1 forwards:")
    print(table)
    report["profile_b1"] = table
    return fwd


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--json", help="also write every number of the run to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False  # f32 comparisons in true f32
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    report = {}

    print("== 1. environment")
    smi = nvidia_smi()
    print(f"  {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    report["card"] = smi

    print("== 2. build")
    built = dcn.build_library()
    print(f"  {built['path'].name}: {built['seconds']:.1f} s")
    for line in built["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  " + line.strip())
    report["build_s"] = built["seconds"]

    max_err = phase_kernel_vs_plain(report)
    predictor, batch, images, launches = phase_main_path(report)
    fwd = phase_timing(report, predictor, batch, images)

    kernels = {"kernels": [{
        "name": "dcn_fwd", "route": "cuda", "source": SOURCE, "replaces": REPLACES,
        "launches": launches, "launches_per_forward": 16, "max_abs_err": max_err,
        "ms": fwd["ms"], "plain_ms": fwd["plain_ms"], "bound_ms": fwd["bound_ms"],
        "bound_by": fwd["bound_by"], "library_ms": None,
    }]}
    report["seconds"] = time.perf_counter() - t_start
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    print(f"== done in {report['seconds']:.1f} s")
    print(json.dumps(kernels))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
