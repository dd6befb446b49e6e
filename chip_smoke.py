#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``detectron2_centernet_tpu_torch``) on
one NVIDIA card: ctdet DLA-34 at full width, inference through the port's
``DefaultPredictor`` and training through its ``DefaultTrainer``, with every
DCN on the hand-written Hopper kernels (K1 forward, K2-K5 backward).

Phases (any failure raises and the script exits non-zero):
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build both kernel libraries (``ops/csrc/dcn_fwd.cu``, ``dcn_bwd.cu``),
     one nvcc each, at once, and print each kernel's registers and spills,
     and the backward kernels' shared memory and resident warps per SM;
  3. every kernel against its plain PyTorch version at the seven DCN shapes
     of DLA-34 at 512x512, batch 2, f32 and bf16, in four offset regimes:
     0 (every sample on the grid), about 1 px (normal), up to ±8 px and up
     to ±40 px (uniform; beyond K2's halo and off the map): K1 with the
     epilogue on and off, K2-K5 on a random cotangent, and dW of K4 and K5
     the same bit for bit over two launches; then K3 and K4 through the
     autograd Function (weight, or offset and mask, frozen), the only way
     they launch;
  4. the inference path: ``DefaultPredictor`` on three seeded images and
     ``CenterNet.predict_fn`` on one batch of 16, bf16, 16 K1 launches per
     forward; the f32 heads of one image on the card against the CPU;
  5. the training path: ``DefaultTrainer`` on the synthetic stand-in for
     coco_2017_train (80 classes, warped to 512²), batch 32, bf16, color
     jitter on the card, SGD at the config's LR, a few steps: each step
     launches 16 x K1, K2 and K5, every loss is finite, peak memory printed;
  6. one f32 train step (TF32 off) of one 512² image: the loss terms and every
     parameter's gradient, through the kernels on the card against the same
     step through the plain versions on the card and on the CPU;
  7. times from CUDA events after warm-up: every kernel at each shape at
     batch 1 (and K2-K5 at the trained batch) beside its bound and its plain
     version's time, ±8 px offsets; K2 and K5 also with zero and ~1 px
     offsets, at batch 1 and at the trained batch. (Phase 4 also times the
     request latency, predict_fn's img/s and a profiled batch-1 forward;
     phase 5 the train step, its img/s and a profiled train step.)
  8. one JSON line for the kernels, the card's name and power limit, and a
     last line ``{"ok": true, "device": {...}}``.

Weights are random, made from a seed (no trained checkpoint is in the repo);
the offset convs get random weights too, so the DCNs sample off the grid.

Bound of a launch (``dcn_bound``): the larger of its bytes (each input read
once, each output written once) over 3.35 TB/s and its operations over the
peak rate, the contractions (2·9·Cin·Cout per pixel each) on the bf16 tensor
cores (989 TFLOP/s) or the f32 pipes (67 TFLOP/s), the elementwise work of
each (channel, tap, pixel) sample on the f32 pipes: 8 FLOPs for the 4-corner
gather, 8 for dX's 4-corner scatter, 12 for the d offset / d mask sums.

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
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from detectron2_centernet_tpu_torch.config import get_cfg
from detectron2_centernet_tpu_torch.data import build_detection_train_loader, letterbox_transform, warp_image
from detectron2_centernet_tpu_torch.data.datasets import ensure_synthetic_datasets
from detectron2_centernet_tpu_torch.engine import DefaultPredictor, DefaultTrainer, HookBase
from detectron2_centernet_tpu_torch.models import build_model
from detectron2_centernet_tpu_torch.models.layers import DCNv2, DeformConvV2
from detectron2_centernet_tpu_torch.ops import dcn
from detectron2_centernet_tpu_torch.ops import deform_conv as plain

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
# f32 train step. The loss terms, card against CPU, within LOSS_TOL relative.
# The gradients, as quantiles over the parameters of error / own max |value|:
# the kernel route against the plain route on the card (same cuDNN, so only
# the five kernels differ) within ROUTE_TOL; the card against the CPU within
# CPU_TOL, and each gradient within GRAD_CAP of its own max plus GRAD_FLOOR of
# the largest gradient (the DCN biases' true gradient is 0: a BatchNorm
# follows). The random full-width model magnifies rounding along its backward
# through 40 train-mode BatchNorms and 16 DCNs: card against CPU sits at ~2%
# at the median, where cuDNN's and oneDNN's convolutions round differently.
LOSS_TOL, GRAD_CAP, GRAD_FLOOR = 1e-3, 0.2, 5e-4
ROUTE_TOL = {0.5: 1e-2, 0.9: 3e-2}
CPU_TOL = {0.5: 5e-2, 0.9: 1e-1}
TRAIN_BATCH = 32  # SOLVER.IMS_PER_BATCH of Base-CenterNet.yaml
TRAIN_STEPS = 6  # the first TRAIN_WARMUP are not timed
TRAIN_WARMUP = 2
PROFILED_STEP = 4
# offset regimes of the kernel phases: 0 px (the zero-initialised offset
# convs every DCN starts training with), about a pixel (normal, σ = 1 px:
# the seeded train step's offsets), uniform within ±8 px and within ±40 px
REGIMES = ("zero", "1px", "8px", "40px")
CSRC = "detectron2_centernet_tpu_torch/ops/csrc/"
PALLAS = "detectron2_centernet_tpu/ops/pallas_dcn.py:"
KERNELS = {  # name: (wrapper, source, TPU kernel it replaces)
    "dcn_fwd": (dcn.modulated_deform_conv, CSRC + "dcn_fwd.cu", PALLAS + "76"),
    "dcn_bwd_dx": (dcn.dcn_bwd_dx, CSRC + "dcn_bwd.cu", PALLAS + "670"),
    "dcn_bwd_dq": (dcn.dcn_bwd_dq, CSRC + "dcn_bwd.cu", PALLAS + "724"),
    "dcn_bwd_dw": (dcn.dcn_bwd_dw, CSRC + "dcn_bwd.cu", PALLAS + "796"),
    "dcn_bwd_dqdw": (dcn.dcn_bwd_dqdw, CSRC + "dcn_bwd.cu", PALLAS + "852"),
}
PLAIN = {
    "dcn_fwd": plain.modulated_deform_conv, "dcn_bwd_dx": plain.dcn_bwd_dx,
    "dcn_bwd_dq": plain.dcn_bwd_dq, "dcn_bwd_dw": plain.dcn_bwd_dw,
    "dcn_bwd_dqdw": plain.dcn_bwd_dqdw,
}


def reset_launches():
    for wrapper, _, _ in KERNELS.values():
        wrapper.launches = 0


def read_launches():
    return {name: wrapper.launches for name, (wrapper, _, _) in KERNELS.items()}


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
        "INPUT.TRAIN_SIZE", (512, 512),
        "INPUT.TEST_SIZE", (512, 512),
        "DATASETS.TRAIN", ("coco_2017_train",),
        "DATASETS.TEST", ("coco_2017_val",),
        "SOLVER.IMS_PER_BATCH", TRAIN_BATCH,
        "SOLVER.BASE_LR", 2.5e-4,
        "SOLVER.STEPS", (90000, 120000),
        "SOLVER.MAX_ITER", 140000,
        "SOLVER.CHECKPOINT_PERIOD", 10000,
        "TEST.BATCH_SIZE", 16,
        "TPU.DTYPE", dtype,
        "OUTPUT_DIR", "output/chip_smoke",
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


def dcn_case(b, cin, cout, hw, dtype, seed, regime="8px"):
    """Inputs of one DCN launch on the card: x, offset (of one of REGIMES),
    mask, weight and the output cotangent g; the bias and the epilogue."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.rand(*s, generator=g, device="cuda")
    n = lambda *s: torch.randn(*s, generator=g, device="cuda")
    x = n(b, cin, hw, hw).to(dtype)
    offset = {"zero": lambda: torch.zeros(b, 18, hw, hw, device="cuda"),
              "1px": lambda: n(b, 18, hw, hw),
              "8px": lambda: (r(b, 18, hw, hw) * 2 - 1) * 8.0,
              "40px": lambda: (r(b, 18, hw, hw) * 2 - 1) * 40.0}[regime]()
    mask = r(b, 9, hw, hw)
    weight = (n(cout, cin, 3, 3) / math.sqrt(9 * cin)).to(dtype)
    cot = n(b, cout, hw, hw).to(dtype)
    bias = n(cout) * 0.1
    scale = r(cout) + 0.5
    shift = n(cout) * 0.1
    epilogue = dict(post_scale=scale, post_shift=shift + scale * bias, post_relu=True)
    return (x, offset, mask, weight), cot, dict(bias=bias), epilogue


def kernel_call(name, args, cot, kw=None):
    """(kernel, plain) callables of one kernel on one case."""
    x, offset, mask, weight = args
    if name == "dcn_fwd":
        return (lambda: dcn.modulated_deform_conv(*args, **(kw or {})),
                lambda: plain.modulated_deform_conv(*args, **(kw or {})))
    if name == "dcn_bwd_dw":
        a = (x, offset, mask, cot)
    else:
        a = (x, offset, mask, weight, cot)
    return lambda: KERNELS[name][0](*a), lambda: PLAIN[name](*a)


def dcn_bound(name, b, cin, cout, hw, dtype):
    """Least time of one launch, (ops_ms, bytes_ms): operations over the peak
    rate (the contractions on the bf16 tensor cores or the f32 pipes, the
    per-sample elementwise work on the f32 pipes, the two at once) and bytes
    over the HBM rate (each input read once, each output written once)."""
    es = torch.tensor([], dtype=dtype).element_size()
    pix = b * hw * hw
    x_b, q_b, w_b, y_b = pix * cin * es, pix * 27 * 4, cout * cin * 9 * es, pix * cout * es
    gemm = 2.0 * 9 * cin * cout * pix
    samples = 9.0 * cin * pix
    nbytes, gemms, elementwise = {
        "dcn_fwd": (x_b + q_b + w_b + 2 * cout * 4 + y_b, 1, 8),
        "dcn_bwd_dx": (q_b + w_b + y_b + x_b, 1, 8),
        "dcn_bwd_dq": (x_b + q_b + w_b + y_b + q_b, 1, 8 + 12),
        "dcn_bwd_dw": (x_b + q_b + y_b + w_b, 1, 8),
        "dcn_bwd_dqdw": (x_b + q_b + w_b + y_b + q_b + w_b, 2, 8 + 12),
    }[name]
    if dtype == torch.bfloat16:
        ops_s = max(gemms * gemm / PEAK_BF16, elementwise * samples / PEAK_F32)
    else:
        ops_s = (gemms * gemm + elementwise * samples) / PEAK_F32
    return ops_s * 1e3, nbytes / PEAK_BYTES * 1e3


def bound_of(ops_ms, bytes_ms):
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def rel_err(got, want):
    return (got.float() - want.float()).abs().max().item() / max(want.float().abs().max().item(), 1e-30)


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def phase_kernels_vs_plain(report):
    print("== 3. every kernel against its plain version (batch 2; offsets 0, ~1 px, ±8 px, ±40 px)")
    rows, bad = [], []
    for cin, cout, hw, _ in DLA_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for regime in REGIMES:
                args, cot, kw_bias, kw_epi = dcn_case(2, cin, cout, hw, dtype, seed=cin + cout + hw, regime=regime)
                cases = [("dcn_fwd", kw_bias), ("dcn_fwd", kw_epi)] + [(k, None) for k in KERNELS if k != "dcn_fwd"]
                errs = {}
                for name, kw in cases:
                    run, ref = kernel_call(name, args, cot, kw)
                    got, want = run(), ref()
                    torch.cuda.synchronize()
                    got, want = as_tuple(got), as_tuple(want)
                    err = max(rel_err(a, b) for a, b in zip(got, want))
                    finite = all(bool(torch.isfinite(a).all()) for a in got)
                    # dW (the last output of K4 and K5) carries no atomics: the same bits again
                    same = name not in ("dcn_bwd_dw", "dcn_bwd_dqdw") or torch.equal(got[-1], as_tuple(run())[-1])
                    label = name + ("+epilogue" if kw is kw_epi else "")
                    errs[label] = err
                    row = dict(kernel=label, cin=cin, cout=cout, hw=hw, dtype=str(dtype).split(".")[1],
                               regime=regime, max_rel_err=err, tol=TOL[dtype], bit_identical=same,
                               ok=finite and same and err <= TOL[dtype],
                               max_abs_err=max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want)))
                    rows.append(row)
                    if not row["ok"]:
                        bad.append(row)
                print(f"  {cin:4d}->{cout:<4d} @{hw:3d}^2 {str(dtype).split('.')[1]:8s} {regime:4s} "
                      f"tol {TOL[dtype]:.0e}: " + " ".join(f"{k}={v:.1e}" for k, v in errs.items()))
    report["kernel_vs_plain"] = rows
    if bad:
        raise SystemExit(f"kernels disagree with their plain versions: {bad}")
    print("  dW of dcn_bwd_dw and dcn_bwd_dqdw: bit-identical over two launches in every case")

    print("  K3 and K4 through the autograd Function (weight, or offset and mask, frozen):")
    reset_launches()
    for cin, cout, hw, _ in DLA_SHAPES:
        args, cot, _, _ = dcn_case(2, cin, cout, hw, torch.bfloat16, seed=hw)
        for frozen in ("weight", "offset_mask"):
            need = (True, frozen != "offset_mask", frozen != "offset_mask", frozen != "weight")
            ts = [t.clone().requires_grad_(n) for t, n in zip(args, need)]
            dcn.modulated_deform_conv_ad(*ts).backward(cot)
            grads = [t.grad for t in ts if t.grad is not None]
            ref = (plain.dcn_bwd_dq(*args, cot) if frozen == "weight"
                   else (plain.dcn_bwd_dw(*args[:3], cot),))
            for got, want in zip(grads[1:], ref):
                if rel_err(got, want) > TOL[torch.bfloat16]:
                    raise SystemExit(f"autograd {frozen}-frozen gradient disagrees at {cin}->{cout} @{hw}")
    torch.cuda.synchronize()
    phase = read_launches()
    print(f"  launches in this phase: {phase}")
    if phase["dcn_bwd_dq"] != len(DLA_SHAPES) or phase["dcn_bwd_dw"] != len(DLA_SHAPES):
        raise SystemExit("the autograd Function did not route to K3 and K4")
    report["autograd_phase_launches"] = phase
    label = lambda k: k + "+epilogue" if k == "dcn_fwd" else k
    return {k: max(r["max_abs_err"] for r in rows if r["dtype"] == "bfloat16" and r["kernel"] == label(k))
            for k in KERNELS}, phase


def letterboxed(rng, dev, n, size):
    return torch.stack([
        warp_image(im, letterbox_transform(*im.shape[:2], size), size, device=dev).permute(2, 0, 1)
        for im in (rng.randint(0, 256, (480, 640, 3)).astype(np.uint8) for _ in range(n))])


def phase_inference(report, weights, seed=0):
    print("== 4. inference: ctdet DLA-34, 512x512, 80 classes, bf16, DefaultPredictor")
    cfg = ctdet_dla34_cfg("bfloat16")
    size = tuple(cfg.INPUT.TEST_SIZE)
    rng = np.random.RandomState(seed + 1)
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
    batch = letterboxed(rng, model.device, cfg.TEST.BATCH_SIZE, size)

    reset_launches()
    per_forward, outputs = [], []
    for img in images:
        before = dcn.modulated_deform_conv.launches
        outputs.append(predictor(img)["instances"])
        per_forward.append(dcn.modulated_deform_conv.launches - before)
    before = dcn.modulated_deform_conv.launches
    dets = model.predict_fn(batch)
    torch.cuda.synchronize()
    per_forward.append(dcn.modulated_deform_conv.launches - before)
    launches = read_launches()
    for h in hooks:
        h.remove()

    print(f"  launches: {launches}; dcn_fwd per forward {per_forward}")
    if per_forward != [16] * len(per_forward) or sum(launches.values()) != launches["dcn_fwd"]:
        raise SystemExit(f"expected 16 dcn_fwd launches per forward and no other, got {launches}")
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
    report["inference"] = dict(launches=launches, per_forward=per_forward,
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


class StepClock(HookBase):
    """Wall time of every train step, the card synchronized at its end, and
    a torch.profiler table of step ``profiled``."""

    def __init__(self, profiled: int):
        self.times, self.profiled, self.table, self._prof = [], profiled, None, None

    def before_step(self):
        torch.cuda.synchronize()
        if self.trainer.iter == self.profiled:
            self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self._prof.__enter__()
        self._t0 = time.perf_counter()

    def after_step(self):
        torch.cuda.synchronize()
        self.times.append((time.perf_counter() - self._t0) * 1e3)
        if self._prof is not None:
            self._prof.__exit__(None, None, None)
            events = self._prof.key_averages()
            self.table = events.table(sort_by="cuda_time_total", row_limit=20, max_name_column_width=90)
            # as the table's "Self CUDA time total": kernels, not annotations
            self.device_ms = sum(e.self_device_time_total for e in events
                                 if e.device_type == DeviceType.CUDA and not e.is_user_annotation) / 1e3
            self.profiled_ms = self.times[-1]
            self._prof = None


def phase_training(report, weights):
    print(f"== 5. training: DefaultTrainer, ctdet DLA-34, 512², batch {TRAIN_BATCH}, bf16, "
          f"synthetic coco_2017_train, {TRAIN_STEPS} steps")
    cfg = ctdet_dla34_cfg("bfloat16")
    cfg.SOLVER.MAX_ITER = TRAIN_STEPS
    ensure_synthetic_datasets(cfg.DATASETS.TRAIN)
    trainer = DefaultTrainer(cfg)
    if trainer.model.num_classes != 80 or trainer.model.device_augment is None:
        raise SystemExit("the trainer's model is not the 80-class ctdet with device color jitter")
    trainer.model.model.load_state_dict(weights)
    trainer.resume_or_load(resume=False)
    clock = StepClock(PROFILED_STEP)
    trainer.register_hooks([clock])
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    trainer.train()
    torch.cuda.synchronize()
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  launches: {launches} over {TRAIN_STEPS} steps")
    want = {"dcn_fwd": 16, "dcn_bwd_dx": 16, "dcn_bwd_dq": 0, "dcn_bwd_dw": 0, "dcn_bwd_dqdw": 16}
    # the profiled step launches the kernels once more inside the profiler; it
    # is one of the TRAIN_STEPS, so the count per step is exact
    if launches != {k: v * TRAIN_STEPS for k, v in want.items()}:
        raise SystemExit(f"expected per step {want}, got {launches} over {TRAIN_STEPS} steps")
    losses = {}
    for k in ("hm_loss", "wh_loss", "off_loss", "total_loss"):
        values = [v for v, _ in trainer.storage.history(k).values()]
        if len(values) != TRAIN_STEPS or not all(math.isfinite(v) for v in values):
            raise SystemExit(f"{k} is not finite at every step: {values}")
        losses[k] = values
        print(f"  {k}: " + " ".join(f"{v:.4f}" for v in values))
    timed = clock.times[TRAIN_WARMUP:]
    step_ms = statistics.median(timed)
    data_ms = statistics.median(v for v, _ in trainer.storage.history("data_time").values()) * 1e3
    print(f"  step times (ms, synchronized): {' '.join(f'{t:.1f}' for t in clock.times)}")
    print(f"  train step {step_ms:.1f} ms median of {len(timed)} = {TRAIN_BATCH * 1e3 / step_ms:.1f} img/s; "
          f"waiting for data {data_ms:.1f} ms median; peak memory {peak_gib:.2f} GiB")
    print(f"  device time by op over one train step ({clock.device_ms:.1f} ms on the card in a "
          f"{clock.profiled_ms:.1f} ms step: busy {100 * clock.device_ms / clock.profiled_ms:.0f}%):")
    print(clock.table)
    loader = build_detection_train_loader(cfg)
    next(loader)
    t0 = time.perf_counter()
    for _ in range(3):
        next(loader)
    loader_ms = (time.perf_counter() - t0) / 3 * 1e3
    loader.close()
    print(f"  the train loader alone, card idle: {loader_ms:.1f} ms per batch of {TRAIN_BATCH} "
          f"({cfg.DATALOADER.NUM_WORKERS} mapper threads, {os.cpu_count()} CPUs)")
    report["training"] = dict(launches=launches, losses=losses, step_ms=clock.times,
                              step_ms_median=step_ms, img_per_s=TRAIN_BATCH * 1e3 / step_ms,
                              data_ms_median=data_ms, peak_gib=peak_gib, profile=clock.table,
                              profiled_step_ms=clock.profiled_ms, profiled_device_ms=clock.device_ms,
                              loader_ms_per_batch=loader_ms)
    return launches


def phase_f32_step(report, weights):
    print("== 6. one f32 train step of one 512² image: card against CPU (TF32 off)")
    # uniform noise: a flat synthetic scene leaves whole channels of the
    # batch-1 BatchNorms with almost no variance, where f32 rounding is
    # magnified by 1/sqrt(eps) and the comparison says nothing of the kernels
    cfg = ctdet_dla34_cfg("float32")
    rng = np.random.RandomState(5)
    batch = {
        "image": torch.from_numpy(rng.uniform(0, 255, (1, 3, 512, 512)).astype(np.float32)),
        "gt_boxes": torch.tensor([[[40.0, 60.0, 300.0, 400.0], [200.0, 80.0, 500.0, 300.0],
                                   [10.0, 10.0, 60.0, 44.0]]]),
        "gt_classes": torch.tensor([[1, 17, 79]]),
        "gt_valid": torch.tensor([[True, True, True]]),
    }
    out = {}
    threads = torch.get_num_threads()
    runs = (("card", "cuda", False), ("card_plain", "cuda", True), ("cpu", "cpu", False))
    for run, device, plain_route in runs:
        cfg.MODEL.DEVICE = device
        m = build_model(cfg)
        m.model.load_state_dict(weights)
        m.model.train()
        t0 = time.perf_counter()
        with plain_dcn_route(plain_route):
            total, losses = m.loss_fn({k: v.to(m.device) for k, v in batch.items()})
            total.backward()
        grads = {k: p.grad.detach().cpu() for k, p in m.model.named_parameters() if p.grad is not None}
        out[run] = ({k: v.item() for k, v in losses.items()}, grads, time.perf_counter() - t0)
    (lc, gc, _), (_, gp, _), (lh, gh, th) = out["card"], out["card_plain"], out["cpu"]
    print(f"  loss terms card {lc}, CPU {lh} (CPU step {th:.1f} s on {threads} threads)")
    for k, v in lh.items():
        if not abs(lc[k] - v) <= LOSS_TOL * abs(v):
            raise SystemExit(f"{k}: card {lc[k]} vs CPU {v} beyond {LOSS_TOL} relative")
    if not set(gc) == set(gh) == set(gp):
        raise SystemExit("the runs have gradients for different parameters")
    # error of each gradient relative to its own max |value|
    rel = lambda a, b: (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
    q = lambda rows, f: rows[min(int(f * len(rows)), len(rows) - 1)][0]
    result = {}
    for name, got, want, limits in (("kernels vs plain route, card", gc, gp, ROUTE_TOL),
                                    ("card vs CPU", gc, gh, CPU_TOL)):
        rows = sorted((rel(got[k], g), k) for k, g in want.items())
        quant = {f: q(rows, f) for f in limits}
        print(f"  {name}: {len(rows)} gradients, error / own max |value|: "
              + ", ".join(f"{f:.0%} quantile {v:.2e} (limit {limits[f]:.0e})" for f, v in quant.items())
              + "; worst " + ", ".join(f"{k} {e:.2e}" for e, k in rows[-3:]))
        for f, v in quant.items():
            if v > limits[f]:
                raise SystemExit(f"{name}: the {f:.0%} quantile {v:.2e} is above {limits[f]:.0e}")
        result[name] = dict(quantiles=quant, worst=rows[-10:])
    floor = GRAD_FLOOR * max(g.abs().max().item() for g in gh.values())
    for k, g in gh.items():
        if (gc[k] - g).abs().max().item() > GRAD_CAP * g.abs().max().item() + floor:
            raise SystemExit(f"gradient of {k}: card vs CPU beyond {GRAD_CAP} of its scale + {floor:.2e}")
    report["f32_step"] = dict(loss_card=lc, loss_cpu=lh, cpu_seconds=th, **result)


class plain_dcn_route:
    """Within the block (when ``on``), the DCN autograd Function runs the plain
    PyTorch versions on the card in place of the five kernels."""

    NAMES = ("modulated_deform_conv", "dcn_bwd_dx", "dcn_bwd_dq", "dcn_bwd_dw", "dcn_bwd_dqdw")

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        if self.on:
            self.saved = {n: getattr(dcn, n) for n in self.NAMES}
            for n in self.NAMES:
                setattr(dcn, n, getattr(plain, n))

    def __exit__(self, *exc):
        if self.on:
            for n, fn in self.saved.items():
                setattr(dcn, n, fn)


def phase_kernel_timing(report):
    print("== 7. kernel times (CUDA events after warm-up; bf16)")
    rows = []
    for cin, cout, hw, count in DLA_SHAPES:
        for name in KERNELS:
            row = dict(kernel=name, cin=cin, cout=cout, hw=hw, count=count)
            for b in (1, TRAIN_BATCH):
                if name == "dcn_fwd" and b == TRAIN_BATCH:
                    b = 16  # the forward at predict_fn's batch, as slice 1 measured it
                args, cot, _, kw = dcn_case(b, cin, cout, hw, torch.bfloat16, seed=7)
                run, ref = kernel_call(name, args, cot, kw if name == "dcn_fwd" else None)
                row[f"ms_b{b}"] = cuda_ms(run, iters=10 if b > 1 else 30)
                row[f"bound_ms_b{b}"], row[f"bound_by_b{b}"] = bound_of(*dcn_bound(name, b, cin, cout, hw, torch.bfloat16))
                if b == 1:
                    row["plain_ms_b1"] = cuda_ms(ref, iters=5, warmup=2)
                    row["ops_ms_b1"], row["bytes_ms_b1"] = dcn_bound(name, 1, cin, cout, hw, torch.bfloat16)
                del args, cot
            rows.append(row)
            big = 16 if name == "dcn_fwd" else TRAIN_BATCH
            print(f"  {name:12s} {cin:4d}->{cout:<4d} @{hw:3d}^2 x{count}: b1 {row['ms_b1']:.4f} ms "
                  f"(plain {row['plain_ms_b1']:.4f}, bound {row['bound_ms_b1']:.4f} {row['bound_by_b1']}) | "
                  f"b{big} {row[f'ms_b{big}']:.4f} ms (bound {row[f'bound_ms_b{big}']:.4f} {row[f'bound_by_b{big}']})")
    # K2 and K5, the train step's backward kernels, in the other offset regimes
    for row in rows:
        if row["kernel"] not in ("dcn_bwd_dx", "dcn_bwd_dqdw"):
            continue
        for regime in ("zero", "1px"):
            for b in (1, TRAIN_BATCH):
                args, cot, _, _ = dcn_case(b, row["cin"], row["cout"], row["hw"], torch.bfloat16, seed=7, regime=regime)
                run, _ = kernel_call(row["kernel"], args, cot)
                row[f"ms_b{b}_{regime}"] = cuda_ms(run, iters=10 if b > 1 else 30)
                del args, cot
    totals = {}
    for name in KERNELS:
        mine = [r for r in rows if r["kernel"] == name]
        big = 16 if name == "dcn_fwd" else TRAIN_BATCH
        t = {k: sum(r[k] * r["count"] for r in mine)
             for k in ("ms_b1", "plain_ms_b1", "bound_ms_b1", "ops_ms_b1", "bytes_ms_b1",
                       f"ms_b{big}", f"bound_ms_b{big}")}
        t["bound_by_b1"] = bound_of(t["ops_ms_b1"], t["bytes_ms_b1"])[1]
        t["big_batch"] = big
        totals[name] = t
        print(f"  {name:12s} 16 launches of one pass: b1 {t['ms_b1']:.4f} ms (plain {t['plain_ms_b1']:.4f}, "
              f"bound {t['bound_ms_b1']:.4f} {t['bound_by_b1']}); b{big} {t[f'ms_b{big}']:.4f} ms "
              f"(bound {t[f'bound_ms_b{big}']:.4f})")
        if name in ("dcn_bwd_dx", "dcn_bwd_dqdw"):
            t["regimes"], shares = {}, []
            for b in (1, big):
                for regime in ("zero", "1px", "8px"):
                    key = f"ms_b{b}" + ("" if regime == "8px" else f"_{regime}")
                    ms = t["regimes"][f"b{b} {regime}"] = sum(r[key] * r["count"] for r in mine)
                    shares.append(f"b{b} {regime} {ms:.4f} ms ({t[f'bound_ms_b{b}'] / ms:.1%} of bound)")
            print(f"  {name:12s} by offset regime, 16 launches: " + "; ".join(shares))

    report["kernel_timing"] = dict(per_shape=rows, per_pass=totals)
    return totals


def phase_inference_timing(report, predictor, batch, images):
    print("== 4c. inference times (host clock for requests, CUDA events for predict_fn; bf16)")
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            model.predict_fn(one)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=15, max_name_column_width=90)
    print("  device time by op over 3 batch-1 forwards:")
    print(table)
    report["inference_timing"] = dict(predictor_ms=lat, predict_fn_b1_ms=fwd1_ms,
                                      predict_fn_b16_ms=batch_ms, img_per_s=ips, profile_b1=table)


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

    print("== 2. build (one nvcc per source, started together)")
    built = dcn.build_libraries()
    for name, b in built.items():
        print(f"  {b['path'].name}: {b['seconds']:.1f} s")
        for line in b["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("    " + line.strip())
    report["build_s"] = {k: v["seconds"] for k, v in built.items()}
    resources = dcn.kernel_resources()
    for name, by_dtype in resources.items():
        print(f"  {name}: " + "; ".join(
            f"{dt} {r['smem_bytes']} B shared, {r['blocks_per_sm']} blocks = {r['warps_per_sm']} warps per SM"
            for dt, r in by_dtype.items()))
    report["backward_resources"] = resources

    max_err, phase_launches = phase_kernels_vs_plain(report)
    rng = np.random.RandomState(0)
    calib = letterboxed(rng, "cpu", 2, (512, 512))
    weights = seeded_weights(ctdet_dla34_cfg("float32"), calib, seed=0)
    predictor, batch, images, inference = phase_inference(report, weights)
    phase_inference_timing(report, predictor, batch, images)
    training = phase_training(report, weights)
    phase_f32_step(report, weights)
    totals = phase_kernel_timing(report)

    kernels = []
    for name, (_, source, replaces) in KERNELS.items():
        t = totals[name]
        main_path = inference[name] + training[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": main_path or phase_launches[name],
            "launches_from": "main path (inference + training)" if main_path
            else "autograd phase (weight or offset/mask frozen); 0 on the main path",
            "launches_inference": inference[name], "launches_training": training[name],
            "max_abs_err": max_err[name], "ms": t["ms_b1"], "plain_ms": t["plain_ms_b1"],
            "bound_ms": t["bound_ms_b1"], "bound_by": t["bound_by_b1"], "library_ms": None,
            "per": "16 launches, the DLA-34 shapes at batch 1, bf16",
            f"ms_b{t['big_batch']}": t[f"ms_b{t['big_batch']}"],
            f"bound_ms_b{t['big_batch']}": t[f"bound_ms_b{t['big_batch']}"],
            **({"ms_by_regime": t["regimes"]} if "regimes" in t else {}),
        })
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    print(f"== done in {report['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
