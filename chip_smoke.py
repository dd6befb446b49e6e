#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``detectron2_centernet_tpu_torch``) on
one NVIDIA card: ctdet DLA-34 at full width, inference through the port's
``DefaultPredictor`` and training through its ``DefaultTrainer``, with every
DCN on the hand-written Hopper kernels (K1 forward, K2-K5 backward); then
the ResNet-18/50-deconv and VoVNet-39 configs, ``tools/train_net`` and
``tools/bench``, and RetinaNet R50-FPN. Every config is read from its YAML
file (``configs/COCO-Detection/``) by the port's own reader.

Phases (any failure raises and the script exits non-zero):
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build both kernel libraries (``ops/csrc/dcn_fwd.cu``, ``dcn_bwd.cu``),
     one nvcc each, at once, and the COCO matcher (``ops/csrc/cocoeval.cpp``,
     g++) beside them, and print each kernel's registers and spills,
     and the shared memory and resident warps per SM of K1 (at each Cout
     tile) and of the backward kernels;
  3. every kernel against its plain PyTorch version at the seven DCN shapes
     of DLA-34 at 512x512, batch 2, f32 and bf16, in four offset regimes:
     0 (every sample on the grid), about 1 px (normal), up to ±8 px and up
     to ±40 px (uniform; beyond K2's halo and off the map): K1 with the
     epilogue on and off, K2-K5 on a random cotangent, and K1's output and
     dW of K4 and K5 the same bit for bit over two launches; then K3 and K4
     through the autograd Function (weight, or offset and mask, frozen), the
     only way they launch;
  4. the inference path: ``DefaultPredictor`` on three seeded images and
     ``CenterNet.predict_fn`` on one batch of 16, bf16, 16 K1 launches per
     forward; the f32 heads of one image on the card against the CPU, with
     TF32 off and again with cuDNN's TF32 flags at PyTorch's defaults (the
     model's own ``ieee_f32`` context must keep them f32; the error with that
     context bypassed is printed beside it);
  4c. ``tools/bench.py``'s inference numbers (request latency, ``predict_fn``
     img/s at batch 16), ``predict_fn`` at batch 1 and its profile;
  4d. evaluation: ``DefaultTrainer.test`` (the test loader with the
     letterbox, ``inference_on_dataset``, ``COCOEvaluator``) on a synthetic
     stand-in for coco_2017_val (64 images of 480x640), bf16, batch 16: 16
     K1 launches per batch, a complete and finite bbox AP dict, the C++ and
     the numpy COCO evaluators equal on the same detections, the eval's
     img/s (CUDA events) and the loop's own timing;
  5. the training path: ``DefaultTrainer`` on the synthetic stand-in for
     coco_2017_train (80 classes, warped to 512²), batch 32, bf16, color
     jitter on the card, SGD at the config's LR, ``tools/bench.py``'s
     steps (2 warm-up, 4 timed, 1 more profiled) and clocks: each step
     launches 16 x K1, K2 and K5, every loss is finite, peak memory printed,
     and the profiled step's device time per DCN kernel;
  5b. ``DefaultTrainer`` at batch 32 for 4 steps with PreciseBN (2 batches)
     and ``TEST.EVAL_PERIOD`` 0: PreciseBN and then ``EvalHook`` fire after
     the last step, the final checkpoint holds PreciseBN's statistics;
  6. f32 train steps of 512² images: the loss terms and every parameter's
     gradient, through the kernels on the card against the same step
     through the plain versions on the card (batch 1 and batch 4; and, only
     reported, batch 1 with the BatchNorms in eval mode, whose statistics
     from the calibration images blow these activations up) and on the
     CPU; and K2 and K5 against their plain versions on each DCN's inputs
     and output gradient captured in the batch-1 step;
  8a. ``ctdet_res_18_1x.yaml``, ``ctdet_res_50_1x.yaml`` and
     ``ctdet_vovnet2_39_1x.yaml`` read without PyYAML;
  8b. each of them at full width, bf16, 512², 80 classes: ``DefaultPredictor``
     detections, the f32 heads card against CPU, and ``tools/bench.py``'s
     numbers on seeded weights: request latency, ``predict_fn`` img/s at
     batch 16, and for ResNet-18 and VoVNet-39 its train steps at batch 32
     (step time, the card's busy share, peak memory); no DCN kernel launches;
  8c. ``tools/train_net`` on ``ctdet_res_18_1x.yaml`` (6 steps at batch 32
     on synthetic data), then ``--eval-only --resume`` on its checkpoint:
     resumed at iteration 6, the same evaluation dict, no DCN launch;
  8d. ``tools/bench`` on ctdet DLA-34; its JSON line is printed;
  9. RetinaNet, ``retinanet_R_50_FPN_1x.yaml`` at full width (ResNet-50
     FrozenBN, FPN 256, P6/P7, 80 classes, 9 anchors, 4-conv towers), bf16,
     no DCN kernel launched anywhere in it: (a) ``DefaultPredictor`` on
     three seeded images letterboxed to 800² and ``predict_fn`` on a batch
     of 16, with seeded weights that detect (``retinanet_weights``), the
     detections not empty; (b) the f32 ``cls_score`` and ``bbox_pred`` of
     every level, card against CPU, and the port's NMS on the card and on
     the CPU on the same candidates; (c) ``tools/bench`` on the config at
     ``TEST.BATCH_SIZE`` 16: request latency, img/s, the train step at 16 ×
     640², busy share, peak memory, every loss finite; (d)
     ``tools/train_net`` 4 steps, then ``--eval-only --resume``: resumed at
     4, the same finite COCO dict; (e) the batch-1 ``predict_fn`` profile,
     the NMS loop's share of its time and launches, and the device time at
     batch 16;
  7. kernel times.
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
import logging
import math
import os
import shutil
import statistics
import sys
import tempfile
import time
from contextlib import contextmanager, nullcontext, redirect_stdout

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from detectron2_centernet_tpu_torch.config import get_cfg
from detectron2_centernet_tpu_torch.data import (DatasetCatalog, MetadataCatalog, build_detection_train_loader,
                                                 letterbox_transform, warp_image)
from detectron2_centernet_tpu_torch.data.datasets import register_synthetic_instances
from detectron2_centernet_tpu_torch.engine import DefaultPredictor, DefaultTrainer, hooks
from detectron2_centernet_tpu_torch.evaluation import COCOEval
from detectron2_centernet_tpu_torch.evaluation import evaluator as eval_loop
from detectron2_centernet_tpu_torch.models import build_model
from detectron2_centernet_tpu_torch.models import layers
from detectron2_centernet_tpu_torch.models.layers import DCNv2, DeformConvV2
from detectron2_centernet_tpu_torch.models.meta_arch import centernet
from detectron2_centernet_tpu_torch.ops import dcn, fast_cocoeval
from detectron2_centernet_tpu_torch.ops.nms import batched_nms_fixed
from detectron2_centernet_tpu_torch.ops import deform_conv as plain
from detectron2_centernet_tpu_torch.tools import bench

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
# f32 train steps. The loss terms, card against CPU, within LOSS_TOL relative.
# The gradients, as quantiles over the parameters of error / own max |value|:
# the kernel route against the plain route on the card (same cuDNN, so only
# the five kernels differ) within ROUTE_TOL_B1 at batch 1 and ROUTE_TOL at
# batch 4; the card against the CPU within CPU_TOL, and each gradient within
# GRAD_CAP of its own max plus GRAD_FLOOR of the largest gradient (the DCN
# biases' true gradient is 0: a BatchNorm follows). The random full-width
# model magnifies rounding along its backward through 40 train-mode
# BatchNorms and 16 DCNs: the route gap halves from batch 1 (4.77e-3 / 1.07e-2
# at the median / 90th percentile) to batch 4 (2.43e-3 / 7.08e-3) while K2 and
# K5 agree with their plain versions to 9e-7 on every DCN's captured inputs,
# so it is the BatchNorms' magnification, not a kernel (ROADMAP C10); the
# limits sit 25-40% above those measurements. Card against CPU sits at ~2% at
# the median, where cuDNN's and oneDNN's convolutions round differently.
LOSS_TOL, GRAD_CAP, GRAD_FLOOR = 1e-3, 0.2, 5e-4
ROUTE_TOL_B1 = {0.5: 6e-3, 0.9: 1.5e-2}
ROUTE_TOL = {0.5: 3e-3, 0.9: 1e-2}
CPU_TOL = {0.5: 5e-2, 0.9: 1e-1}
TRAIN_BATCH = 32  # SOLVER.IMS_PER_BATCH of Base-CenterNet.yaml
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


def ctdet_cfg(name: str, dtype: str):
    """``configs/COCO-Detection/<name>.yaml`` (over Base-CenterNet.yaml) read
    by the port's own YAML reader, with the run's compute width, output
    directory and seed over it."""
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join("configs", "COCO-Detection", name + ".yaml"))
    cfg.merge_from_list(["TPU.DTYPE", dtype, "OUTPUT_DIR", "output/chip_smoke", "SEED", 0])
    return cfg


DLA = "ctdet_dla_34_1x"


def seeded_weights(cfg, images: torch.Tensor, seed: int) -> dict:
    """Random weights from ``seed``, on the CPU in f32: the model's own init,
    random offset convs (N(0, 1/fan_in): offsets of about a pixel), and
    BatchNorm (and FrozenBatchNorm) statistics measured on ``images`` so
    activations keep their scale through the layers (with identity
    statistics they fade or grow, and the heatmap is flat). Returns the
    state dict for every model of the run."""
    cfg = cfg.clone()
    cfg.MODEL.DEVICE = "cpu"
    cfg.TPU.DTYPE = "float32"
    host = build_model(cfg)
    g = torch.Generator().manual_seed(seed)
    bns = [m for m in host.model.modules() if isinstance(m, torch.nn.BatchNorm2d)]

    def calibrate(frozen, inputs):  # a FrozenBatchNorm's statistics := this batch's (biased, as flax's)
        x = inputs[0].float()
        frozen.running_mean.copy_(x.mean((0, 2, 3)))
        frozen.running_var.copy_(x.var((0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(calibrate) for m in host.model.modules()
             if isinstance(m, layers.FrozenBatchNorm)]
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
    for h in hooks:
        h.remove()
    return host.model.state_dict()


cuda_ms = bench.Clock("cuda").ms  # mean ms per call, CUDA events


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
                    # K1's output and dW (the last output of K4 and K5) carry no atomics: the same bits again
                    same = name not in ("dcn_fwd", "dcn_bwd_dw", "dcn_bwd_dqdw") or torch.equal(got[-1], as_tuple(run())[-1])
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
    print("  dcn_fwd's output and dW of dcn_bwd_dw and dcn_bwd_dqdw: bit-identical over two launches in every case")

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


def check_detections(name, img, inst, score_threshold):
    """Some detections, finite, inside the image, above the threshold, of the 80 classes."""
    b, (h, w) = inst.pred_boxes.tensor, img.shape[:2]
    if not (len(inst) > 0 and np.isfinite(b).all() and np.isfinite(inst.scores).all()
            and (b[:, [0, 2]] <= w).all() and (b[:, [1, 3]] <= h).all() and (b >= 0).all()
            and (inst.scores > score_threshold).all() and (inst.pred_classes < 80).all()):
        raise SystemExit(f"{name}: bad detections for a {h}x{w} image: {inst}")


def phase_inference(report, weights, seed=0):
    print("== 4. inference: ctdet DLA-34, 512x512, 80 classes, bf16, DefaultPredictor")
    cfg = ctdet_cfg(DLA, "bfloat16")
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
        check_detections(DLA, img, inst, model.score_threshold)
        print(f"  request {img.shape[0]}x{img.shape[1]}: {len(inst)} detections, top score {inst.scores.max():.4f}")
    n = cfg.TEST.BATCH_SIZE
    if not (dets["boxes"].shape == (n, 100, 4) and dets["scores"].shape == (n, 100)
            and bool(torch.isfinite(dets["boxes"]).all()) and bool(torch.isfinite(dets["scores"]).all())):
        raise SystemExit("predict_fn returned malformed detections")
    print(f"  predict_fn batch {n}: boxes {tuple(dets['boxes'].shape)}, all finite")
    report["inference"] = dict(launches=launches, per_forward=per_forward,
                               detections=[len(i) for i in outputs])

    print("== 4b. f32 head outputs of one image: card against CPU (TF32 off for the process)")
    cfg32 = ctdet_cfg(DLA, "float32")
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

    print("== 4b. the same f32 heads with cuDNN's TF32 flags at PyTorch's defaults (ROADMAP C9)")
    c9 = {}
    for run, bypass in (("ieee_f32", False), ("ieee_f32 bypassed", True)):
        with pytorch_default_tf32(), (bypass_ieee_f32() if bypass else nullcontext()), torch.inference_mode():
            zd = card.model(card.normalize(x))
        c9[run] = {k: (zd[k].float().cpu() - zh[k]).abs().max().item() for k in ("hm", "wh", "reg")}
    for k in ("hm", "wh", "reg"):
        scale = head_err[k]["scale"]
        ok = c9["ieee_f32"][k] <= HEAD_TOL * max(scale, 1.0)
        print(f"  {k}: max_abs_err={c9['ieee_f32'][k]:.3e} (tol {HEAD_TOL:.0e} x max(scale, 1)) "
              f"{'ok' if ok else 'FAIL'}; with the context bypassed (TF32): {c9['ieee_f32 bypassed'][k]:.3e}")
        if not ok:
            raise SystemExit(f"the card's f32 {k} head at PyTorch's default TF32 flags differs from the CPU's")
    report["heads_card_vs_cpu_default_tf32_flags"] = c9
    return predictor, batch, launches


@contextmanager
def pytorch_default_tf32():
    """cuDNN's and cuBLAS's TF32 flags at PyTorch's defaults (cuDNN's on,
    cuBLAS's off) within the block; this script's own setting after it."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@contextmanager
def bypass_ieee_f32():
    """CenterNetModel.forward without its ``ieee_f32`` context (what the
    repair of ROADMAP C9 prevents), within the block."""
    saved = centernet.ieee_f32
    centernet.ieee_f32 = nullcontext
    try:
        yield
    finally:
        centernet.ieee_f32 = saved


EVAL_IMAGES, EVAL_SIZE = 64, (480, 640)  # the synthetic stand-in for coco_2017_val
BBOX_KEYS = ("AP", "AP50", "AP75", "APs", "APm", "APl")


def phase_evaluation(report, weights, out_dir):
    print(f"== 4d. evaluation: DefaultTrainer.test, ctdet DLA-34, 512², bf16, synthetic coco_2017_val "
          f"({EVAL_IMAGES} images of {EVAL_SIZE[0]}x{EVAL_SIZE[1]}), batch 16")
    cfg = ctdet_cfg(DLA, "bfloat16")
    cfg.OUTPUT_DIR = out_dir
    register_synthetic_instances("coco_2017_val", num_images=EVAL_IMAGES, image_size=EVAL_SIZE)
    model = build_model(cfg)
    model.model.load_state_dict(weights)
    batches = -(-EVAL_IMAGES // cfg.TEST.BATCH_SIZE)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    reset_launches()
    start.record()
    results = DefaultTrainer.test(cfg, model)
    end.record()
    end.synchronize()
    launches = read_launches()
    stats = dict(eval_loop.LAST_INFERENCE_STATS)
    eval_ms = start.elapsed_time(end)
    print(f"  launches: {launches} over {batches} batches")
    if launches != {k: 16 * batches if k == "dcn_fwd" else 0 for k in KERNELS}:
        raise SystemExit(f"expected {16 * batches} dcn_fwd launches (16 per batch) and no other, got {launches}")
    with open(os.path.join(out_dir, "coco_instances_results.json")) as f:
        dets = json.load(f)
    with open(os.path.join(out_dir, "coco_2017_val_coco_format.json")) as f:
        gt = json.load(f)
    # complete: the six numbers and a per-class AP for each of the 80 classes;
    # finite: all six, and the per-class AP of every class with a ground-truth
    # box (COCO's per-class AP of a class without one is NaN)
    bbox = results.get("bbox", {})
    names = [c["name"] for c in gt["categories"]]
    present = {names[a["category_id"]] for a in gt["annotations"]}
    if not (all(k in bbox and math.isfinite(bbox[k]) for k in BBOX_KEYS) and len(names) == 80
            and all(f"AP-{n}" in bbox for n in names)
            and all(math.isfinite(bbox[f"AP-{n}"]) == (n in present) for n in names)):
        raise SystemExit(f"the bbox AP dict is not complete and finite: {bbox}")
    print("  bbox: " + ", ".join(f"{k} {bbox[k]:.4f}" for k in BBOX_KEYS)
          + f"; 80 per-class APs, finite for the {len(present)} classes with a ground-truth box")
    # the C++ matcher (the port's cocoeval.cpp) against the numpy evaluator on the same detections
    img_ids = [im["id"] for im in gt["images"]]
    cat_ids = [c["id"] for c in gt["categories"]]
    evals = {}
    for name, cls in (("fast", fast_cocoeval.FastCOCOEval), ("numpy", COCOEval)):
        t0 = time.perf_counter()
        ev = cls(gt["annotations"], dets, img_ids, cat_ids)
        ev.evaluate()
        evals[name] = (ev.summarize(), ev.per_category_ap(), time.perf_counter() - t0)
    (fs, fc, ft), (ns, nc, nt) = evals["fast"], evals["numpy"]
    same = np.array_equal(fs, ns) and all(fc[k] == nc[k] or (math.isnan(fc[k]) and math.isnan(nc[k])) for k in nc)
    print(f"  {len(dets)} detections: FastCOCOEval ({ft:.2f} s) and numpy COCOEval ({nt:.2f} s) "
          f"stats and per-category APs {'equal' if same else 'DIFFER'}; stats {np.round(fs, 6).tolist()}")
    if not same or not np.isclose(fs[0] * 100, bbox["AP"]):
        raise SystemExit("the fast and the numpy COCO evaluators disagree on the same detections")
    img_s = EVAL_IMAGES * 1e3 / eval_ms
    busy = stats.get("device_s", float("nan")) / stats["wall_s"]
    print(f"  DefaultTrainer.test: {eval_ms:.1f} ms by CUDA events = {img_s:.1f} img/s (loader, letterbox, "
          f"forward, decode, postprocess and COCO evaluation); forward spans on the stream "
          f"{stats.get("device_s", float("nan")) * 1e3:.1f} ms of the loop's {stats['wall_s'] * 1e3:.1f} ms ({busy:.0%})")
    print("  LAST_INFERENCE_STATS: " + json.dumps(stats))
    report["evaluation"] = dict(launches=launches, batches=batches, bbox=bbox, detections=len(dets),
                                eval_ms=eval_ms, img_per_s=img_s, forward_share=busy,
                                fast_vs_numpy_equal=same, fast_s=ft, numpy_s=nt, inference_stats=stats)
    return launches


def phase_train_with_eval(report, weights, out_dir):
    print(f"== 5b. DefaultTrainer, batch {TRAIN_BATCH}, 4 steps, PreciseBN over 2 batches, EVAL_PERIOD 0")
    cfg = ctdet_cfg(DLA, "bfloat16")
    cfg.merge_from_list(["SOLVER.MAX_ITER", 4, "TEST.PRECISE_BN.ENABLED", True, "TEST.PRECISE_BN.NUM_ITER", 2,
                         "TEST.EVAL_PERIOD", 0, "TEST.EXPECTED_RESULTS", [], "OUTPUT_DIR", out_dir])
    trainer = DefaultTrainer(cfg)
    trainer.model.model.load_state_dict(weights)
    trainer.resume_or_load(resume=False)
    names = [type(h).__name__ for h in trainer._hooks]
    precise = next(h for h in trainer._hooks if isinstance(h, hooks.PreciseBN))
    evalhook = next(h for h in trainer._hooks if isinstance(h, hooks.EvalHook))
    fired, snap = [], {}
    running = lambda: {k: v.detach().clone() for k, v in trainer.model.model.state_dict().items() if "running" in k}
    update, do_eval = precise.update_stats, evalhook._do_eval

    def traced_update():
        before = running()
        update()
        fired.append(("PreciseBN", trainer.iter))
        snap.update(before=before, after=running())

    def traced_eval():
        fired.append(("EvalHook", trainer.iter))
        return do_eval()

    precise.update_stats, evalhook._do_eval = traced_update, traced_eval
    reset_launches()
    results = trainer.train()
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"  hooks {names}; fired {fired}; launches {launches}")
    if names.index("PreciseBN") > names.index("PeriodicCheckpointerHook") or names.index("EvalHook") < names.index("PeriodicCheckpointerHook"):
        raise SystemExit(f"the hooks are not in the JAX package's order: {names}")
    if fired != [("PreciseBN", 3), ("EvalHook", 4)]:
        raise SystemExit(f"expected PreciseBN after the last step and then EvalHook, got {fired}")
    eval_batches = -(-EVAL_IMAGES // cfg.TEST.BATCH_SIZE)
    want = {"dcn_fwd": 16 * (4 + 2 + eval_batches), "dcn_bwd_dx": 64, "dcn_bwd_dq": 0, "dcn_bwd_dw": 0, "dcn_bwd_dqdw": 64}
    if launches != want:
        raise SystemExit(f"expected {want} (4 steps, 2 PreciseBN forwards, {eval_batches} eval batches), got {launches}")
    saved = torch.load(os.path.join(out_dir, "model_final.pth"), map_location="cpu", weights_only=True)["model"]
    moved = max((snap["after"][k] - snap["before"][k]).abs().max().item() for k in snap["after"])
    if moved == 0 or any(not torch.equal(saved[k], v.cpu()) for k, v in snap["after"].items()):
        raise SystemExit("the final checkpoint does not hold PreciseBN's statistics")
    bbox = results["bbox"]
    if not all(math.isfinite(bbox[k]) for k in BBOX_KEYS):
        raise SystemExit(f"the end-of-training evaluation is not finite: {bbox}")
    print(f"  the final checkpoint holds PreciseBN's {len(snap['after'])} statistics (they moved by up to "
          f"{moved:.3e}); end-of-training bbox AP {bbox['AP']:.4f}")
    report["train_with_eval"] = dict(hooks=names, fired=fired, launches=launches, bbox=bbox, precise_bn_moved=moved)
    return launches


def dcn_device_ms(events) -> dict:
    """Device ms of each DCN kernel family in a profiler's ``key_averages()``,
    helpers included: K1 with its staging and split sum, K2, K3-K5 with their
    split sum."""
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    families = {"dcn_fwd": ("dcn_fwd",), "dcn_bwd_dx": ("dcn_bwd_dx",), "dcn_bwd_wq": ("dcn_bwd_wq", "sum_splits")}
    return {f: sum(e.self_device_time_total for e in kernels if any(k in e.key for k in keys)) / 1e3
            for f, keys in families.items()}


def phase_training(report, weights):
    steps = bench.TRAIN_WARMUP + bench.TRAIN_STEPS + 1
    print(f"== 5. training: DefaultTrainer, ctdet DLA-34, 512², batch {TRAIN_BATCH}, bf16, synthetic "
          f"coco_2017_train, tools/bench.py's {steps} steps (the last one profiled)")
    reset_launches()
    numbers, trainer, clock = bench.bench_training(ctdet_cfg(DLA, "bfloat16"), weights)
    torch.cuda.synchronize()
    launches = read_launches()
    if trainer.model.num_classes != 80 or trainer.model.device_augment is None:
        raise SystemExit("the trainer's model is not the 80-class ctdet with device color jitter")
    print(f"  launches: {launches} over {steps} steps")
    want = {"dcn_fwd": 16, "dcn_bwd_dx": 16, "dcn_bwd_dq": 0, "dcn_bwd_dw": 0, "dcn_bwd_dqdw": 16}
    if launches != {k: v * steps for k, v in want.items()}:
        raise SystemExit(f"expected per step {want}, got {launches} over {steps} steps")
    losses = {}
    for k in ("hm_loss", "wh_loss", "off_loss", "total_loss"):
        values = [v for v, _ in trainer.storage.history(k).values()]
        if len(values) != steps or not all(math.isfinite(v) for v in values):
            raise SystemExit(f"{k} is not finite at every step: {values}")
        losses[k] = values
        print(f"  {k}: " + " ".join(f"{v:.4f}" for v in values))
    step_ms = numbers["train_step_ms"]
    data_ms = statistics.median(v for v, _ in trainer.storage.history("data_time").values()) * 1e3
    table = clock.events.table(sort_by="cuda_time_total", row_limit=20, max_name_column_width=90)
    dcn_ms = dcn_device_ms(clock.events)
    print(f"  step times (ms, synchronized): {' '.join(f'{t:.1f}' for t in clock.times)}; "
          f"the profiled step {clock.profiled_ms:.1f}")
    print(f"  train step {step_ms:.1f} ms median of {bench.TRAIN_STEPS} = {numbers['train_img_s']:.1f} img/s; "
          f"waiting for data {data_ms:.1f} ms median; peak memory {numbers['peak_memory_gib']:.2f} GiB")
    print(f"  device time by op over the profiled step ({clock.device_ms:.1f} ms on the card: busy "
          f"{numbers['train_busy_share']:.0%} of the median step):")
    print(table)
    print("  DCN kernels in the profiled step (ms of device time, helpers included): "
          + ", ".join(f"{k} {v:.3f}" for k, v in dcn_ms.items()))
    loader = build_detection_train_loader(trainer.cfg)
    next(loader)
    t0 = time.perf_counter()
    for _ in range(3):
        next(loader)
    loader_ms = (time.perf_counter() - t0) / 3 * 1e3
    loader.close()
    print(f"  the train loader alone, card idle: {loader_ms:.1f} ms per batch of {TRAIN_BATCH} "
          f"({trainer.cfg.DATALOADER.NUM_WORKERS} mapper threads, {os.cpu_count()} CPUs)")
    report["training"] = dict(launches=launches, losses=losses, step_ms=clock.times, **numbers,
                              data_ms_median=data_ms, profile=table, profiled_step_ms=clock.profiled_ms,
                              profiled_device_ms=clock.device_ms, profiled_dcn_ms=dcn_ms,
                              loader_ms_per_batch=loader_ms)
    return launches


def f32_batch(n):
    """n uniform-noise 512² images (a flat synthetic scene leaves whole
    channels of the batch-1 BatchNorms with almost no variance, where f32
    rounding is magnified by 1/sqrt(eps) and the comparison says nothing of
    the kernels) with three boxes each."""
    rng = np.random.RandomState(5)
    return {
        "image": torch.from_numpy(rng.uniform(0, 255, (n, 3, 512, 512)).astype(np.float32)),
        "gt_boxes": torch.tensor([[[40.0, 60.0, 300.0, 400.0], [200.0, 80.0, 500.0, 300.0],
                                   [10.0, 10.0, 60.0, 44.0]]] * n),
        "gt_classes": torch.tensor([[1, 17, 79]] * n),
        "gt_valid": torch.tensor([[True, True, True]] * n),
    }


def phase_f32_step(report, weights):
    print("== 6. f32 train steps of 512² images: kernels against plain versions, card against CPU (TF32 off)")
    cfg = ctdet_cfg(DLA, "float32")
    out = {}
    threads = torch.get_num_threads()
    captured = []  # each DCN's inputs and output gradient in the kernel route's step
    # (run, device, plain DCN route, batch, BatchNorms in eval mode)
    runs = (("card", "cuda", False, 1, False), ("card_plain", "cuda", True, 1, False),
            ("card_b4", "cuda", False, 4, False), ("card_plain_b4", "cuda", True, 4, False),
            ("card_bn_eval", "cuda", False, 1, True), ("card_plain_bn_eval", "cuda", True, 1, True),
            ("cpu", "cpu", False, 1, False))
    for run, device, plain_route, n, bn_eval in runs:
        cfg.MODEL.DEVICE = device
        m = build_model(cfg)
        m.model.load_state_dict(weights)
        m.model.train()
        if bn_eval:
            for mod in m.model.modules():
                if isinstance(mod, torch.nn.BatchNorm2d):
                    mod.eval()
        t0 = time.perf_counter()
        with plain_dcn_route(plain_route), capture_dcn(captured if run == "card" else None):
            total, losses = m.loss_fn({k: v.to(m.device) for k, v in f32_batch(n).items()})
            total.backward()
        grads = {k: p.grad.detach().cpu() for k, p in m.model.named_parameters() if p.grad is not None}
        out[run] = ({k: v.item() for k, v in losses.items()}, grads, time.perf_counter() - t0)
    for run, (loss, _, _) in out.items():
        print(f"  {run}: loss terms " + ", ".join(f"{k} {v:.6g}" for k, v in loss.items()))

    print(f"  K2 and K5 against their plain versions on the {len(captured)} DCNs' captured inputs "
          f"and output gradients (batch 1, f32, tol {TOL[torch.float32]:.0e} of the plain output's max |value|):")
    layer_errs = []
    for i, c in enumerate(captured):
        args = (c["x"], c["offset"], c["mask"], c["weight"], c["g"])
        errs = {"dcn_bwd_dx": rel_err(dcn.dcn_bwd_dx(*args), plain.dcn_bwd_dx(*args))}
        errs.update({f"dcn_bwd_dqdw {part}": rel_err(a, b) for part, a, b in zip(
            ("d offset", "d mask", "dW"), dcn.dcn_bwd_dqdw(*args), plain.dcn_bwd_dqdw(*args))})
        shape = f"{c['x'].shape[1]}->{c['weight'].shape[0]} @{c['x'].shape[2]}^2"
        layer_errs.append(dict(layer=i, shape=shape, **errs))
        print(f"    DCN {i:2d} {shape}: " + " ".join(f"{k}={v:.1e}" for k, v in errs.items()))
        if max(errs.values()) > TOL[torch.float32]:
            raise SystemExit(f"DCN {i} ({shape}): a backward kernel differs from its plain version: {errs}")

    (lc, gc, _), (lh, gh, th) = out["card"], out["cpu"]
    print(f"  CPU step {th:.1f} s on {threads} threads")
    for k, v in lh.items():
        if not abs(lc[k] - v) <= LOSS_TOL * abs(v):
            raise SystemExit(f"{k}: card {lc[k]} vs CPU {v} beyond {LOSS_TOL} relative")
    if len({frozenset(g) for _, g, _ in out.values()}) != 1:
        raise SystemExit("the runs have gradients for different parameters")
    # error of each gradient relative to its own max |value|
    rel = lambda a, b: (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
    q = lambda rows, f: rows[min(int(f * len(rows)), len(rows) - 1)][0]
    result = {}
    for name, got, want, limits in (
        ("kernels vs plain route, card, batch 1", "card", "card_plain", ROUTE_TOL_B1),
        ("kernels vs plain route, card, batch 4", "card_b4", "card_plain_b4", ROUTE_TOL),
        ("kernels vs plain route, card, batch 1, BatchNorm in eval mode (reported)",
         "card_bn_eval", "card_plain_bn_eval", None),
        ("card vs CPU, batch 1", "card", "cpu", CPU_TOL),
    ):
        got, want = out[got][1], out[want][1]
        rows = sorted((rel(got[k], g), k) for k, g in want.items())
        quant = {f: q(rows, f) for f in (0.5, 0.9)}
        print(f"  {name}: {len(rows)} gradients, error / own max |value|: "
              + ", ".join(f"{f:.0%} quantile {v:.2e}" + (f" (limit {limits[f]:.2g})" if limits else "")
                          for f, v in quant.items())
              + "; worst " + ", ".join(f"{k} {e:.2e}" for e, k in rows[-3:]))
        for f, v in quant.items():
            if limits and v > limits[f]:
                raise SystemExit(f"{name}: the {f:.0%} quantile {v:.2e} is above {limits[f]:.2g}")
        result[name] = dict(quantiles=quant, worst=rows[-10:])
    floor = GRAD_FLOOR * max(g.abs().max().item() for g in gh.values())
    for k, g in gh.items():
        if (gc[k] - g).abs().max().item() > GRAD_CAP * g.abs().max().item() + floor:
            raise SystemExit(f"gradient of {k}: card vs CPU beyond {GRAD_CAP} of its scale + {floor:.2e}")
    report["f32_step"] = dict(losses={k: v[0] for k, v in out.items()}, cpu_seconds=th,
                              captured_dcn=layer_errs, **result)


@contextmanager
def capture_dcn(records):
    """Within the block (when ``records`` is a list), every differentiable
    DCN of the model appends its inputs and, in the backward, the gradient
    of its output to ``records``."""
    if records is None:
        yield
        return
    orig = layers.modulated_deform_conv_ad

    def capturing(x, offset, mask, weight, bias=None):
        out = orig(x, offset, mask, weight, bias)
        rec = dict(x=x.detach(), offset=offset.detach(), mask=mask.detach(), weight=weight.detach())
        out.register_hook(lambda g: rec.__setitem__("g", g.detach().clone()))
        records.append(rec)
        return out

    layers.modulated_deform_conv_ad = capturing
    try:
        yield
    finally:
        layers.modulated_deform_conv_ad = orig


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


def timed_batches(name):
    """(batch, epilogue) of each launch phase 7 times: K1 at batch 1 and at
    predict_fn's 16 with the eval epilogue, and at the trained batch without
    it (the train step's call); K2-K5 at batch 1 and the trained batch."""
    if name == "dcn_fwd":
        return ((1, True), (16, True), (TRAIN_BATCH, False))
    return ((1, False), (TRAIN_BATCH, False))


REGIME_TIMED = ("dcn_fwd", "dcn_bwd_dx", "dcn_bwd_dqdw")  # the main path's kernels


def phase_kernel_timing(report):
    print("== 7. kernel times (CUDA events after warm-up; bf16)")
    rows = []
    for cin, cout, hw, count in DLA_SHAPES:
        for name in KERNELS:
            row = dict(kernel=name, cin=cin, cout=cout, hw=hw, count=count)
            for b, epi in timed_batches(name):
                for regime in ("8px", "zero", "1px") if name in REGIME_TIMED else ("8px",):
                    args, cot, _, kw = dcn_case(b, cin, cout, hw, torch.bfloat16, seed=7, regime=regime)
                    run, ref = kernel_call(name, args, cot, kw if epi else None)
                    row[f"ms_b{b}" + ("" if regime == "8px" else f"_{regime}")] = cuda_ms(run, iters=10 if b > 1 else 30)
                    if regime == "8px":
                        row[f"bound_ms_b{b}"], row[f"bound_by_b{b}"] = bound_of(*dcn_bound(name, b, cin, cout, hw, torch.bfloat16))
                    if regime == "8px" and b == 1:
                        row["plain_ms_b1"] = cuda_ms(ref, iters=5, warmup=2)
                        row["ops_ms_b1"], row["bytes_ms_b1"] = dcn_bound(name, 1, cin, cout, hw, torch.bfloat16)
                    del args, cot
            rows.append(row)
            print(f"  {name:12s} {cin:4d}->{cout:<4d} @{hw:3d}^2 x{count}: b1 {row['ms_b1']:.4f} ms "
                  f"(plain {row['plain_ms_b1']:.4f}, bound {row['bound_ms_b1']:.4f} {row['bound_by_b1']})"
                  + "".join(f" | b{b} {row[f'ms_b{b}']:.4f} ms (bound {row[f'bound_ms_b{b}']:.4f} {row[f'bound_by_b{b}']})"
                            for b, _ in timed_batches(name)[1:]))
    totals = {}
    for name in KERNELS:
        mine = [r for r in rows if r["kernel"] == name]
        bigs = [b for b, _ in timed_batches(name)[1:]]
        t = {k: sum(r[k] * r["count"] for r in mine)
             for k in ("ms_b1", "plain_ms_b1", "bound_ms_b1", "ops_ms_b1", "bytes_ms_b1",
                       *(f"ms_b{b}" for b in bigs), *(f"bound_ms_b{b}" for b in bigs))}
        t["bound_by_b1"] = bound_of(t["ops_ms_b1"], t["bytes_ms_b1"])[1]
        t["big_batches"] = bigs
        totals[name] = t
        print(f"  {name:12s} 16 launches of one pass: b1 {t['ms_b1']:.4f} ms (plain {t['plain_ms_b1']:.4f}, "
              f"bound {t['bound_ms_b1']:.4f} {t['bound_by_b1']})"
              + "".join(f"; b{b} {t[f'ms_b{b}']:.4f} ms (bound {t[f'bound_ms_b{b}']:.4f})" for b in bigs))
        if name in REGIME_TIMED:
            t["regimes"], shares = {}, []
            for b in (1, *bigs):
                for regime in ("zero", "1px", "8px"):
                    key = f"ms_b{b}" + ("" if regime == "8px" else f"_{regime}")
                    ms = t["regimes"][f"b{b} {regime}"] = sum(r[key] * r["count"] for r in mine)
                    shares.append(f"b{b} {regime} {ms:.4f} ms ({t[f'bound_ms_b{b}'] / ms:.1%} of bound)")
            print(f"  {name:12s} by offset regime, 16 launches: " + "; ".join(shares))

    report["kernel_timing"] = dict(per_shape=rows, per_pass=totals)
    return totals


def phase_inference_timing(report, predictor, batch):
    print("== 4c. inference times (tools/bench.py's: host clock for requests, CUDA events for predict_fn; bf16)")
    numbers = bench.bench_inference(predictor)
    model = predictor.model
    one = batch[:1].contiguous()
    fwd1_ms = cuda_ms(lambda: model.predict_fn(one), iters=20)
    print(f"  DefaultPredictor request (480x640): median {numbers['predictor_latency_ms']:.3f} ms of "
          f"{bench.REQUESTS}; predict_fn batch 1: {fwd1_ms:.3f} ms; batch {numbers['batch']}: "
          f"{numbers['predict_fn_ms']:.3f} ms = {numbers['img_s']:.1f} img/s")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            model.predict_fn(one)
        torch.cuda.synchronize()
    events = prof.key_averages()
    table = events.table(sort_by="cuda_time_total", row_limit=15, max_name_column_width=90)
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA and not e.is_user_annotation) / 1e3
    dcn_ms = dcn_device_ms(events)
    print(f"  device time by op over 3 batch-1 forwards ({device_ms:.3f} ms; K1 with its helpers "
          f"{dcn_ms['dcn_fwd']:.3f} ms):")
    print(table)
    report["inference_timing"] = dict(**numbers, predict_fn_b1_ms=fwd1_ms, profile_b1=table,
                                      profile_b1_device_ms=device_ms, profile_b1_dcn_ms=dcn_ms)


NEW_CONFIGS = ("ctdet_res_18_1x", "ctdet_res_50_1x", "ctdet_vovnet2_39_1x")
NEW_TRAINED = ("ctdet_res_18_1x", "ctdet_vovnet2_39_1x")


def phase_configs(report):
    print("== 8a. the ResNet and VoVNet configs through the port's YAML reader")
    rows = {}
    for name in NEW_CONFIGS:
        cfg = ctdet_cfg(name, "bfloat16")
        m, c = cfg.MODEL, cfg.MODEL.CENTERNET
        body = (f"VoVNet {m.VOVNET.CONV_BODY}" if "vovnet" in m.BACKBONE.NAME
                else f"ResNet-{m.RESNETS.DEPTH} (RES2_OUT_CHANNELS {m.RESNETS.RES2_OUT_CHANNELS}, NORM "
                     f"{m.RESNETS.NORM}, FREEZE_AT {m.BACKBONE.FREEZE_AT})")
        rows[name] = dict(backbone=m.BACKBONE.NAME, body=body, head_conv=c.HEAD_CONV,
                          test_size=list(cfg.INPUT.TEST_SIZE), train_batch=cfg.SOLVER.IMS_PER_BATCH)
        print(f"  {name}: {m.BACKBONE.NAME}, {body}, HEAD_CONV {c.HEAD_CONV}, TEST_SIZE "
              f"{tuple(cfg.INPUT.TEST_SIZE)}, IMS_PER_BATCH {cfg.SOLVER.IMS_PER_BATCH}")
    if "yaml" in sys.modules:
        raise SystemExit("PyYAML was imported: the port must read configs with its own reader")
    print("  PyYAML not imported (the port's config/yaml_io.py read every file)")
    report["new_configs"] = rows


def phase_backbones(report):
    """(b): each new config at full width, seeded weights: DefaultPredictor
    detections, the f32 heads card against CPU, and tools/bench.py's
    inference numbers (bf16), and for R18 and VoVNet-39 its train steps at
    batch 32; no DCN kernel may launch."""
    out = {}
    steps = bench.TRAIN_WARMUP + bench.TRAIN_STEPS + 1
    for name in NEW_CONFIGS:
        print(f"== 8b. {name}: inference (bf16, 512², 80 classes), f32 heads card vs CPU"
              + (f", {steps} train steps at batch {TRAIN_BATCH}" if name in NEW_TRAINED else ""))
        rng = np.random.RandomState(3)
        cfg = ctdet_cfg(name, "bfloat16")
        size = tuple(cfg.INPUT.TEST_SIZE)
        weights = seeded_weights(ctdet_cfg(name, "float32"), letterboxed(rng, "cpu", 2, size), seed=0)
        reset_launches()
        predictor = DefaultPredictor(cfg)
        model = predictor.model
        model.model.load_state_dict(weights)
        for h, w in ((480, 640), (512, 512), (375, 500)):
            img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            check_detections(name, img, predictor(img)["instances"], model.score_threshold)
        batch = letterboxed(rng, model.device, cfg.TEST.BATCH_SIZE, size)
        dets = model.predict_fn(batch)
        n = cfg.TEST.BATCH_SIZE
        if not (dets["boxes"].shape == (n, 100, 4) and bool(torch.isfinite(dets["boxes"]).all())
                and bool(torch.isfinite(dets["scores"]).all())):
            raise SystemExit(f"{name}: predict_fn returned malformed detections")
        row = bench.bench_inference(predictor)
        print(f"  DefaultPredictor request 480x640: median {row['predictor_latency_ms']:.3f} ms of "
              f"{bench.REQUESTS}; predict_fn batch {n}: {row['predict_fn_ms']:.3f} ms = {row['img_s']:.1f} img/s")
        del predictor, model

        cfg32 = ctdet_cfg(name, "float32")
        card = build_model(cfg32)
        cfg32.MODEL.DEVICE = "cpu"
        host = build_model(cfg32)
        for m in (card, host):
            m.model.load_state_dict(weights)
        with torch.inference_mode():
            zc = card.model(card.normalize(batch[:1]))
            zh = host.model(host.normalize(batch[:1].cpu()))
        row["heads_card_vs_cpu"] = {}
        for k in ("hm", "wh", "reg"):
            err = (zc[k].float().cpu() - zh[k]).abs().max().item()
            scale = zh[k].abs().max().item()
            row["heads_card_vs_cpu"][k] = dict(max_abs_err=err, scale=scale)
            ok = bool(torch.isfinite(zc[k]).all()) and err <= HEAD_TOL * max(scale, 1.0)
            print(f"  f32 {k}: max_abs_err={err:.3e} (scale {scale:.3e}, tol {HEAD_TOL:.0e} x max(scale, 1)) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"{name}: the card's f32 {k} head differs from the CPU's")
        del card, host

        if name in NEW_TRAINED:
            numbers, trainer, clock = bench.bench_training(ctdet_cfg(name, "bfloat16"), weights)
            losses = [v for v, _ in trainer.storage.history("total_loss").values()]
            if len(losses) != steps or not all(math.isfinite(v) for v in losses):
                raise SystemExit(f"{name}: the total loss is not finite at every step: {losses}")
            row.update(numbers, train_step_ms_all=clock.times, profiled_step_ms=clock.profiled_ms,
                       profiled_device_ms=clock.device_ms, total_loss=losses)
            print(f"  train: total loss {' '.join(f'{v:.4f}' for v in losses)}; step times (ms) "
                  f"{' '.join(f'{t:.1f}' for t in clock.times)}, the profiled one {clock.profiled_ms:.1f}; "
                  f"median of {bench.TRAIN_STEPS} {numbers['train_step_ms']:.1f} ms = "
                  f"{numbers['train_img_s']:.1f} img/s; card busy {clock.device_ms:.1f} ms = "
                  f"{numbers['train_busy_share']:.0%} of the median step; peak memory "
                  f"{numbers['peak_memory_gib']:.2f} GiB")
            print(clock.events.table(sort_by="cuda_time_total", row_limit=20, max_name_column_width=90))
            del trainer
        torch.cuda.synchronize()
        launches = read_launches()
        print(f"  DCN kernel launches on this path: {launches}")
        if any(launches.values()):
            raise SystemExit(f"{name}: the path launched DCN kernels: {launches}")
        row["launches"] = launches
        out[name] = row
        torch.cuda.empty_cache()
    report["new_backbones"] = out
    return out


def same_results(a, b) -> bool:
    """Equal result dicts, NaN equal to NaN (the AP of a class with no box)."""
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def fresh_synthetic_val():
    """coco_2017_val as the synthetic stand-in, afresh (its metadata may name a
    COCO json an earlier phase cached in a directory since removed)."""
    os.environ["DETECTRON2_SYNTH_DATA"] = "1"
    for catalog in (DatasetCatalog, MetadataCatalog):
        if "coco_2017_val" in catalog:
            catalog.remove("coco_2017_val")
    register_synthetic_instances("coco_2017_val", num_images=EVAL_IMAGES, image_size=EVAL_SIZE)


def run_train_net(argv, log_path):
    """``tools/train_net`` with ``argv``, then ``--eval-only --resume`` with
    the same, in this process, their output in ``log_path``: (the training's
    results, the evaluation's, the iterations each run started at, training
    seconds, evaluation seconds)."""
    from detectron2_centernet_tpu_torch.engine import default_argument_parser, launch
    from detectron2_centernet_tpu_torch.tools import train_net
    from detectron2_centernet_tpu_torch.utils.logger import setup_logger

    resumed = []
    resume_or_load = train_net.Trainer.resume_or_load

    def recording(self, resume=True):
        resume_or_load(self, resume=resume)
        resumed.append(self.start_iter)

    train_net.Trainer.resume_or_load = recording
    try:
        with open(log_path, "w") as log, redirect_stdout(log):
            t0 = time.perf_counter()
            trained = launch(train_net.main, args=(default_argument_parser().parse_args(argv),))
            t1 = time.perf_counter()
            evaluated = launch(train_net.main,
                               args=(default_argument_parser().parse_args(["--eval-only", "--resume"] + argv),))
            t2 = time.perf_counter()
            pkg = logging.getLogger("detectron2_centernet_tpu_torch")
            for h in list(pkg.handlers):  # the entry point's handlers write to this log
                pkg.removeHandler(h)
                h.close()
            pkg.propagate = True
            setup_logger.cache_clear()
    finally:
        train_net.Trainer.resume_or_load = resume_or_load
    torch.cuda.synchronize()
    return trained, evaluated, resumed, t1 - t0, t2 - t1


def phase_train_net(report, out_dir):
    print(f"== 8c. tools/train_net on ctdet_res_18_1x.yaml: 6 steps at batch {TRAIN_BATCH} (DETECTRON2_SYNTH_DATA), "
          f"then --eval-only --resume on the {EVAL_IMAGES} synthetic coco_2017_val images")
    argv = ["--config-file", "configs/COCO-Detection/ctdet_res_18_1x.yaml", "SOLVER.MAX_ITER", "6",
            "SOLVER.IMS_PER_BATCH", str(TRAIN_BATCH), "OUTPUT_DIR", out_dir, "SEED", "0"]
    fresh_synthetic_val()
    log_path = "output/chip_smoke_train_net_log.txt"
    reset_launches()
    trained, evaluated, resumed, train_s, eval_s = run_train_net(argv, log_path)
    launches = read_launches()
    print(f"  train: {train_s:.1f} s; eval-only: {eval_s:.1f} s; iterations resumed at {resumed}; "
          f"bbox AP {trained['bbox']['AP']:.4f} / {evaluated['bbox']['AP']:.4f}; DCN launches {launches}")
    if resumed != [0, 6]:
        raise SystemExit(f"expected to start at iteration 0 and resume at 6, got {resumed}")
    if not same_results(trained, evaluated):
        raise SystemExit(f"the evaluation after training and the --eval-only --resume one differ: "
                         f"{trained['bbox']} vs {evaluated['bbox']}")
    if any(launches.values()):
        raise SystemExit(f"train_net on ResNet-18 launched DCN kernels: {launches}")
    if not os.path.exists(os.path.join(out_dir, "config.yaml")):
        raise SystemExit("default_setup did not write config.yaml")
    print(f"  the two evaluation dicts are identical ({len(trained['bbox'])} bbox entries); "
          f"config.yaml written; log in {log_path}")
    report["train_net"] = dict(train_s=train_s, eval_only_s=eval_s, resumed=resumed, bbox=trained["bbox"],
                               launches=launches)
    return launches


def phase_bench(report):
    print("== 8d. tools/bench on ctdet DLA-34 (512², bf16, the YAML's TEST.BATCH_SIZE and IMS_PER_BATCH)")
    from detectron2_centernet_tpu_torch.tools import bench

    reset_launches()
    result = bench.main([])
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"  DCN launches in the bench: {launches}")
    calls = 2 + bench.ITERS + bench.REQUEST_WARMUP + bench.REQUESTS
    steps = bench.TRAIN_WARMUP + bench.TRAIN_STEPS + 1
    want = {"dcn_fwd": 16 * (calls + steps), "dcn_bwd_dx": 16 * steps, "dcn_bwd_dq": 0, "dcn_bwd_dw": 0,
            "dcn_bwd_dqdw": 16 * steps}
    if launches != want:
        raise SystemExit(f"expected {want} ({calls} forwards, {steps} train steps), got {launches}")
    keys = {"predictor_latency_ms", "train_step_ms", "train_img_s", "train_busy_share", "peak_memory_gib",
            "dtype", "card"}
    if not (result["metric"] == "ctdet_dla34_512_infer_throughput" and result["value"] > 0
            and keys <= set(result["extra"]) and all(result["extra"][k] is not None for k in keys)):
        raise SystemExit(f"the bench's line is not complete: {result}")
    report["bench"] = dict(result=result, launches=launches)
    return launches


RETINA = "retinanet_R_50_FPN_1x"
RETINA_YAML = os.path.join("configs", "COCO-Detection", RETINA + ".yaml")
RETINA_BATCH = 16  # predict_fn's batch (the YAML keeps TEST.BATCH_SIZE 1) and SOLVER.IMS_PER_BATCH
RETINA_STEPS = 4  # tools/train_net's steps in 9d


def retinanet_cfg(dtype: str):
    """``configs/COCO-Detection/retinanet_R_50_FPN_1x.yaml`` (over
    Base-RetinaNet.yaml) read by the port's own YAML reader, with the run's
    compute width, output directory and seed over it and no weights file
    (the YAML names ImageNet weights, which are not in the repository)."""
    cfg = get_cfg()
    cfg.merge_from_file(RETINA_YAML)
    cfg.merge_from_list(["TPU.DTYPE", dtype, "OUTPUT_DIR", "output/chip_smoke", "SEED", 0, "MODEL.WEIGHTS", ""])
    return cfg


def retinanet_weights(cfg, images: torch.Tensor, seed: int) -> dict:
    """Seeded weights under which the RetinaNet detects: ``seeded_weights``
    (the model's own init, FrozenBN statistics measured on ``images``), then
    the head's weights drawn anew from ``seed`` (tower convs N(0, 2/fan_in),
    so the ReLU towers keep the FPN maps' scale) and its two predictors
    scaled on the first image so that ``cls_score``'s logits spread with std
    1 around the prior-prob bias of the init (-4.6: about 5% of the scores
    above SCORE_THRESH_TEST 0.05, where the init's 0.01 everywhere leaves
    the NMS nothing to pick) and ``bbox_pred``'s deltas with std 0.1 (boxes
    near their anchors). Weights to serve with, not to train from: from
    them, SGD at the config's LR on the synthetic train scenes reached a
    NaN loss within 4 steps."""
    state = seeded_weights(cfg, images, seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for k, v in state.items():
            if k.startswith("head.") and k.endswith(".weight"):
                v.copy_(torch.randn(v.shape, generator=g) * math.sqrt(2.0 / v[0].numel()))
        cfg = cfg.clone()
        cfg.MODEL.DEVICE = "cpu"
        host = build_model(cfg)
        host.model.load_state_dict(state)
        logits, deltas = host.model(host.normalize(images[:1]))
        for name, maps, std in (("cls_score", logits, 1.0), ("bbox_pred", deltas, 0.1)):
            spread = torch.cat([(t - state[f"head.{name}.bias"].view(1, -1, 1, 1)).flatten() for t in maps]).std()
            state[f"head.{name}.weight"].mul_(std / spread.item())
    return state


def phase_retinanet(report, out_dir):
    """Phase 9: RetinaNet R50-FPN at full width through the port's entry
    points; no DCN kernel may launch on any of it."""
    cfg = retinanet_cfg("bfloat16")
    m, r = cfg.MODEL, cfg.MODEL.RETINANET
    size = tuple(cfg.INPUT.TEST_SIZE)
    print(f"== 9a. RetinaNet ({RETINA}.yaml): {m.BACKBONE.NAME}, ResNet-{m.RESNETS.DEPTH} {m.RESNETS.NORM} "
          f"FREEZE_AT {m.BACKBONE.FREEZE_AT}, FPN {m.FPN.OUT_CHANNELS} from {list(m.FPN.IN_FEATURES)}, "
          f"{r.NUM_CLASSES} classes, {r.NUM_CONVS}-conv towers, bf16: DefaultPredictor at {size[0]}², "
          f"predict_fn at batch {RETINA_BATCH}")
    if "yaml" in sys.modules:
        raise SystemExit("PyYAML was imported: the port must read configs with its own reader")
    rng = np.random.RandomState(9)
    reset_launches()
    weights = retinanet_weights(retinanet_cfg("float32"), letterboxed(rng, "cpu", 2, size), seed=0)
    predictor = DefaultPredictor(cfg)
    model = predictor.model
    model.model.load_state_dict(weights)
    anchors = sum(a.shape[0] for a in model.anchors_per_level(size))
    if not (m.RESNETS.DEPTH == 50 and m.FPN.OUT_CHANNELS == 256 and r.NUM_CLASSES == 80 and r.NUM_CONVS == 4
            and model.num_anchors_per_cell == 9 and model.dtype == torch.bfloat16 and size == (800, 800)):
        raise SystemExit(f"{RETINA} is not at full width here: {m}")
    requests = []
    for h, w in ((480, 640), (800, 800), (375, 500)):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        inst = predictor(img)["instances"]
        check_detections(RETINA, img, inst, model.score_threshold)
        requests.append(len(inst))
        print(f"  request {h}x{w}: {len(inst)} detections, top score {inst.scores.max():.4f}")
    batch = letterboxed(rng, model.device, RETINA_BATCH, size)
    dets = model.predict_fn(batch)
    valid = (dets["scores"] > model.score_threshold).sum(1).cpu()
    if not (dets["boxes"].shape == (RETINA_BATCH, 100, 4) and dets["scores"].shape == (RETINA_BATCH, 100)
            and bool(torch.isfinite(dets["boxes"]).all()) and bool(torch.isfinite(dets["scores"]).all())):
        raise SystemExit("RetinaNet's predict_fn returned malformed detections")
    if int(valid.min()) == 0:
        raise SystemExit(f"RetinaNet detected nothing in some images of the batch: {valid.tolist()}")
    print(f"  predict_fn batch {RETINA_BATCH}: boxes {tuple(dets['boxes'].shape)}, all finite; valid detections "
          f"per image {int(valid.min())}-{int(valid.max())} of 100; {anchors} anchors per image")
    out = dict(requests=requests, valid_per_image=valid.tolist(), anchors=anchors)

    print("== 9b. f32 cls_score and bbox_pred of one image, card against CPU (the model's ieee_f32); "
          "the NMS on the card and on the CPU on the same candidates")
    cfg32 = retinanet_cfg("float32")
    card = build_model(cfg32)
    cfg32.MODEL.DEVICE = "cpu"
    host = build_model(cfg32)
    for mdl in (card, host):
        mdl.model.load_state_dict(weights)
    x = batch[:1]
    with torch.inference_mode():
        zc = card.model(card.normalize(x))
        zh = host.model(host.normalize(x.cpu()))
    heads = {}
    for name, maps_c, maps_h in (("cls_score", zc[0], zh[0]), ("bbox_pred", zc[1], zh[1])):
        for level, (c, h) in enumerate(zip(maps_c, maps_h), 3):
            err = (c.float().cpu() - h).abs().max().item()
            scale = h.abs().max().item()
            ok = bool(torch.isfinite(c).all()) and err <= HEAD_TOL * max(scale, 1.0)
            heads[f"{name}_p{level}"] = dict(max_abs_err=err, scale=scale)
            print(f"  {name} p{level} {tuple(c.shape)}: max_abs_err={err:.3e} (scale {scale:.3e}, "
                  f"tol {HEAD_TOL:.0e} x max(scale, 1)) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"the card's f32 {name} at p{level} differs from the CPU's")
    del card, host
    with torch.inference_mode():
        xb = model.normalize(batch[:4])
        cands = model.candidates(*model.model(xb), xb.shape[2:])
    keep_c, valid_c = batched_nms_fixed(*cands, model.nms_threshold, model.max_detections)
    keep_h, valid_h = batched_nms_fixed(*(t.cpu() for t in cands), model.nms_threshold, model.max_detections)
    same = torch.equal(keep_c.cpu(), keep_h) and torch.equal(valid_c.cpu(), valid_h)
    print(f"  NMS of {cands[1].shape[1]} candidates x 4 images ({int(torch.isfinite(cands[1]).sum())} live): "
          f"card and CPU keep {'the same' if same else 'DIFFERENT'} indices ({int(valid_c.sum())} valid picks)")
    if not same:
        raise SystemExit("the port's NMS keeps other indices on the card than on the CPU")
    out.update(heads_card_vs_cpu=heads, nms_card_vs_cpu_equal=same, nms_candidates=int(cands[1].shape[1]))

    print(f"== 9c. tools/bench --config-file {RETINA_YAML} TEST.BATCH_SIZE {RETINA_BATCH} (the model's own init)")
    captured, bench_training = [], bench.bench_training
    bench.bench_training = lambda c, w=None: captured.append(bench_training(c, w)) or captured[-1]
    try:
        result = bench.main(["--config-file", RETINA_YAML, "TEST.BATCH_SIZE", str(RETINA_BATCH)])
    finally:
        bench.bench_training = bench_training
    extra = result["extra"]
    _, trainer, clock = captured[0]
    losses = {k: [v for v, _ in trainer.storage.history(k).values()] for k in ("loss_cls", "loss_box_reg", "total_loss")}
    steps = bench.TRAIN_WARMUP + bench.TRAIN_STEPS + 1
    keys = ("predictor_latency_ms", "train_step_ms", "train_busy_share", "peak_memory_gib")
    if not (result["metric"] == "retinanet_res50_fpn_800_infer_throughput" and result["value"] > 0
            and extra["batch"] == RETINA_BATCH and extra["train_batch"] == RETINA_BATCH
            and all(extra.get(k) is not None for k in keys)):
        raise SystemExit(f"the bench's RetinaNet line is not complete: {result}")
    if any(len(v) != steps or not all(math.isfinite(x) for x in v) for v in losses.values()):
        raise SystemExit(f"RetinaNet's bench losses are not finite at every step: {losses}")
    print(f"  {result['metric']}: {result['value']} img/s (vs_baseline {result['vs_baseline']}, against "
          f"1/0.056 s); request (480x640 → 800²) median {extra['predictor_latency_ms']:.3f} ms of {bench.REQUESTS}; "
          f"predict_fn batch {extra['batch']} {extra['predict_fn_ms']:.3f} ms")
    print(f"  train at {extra['train_batch']} x {cfg.INPUT.TRAIN_SIZE[0]}²: total loss "
          f"{' '.join(f'{v:.4f}' for v in losses['total_loss'])}; step times (ms) "
          f"{' '.join(f'{t:.1f}' for t in clock.times)}, median of {bench.TRAIN_STEPS} "
          f"{extra['train_step_ms']:.1f} ms = {extra['train_img_s']:.1f} img/s; card busy {clock.device_ms:.1f} ms = "
          f"{extra['train_busy_share']:.0%} of the median step; peak memory {extra['peak_memory_gib']:.2f} GiB")
    print(clock.events.table(sort_by="cuda_time_total", row_limit=15, max_name_column_width=90))
    out.update(bench=result, bench_losses=losses, bench_step_ms_all=clock.times,
               bench_profiled_device_ms=clock.device_ms)
    del trainer, captured

    # from the model's own init (the seeded weights above detect but are no
    # trained model: SGD at the config's LR diverges from them within 4
    # steps); the init scores every (anchor, class)
    # at the prior 0.0099, so the threshold goes under it for the evaluation
    # to have detections to score
    print(f"== 9d. tools/train_net on {RETINA}.yaml: {RETINA_STEPS} steps at batch {RETINA_BATCH} from the model's "
          f"init (DETECTRON2_SYNTH_DATA), then --eval-only --resume on the {EVAL_IMAGES} synthetic coco_2017_val "
          f"images, SCORE_THRESH_TEST 0.005")
    argv = ["--config-file", RETINA_YAML, "SOLVER.MAX_ITER", str(RETINA_STEPS), "SOLVER.IMS_PER_BATCH",
            str(RETINA_BATCH), "TEST.BATCH_SIZE", str(RETINA_BATCH), "MODEL.WEIGHTS", "",
            "MODEL.RETINANET.SCORE_THRESH_TEST", "0.005", "OUTPUT_DIR", out_dir, "SEED", "0"]
    fresh_synthetic_val()
    log_path = "output/chip_smoke_retinanet_train_net_log.txt"
    trained, evaluated, resumed, train_s, eval_s = run_train_net(argv, log_path)
    bbox = trained["bbox"]
    print(f"  train: {train_s:.1f} s; eval-only: {eval_s:.1f} s; iterations resumed at {resumed}; "
          + ", ".join(f"{k} {bbox[k]:.4f}" for k in BBOX_KEYS if k in bbox))
    if resumed != [0, RETINA_STEPS]:
        raise SystemExit(f"expected to start at iteration 0 and resume at {RETINA_STEPS}, got {resumed}")
    if not same_results(trained, evaluated):
        raise SystemExit(f"RetinaNet's evaluation after training and the --eval-only --resume one differ: "
                         f"{trained['bbox']} vs {evaluated['bbox']}")
    if not all(math.isfinite(bbox[k]) for k in BBOX_KEYS):
        raise SystemExit(f"RetinaNet's bbox AP dict is not finite: {bbox}")
    print(f"  the two evaluation dicts are identical ({len(bbox)} bbox entries); log in {log_path}")
    out.update(train_net=dict(train_s=train_s, eval_only_s=eval_s, resumed=resumed, bbox=bbox))

    print("== 9e. predict_fn at batch 1 (800², bf16): its profile, and the NMS loop's share and launches; "
          f"predict_fn's device time at batch {RETINA_BATCH}")
    one = batch[:1].contiguous()
    fwd1_ms = cuda_ms(lambda: model.predict_fn(one), iters=10)
    with torch.inference_mode():
        x1 = model.normalize(one)
        cand1 = model.candidates(*model.model(x1), x1.shape[2:])
    nms = lambda: batched_nms_fixed(*cand1, model.nms_threshold, model.max_detections)
    nms_ms = cuda_ms(nms, iters=10)
    profiles = {}
    for name, fn in (("predict_fn", lambda: model.predict_fn(one)), ("nms", nms),
                     ("predict_fn_b16", lambda: model.predict_fn(batch))):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        kernels = [e for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
        profiles[name] = dict(launches=sum(e.count for e in kernels) / 3,
                              device_ms=sum(e.self_device_time_total for e in kernels) / 3e3, events=events)
    p, q = profiles["predict_fn"], profiles["nms"]
    print(f"  predict_fn batch 1: {fwd1_ms:.3f} ms ({p['launches']:.0f} kernel launches, {p['device_ms']:.3f} ms "
          f"on the card); the NMS loop alone ({model.max_detections} picks of {cand1[1].shape[1]} candidates): "
          f"{nms_ms:.3f} ms = {nms_ms / fwd1_ms:.0%} of the call, {q['launches']:.0f} launches "
          f"({q['launches'] / p['launches']:.0%} of them), {q['device_ms']:.3f} ms on the card "
          f"({q['device_ms'] / p['device_ms']:.0%} of its device time)")
    print(p["events"].table(sort_by="cuda_time_total", row_limit=15, max_name_column_width=90))
    b16 = profiles["predict_fn_b16"]
    f32_conv_ms = sum(e.self_device_time_total for e in b16["events"] if e.device_type == DeviceType.CUDA
                      and "f32f32" in e.key and "bf16" not in e.key) / 3e3
    print(f"  predict_fn batch {RETINA_BATCH}: {b16['device_ms']:.3f} ms on the card per call "
          f"({b16['launches']:.0f} launches); cuDNN's f32 kernels (the f32 cls_score and bbox_pred) "
          f"{f32_conv_ms:.3f} ms of it")
    print(b16["events"].table(sort_by="cuda_time_total", row_limit=12, max_name_column_width=90))
    out.update(predict_fn_b1_ms=fwd1_ms, nms_b1_ms=nms_ms, nms_share=nms_ms / fwd1_ms,
               predict_fn_b1_launches=p["launches"], nms_launches=q["launches"],
               predict_fn_b1_device_ms=p["device_ms"], nms_device_ms=q["device_ms"],
               predict_fn_b16_device_ms=b16["device_ms"], predict_fn_b16_f32_conv_ms=f32_conv_ms)

    torch.cuda.synchronize()
    launches = read_launches()
    print(f"  DCN kernel launches on the RetinaNet path (9a-9e): {launches}")
    if any(launches.values()):
        raise SystemExit(f"the RetinaNet path launched DCN kernels: {launches}")
    out["launches"] = launches
    report["retinanet"] = out
    return launches


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
    smi = bench.card()
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
    t0 = time.perf_counter()
    cocoeval_lib = fast_cocoeval.build_library()
    built["cocoeval"] = {"path": cocoeval_lib, "seconds": time.perf_counter() - t0, "log": ""}
    print(f"  {cocoeval_lib.name} (g++, from {os.path.relpath(fast_cocoeval.SOURCE)}): "
          f"{built['cocoeval']['seconds']:.1f} s")
    report["build_s"] = {k: v["seconds"] for k, v in built.items()}
    resources = dcn.kernel_resources()
    for name, by_dtype in resources.items():
        print(f"  {name}: " + "; ".join(
            f"{dt} {r['smem_bytes']} B shared, {r['blocks_per_sm']} blocks = {r['warps_per_sm']} warps per SM"
            for dt, r in by_dtype.items()))
    report["kernel_resources"] = resources

    max_err, phase_launches = phase_kernels_vs_plain(report)
    rng = np.random.RandomState(0)
    calib = letterboxed(rng, "cpu", 2, (512, 512))
    weights = seeded_weights(ctdet_cfg(DLA, "float32"), calib, seed=0)
    predictor, batch, inference = phase_inference(report, weights)
    phase_inference_timing(report, predictor, batch)
    os.makedirs("output", exist_ok=True)
    scratch = tempfile.mkdtemp(prefix="chip_smoke_", dir="output")
    try:
        evaluation = phase_evaluation(report, weights, os.path.join(scratch, "eval"))
        training = phase_training(report, weights)
        train_eval = phase_train_with_eval(report, weights, os.path.join(scratch, "train_eval"))
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    phase_f32_step(report, weights)
    phase_configs(report)
    phase_backbones(report)
    scratch = tempfile.mkdtemp(prefix="chip_smoke_", dir="output")
    try:
        train_net_launches = phase_train_net(report, os.path.join(scratch, "train_net"))
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    bench_launches = phase_bench(report)
    scratch = tempfile.mkdtemp(prefix="chip_smoke_", dir="output")
    try:
        retinanet_launches = phase_retinanet(report, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    totals = phase_kernel_timing(report)

    kernels = []
    for name, (_, source, replaces) in KERNELS.items():
        t = totals[name]
        main_path = inference[name] + evaluation[name] + training[name] + train_eval[name] + bench_launches[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": main_path or phase_launches[name],
            "launches_from": "main path (inference, evaluation, training, training with PreciseBN and "
            "evaluation, the bench)" if main_path else "autograd phase (weight or offset/mask frozen); 0 on the main path",
            "launches_inference": inference[name], "launches_evaluation": evaluation[name],
            "launches_training": training[name], "launches_train_eval": train_eval[name],
            "launches_bench": bench_launches[name],
            # the ResNet-18/50 and VoVNet-39 paths (inference, training) and train_net on ResNet-18
            "launches_resnet_vovnet": sum(r["launches"][name] for r in report["new_backbones"].values())
            + train_net_launches[name],
            "launches_retinanet": retinanet_launches[name],  # phase 9, asserted 0
            "max_abs_err": max_err[name], "ms": t["ms_b1"], "plain_ms": t["plain_ms_b1"],
            "bound_ms": t["bound_ms_b1"], "bound_by": t["bound_by_b1"], "library_ms": None,
            "per": "16 launches, the DLA-34 shapes at batch 1, bf16"
            + (" (K1: with the eval epilogue at batches 1 and 16, without at 32)" if name == "dcn_fwd" else ""),
            **{f"ms_b{b}": t[f"ms_b{b}"] for b in t["big_batches"]},
            **{f"bound_ms_b{b}": t[f"bound_ms_b{b}"] for b in t["big_batches"]},
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
    print(bench.card())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
