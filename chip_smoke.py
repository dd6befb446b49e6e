#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``detectron2_centernet_tpu_torch``) on
one NVIDIA card: ctdet DLA-34 at full width, inference through the port's
``DefaultPredictor`` and training through its ``DefaultTrainer``, with every
DCN on the hand-written Hopper kernels (K1 forward, K2-K5 backward); then
the ResNet-18/50-deconv and VoVNet-39 configs, ``tools/train_net`` and
``tools/bench``, RetinaNet R50-FPN, Faster R-CNN R50-FPN with the
ProposalNetwork, Mask R-CNN and Keypoint R-CNN R50-FPN, every NMS of the R-CNN
and RetinaNet paths on the hand-written NMS kernel (``ops/csrc/nms.cu``).
Every config is read from its YAML file (``configs/COCO-Detection/``,
``COCO-InstanceSegmentation/``, ``COCO-Keypoints/``) by the port's own
reader.

Phases (any failure raises and the script exits non-zero):
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build the three kernel libraries (``ops/csrc/dcn_fwd.cu``,
     ``dcn_bwd.cu``, ``nms.cu``), one nvcc each, at once, and the COCO matcher (``ops/csrc/cocoeval.cpp``,
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
     the NMS's share of its time and launches, through the kernel and
     through the plain loop, and the device time at batch 16 (every phase-9
     path launches the NMS kernel once per call, counted);
  10. Faster R-CNN, ``faster_rcnn_R_50_FPN_1x.yaml`` at full width (ResNet-50
     FrozenBN, FPN 256 with the max-pool P6, RPN on p2-p6 with 3 anchors per
     cell, 1000/1000 proposals at test and 2000/1000 at training, 512 rois,
     80 classes), bf16, no DCN kernel anywhere: (a) ``DefaultPredictor``
     requests (median of 20, 480x640 → 800²) and ``predict_fn`` at batch 16
     with seeded weights that detect (``rcnn_weights``), the batch-1
     call's profile with the NMS kernel's share, and the same call through
     the plain NMS loop; (b) f32 at batch 2, card against CPU, each stage
     fed the card's inputs on both sides: the RPN heads, the proposals, the
     box predictor (rois that the two devices' log2 puts on different FPN
     levels are counted and left out), the detections; (c) the NMS kernel
     against its plain loop on the card, indices and validity equal, on
     the inputs the main paths gave it: RetinaNet's batch 16, the RPN's
     level rows at test and at training, the box head's batch 16 served
     (rows compacted into shared memory) and in (e)'s evaluation (rows
     swept in place), and the same three of Mask and Keypoint R-CNN (11,
     12: Keypoint R-CNN's box head of one class, its 1500 proposals at
     training), each timed beside its bound; (d) ``tools/bench`` on the config at
     ``TEST.BATCH_SIZE`` 16: request latency, img/s against 1/0.038 s, the
     train step at 16 × 800², busy share, peak memory, every loss finite;
     (e) ``tools/train_net`` 4 steps from the model's init with calibrated
     FrozenBN statistics, then ``--eval-only --resume``: resumed at 4, the
     same finite COCO dict;
     (f) ``rpn_R_50_FPN_1x.yaml``'s ProposalNetwork: one forward and one
     loss with its backward. Each path's NMS kernel launches are counted
     from 0 and checked;
  11. Mask R-CNN, ``COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.yaml``
     (phase 10's model with the mask head: 4 convs of 256 at 14², the
     deconv, 80 per-class 28² masks), and 12. Keypoint R-CNN,
     ``COCO-Keypoints/keypoint_rcnn_R_50_FPN_1x.yaml`` (one class, 1500
     proposals at training, 8 convs of 512 at 14², 17 heatmaps of 56²),
     bf16, no DCN kernel anywhere, each: (a) ``DefaultPredictor`` requests
     (median of 20, 480x640 → 800²; the pasted bool masks, or the decoded
     keypoints inside their boxes, checked) and ``predict_fn`` at batch 16
     with seeded weights that detect; (b) f32 at batch 2, card against
     CPU: the head's outputs (mask logits at the detected class, or the
     heatmaps) on the card's top 16 detection boxes of each image within
     HEAD_TOL times their scale, and out of it with cuDNN's TF32 on and
     the model's ``ieee_f32`` bypassed (the control that shows the check
     sees TF32), and the host boundary on the card's outputs (the pasted
     masks; the keypoint positions, but at ties in at most 1%) equal on
     both devices;
     (c) ``tools/bench`` at ``TEST.BATCH_SIZE`` 16 with its train steps at
     16 × 800² (busy share, peak memory, ROIAlign's ``embedding_bag``
     forward and backward in the profiled step); (d) ``tools/train_net`` 4
     steps from the calibrated init, then ``--eval-only --resume``: resumed
     at 4, the same dict with ``segm`` (or ``keypoints``) in it; the NMS
     kernel's launches counted per path, and its inputs at test (the
     RPN's, the box head's) and for the training's proposals recorded for
     10c;
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
from typing import Tuple

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
from detectron2_centernet_tpu_torch.models.meta_arch import centernet, rcnn
from detectron2_centernet_tpu_torch.ops import cuda_lib, dcn, fast_cocoeval
from detectron2_centernet_tpu_torch.ops import nms as nms_ops
from detectron2_centernet_tpu_torch.ops.nms import batched_nms_fixed
from detectron2_centernet_tpu_torch.ops import deform_conv as plain
from detectron2_centernet_tpu_torch.models.proposal_generator import rpn as rpn_ops
from detectron2_centernet_tpu_torch.models.roi_heads import roi_heads as roi_heads_ops
from detectron2_centernet_tpu_torch.ops import roi_align as roi_ops
from detectron2_centernet_tpu_torch.structures.keypoints import heatmaps_to_keypoints
from detectron2_centernet_tpu_torch.structures.masks import paste_masks_in_image
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
def bypass_ieee_f32(module=centernet):
    """``module``'s model (CenterNetModel's by default) without its
    ``ieee_f32`` context (what the repair of ROADMAP C9 prevents), within
    the block."""
    saved = module.ieee_f32
    module.ieee_f32 = nullcontext
    try:
        yield
    finally:
        module.ieee_f32 = saved


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


def fresh_synthetic_val(name: str = "coco_2017_val", keypoints: bool = False):
    """``name`` (coco_2017_val, or with ``keypoints`` the person-keypoint
    keypoints_coco_2017_val) as the synthetic stand-in, afresh (its metadata
    may name a COCO json an earlier phase cached in a directory since
    removed)."""
    os.environ["DETECTRON2_SYNTH_DATA"] = "1"
    for catalog in (DatasetCatalog, MetadataCatalog):
        if name in catalog:
            catalog.remove(name)
    register_synthetic_instances(name, num_images=EVAL_IMAGES, image_size=EVAL_SIZE, keypoints=keypoints)


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
    batch = letterboxed(rng, model.device, RETINA_BATCH, size)
    nms_launches, nms_inputs = {}, []
    nms_ops.greedy_nms.launches = 0
    for h, w in ((480, 640), (800, 800), (375, 500)):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        inst = predictor(img)["instances"]
        check_detections(RETINA, img, inst, model.score_threshold)
        requests.append(len(inst))
        print(f"  request {h}x{w}: {len(inst)} detections, top score {inst.scores.max():.4f}")
    with capture_nms(nms_inputs):
        dets = model.predict_fn(batch)
    torch.cuda.synchronize()
    nms_launches["serving"] = nms_ops.greedy_nms.launches
    if nms_launches["serving"] != 4:
        raise SystemExit(f"expected one NMS kernel launch per request and batch (4), got {nms_launches}")
    valid = (dets["scores"] > model.score_threshold).sum(1).cpu()
    if not (dets["boxes"].shape == (RETINA_BATCH, 100, 4) and dets["scores"].shape == (RETINA_BATCH, 100)
            and bool(torch.isfinite(dets["boxes"]).all()) and bool(torch.isfinite(dets["scores"]).all())):
        raise SystemExit("RetinaNet's predict_fn returned malformed detections")
    if int(valid.min()) == 0:
        raise SystemExit(f"RetinaNet detected nothing in some images of the batch: {valid.tolist()}")
    print(f"  predict_fn batch {RETINA_BATCH}: boxes {tuple(dets['boxes'].shape)}, all finite; valid detections "
          f"per image {int(valid.min())}-{int(valid.max())} of 100; {anchors} anchors per image; NMS kernel "
          f"launches {nms_launches['serving']} (one per call)")
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
          f"the kernel on the card and the plain version on the CPU keep {'the same' if same else 'DIFFERENT'} "
          f"indices ({int(valid_c.sum())} valid picks)")
    if not same:
        raise SystemExit("the NMS kernel keeps other indices on the card than the plain version on the CPU")
    out.update(heads_card_vs_cpu=heads, nms_card_vs_cpu_equal=same, nms_candidates=int(cands[1].shape[1]))

    print(f"== 9c. tools/bench --config-file {RETINA_YAML} TEST.BATCH_SIZE {RETINA_BATCH} (the model's own init)")
    captured, bench_training = [], bench.bench_training
    bench.bench_training = lambda c, w=None: captured.append(bench_training(c, w)) or captured[-1]
    nms_ops.greedy_nms.launches = 0
    try:
        result = bench.main(["--config-file", RETINA_YAML, "TEST.BATCH_SIZE", str(RETINA_BATCH)])
    finally:
        bench.bench_training = bench_training
    torch.cuda.synchronize()
    nms_launches["bench"] = nms_ops.greedy_nms.launches
    calls = 2 + bench.ITERS + bench.REQUEST_WARMUP + bench.REQUESTS
    if nms_launches["bench"] != calls:
        raise SystemExit(f"expected one NMS kernel launch per bench call ({calls}), got {nms_launches['bench']}")
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
    nms_ops.greedy_nms.launches = 0
    trained, evaluated, resumed, train_s, eval_s = run_train_net(argv, log_path)
    nms_launches["train_net"] = nms_ops.greedy_nms.launches
    if nms_launches["train_net"] != 2 * -(-EVAL_IMAGES // RETINA_BATCH):
        raise SystemExit(f"expected one NMS kernel launch per evaluated batch, got {nms_launches['train_net']}")
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

    print("== 9e. predict_fn at batch 1 (800², bf16): its profile, and the NMS's share and launches, through the "
          f"kernel and through the plain loop; predict_fn's device time at batch {RETINA_BATCH}")
    one = batch[:1].contiguous()
    fwd1_ms = cuda_ms(lambda: model.predict_fn(one), iters=10)
    with torch.inference_mode():
        x1 = model.normalize(one)
        cand1 = model.candidates(*model.model(x1), x1.shape[2:])
    nms = lambda: batched_nms_fixed(*cand1, model.nms_threshold, model.max_detections)
    with plain_nms_route():
        nms_plain_ms = cuda_ms(nms, iters=10)
        plain_profile = profiled(nms)
    nms_ms = cuda_ms(nms, iters=10)
    profiles = {name: profiled(fn) for name, fn in (("predict_fn", lambda: model.predict_fn(one)), ("nms", nms),
                                                    ("predict_fn_b16", lambda: model.predict_fn(batch)))}
    p, q = profiles["predict_fn"], profiles["nms"]
    print(f"  predict_fn batch 1: {fwd1_ms:.3f} ms ({p['launches']:.0f} kernel launches, {p['device_ms']:.3f} ms "
          f"on the card); the NMS alone ({model.max_detections} picks of {cand1[1].shape[1]} candidates, class "
          f"offsets and the kernel): {nms_ms:.3f} ms = {nms_ms / fwd1_ms:.0%} of the call, {q['launches']:.0f} "
          f"launches ({q['launches'] / p['launches']:.0%} of them), {q['device_ms']:.3f} ms on the card "
          f"({q['device_ms'] / p['device_ms']:.0%} of its device time); through the plain loop instead: "
          f"{nms_plain_ms:.3f} ms, {plain_profile['launches']:.0f} launches, {plain_profile['device_ms']:.3f} ms "
          f"on the card")
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
               nms_plain_b1_ms=nms_plain_ms, nms_plain_launches=plain_profile["launches"],
               nms_plain_device_ms=plain_profile["device_ms"],
               predict_fn_b16_device_ms=b16["device_ms"], predict_fn_b16_f32_conv_ms=f32_conv_ms)

    torch.cuda.synchronize()
    launches = read_launches()
    print(f"  DCN kernel launches on the RetinaNet path (9a-9e): {launches}; NMS kernel launches on its paths "
          f"{nms_launches}")
    if any(launches.values()):
        raise SystemExit(f"the RetinaNet path launched DCN kernels: {launches}")
    out.update(launches=launches, nms_kernel_launches=nms_launches)
    report["retinanet"] = out
    return launches, nms_launches, nms_inputs[0]


@contextmanager
def capture_nms(into):
    """Record the arguments of every ``greedy_nms`` call (the RPN's and the
    class-aware NMS's) into ``into``, the call going on to the kernel. The
    wrapper counts its launches on the module's ``greedy_nms``, here the
    recorder: they join the real count on the way out."""
    real = nms_ops.greedy_nms

    def recording(boxes, scores, iou_threshold, max_out=100):
        counts = max_out if isinstance(max_out, int) else tuple(int(c) for c in max_out)
        into.append((boxes.clone(), scores.clone(), float(iou_threshold), counts))
        return real(boxes, scores, iou_threshold, max_out)

    recording.launches = 0
    nms_ops.greedy_nms = rpn_ops.greedy_nms = recording
    try:
        yield
    finally:
        nms_ops.greedy_nms = rpn_ops.greedy_nms = real
        real.launches += recording.launches


@contextmanager
def plain_nms_route():
    """Every NMS of the port through the plain loop (``nms_fixed``), on the card."""
    real = nms_ops.greedy_nms
    nms_ops.greedy_nms = rpn_ops.greedy_nms = nms_ops.nms_fixed
    try:
        yield
    finally:
        nms_ops.greedy_nms = rpn_ops.greedy_nms = real


def profiled(fn, calls=3):
    """``fn`` run ``calls`` times under the profiler: per call its kernel
    launches and device ms, the NMS kernel's device ms, and the events."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    return dict(launches=sum(e.count for e in kernels) / calls, events=events,
                device_ms=sum(e.self_device_time_total for e in kernels) / calls / 1e3,
                nms_kernel_ms=sum(e.self_device_time_total for e in kernels if "nms_kernel" in e.key) / calls / 1e3)


def nms_work(boxes, scores, iou_threshold, counts):
    """(live candidates summed over every valid pick, valid picks) of the
    greedy NMS of these inputs: the plain loop replayed on the card."""
    live = torch.isfinite(scores)
    keep, valid = nms_ops.nms_fixed(boxes, scores, iou_threshold, counts)
    total = 0
    areas = nms_ops._areas(boxes)
    rows = torch.arange(boxes.shape[0], device=boxes.device)
    for p in range(keep.shape[1]):
        ok = valid[:, p]
        total += int((live.sum(1) * ok).sum())
        j = keep[:, p]
        box = boxes[rows, j][:, None]
        lt = torch.maximum(box[..., :2], boxes[..., :2])
        rb = torch.minimum(box[..., 2:], boxes[..., 2:])
        wh = torch.clamp(rb - lt, min=0)
        inter = wh[..., 0] * wh[..., 1]
        iou = nms_ops._iou(inter, areas[rows, j][:, None] + areas - inter)
        live &= ~((iou > iou_threshold) & ok[:, None])
        live[rows[ok], j[ok]] = False
    return total, int(valid.sum())


def phase_nms_kernel(report, cases):
    """The NMS kernel against its plain loop on the card, on the inputs the
    main paths gave it: indices and validity exactly equal; both timed;
    the bound of each shape."""
    print("== 10c. the NMS kernel (ops/csrc/nms.cu) against the plain loop on the card, on the main paths' inputs")
    out = {}
    for name, (boxes, scores, thr, counts) in cases.items():
        got = nms_ops.greedy_nms(boxes, scores, thr, counts)
        want = nms_ops.nms_fixed(boxes, scores, thr, counts)
        torch.cuda.synchronize()
        equal = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        rows, cands = scores.shape
        k = got[0].shape[1]
        kernel_ms = cuda_ms(lambda: nms_ops.greedy_nms(boxes, scores, thr, counts), iters=20)
        plain_ms = cuda_ms(lambda: nms_ops.nms_fixed(boxes, scores, thr, counts), iters=2, warmup=1)
        live, picks = nms_work(boxes, scores, thr, counts)
        alive = torch.isfinite(scores)
        n_live, row_live = int(alive.sum()), int(alive.sum(1).max())
        # every score read once (a dead candidate's score is all that says it is dead),
        # a live candidate's box once, the per-row counts, each output written once;
        # ~20 f32 operations per (valid pick, live candidate): the IoU in its rounded
        # steps and the argmax's compare
        in_bytes = rows * cands * 4 + n_live * 16 + (0 if isinstance(counts, int) else rows * 4)
        bytes_ms = (in_bytes + rows * k * 9) / PEAK_BYTES * 1e3
        ops_ms = 20 * live / PEAK_F32 * 1e3
        per_pick_ms = live * 20 / PEAK_BYTES * 1e3  # every pick reads each live candidate's score and box
        bound, by = bound_of(ops_ms, bytes_ms)
        max_out = counts if isinstance(counts, int) else sorted(set(counts), reverse=True)
        shared = row_live <= cuda_lib.library("nms", nms_ops._SIGNATURES).nms_fixed_shared_cap()
        row = dict(rows=rows, candidates=cands, max_out=max_out, live_candidates=n_live, most_live_in_a_row=row_live,
                   path="shared memory" if shared else "in place", valid_picks=picks, live_per_pick_sum=live,
                   equal=equal, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, bytes_ms=bytes_ms,
                   ops_ms=ops_ms, per_pick_read_ms=per_pick_ms, shared_memory=shared)
        out[name] = row
        print(f"  {name}: {rows} rows x {cands} candidates ({n_live} live, at most {row_live} in a row: "
              f"{row['path']}), picks {max_out}, {picks} valid picks: {'equal' if equal else 'DIFFERENT'}; kernel "
              f"{kernel_ms:.3f} ms, plain loop {plain_ms:.3f} ms; bound {bound:.4f} ms ({by}: bytes {bytes_ms:.4f}, "
              f"operations {ops_ms:.4f}; reading every live candidate at every pick: {per_pick_ms:.4f} ms)")
        if not equal:
            raise SystemExit(f"the NMS kernel disagrees with its plain version on {name}")
    if out["box_head_eval"]["shared_memory"]:
        raise SystemExit("the evaluation's box-head NMS, the case of the kernel's in-place path, fit in shared memory")
    report["nms_kernel"] = out
    return out


FASTER = "faster_rcnn_R_50_FPN_1x"
PROPOSALS = "rpn_R_50_FPN_1x"
RCNN_BATCH = 16  # predict_fn's batch (the YAML keeps TEST.BATCH_SIZE 1); SOLVER.IMS_PER_BATCH of Base-RCNN-FPN
RCNN_STEPS = 4  # tools/train_net's steps in 10e


def rcnn_cfg(name: str, dtype: str, folder: str = "COCO-Detection"):
    """``configs/<folder>/<name>.yaml`` (over Base-RCNN-FPN.yaml) read by the
    port's own YAML reader, with the run's compute width, output directory
    and seed over it and no weights file (the YAML names ImageNet weights,
    which are not in the repository)."""
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join("configs", folder, name + ".yaml"))
    cfg.merge_from_list(["TPU.DTYPE", dtype, "OUTPUT_DIR", "output/chip_smoke", "SEED", 0, "MODEL.WEIGHTS", ""])
    return cfg


def rcnn_weights(cfg, images: torch.Tensor, seed: int) -> Tuple[dict, dict]:
    """(``seeded_weights``: the model's own init with FrozenBN statistics
    measured on ``images``, what a model initialised from ImageNet weights
    starts from; the same with the box predictor scaled on the first
    image's proposals so that ``cls_score``'s logits spread with std 2 and
    ``bbox_pred``'s deltas with std 0.5, weights that detect to serve with).
    The init's N(0, 0.01) predictor puts every class near 1/81, under
    SCORE_THRESH_TEST 0.05: served, its NMS would get no candidate."""
    init = seeded_weights(cfg, images, seed)
    state = dict(init)
    cfg = cfg.clone()
    cfg.MODEL.DEVICE = "cpu"
    host = build_model(cfg)
    host.model.load_state_dict(state)
    with torch.no_grad():
        x = host.normalize(images[:1])
        feats, logits, deltas = host.model(x)
        boxes, _, _ = host.proposals(logits, deltas, x.shape[2:], "test")
        head = host.model.roi_heads.box_head(host.pool(feats, boxes[0], boxes.shape[1]))
        for name, std in (("cls_score", 2.0), ("bbox_pred", 0.5)):
            key = f"roi_heads.box_predictor.{name}.weight"
            state[key] = init[key] * (std / (head @ init[key].T).std().item())
    return init, state


def phase_faster_rcnn(report, out_dir):
    """Phase 10: Faster R-CNN R50-FPN and the ProposalNetwork at full width
    through the port's entry points; every NMS through the kernel, no DCN
    kernel anywhere."""
    cfg = rcnn_cfg(FASTER, "bfloat16")
    m = cfg.MODEL
    size = tuple(cfg.INPUT.TEST_SIZE)
    print(f"== 10a. Faster R-CNN ({FASTER}.yaml): {m.BACKBONE.NAME}, ResNet-{m.RESNETS.DEPTH} {m.RESNETS.NORM} "
          f"FREEZE_AT {m.BACKBONE.FREEZE_AT}, FPN {m.FPN.OUT_CHANNELS}, RPN on {list(m.RPN.IN_FEATURES)} "
          f"({m.RPN.PRE_NMS_TOPK_TEST}/{m.RPN.POST_NMS_TOPK_TEST} proposals at test, {m.RPN.PRE_NMS_TOPK_TRAIN}/"
          f"{m.RPN.POST_NMS_TOPK_TRAIN} at train), {m.ROI_HEADS.NUM_CLASSES} classes, "
          f"{m.ROI_HEADS.BATCH_SIZE_PER_IMAGE} rois per image, bf16: DefaultPredictor at {size[0]}², "
          f"predict_fn at batch {RCNN_BATCH}")
    if "yaml" in sys.modules:
        raise SystemExit("PyYAML was imported: the port must read configs with its own reader")
    rng = np.random.RandomState(10)
    reset_launches()
    init, weights = rcnn_weights(rcnn_cfg(FASTER, "float32"), letterboxed(rng, "cpu", 2, size), seed=0)
    predictor = DefaultPredictor(cfg)
    model = predictor.model
    model.model.load_state_dict(weights)
    anchors = [a.shape[0] for a in model.anchors_per_level(size)]
    if not (m.RESNETS.DEPTH == 50 and m.FPN.OUT_CHANNELS == 256 and m.ROI_HEADS.NUM_CLASSES == 80
            and model.anchor_generator.num_anchors == [3] * 5 and model.dtype == torch.bfloat16
            and size == (800, 800) and m.ROI_HEADS.BATCH_SIZE_PER_IMAGE == 512
            and (m.RPN.POST_NMS_TOPK_TEST, m.RPN.PRE_NMS_TOPK_TRAIN) == (1000, 2000)):
        raise SystemExit(f"{FASTER} is not at full width here: {m}")
    batch = letterboxed(rng, model.device, RCNN_BATCH, size)
    nms_launches, nms_inputs = {}, []
    nms_ops.greedy_nms.launches = 0
    requests = []
    for h, w in ((480, 640), (800, 800), (375, 500)):
        im = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        inst = predictor(im)["instances"]
        check_detections(FASTER, im, inst, model.score_threshold)
        requests.append(len(inst))
        print(f"  request {h}x{w}: {len(inst)} detections, top score {inst.scores.max():.4f}")
    latency = bench.request_ms(predictor, rng.randint(0, 256, (480, 640, 3)).astype(np.uint8))
    with capture_nms(nms_inputs):
        dets = model.predict_fn(batch)
        with torch.inference_mode():  # the training's proposals: 2000 per level, 1000 picks
            x = model.normalize(batch)
            model.proposals(*model.model(x)[1:], size, "train")
    torch.cuda.synchronize()
    nms_launches["serving"] = nms_ops.greedy_nms.launches
    calls = 3 + bench.REQUEST_WARMUP + bench.REQUESTS + 1
    if nms_launches["serving"] != 2 * calls + 1:
        raise SystemExit(f"expected two NMS kernel launches per call (RPN, boxes) and one for the training's "
                         f"proposals, {2 * calls + 1}, got {nms_launches['serving']}")
    valid = (dets["scores"] > model.score_threshold).sum(1).cpu()
    if not (dets["boxes"].shape == (RCNN_BATCH, 100, 4) and bool(torch.isfinite(dets["boxes"]).all())
            and bool(torch.isfinite(dets["scores"]).all()) and int(valid.min()) > 0):
        raise SystemExit(f"Faster R-CNN's predict_fn returned malformed or empty detections: {valid.tolist()}")
    predict_ms = cuda_ms(lambda: model.predict_fn(batch), iters=5)
    print(f"  request (480x640 → 800²) median {statistics.median(latency):.3f} ms of {bench.REQUESTS}; predict_fn "
          f"batch {RCNN_BATCH}: {predict_ms:.3f} ms = {RCNN_BATCH * 1e3 / predict_ms:.2f} img/s; valid detections "
          f"per image {int(valid.min())}-{int(valid.max())} of 100; anchors per level {anchors}; NMS kernel "
          f"launches {nms_launches['serving']}")
    out = dict(requests=requests, request_ms=latency, request_median_ms=statistics.median(latency),
               predict_fn_b16_ms=predict_ms, valid_per_image=valid.tolist(), anchors=anchors)
    rpn_test, box_head, rpn_train = nms_inputs[0], nms_inputs[1], nms_inputs[2]

    one = batch[:1].contiguous()
    fwd1_ms = cuda_ms(lambda: model.predict_fn(one), iters=10)
    p = profiled(lambda: model.predict_fn(one))
    with plain_nms_route():
        plain1_ms = cuda_ms(lambda: model.predict_fn(one), iters=3, warmup=1)
        q = profiled(lambda: model.predict_fn(one), calls=1)
    b16 = profiled(lambda: model.predict_fn(batch))
    print(f"  predict_fn batch 1: {fwd1_ms:.3f} ms, {p['launches']:.0f} kernel launches, {p['device_ms']:.3f} ms on "
          f"the card, of it the NMS kernel {p['nms_kernel_ms']:.3f} ms ({p['nms_kernel_ms'] / p['device_ms']:.0%}); "
          f"with the plain NMS loop instead: {plain1_ms:.3f} ms, {q['launches']:.0f} launches; predict_fn batch "
          f"{RCNN_BATCH}: {b16['device_ms']:.3f} ms on the card, the NMS kernel {b16['nms_kernel_ms']:.3f} ms")
    print(p["events"].table(sort_by="cuda_time_total", row_limit=15, max_name_column_width=90))
    print(b16["events"].table(sort_by="cuda_time_total", row_limit=12, max_name_column_width=90))
    out.update(predict_fn_b1_ms=fwd1_ms, predict_fn_b1_launches=p["launches"], predict_fn_b1_device_ms=p["device_ms"],
               predict_fn_b1_nms_kernel_ms=p["nms_kernel_ms"], predict_fn_b1_plain_nms_ms=plain1_ms,
               predict_fn_b1_plain_nms_launches=q["launches"], predict_fn_b16_device_ms=b16["device_ms"],
               predict_fn_b16_nms_kernel_ms=b16["nms_kernel_ms"])
    del predictor

    print("== 10b. f32, batch 2, card against CPU: the RPN heads, the proposals, the box predictor, the detections "
          "(each stage fed the card's inputs on both sides)")
    cfg32 = rcnn_cfg(FASTER, "float32")
    card = build_model(cfg32)
    cfg32.MODEL.DEVICE = "cpu"
    host = build_model(cfg32)
    for mdl in (card, host):
        mdl.model.load_state_dict(weights)
    x = batch[:2]
    checks = {}
    with torch.inference_mode():
        xc = card.normalize(x)
        feats_c, lg_c, dl_c = card.model(xc)
        feats_h, lg_h, dl_h = host.model(host.normalize(x.cpu()))
        for name, maps_c, maps_h in (("objectness_logits", lg_c, lg_h), ("anchor_deltas", dl_c, dl_h)):
            for level, (c, h) in enumerate(zip(maps_c, maps_h), 2):
                err, scale = (c.cpu() - h).abs().max().item(), h.abs().max().item()
                checks[f"{name}_p{level}"] = dict(max_abs_err=err, scale=scale, tol=HEAD_TOL * max(scale, 1.0))
        props_c = card.proposals(lg_c, dl_c, size, "test")
        props_h = host.proposals([t.cpu() for t in lg_c], [t.cpu() for t in dl_c], size, "test")
        same_slots = torch.equal(props_c[2].cpu(), props_h[2]) and torch.equal(props_c[1].cpu(), props_h[1])
        box_err = (props_c[0].cpu() - props_h[0]).abs().max().item()
        p_boxes = props_c[0].reshape(-1, 4)
        levels_c = roi_ops.assign_boxes_to_levels(p_boxes, 2, 5).cpu()
        levels_h = roi_ops.assign_boxes_to_levels(p_boxes.cpu(), 2, 5)
        same_level = levels_c == levels_h
        sc_c, bd_c = card.model.box_predict(card.pool(feats_c, p_boxes, props_c[0].shape[1]))
        sc_h, bd_h = host.model.box_predict(host.pool(feats_h, p_boxes.cpu(), props_c[0].shape[1]))
        for name, c, h in (("cls_score", sc_c, sc_h), ("bbox_pred", bd_c, bd_h)):
            err, scale = (c.cpu() - h)[same_level].abs().max().item(), h.abs().max().item()
            checks[name] = dict(max_abs_err=err, scale=scale, tol=HEAD_TOL * max(scale, 1.0))
        n, pp = props_c[0].shape[:2]
        det_c = roi_ops_inference(card, props_c, sc_c, bd_c, n, pp, size)
        det_h = roi_ops_inference(host, [t.cpu() for t in props_c], sc_c.cpu(), bd_c.cpu(), n, pp, size)
    same_dets = torch.equal(det_c["classes"].cpu(), det_h["classes"]) and \
        torch.equal(det_c["scores"].cpu() > 0, det_h["scores"] > 0)
    det_box_err = (det_c["boxes"].cpu() - det_h["boxes"]).abs().max().item()
    det_score_err = (det_c["scores"].cpu() - det_h["scores"]).abs().max().item()
    for k, v in checks.items():
        ok = v["max_abs_err"] <= v["tol"]
        print(f"  {k}: max_abs_err={v['max_abs_err']:.3e} (scale {v['scale']:.3e}, tol {v['tol']:.1e}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"the card's f32 {k} differs from the CPU's")
    print(f"  proposals (the card's heads through the CPU's plain path): slots {'equal' if same_slots else 'DIFFERENT'}"
          f", boxes within {box_err:.2e} px (tol 1e-3); {int((~same_level).sum())} of {len(same_level)} proposals "
          f"assigned another FPN level by the card's log2 than by the CPU's (excluded from the box predictor's "
          f"check; tol 0.1%); detections: {'equal' if same_dets else 'DIFFERENT'} classes and validity, boxes "
          f"within {det_box_err:.2e} px (tol 1e-3), scores within {det_score_err:.2e} (tol 1e-6)")
    if not (same_slots and box_err <= 1e-3 and (~same_level).float().mean() <= 1e-3 and same_dets
            and det_box_err <= 1e-3 and det_score_err <= 1e-6):
        raise SystemExit("Faster R-CNN's proposals or detections differ between the card and the CPU")
    out.update(card_vs_cpu=checks, proposal_box_err=box_err, level_flips=int((~same_level).sum()),
               detection_box_err=det_box_err, detection_score_err=det_score_err)
    del card, host, feats_c, feats_h

    print(f"== 10d. tools/bench --config-file {FASTER}.yaml TEST.BATCH_SIZE {RCNN_BATCH} (the model's own init; "
          f"train at {RCNN_BATCH} x 800²)")
    captured, bench_training = [], bench.bench_training
    bench.bench_training = lambda c, w=None: captured.append(bench_training(c, w)) or captured[-1]
    nms_ops.greedy_nms.launches = 0
    try:
        result = bench.main(["--config-file", os.path.join("configs", "COCO-Detection", FASTER + ".yaml"),
                             "TEST.BATCH_SIZE", str(RCNN_BATCH)])
    finally:
        bench.bench_training = bench_training
    torch.cuda.synchronize()
    nms_launches["bench"] = nms_ops.greedy_nms.launches
    calls = 2 + bench.ITERS + bench.REQUEST_WARMUP + bench.REQUESTS
    steps = bench.TRAIN_WARMUP + bench.TRAIN_STEPS + 1
    if nms_launches["bench"] != 2 * calls + steps:
        raise SystemExit(f"expected 2 NMS launches per bench call and 1 per step ({2 * calls + steps}), "
                         f"got {nms_launches['bench']}")
    extra = result["extra"]
    _, trainer, clock = captured[0]
    names = ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "total_loss")
    losses = {k: [v for v, _ in trainer.storage.history(k).values()] for k in names}
    keys = ("predictor_latency_ms", "train_step_ms", "train_busy_share", "peak_memory_gib")
    if not (result["metric"] == "faster_rcnn_res50_fpn_800_infer_throughput" and result["value"] > 0
            and extra["batch"] == RCNN_BATCH and extra["train_batch"] == RCNN_BATCH
            and all(extra.get(k) is not None for k in keys)):
        raise SystemExit(f"the bench's Faster R-CNN line is not complete: {result}")
    if any(len(v) != steps or not all(math.isfinite(x) for x in v) for v in losses.values()):
        raise SystemExit(f"Faster R-CNN's bench losses are not finite at every step: {losses}")
    print(f"  {result['metric']}: {result['value']} img/s (vs_baseline {result['vs_baseline']}, against 1/0.038 s); "
          f"request median {extra['predictor_latency_ms']:.3f} ms; predict_fn batch {extra['batch']} "
          f"{extra['predict_fn_ms']:.3f} ms; NMS kernel launches {nms_launches['bench']}")
    total = " ".join(f"{v:.4f}" for v in losses["total_loss"])
    print(f"  train at {extra['train_batch']} x 800²: total loss {total}; "
          f"step times (ms) {' '.join(f'{t:.1f}' for t in clock.times)}, median of {bench.TRAIN_STEPS} "
          f"{extra['train_step_ms']:.1f} ms = {extra['train_img_s']:.1f} img/s; card busy {clock.device_ms:.1f} ms = "
          f"{extra['train_busy_share']:.0%} of the median step; peak memory {extra['peak_memory_gib']:.2f} GiB")
    print(clock.events.table(sort_by="cuda_time_total", row_limit=15, max_name_column_width=90))
    out.update(bench=result, bench_losses=losses, bench_step_ms_all=clock.times,
               bench_profiled_device_ms=clock.device_ms)
    del trainer, captured

    # from the init with calibrated FrozenBN statistics (MODEL.WEIGHTS, a bare
    # state dict; the stand-in for ImageNet weights), which the warm-up's small
    # steps barely move: its box predictor scores every class near 1/81, over
    # the threshold of 0.005, so the evaluation has detections to score and
    # its box-head NMS ~80 000 live candidates per row, more than shared
    # memory holds (with FrozenBN's identity statistics the activations grow
    # through the trunk, the softmax peaks and no class reaches 0.005)
    init_path = os.path.join(out_dir, "init_weights.pth")
    os.makedirs(out_dir, exist_ok=True)
    torch.save(init, init_path)
    print(f"== 10e. tools/train_net on {FASTER}.yaml: {RCNN_STEPS} steps at batch {RCNN_BATCH} from the init with "
          f"calibrated FrozenBN statistics (MODEL.WEIGHTS; DETECTRON2_SYNTH_DATA), then --eval-only --resume on the "
          f"{EVAL_IMAGES} synthetic coco_2017_val images, ROI_HEADS.SCORE_THRESH_TEST 0.005")
    argv = ["--config-file", os.path.join("configs", "COCO-Detection", FASTER + ".yaml"), "SOLVER.MAX_ITER",
            str(RCNN_STEPS), "SOLVER.IMS_PER_BATCH", str(RCNN_BATCH), "TEST.BATCH_SIZE", str(RCNN_BATCH),
            "MODEL.WEIGHTS", init_path, "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.005", "OUTPUT_DIR", out_dir,
            "SEED", "0"]
    fresh_synthetic_val()
    log_path = "output/chip_smoke_faster_rcnn_train_net_log.txt"
    nms_ops.greedy_nms.launches = 0
    eval_nms = []
    with capture_nms(eval_nms):
        trained, evaluated, resumed, train_s, eval_s = run_train_net(argv, log_path)
    nms_launches["train_net"] = nms_ops.greedy_nms.launches
    # the evaluation's box-head NMS with the most live candidates in a row
    # (every (proposal, class) pair over 0.005): the kernel's in-place path, for 10c
    box_head_eval = max((c for c in eval_nms if c[1].shape == box_head[1].shape),
                        key=lambda c: int(torch.isfinite(c[1]).sum(1).max()))
    del eval_nms
    want = RCNN_STEPS + 2 * 2 * -(-EVAL_IMAGES // RCNN_BATCH)
    if nms_launches["train_net"] != want:
        raise SystemExit(f"expected {want} NMS kernel launches in train_net, got {nms_launches['train_net']}")
    bbox = trained["bbox"]
    print(f"  train: {train_s:.1f} s; eval-only: {eval_s:.1f} s; iterations resumed at {resumed}; "
          + ", ".join(f"{k} {bbox[k]:.4f}" for k in BBOX_KEYS if k in bbox))
    if resumed != [0, RCNN_STEPS]:
        raise SystemExit(f"expected to start at iteration 0 and resume at {RCNN_STEPS}, got {resumed}")
    if not same_results(trained, evaluated):
        raise SystemExit(f"Faster R-CNN's evaluation after training and the --eval-only --resume one differ: "
                         f"{trained['bbox']} vs {evaluated['bbox']}")
    if not all(math.isfinite(bbox[k]) for k in BBOX_KEYS):
        raise SystemExit(f"Faster R-CNN's bbox AP dict is not finite: {bbox}")
    print(f"  the two evaluation dicts are identical ({len(bbox)} bbox entries); NMS kernel launches "
          f"{nms_launches['train_net']}; log in {log_path}")
    out.update(train_net=dict(train_s=train_s, eval_only_s=eval_s, resumed=resumed, bbox=bbox))

    print(f"== 10f. ProposalNetwork ({PROPOSALS}.yaml, bf16): predict_fn and loss_fn on 2 images of 800²")
    pcfg = rcnn_cfg(PROPOSALS, "bfloat16")
    rpn_model = build_model(pcfg)
    own = rpn_model.model.state_dict()
    rpn_model.model.load_state_dict({k: v for k, v in weights.items() if k in own})
    nms_ops.greedy_nms.launches = 0
    props = rpn_model.predict_fn(batch[:2])
    post = pcfg.MODEL.RPN.POST_NMS_TOPK_TEST
    g = torch.Generator(device="cuda").manual_seed(0)
    xy = torch.rand(2, 8, 2, generator=g, device="cuda") * 600
    gt = torch.cat([xy, xy + 32 + torch.rand(2, 8, 2, generator=g, device="cuda") * 160], -1)
    rpn_model.model.train()
    total, rpn_losses = rpn_model.loss_fn({"image": batch[:2], "gt_boxes": gt, "gt_valid": torch.ones(
        2, 8, dtype=torch.bool, device="cuda"), "generator": g})
    total.backward()
    torch.cuda.synchronize()
    nms_launches["proposal_network"] = nms_ops.greedy_nms.launches
    grads_finite = all(bool(torch.isfinite(p.grad).all()) for p in rpn_model.model.parameters() if p.grad is not None)
    valid = (props["scores"] > 0).sum(1).tolist()
    print(f"  proposals {tuple(props['boxes'].shape)}, valid per image {valid}; losses "
          f"{ {k: round(v.item(), 5) for k, v in rpn_losses.items()} }, gradients finite: {grads_finite}; NMS kernel "
          f"launches {nms_launches['proposal_network']}")
    if not (props["boxes"].shape == (2, post, 4) and min(valid) > 0 and bool(torch.isfinite(total))
            and grads_finite and nms_launches["proposal_network"] == 1):
        raise SystemExit("the ProposalNetwork's forward or loss failed")
    out.update(proposal_network=dict(valid=valid, losses={k: v.item() for k, v in rpn_losses.items()}))
    del rpn_model

    torch.cuda.synchronize()
    launches = read_launches()
    print(f"  DCN kernel launches on the Faster R-CNN path (10a-10f): {launches}; NMS kernel launches {nms_launches}")
    if any(launches.values()):
        raise SystemExit(f"the Faster R-CNN path launched DCN kernels: {launches}")
    out.update(launches=launches, nms_kernel_launches=nms_launches)
    report["faster_rcnn"] = out
    return launches, nms_launches, dict(rpn_test=rpn_test, rpn_train=rpn_train, box_head=box_head,
                                        box_head_eval=box_head_eval)


HEADS = {  # phase: (config folder, config name, the head's output, its evaluation's task)
    "mask": ("COCO-InstanceSegmentation", "mask_rcnn_R_50_FPN_1x", "masks", "segm"),
    "keypoint": ("COCO-Keypoints", "keypoint_rcnn_R_50_FPN_1x", "keypoint_heatmaps", "keypoints"),
}


def embedding_bag_ms(events) -> dict:
    """Device ms under the ROIAlign's ``embedding_bag`` ops in a profile
    (``ops/roi_align.py``), forward and backward apart: the kernels each op
    launched, whatever their names."""
    ops = {"forward": ("aten::embedding_bag",), "backward": ("aten::_embedding_bag_backward",)}
    return {k: sum(e.device_time_total for e in events if e.key in names) / 1e3 for k, names in ops.items()}


def keypoint_ties(maps, rois, got, want) -> dict:
    """Where the card's decode (``got``, (D, K, 4)) puts a keypoint
    elsewhere than the CPU's (``want``): whether it is another cell that
    ties the CPU's f64 bicubic maximum, its value within 1e-9 of the map's
    scale of it (both argmaxes pick the first maximum; at a tie the two
    devices' roundings, ~1e-16 apart, pick different cells). The same cell
    at another position is no tie: a failure."""
    moved, ties = 0, True
    for d, k in (got[..., :2] != want[..., :2]).any(-1).nonzero().tolist():
        moved += 1
        x0, y0, x1, y1 = rois[d].tolist()
        rw, rh = max(x1 - x0, 1.0), max(y1 - y0, 1.0)
        uw, uh = max(math.ceil(rw), 1), max(math.ceil(rh), 1)
        up = torch.nn.functional.interpolate(maps[d: d + 1].double(), size=(uh, uw), mode="bicubic",
                                             align_corners=False)[0, k]
        cells = [(min(max(round((p[d, k, 1].item() - y0) * uh / rh - 0.5), 0), uh - 1),
                  min(max(round((p[d, k, 0].item() - x0) * uw / rw - 0.5), 0), uw - 1)) for p in (got, want)]
        ties &= cells[0] != cells[1] and bool(up[cells[0]] >= up.max() - 1e-9 * up.abs().max())
    return {"moved": moved, "all_ties": ties}


def phase_rcnn_head(report, out_dir, kind: str):
    """Phases 11 (Mask R-CNN) and 12 (Keypoint R-CNN) at full width through
    the port's entry points: requests and predict_fn at batch 16, the head's
    f32 outputs card against CPU at batch 2, tools/bench with its train
    steps at 16 × 800², tools/train_net 4 steps then --eval-only --resume;
    every NMS through the kernel, no DCN kernel anywhere."""
    folder, name, output, task = HEADS[kind]
    number = {"mask": 11, "keypoint": 12}[kind]
    cfg = rcnn_cfg(name, "bfloat16", folder)
    m = cfg.MODEL
    size = tuple(cfg.INPUT.TEST_SIZE)
    head = (f"mask head of {m.ROI_MASK_HEAD.NUM_CONV} convs of {m.ROI_MASK_HEAD.CONV_DIM} at "
            f"{m.ROI_MASK_HEAD.POOLER_RESOLUTION}² → {2 * m.ROI_MASK_HEAD.POOLER_RESOLUTION}²" if kind == "mask" else
            f"keypoint head of {len(m.ROI_KEYPOINT_HEAD.CONV_DIMS)} convs of {m.ROI_KEYPOINT_HEAD.CONV_DIMS[0]} at "
            f"{m.ROI_KEYPOINT_HEAD.POOLER_RESOLUTION}² → {m.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS} heatmaps of "
            f"{4 * m.ROI_KEYPOINT_HEAD.POOLER_RESOLUTION}²")
    print(f"== {number}a. {name}.yaml: ResNet-{m.RESNETS.DEPTH} {m.RESNETS.NORM}, FPN {m.FPN.OUT_CHANNELS}, "
          f"{m.ROI_HEADS.NUM_CLASSES} classes, {head}, {m.RPN.POST_NMS_TOPK_TRAIN} proposals at training, bf16: "
          f"DefaultPredictor at {size[0]}², predict_fn at batch {RCNN_BATCH}")
    if not (m.RESNETS.DEPTH == 50 and m.FPN.OUT_CHANNELS == 256 and size == (800, 800)
            and m.ROI_HEADS.BATCH_SIZE_PER_IMAGE == 512
            and ((kind == "mask" and m.MASK_ON and m.ROI_HEADS.NUM_CLASSES == 80 and m.ROI_MASK_HEAD.NUM_CONV == 4
                  and m.ROI_MASK_HEAD.CONV_DIM == 256 and m.ROI_MASK_HEAD.POOLER_RESOLUTION == 14)
                 or (kind == "keypoint" and m.KEYPOINT_ON and m.ROI_HEADS.NUM_CLASSES == 1
                     and list(m.ROI_KEYPOINT_HEAD.CONV_DIMS) == [512] * 8 and m.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS == 17
                     and m.RPN.POST_NMS_TOPK_TRAIN == 1500))):
        raise SystemExit(f"{name} is not at full width here: {m}")
    rng = np.random.RandomState(10 + number)
    reset_launches()
    init, weights = rcnn_weights(rcnn_cfg(name, "float32", folder), letterboxed(rng, "cpu", 2, size), seed=0)
    predictor = DefaultPredictor(cfg)
    model = predictor.model
    model.model.load_state_dict(weights)
    batch = letterboxed(rng, model.device, RCNN_BATCH, size)
    nms_launches = {}
    nms_ops.greedy_nms.launches = 0
    requests = []
    for h, w in ((480, 640), (800, 800), (375, 500)):
        im = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        inst = predictor(im)["instances"]
        check_detections(name, im, inst, model.score_threshold)
        if kind == "mask":
            got = inst.pred_masks
            if not (got.dtype == bool and got.shape == (len(inst), h, w) and got.any()):
                raise SystemExit(f"{name}: bad pred_masks for a {h}x{w} image: {got.dtype} {got.shape}")
            extra = f"{int(got.sum(axis=(1, 2)).mean())} mask pixels per detection"
        else:
            got = inst.pred_keypoints
            b = inst.pred_boxes.tensor[:, None]  # the decode grows a box to at least 1 px a side
            inside = ((got[..., 0] >= b[..., 0]) & (got[..., 0] <= b[..., 0] + np.maximum(b[..., 2] - b[..., 0], 1))
                      & (got[..., 1] >= b[..., 1]) & (got[..., 1] <= b[..., 1] + np.maximum(b[..., 3] - b[..., 1], 1)))
            if not (got.shape == (len(inst), 17, 3) and np.isfinite(got).all() and inside.all()):
                raise SystemExit(f"{name}: bad pred_keypoints for a {h}x{w} image: {got.shape}")
            extra = f"keypoint scores {got[..., 2].min():.3g}-{got[..., 2].max():.3g}"
        requests.append(len(inst))
        print(f"  request {h}x{w}: {len(inst)} detections, top score {inst.scores.max():.4f}, {extra}")
    latency = bench.request_ms(predictor, rng.randint(0, 256, (480, 640, 3)).astype(np.uint8))
    nms_inputs = []
    with capture_nms(nms_inputs):
        dets = model.predict_fn(batch)
        with torch.inference_mode():  # the training's proposals (Keypoint R-CNN: 1500 picks)
            model.proposals(*model.model(model.normalize(batch))[1:], size, "train")
    torch.cuda.synchronize()
    nms_launches["serving"] = nms_ops.greedy_nms.launches
    calls = 3 + bench.REQUEST_WARMUP + bench.REQUESTS + 1
    if nms_launches["serving"] != 2 * calls + 1:
        raise SystemExit(f"expected two NMS kernel launches per call (RPN, boxes) and one for the training's "
                         f"proposals, {2 * calls + 1}, got {nms_launches['serving']}")
    short = {"mask": "mask", "keypoint": "kp"}[kind]
    nms_cases = {f"{k}_{short}": c for k, c in zip(("rpn_test", "box_head", "rpn_train"), nms_inputs)}
    valid = (dets["scores"] > model.score_threshold).sum(1).cpu()
    want_shape = (RCNN_BATCH, 100, 28, 28) if kind == "mask" else (RCNN_BATCH, 100, 17, 56, 56)
    if not (tuple(dets[output].shape) == want_shape and bool(torch.isfinite(dets[output]).all())
            and int(valid.min()) > 0):
        raise SystemExit(f"{name}'s predict_fn returned a malformed {output} or no detections: "
                         f"{tuple(dets[output].shape)}, {valid.tolist()}")
    predict_ms = cuda_ms(lambda: model.predict_fn(batch), iters=5)
    b16 = profiled(lambda: model.predict_fn(batch), calls=1)
    print(f"  request (480x640 → 800²) median {statistics.median(latency):.3f} ms of {bench.REQUESTS}; predict_fn "
          f"batch {RCNN_BATCH}: {predict_ms:.3f} ms = {RCNN_BATCH * 1e3 / predict_ms:.2f} img/s, {b16['device_ms']:.3f} "
          f"ms on the card; valid detections per image {int(valid.min())}-{int(valid.max())} of 100; NMS kernel "
          f"launches {nms_launches['serving']}")
    print(b16["events"].table(sort_by="cuda_time_total", row_limit=12, max_name_column_width=90))
    out = dict(requests=requests, request_ms=latency, request_median_ms=statistics.median(latency),
               predict_fn_b16_ms=predict_ms, predict_fn_b16_device_ms=b16["device_ms"],
               valid_per_image=valid.tolist())
    del predictor, dets

    top = 16  # the best-scored detection slots of each image (the keypoint head costs ~9 GFLOP a roi on the CPU)
    print(f"== {number}b. f32, batch 2, card against CPU: the {kind} head on the card's top {top} detection boxes "
          f"of each image (rois the two devices' log2 puts on other FPN levels left out), and the host boundary "
          f"on the card's outputs")
    cfg32 = rcnn_cfg(name, "float32", folder)
    card = build_model(cfg32)
    cfg32.MODEL.DEVICE = "cpu"
    host = build_model(cfg32)
    for mdl in (card, host):
        mdl.model.load_state_dict(weights)
    x = batch[:2]
    with torch.inference_mode():
        dets = card.predict_fn(x)
        feats_c = card.model(card.normalize(x))[0]
        feats_h = host.model(host.normalize(x.cpu()))[0]
        boxes = dets["boxes"][:, :top].reshape(-1, 4)
        same_level = (roi_ops.assign_boxes_to_levels(boxes, 2, 5).cpu()
                      == roi_ops.assign_boxes_to_levels(boxes.cpu(), 2, 5))
        if kind == "mask":
            res = card.mask_pooler_resolution
            cls = torch.clamp(dets["classes"][:, :top].reshape(-1), 0, card.num_classes - 1)
            rows = torch.arange(len(cls), device=cls.device)
            got_c = card.model.mask_predict(card.pool(feats_c, boxes, top, res))[rows, cls].cpu()
            got_h = host.model.mask_predict(host.pool(feats_h, boxes.cpu(), top, res))[rows.cpu(), cls.cpu()]
        else:
            res = card.keypoint_pooler_resolution
            got_c = card.model.keypoint_predict(card.pool(feats_c, boxes, top, res)).cpu()
            got_h = host.model.keypoint_predict(host.pool(feats_h, boxes.cpu(), top, res))
        err = (got_c - got_h)[same_level].abs().max().item()
        scale = got_h.abs().max().item()
        tol = HEAD_TOL * scale
        # the control: cuDNN's TF32 on and the model's ieee_f32 bypassed, the
        # same boxes; the check must see it (as phase 4b's C9 control)
        with pytorch_default_tf32(), bypass_ieee_f32(rcnn):
            feats_t = card.model(card.normalize(x))[0]
            if kind == "mask":
                got_t = card.model.mask_predict(card.pool(feats_t, boxes, top, res))[rows, cls].cpu()
            else:
                got_t = card.model.keypoint_predict(card.pool(feats_t, boxes, top, res)).cpu()
        tf32_err = (got_t - got_h)[same_level].abs().max().item()
        b0 = dets["boxes"][0, :top]  # the first image's, in the 800² frame
        if kind == "mask":
            on_card = paste_masks_in_image(dets["masks"][0, :top], b0, size)
            on_host = paste_masks_in_image(dets["masks"][0, :top].cpu(), b0.cpu(), size)
            boundary = ("pasted masks", torch.equal(on_card.cpu(), on_host), int(on_card.sum()))
        else:
            maps = dets["keypoint_heatmaps"][0, :top]
            on_card = heatmaps_to_keypoints(maps, b0)
            on_host = heatmaps_to_keypoints(maps.cpu(), b0.cpu())
            ties = keypoint_ties(maps.cpu(), b0.cpu(), on_card, on_host)
            boundary = ("keypoint positions", ties["all_ties"] and ties["moved"] <= 0.01 * on_host[..., 0].numel(),
                        float((on_card[..., 3] - on_host[..., 3]).abs().max() / on_host[..., 3].abs().max()))
            print(f"  keypoints decoded elsewhere on the card than on the CPU: {ties['moved']} of "
                  f"{on_host[..., 0].numel()}, each at another cell tying the CPU's f64 upsampled maximum "
                  f"(within 1e-9 of its scale): {ties['all_ties']} (tol: ties only, at most 1%)")
            out["keypoint_ties"] = ties
    flips = int((~same_level).sum())
    print(f"  {output} head: max_abs_err={err:.3e} (scale {scale:.3e}, tol {HEAD_TOL:.0e} x scale = {tol:.1e}) "
          f"{'ok' if err <= tol else 'FAIL'}; with cuDNN's TF32 on and ieee_f32 bypassed {tf32_err:.3e} "
          f"{'(over the tol: the check sees TF32)' if tf32_err > tol else '(NOT over the tol: FAIL)'}; "
          f"{flips} of {len(same_level)} rois on another FPN level (tol 0.1%); {boundary[0]} of the top {top} "
          f"detections of image 0 on the card and on the CPU: "
          f"{('equal' if kind == 'mask' or not ties['moved'] else 'equal but at ties') if boundary[1] else 'DIFFERENT'} "
          f"({boundary[2]:.4g} {'mask pixels' if kind == 'mask' else 'largest relative score difference'})")
    if not (err <= tol and flips <= 1e-3 * len(same_level) and boundary[1]):
        raise SystemExit(f"{name}'s f32 {kind} head or host boundary differs between the card and the CPU")
    if not tf32_err > tol:
        raise SystemExit(f"{name}'s f32 {kind} head check did not see TF32: {tf32_err:.3e} <= {tol:.3e}")
    out.update(card_vs_cpu=dict(max_abs_err=err, scale=scale, tol=tol, tf32_bypass_err=tf32_err, level_flips=flips,
                                host_boundary_equal=boundary[1], host_boundary_extra=boundary[2]))
    del card, host, feats_c, feats_h, feats_t, dets

    print(f"== {number}c. tools/bench --config-file {folder}/{name}.yaml TEST.BATCH_SIZE {RCNN_BATCH} (the model's "
          f"own init; train at {RCNN_BATCH} x 800²)")
    captured, bench_training = [], bench.bench_training
    bench.bench_training = lambda c, w=None: captured.append(bench_training(c, w)) or captured[-1]
    nms_ops.greedy_nms.launches = 0
    try:
        result = bench.main(["--config-file", os.path.join("configs", folder, name + ".yaml"),
                             "TEST.BATCH_SIZE", str(RCNN_BATCH)])
    finally:
        bench.bench_training = bench_training
    torch.cuda.synchronize()
    nms_launches["bench"] = nms_ops.greedy_nms.launches
    calls = 2 + bench.ITERS + bench.REQUEST_WARMUP + bench.REQUESTS
    steps = bench.TRAIN_WARMUP + bench.TRAIN_STEPS + 1
    if nms_launches["bench"] != 2 * calls + steps:
        raise SystemExit(f"expected 2 NMS launches per bench call and 1 per step ({2 * calls + steps}), "
                         f"got {nms_launches['bench']}")
    extra = result["extra"]
    _, trainer, clock = captured[0]
    loss = "loss_mask" if kind == "mask" else "loss_keypoint"
    names = ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", loss, "total_loss")
    losses = {k: [v for v, _ in trainer.storage.history(k).values()] for k in names}
    keys = ("predictor_latency_ms", "train_step_ms", "train_busy_share", "peak_memory_gib")
    metric = f"{'mask' if kind == 'mask' else 'keypoint'}_rcnn_res50_fpn_800_infer_throughput"
    if not (result["metric"] == metric and result["value"] > 0 and extra["batch"] == RCNN_BATCH
            and extra["train_batch"] == RCNN_BATCH and all(extra.get(k) is not None for k in keys)
            and (result["vs_baseline"] is None) == (kind == "keypoint")):
        raise SystemExit(f"the bench's {name} line is not complete: {result}")
    if any(len(v) != steps or not all(math.isfinite(x) for x in v) for v in losses.values()):
        raise SystemExit(f"{name}'s bench losses are not finite at every step: {losses}")
    roi_align = embedding_bag_ms(clock.events)
    print(f"  {result['metric']}: {result['value']} img/s (vs_baseline {result['vs_baseline']}); request median "
          f"{extra['predictor_latency_ms']:.3f} ms; predict_fn batch {extra['batch']} {extra['predict_fn_ms']:.3f} ms; "
          f"NMS kernel launches {nms_launches['bench']}")
    print(f"  train at {extra['train_batch']} x 800²: {loss} {' '.join(f'{v:.4f}' for v in losses[loss])}; total "
          f"{' '.join(f'{v:.4f}' for v in losses['total_loss'])}; step times (ms) "
          f"{' '.join(f'{t:.1f}' for t in clock.times)}, median of {bench.TRAIN_STEPS} {extra['train_step_ms']:.1f} ms = "
          f"{extra['train_img_s']:.1f} img/s; card busy {clock.device_ms:.1f} ms = {extra['train_busy_share']:.0%} "
          f"of the median step; peak memory {extra['peak_memory_gib']:.2f} GiB; ROIAlign's embedding_bag in the "
          f"profiled step: forward {roi_align['forward']:.2f} ms, backward {roi_align['backward']:.2f} ms")
    print(clock.events.table(sort_by="cuda_time_total", row_limit=15, max_name_column_width=90))
    out.update(bench=result, bench_losses=losses, bench_step_ms_all=clock.times,
               bench_profiled_device_ms=clock.device_ms, bench_roi_align_ms=roi_align)
    del trainer, captured

    init_path = os.path.join(out_dir, "init_weights.pth")
    os.makedirs(out_dir, exist_ok=True)
    torch.save(init, init_path)
    val = cfg.DATASETS.TEST[0]
    # from the init with calibrated FrozenBN statistics, as 10e; Mask R-CNN's
    # 80 classes score near 1/81 there, so its threshold goes to 0.005 for
    # detections to evaluate; Keypoint R-CNN's one class scores near 1/2
    thresh = ["MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.005"] if kind == "mask" else []
    print(f"== {number}d. tools/train_net on {name}.yaml: {RCNN_STEPS} steps at batch {RCNN_BATCH} from the init with "
          f"calibrated FrozenBN statistics (MODEL.WEIGHTS; DETECTRON2_SYNTH_DATA), then --eval-only --resume on the "
          f"{EVAL_IMAGES} synthetic {val} images {' '.join(thresh)}")
    argv = ["--config-file", os.path.join("configs", folder, name + ".yaml"), "SOLVER.MAX_ITER", str(RCNN_STEPS),
            "SOLVER.IMS_PER_BATCH", str(RCNN_BATCH), "TEST.BATCH_SIZE", str(RCNN_BATCH), "MODEL.WEIGHTS", init_path,
            "OUTPUT_DIR", out_dir, "SEED", "0"] + thresh
    fresh_synthetic_val(val, keypoints=kind == "keypoint")
    log_path = f"output/chip_smoke_{kind}_rcnn_train_net_log.txt"
    nms_ops.greedy_nms.launches = 0
    trained, evaluated, resumed, train_s, eval_s = run_train_net(argv, log_path)
    nms_launches["train_net"] = nms_ops.greedy_nms.launches
    want = RCNN_STEPS + 2 * 2 * -(-EVAL_IMAGES // RCNN_BATCH)
    if nms_launches["train_net"] != want:
        raise SystemExit(f"expected {want} NMS kernel launches in train_net, got {nms_launches['train_net']}")
    print(f"  train: {train_s:.1f} s; eval-only: {eval_s:.1f} s; iterations resumed at {resumed}; "
          + "; ".join(f"{t} " + ", ".join(f"{k} {trained[t][k]:.4f}" for k in ("AP", "AP50", "AP75") if k in trained[t])
                      for t in trained))
    if resumed != [0, RCNN_STEPS]:
        raise SystemExit(f"expected to start at iteration 0 and resume at {RCNN_STEPS}, got {resumed}")
    if set(trained) != {"bbox", task}:
        raise SystemExit(f"{name}'s evaluation has no {task} results: {sorted(trained)}")
    if not same_results(trained, evaluated):
        raise SystemExit(f"{name}'s evaluation after training and the --eval-only --resume one differ: "
                         f"{trained} vs {evaluated}")
    if not all(math.isfinite(trained[t][k]) for t in trained for k in ("AP", "AP50", "AP75")):
        raise SystemExit(f"{name}'s AP dicts are not finite: {trained}")
    print(f"  the two evaluation dicts are identical (bbox and {task}); NMS kernel launches "
          f"{nms_launches['train_net']}; log in {log_path}")
    out.update(train_net=dict(train_s=train_s, eval_only_s=eval_s, resumed=resumed, results=trained))

    torch.cuda.synchronize()
    launches = read_launches()
    print(f"  DCN kernel launches on the {name} path ({number}a-{number}d): {launches}; NMS kernel launches "
          f"{nms_launches}")
    if any(launches.values()):
        raise SystemExit(f"the {name} path launched DCN kernels: {launches}")
    out.update(launches=launches, nms_kernel_launches=nms_launches)
    report[f"{kind}_rcnn"] = out
    return launches, nms_launches, nms_cases


def roi_ops_inference(model, props, scores, deltas, n, p, size):
    """``fast_rcnn_inference`` of the box predictor's outputs on (N, P) proposals."""
    return roi_heads_ops.fast_rcnn_inference(props[0], props[2], scores.view(n, p, -1), deltas.view(n, p, -1),
                                             model.box2box, model.num_classes, size, model.score_threshold,
                                             model.nms_threshold, model.max_detections)


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
    built = cuda_lib.build_libraries()
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
        retinanet_launches, retinanet_nms, retinanet_case = phase_retinanet(report, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    scratch = tempfile.mkdtemp(prefix="chip_smoke_", dir="output")
    try:
        rcnn_launches, rcnn_nms, rcnn_cases = phase_faster_rcnn(report, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    head_launches, head_nms, head_cases = {}, {}, {}
    for kind in HEADS:
        scratch = tempfile.mkdtemp(prefix="chip_smoke_", dir="output")
        try:
            head_launches[kind], head_nms[kind], cases = phase_rcnn_head(report, scratch, kind)
            head_cases.update(cases)
        finally:
            shutil.rmtree(scratch, ignore_errors=True)
    nms_rows = phase_nms_kernel(report, dict(retinanet=retinanet_case, **rcnn_cases, **head_cases))
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
            "launches_faster_rcnn": rcnn_launches[name],  # phase 10, asserted 0
            "launches_mask_rcnn": head_launches["mask"][name],  # phase 11, asserted 0
            "launches_keypoint_rcnn": head_launches["keypoint"][name],  # phase 12, asserted 0
            "max_abs_err": max_err[name], "ms": t["ms_b1"], "plain_ms": t["plain_ms_b1"],
            "bound_ms": t["bound_ms_b1"], "bound_by": t["bound_by_b1"], "library_ms": None,
            "per": "16 launches, the DLA-34 shapes at batch 1, bf16"
            + (" (K1: with the eval epilogue at batches 1 and 16, without at 32)" if name == "dcn_fwd" else ""),
            **{f"ms_b{b}": t[f"ms_b{b}"] for b in t["big_batches"]},
            **{f"bound_ms_b{b}": t[f"bound_ms_b{b}"] for b in t["big_batches"]},
            **({"ms_by_regime": t["regimes"]} if "regimes" in t else {}),
        })
    main_rpn = nms_rows["rpn_test"]
    kernels.append({
        "name": "nms_fixed", "route": "cuda", "source": CSRC + "nms.cu",
        "replaces": "detectron2_centernet_tpu/ops/nms.py:51",
        "launches": sum(retinanet_nms.values()) + sum(rcnn_nms.values())
        + sum(sum(v.values()) for v in head_nms.values()),
        "launches_from": "RetinaNet (phase 9: requests and batch 16, the bench, train_net), Faster R-CNN "
        "(phase 10: requests and batch 16, the training's proposals, the bench, train_net, the ProposalNetwork), "
        "Mask R-CNN and Keypoint R-CNN (phases 11 and 12: requests and batch 16, the training's proposals, the "
        "bench, train_net)",
        "launches_retinanet": retinanet_nms, "launches_faster_rcnn": rcnn_nms,
        "launches_mask_rcnn": head_nms["mask"], "launches_keypoint_rcnn": head_nms["keypoint"],
        "max_abs_err": 0.0 if all(r["equal"] for r in nms_rows.values()) else None,
        "ms": main_rpn["ms"], "plain_ms": main_rpn["plain_ms"], "bound_ms": main_rpn["bound_ms"],
        "bound_by": main_rpn["bound_by"], "library_ms": None,
        "per": f"one launch for the RPN's {main_rpn['rows']} level rows of a batch-16 800² test forward "
        "(indices and validity compared exactly; max_abs_err 0 means equal)",
        **{f"{k}_{name}": r[k] for name, r in nms_rows.items()
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "most_live_in_a_row", "path")},
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
