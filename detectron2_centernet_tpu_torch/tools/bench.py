#!/usr/bin/env python3
"""Benchmark of one detector configuration on one card; prints one JSON line
last, in the shape of the JAX package's ``bench.py``:

  {"metric": "<arch>_<backbone>_<size>_infer_throughput", "value": img/s,
   "unit": "img/s/chip", "vs_baseline": value / baseline, "extra": {...}}

``<arch>`` is ``ctdet`` for CenterNet, ``retinanet`` for RetinaNet,
``faster_rcnn`` for GeneralizedRCNN, ``mask_rcnn`` for it with
``MODEL.MASK_ON``, ``keypoint_rcnn`` with ``MODEL.KEYPOINT_ON``, ``pointrend_rcnn`` with
PointRend's point head, ``rpn`` for ProposalNetwork, ``panoptic_fpn`` for
PanopticFPN (``cascade_panoptic_fpn`` with Cascade ROI heads) and, for
SemanticSegmentor, ``semantic_fpn``, ``deeplab_v3``, ``deeplab_v3_plus`` or
``pointrend_semantic`` by its head (``<backbone>`` ends in ``_fpn`` on an
FPN: ``retinanet_res50_fpn_800``, ``faster_rcnn_res50_fpn_800``).
``value`` is the meta-architecture's ``predict_fn`` throughput at
``TEST.BATCH_SIZE`` (CUDA events over ``ITERS`` calls after 2) on seeded
random images at ``INPUT.TEST_SIZE``. The baselines are ``bench.py``'s: 104
img/s for ctdet (an A100's ctdet DLA-34 rate at 512², twice the paper's
Titan Xp), and for RetinaNet, Faster R-CNN and Mask R-CNN the reference
MODEL_ZOO's R50-FPN inference times (``BASELINE.md``): 0.056, 0.038 and
0.043 s/im on a V100 (1 / 0.056 ≈ 17.9, 1 / 0.038 ≈ 26.3 and 1 / 0.043 ≈
23.3 img/s), and Panoptic FPN R50's 0.053 s/im (≈ 18.9 img/s).
``BASELINE.md`` has no number for the ProposalNetwork, Keypoint R-CNN,
PointRend, Semantic FPN or DeepLab: their ``vs_baseline`` is null. ``extra`` holds:
  * ``predictor_latency_ms``: ``DefaultPredictor`` on one 480x640 image,
    median of ``REQUESTS`` requests after ``REQUEST_WARMUP`` (host clock;
    the call returns host arrays);
  * ``train_step_ms`` and ``train_img_s``: ``DefaultTrainer`` steps at
    ``SOLVER.IMS_PER_BATCH`` on the synthetic stand-in for the train set,
    the card synchronized at each step's start and end, median of the
    ``TRAIN_STEPS`` steps after ``TRAIN_WARMUP`` warm-up steps;
  * ``train_busy_share``: the card's kernel time in one more step, run
    under ``torch.profiler`` after the timed ones, over ``train_step_ms``
    (the profiler lengthens the step it traces, not its kernels);
  * ``peak_memory_gib``: the training's peak of allocated device memory;
  * ``dtype``, ``batch``, ``train_batch``, ``config``;
  * ``card``: ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``.
On the CPU (``MODEL.DEVICE cpu``, for tests at a tiny size) the numbers are
host times and the card's entries are null.

Weights are random, made from ``SEED`` (no trained checkpoint is in the
repository). With no ``--config-file``: ctdet DLA-34
(``configs/COCO-Detection/ctdet_dla_34_1x.yaml``) at 512², bf16.
``Clock``, ``request_ms`` and ``StepClock`` are the clocks of these numbers;
``chip_smoke.py`` times with them too.

Usage:
  python -m detectron2_centernet_tpu_torch.tools.bench [--config-file F] [KEY VALUE ...]
"""

import argparse
import json
import logging
import os
import re
import statistics
import subprocess
import time
from typing import Optional

import numpy as np
import torch

from ..config import get_cfg
from ..data.datasets import ensure_synthetic_datasets
from ..engine import DefaultPredictor, DefaultTrainer, HookBase

# META_ARCHITECTURE (with its R-CNN heads) -> (the metric's <arch>, its
# baseline img/s): bench.py's A100 ctdet DLA-34 512² rate, and the reference
# MODEL_ZOO's R50-FPN V100 inference times, 0.056 s/im for RetinaNet, 0.038
# s/im for Faster R-CNN, 0.043 s/im for Mask R-CNN and 0.053 s/im for Panoptic
# FPN (BASELINE.md:13, :16, :17, :19); none for the ProposalNetwork, Keypoint
# R-CNN, Cascade, Semantic FPN, or an R-CNN on the C4 or DC5 trunk (no time
# of theirs is in BASELINE.md)
ARCHS = {"CenterNet": ("ctdet", 104.0), "RetinaNet": ("retinanet", 1.0 / 0.056),
         "GeneralizedRCNN": ("faster_rcnn", 1.0 / 0.038), "GeneralizedRCNN+mask": ("mask_rcnn", 1.0 / 0.043),
         "GeneralizedRCNN+keypoint": ("keypoint_rcnn", None), "ProposalNetwork": ("rpn", None),
         "CascadeRCNN": ("cascade_rcnn", None), "CascadeRCNN+mask": ("cascade_mask_rcnn", None),
         "CascadeRCNN+keypoint": ("cascade_keypoint_rcnn", None), "PanopticFPN": ("panoptic_fpn", 1.0 / 0.053),
         "CascadePanopticFPN": ("cascade_panoptic_fpn", None), "GeneralizedRCNN+pointrend": ("pointrend_rcnn", None),
         "SemanticSegmentor": ("semantic_fpn", None), "SemanticSegmentor+DeepLabV3Head": ("deeplab_v3", None),
         "SemanticSegmentor+DeepLabV3PlusHead": ("deeplab_v3_plus", None),
         "SemanticSegmentor+PointRendSemSegHead": ("pointrend_semantic", None)}
DEFAULT_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                              "configs", "COCO-Detection", "ctdet_dla_34_1x.yaml")
ITERS = 10  # timed predict_fn calls, after 2
TRAIN_WARMUP, TRAIN_STEPS = 2, 4  # then one more step runs under the profiler
REQUESTS, REQUEST_WARMUP = 20, 3


def backbone_tag(cfg) -> str:
    """``dla34``, ``res18``, ``vovnet39``, ``vovnet19_slim``, ... from the
    config's backbone."""
    name = cfg.MODEL.BACKBONE.NAME
    if "dla34" in name:
        return "dla34"
    if "resnet" in name:
        return f"res{cfg.MODEL.RESNETS.DEPTH}"
    if "vovnet" in name:
        body = cfg.MODEL.VOVNET.CONV_BODY  # e.g. V-19-slim-dw-eSE
        extra = [t for t in body.split("-")[2:] if t != "eSE"]
        return "_".join(["vovnet" + re.sub(r"\D", "", body)] + extra)
    return re.sub(r"^build_|_backbone$", "", name)


def _arch(cfg):
    name = cfg.MODEL.META_ARCHITECTURE
    if name in ("GeneralizedRCNN", "PanopticFPN") and cfg.MODEL.ROI_HEADS.NAME == "CascadeROIHeads":
        name = "Cascade" + ("RCNN" if name == "GeneralizedRCNN" else name)
    mh = cfg.MODEL.ROI_MASK_HEAD
    point_rend = mh.NAME == "PointRendMaskHead" or mh.POINT_HEAD_ON or cfg.MODEL.ROI_HEADS.NAME == "PointRendROIHeads"
    if name in ("GeneralizedRCNN", "CascadeRCNN") and cfg.MODEL.KEYPOINT_ON:
        name += "+keypoint"
    elif name == "GeneralizedRCNN" and cfg.MODEL.MASK_ON and point_rend:
        name += "+pointrend"
    elif name in ("GeneralizedRCNN", "CascadeRCNN") and cfg.MODEL.MASK_ON:
        name += "+mask"
    if name == "SemanticSegmentor" and cfg.MODEL.SEM_SEG_HEAD.NAME != "SemSegFPNHead":
        name += "+" + cfg.MODEL.SEM_SEG_HEAD.NAME
    if name not in ARCHS:
        raise ValueError(f"tools/bench has no metric for META_ARCHITECTURE {name!r}; it benches {sorted(ARCHS)}")
    return ARCHS[name]


def _neck(cfg) -> str:
    """``_fpn``; for an R-CNN on the bare ResNet, ``_dc5`` (a dilated res5)
    or ``_c4`` (res4, the res5 head on the rois); else ""."""
    if "fpn" in cfg.MODEL.BACKBONE.NAME:
        return "_fpn"
    if cfg.MODEL.META_ARCHITECTURE in ("GeneralizedRCNN", "ProposalNetwork"):
        return "_dc5" if cfg.MODEL.RESNETS.RES5_DILATION > 1 else "_c4"
    return ""


def metric_name(cfg) -> str:
    """``<arch>_<backbone>[_fpn|_c4|_dc5]_<size>_infer_throughput``."""
    return f"{_arch(cfg)[0]}_{backbone_tag(cfg)}{_neck(cfg)}_{cfg.INPUT.TEST_SIZE[0]}_infer_throughput"


def baseline_img_s(cfg) -> Optional[float]:
    return _arch(cfg)[1] if _neck(cfg) in ("", "_fpn") else None


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


class Clock:
    """Times on one device: CUDA events on a card, the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def ms(self, fn, iters: int, warmup: int = 2) -> float:
        """Mean ms per call of ``fn`` over ``iters`` calls after ``warmup``."""
        for _ in range(warmup):
            fn()
        self.sync()
        if self.cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / iters
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters


def request_ms(predictor, image) -> list:
    """Host ms of ``REQUESTS`` ``DefaultPredictor`` requests after
    ``REQUEST_WARMUP`` (the call returns host arrays: the device work is
    done)."""
    for _ in range(REQUEST_WARMUP):
        predictor(image)
    latency = []
    for _ in range(REQUESTS):
        t0 = time.perf_counter()
        predictor(image)
        latency.append((time.perf_counter() - t0) * 1e3)
    return latency


class StepClock(HookBase):
    """Wall time of every train step but step ``profiled``, the device
    synchronized at each step's start and end. Step ``profiled`` runs under
    ``torch.profiler`` on a card: its wall time goes to ``profiled_ms``,
    its ``key_averages()`` to ``events`` and their kernel time to
    ``device_ms``."""

    def __init__(self, clock: Clock, profiled: int):
        self.clock, self.profiled = clock, profiled
        self.times, self.profiled_ms, self.events, self.device_ms, self._prof = [], None, None, None, None

    def before_step(self):
        self.clock.sync()
        if self.trainer.iter == self.profiled and self.clock.cuda:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self._prof.__enter__()
        self._t0 = time.perf_counter()

    def after_step(self):
        self.clock.sync()
        ms = (time.perf_counter() - self._t0) * 1e3
        if self.trainer.iter != self.profiled:
            self.times.append(ms)
            return
        self.profiled_ms = ms
        if self._prof is not None:
            from torch.autograd import DeviceType

            self._prof.__exit__(None, None, None)
            self.events = self._prof.key_averages()
            # as the table's "Self CUDA time total": kernels, not annotations
            self.device_ms = sum(e.self_device_time_total for e in self.events
                                 if e.device_type == DeviceType.CUDA and not e.is_user_annotation) / 1e3
            self._prof = None


def bench_inference(predictor) -> dict:
    """``predict_fn`` img/s at ``TEST.BATCH_SIZE`` and the request latency
    of a ``DefaultPredictor``."""
    model, cfg = predictor.model, predictor.cfg
    clock = Clock(model.device)
    rng = np.random.RandomState(0)
    h, w = cfg.INPUT.TEST_SIZE
    n = int(cfg.TEST.BATCH_SIZE)
    images = torch.from_numpy(rng.randint(0, 256, (n, 3, h, w)).astype(np.float32)).to(model.device)
    batch_ms = clock.ms(lambda: model.predict_fn(images), ITERS)
    latency = request_ms(predictor, rng.randint(0, 256, (480, 640, 3)).astype(np.uint8))
    return {"img_s": n * 1e3 / batch_ms, "predict_fn_ms": batch_ms, "batch": n,
            "predictor_latency_ms": statistics.median(latency)}


def bench_training(cfg, weights: Optional[dict] = None):
    """``TRAIN_WARMUP + TRAIN_STEPS + 1`` ``DefaultTrainer`` steps of ``cfg``
    (``weights`` loaded when given), no evaluation, no output files:
    (the training's entries of ``extra``, the trainer, its ``StepClock``)."""
    cfg = cfg.clone()
    cfg.DATASETS.TEST = ()  # the step alone
    cfg.SOLVER.MAX_ITER = TRAIN_WARMUP + TRAIN_STEPS + 1
    cfg.OUTPUT_DIR = ""  # no checkpoint, no metrics file
    ensure_synthetic_datasets(cfg.DATASETS.TRAIN)
    trainer = DefaultTrainer(cfg)
    if weights is not None:
        trainer.model.model.load_state_dict(weights)
    trainer.resume_or_load(resume=False)
    step_clock = StepClock(Clock(cfg.MODEL.DEVICE), profiled=cfg.SOLVER.MAX_ITER - 1)
    trainer.register_hooks([step_clock])
    cuda = step_clock.clock.cuda
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    trainer.train()
    step_ms = statistics.median(step_clock.times[TRAIN_WARMUP:])
    batch = int(cfg.SOLVER.IMS_PER_BATCH)
    entries = {"train_step_ms": step_ms, "train_img_s": batch * 1e3 / step_ms, "train_batch": batch,
               "train_busy_share": step_clock.device_ms / step_ms if cuda else None,
               "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else None}
    return entries, trainer, step_clock


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config-file", default=DEFAULT_CONFIG, metavar="FILE")
    parser.add_argument("opts", nargs=argparse.REMAINDER, help="'KEY VALUE' config overrides")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)
    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(["TPU.DTYPE", "bfloat16", "SEED", 0] + list(args.opts))
    cfg.MODEL.WEIGHTS = ""  # weights from the seed

    extra = {"config": os.path.relpath(args.config_file), "dtype": cfg.TPU.DTYPE,
             "input_size": list(cfg.INPUT.TEST_SIZE)}
    inference = bench_inference(DefaultPredictor(cfg))
    extra.update({k: v for k, v in inference.items() if k != "img_s"})
    extra.update(bench_training(cfg)[0])
    extra["card"] = card() if torch.device(cfg.MODEL.DEVICE).type == "cuda" else None
    value, baseline = round(inference["img_s"], 2), baseline_img_s(cfg)  # vs_baseline: of the printed value
    result = {"metric": metric_name(cfg), "value": value, "unit": "img/s/chip",
              "vs_baseline": round(value / baseline, 3) if baseline else None, "extra": extra}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
