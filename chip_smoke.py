#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``detectron2_centernet_tpu_torch``) on
one NVIDIA card: ctdet DLA-34 at full width, inference through the port's
``DefaultPredictor`` and training through its ``DefaultTrainer``, with every
DCN on the hand-written Hopper kernels (K1 forward, K2-K5 backward); then
the ResNet-18/50-deconv and VoVNet-39 configs, ``tools/train_net`` and
``tools/bench``, RetinaNet R50-FPN, Faster R-CNN R50-FPN with the
ProposalNetwork, Mask R-CNN and Keypoint R-CNN R50-FPN, Cascade Mask R-CNN
R50-FPN, Mask R-CNN R50-C4 with the C4 ProposalNetwork, Faster R-CNN
R50-DC5, the dconv Mask R-CNN R50-FPN (its deformable trunk on the DCN
kernels, at stride 1 and 2), Fast R-CNN R50-FPN on precomputed
proposals, LVIS v1 Mask R-CNN R50-FPN (serving, training from a
``RepeatFactorTrainingSampler``, ``LVISEvaluator``) and the Pascal VOC and
Cityscapes-instance evaluations, Panoptic FPN R50, Semantic FPN R50, the
dconv Cascade GN Panoptic FPN R101 (its 30 deformable blocks on the DCN
kernels), DeepLab V3+ R50 and V3 R-103, PointRend R-CNN R50-FPN and
PointRend's semantic FPN R101, the rotated Faster R-CNN R50-C4 (its rotated
IoU and rotated NMS on the hand-written kernels ``ops/csrc/iou_rotated.cu``
and ``nms.cu``'s rotated pipeline) and TridentNet R50-C4 (Fast and full),
every NMS of the R-CNN and RetinaNet paths on the hand-written NMS kernel
(``ops/csrc/nms.cu``). Every config is read
from its YAML file (``configs/COCO-Detection/``,
``COCO-InstanceSegmentation/``, ``COCO-Keypoints/``, ``Misc/``,
``LVIS-InstanceSegmentation/``, ``PascalVOC-Detection/``, ``Cityscapes/``,
``COCO-PanopticSegmentation/``, ``projects/DeepLab/configs/``,
``projects/PointRend/configs/``) by the port's own reader.

Phases (any failure raises and the script exits non-zero):
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build the four kernel libraries (``ops/csrc/dcn_fwd.cu``,
     ``dcn_bwd.cu``, ``nms.cu``, ``iou_rotated.cu``), one nvcc each, at once, and the COCO matcher (``ops/csrc/cocoeval.cpp``,
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
     steps (2 warm-up, 2 timed, 1 more profiled) and clocks: each step
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
     requests (median of 10, 480x640 → 800²) and ``predict_fn`` at batch 16
     with seeded weights that detect (``rcnn_weights``), the batch-1
     call's profile with the NMS kernel's share, and the same call through
     the plain NMS loop; (b) f32 at batch 2, card against CPU, each stage
     fed the card's inputs on both sides: the RPN heads, the proposals, the
     box predictor (rois that the two devices' log2 puts on different FPN
     levels are counted and left out), the detections; (c) the NMS kernels
     against their plain loop and the algorithm's plain mirror
     (``nms_sorted_reference``) on the card, indices and validity equal, on
     the inputs the main paths gave them: RetinaNet's batch 16, the RPN's
     level rows at test and at training, the box head's batch 16 served
     and in (e)'s evaluation, and the same three of every later R-CNN
     (11-15, 18, 19), each timed beside PR 13's kernel and its bound, with
     the chunks it took; (d) ``tools/bench`` on the config at
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
     (median of 10, 480x640 → 800²; the pasted bool masks, or the decoded
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
     steps from the calibrated init, then ``--eval-only --resume`` on 16
     synthetic scenes (``HEAD_EVAL_IMAGES``, as for 13-16sd): resumed
     at 4, the same dict with ``segm`` (or ``keypoints``) in it; the NMS
     kernel's launches counted per path, and its inputs at test (the
     RPN's, the box head's) and for the training's proposals recorded for
     10c;
  13. Cascade Mask R-CNN, ``Misc/cascade_mask_rcnn_R_50_FPN_1x.yaml`` (3
     class-agnostic stages at IoU 0.5/0.6/0.7, 2000 proposals at training,
     phase 11's mask head), 14. Mask R-CNN R50-C4,
     ``COCO-InstanceSegmentation/mask_rcnn_R_50_C4_1x.yaml`` (the trunk to
     res4, the RPN on it with 6000/1000 proposals at test, the res5 head on
     14² rois feeding the predictor and the 14² mask head), and 15. Faster
     R-CNN R50-DC5, ``COCO-Detection/faster_rcnn_R_50_DC5_1x.yaml`` (res5
     dilated, at stride 16, the RPN and a 7² pooler on it; 800², which the
     YAML leaves unset), bf16, no DCN kernel anywhere, each: (a)
     ``DefaultPredictor`` requests and ``predict_fn`` at batch 16 with
     seeded weights that detect (C4: ROIAlign's and the res5 head's time at
     batch 16, each alone); (b) f32 at batch 2, card against CPU within
     HEAD_TOL times each output's scale, each stage fed the card's boxes:
     every Cascade stage's ``cls_score`` and ``bbox_pred``, C4's res5 output
     and predictor, DC5's RPN on res5 and predictor, the mask logits on the
     top 16 detections and the pasted masks equal; the TF32 control must
     exceed the limit; (c) ``tools/bench`` at ``TEST.BATCH_SIZE`` 16 with its
     train steps at 16 × 800²; (d) ``tools/train_net`` 4 steps, then
     ``--eval-only --resume``: resumed at 4, the same dict; (14e) the C4
     ProposalNetwork's forward and loss. NMS launches: 2 per served call, 1
     per train step; the inputs go to 10c (C4's and DC5's RPN rows of 12 000
     at training hold more candidates than one chunk);
  16k. K1, K2 and K5 against their plain versions at the DCN shapes of the
     deformable trunk at 800² (res3-res5 at stride 1, the three stride-2
     transitions, dilation 2 at 512 x 50²), batch 1 and 16, modulated and
     not, with the DLA shapes' tolerances; their times at batch 16 beside
     the plain versions' and their bounds; a CUDA call at stride 3 raises;
  16. the dconv Mask R-CNN, ``Misc/mask_rcnn_R_50_FPN_1x_dconv_c3-c5.yaml``
     (phase 11's model with DCNv1 in the 13 blocks of res3-res5), and 16s,
     the same with ``STRIDE_IN_1X1`` False (the first block of res3-res5
     runs its DCN at stride 2): 13a-13d's four steps, each deformable
     block among the f32 checks, each trunk forward launching K1 13 times and each
     train step K1, K2 and K5 13 times each, counted, the profiled step's
     DCN device time printed;
  17. Fast R-CNN, ``COCO-Detection/fast_rcnn_R_50_FPN_1x.yaml``: the
     ProposalNetwork writes the proposal files of the synthetic train and
     val scenes, then ``predict_fn`` at batch 16 on the test loader's
     proposals (``DefaultPredictor`` raises), ``tools/train_net`` 4 steps
     and ``--eval-only --resume`` on the files; one NMS launch per call,
     none per train step, no DCN;
  18. LVIS v1 Mask R-CNN, ``LVIS-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.yaml``
     (phase 11's model at 1203 classes, 300 detections an image at
     SCORE_THRESH_TEST 1e-4: the box head's NMS row holds 1000 x 1203
     candidates): (a) ``DefaultPredictor`` requests and
     ``predict_fn`` at batch 1 and 16, peak memory, the profiled calls' NMS
     and mask-predictor shares, the mask head alone on the chosen class
     against all 1203 at batch 1; (b) f32 card against CPU on the card's
     maps: the box predictor and the chosen-class mask logits within
     SAME_INPUT_TOL of their scale, the TF32 control over it; (c)
     ``tools/bench``'s train steps at 16 x 800² from a
     ``RepeatFactorTrainingSampler`` over an LVIS json written here (its
     repeat factors against a numpy recount); (d) ``LVISEvaluator`` through
     ``tools/train_net``'s ``build_evaluator`` and ``inference_on_dataset``
     on another LVIS json; 19. Faster R-CNN on a Pascal VOC tree (XML,
     ``ImageSets``) and Mask R-CNN on a Cityscapes split (``gtFine``
     polygons, 2048x1024 → 1024²), each loaded by the ported loader and
     evaluated the same way: the string image ids reach the evaluators
     unchanged, the numbers are finite, each evaluator's host seconds
     printed. The records carry their pixels in ``image`` (the card's
     machine may have no PIL). Their box-head NMS inputs go to 10c; no DCN;
  20. segmentation: Panoptic FPN R50,
     ``COCO-PanopticSegmentation/panoptic_fpn_R_50_1x.yaml`` (Mask R-CNN
     with ``SemSegFPNHead`` of 128 on p2-p5, 54 stuff classes, the
     panoptic merge), and 20s, Semantic FPN R50,
     ``Misc/semantic_R_50_FPN_1x.yaml``, bf16, each: (a) ``DefaultPredictor``
     requests (the label maps, instances and panoptic segments checked),
     ``predict_fn`` at batch 1 and 16 with seeded weights that detect, the
     label maps (un-warp and argmax on the card) and the host boundary of a
     batch of 16, the panoptic merge's ms per image; (b) f32 at batch 2,
     card against CPU on the card's maps: the sem-seg head (and the box
     predictor and mask logits) within SAME_INPUT_TOL of their scale, the
     TF32 control over it; (c) ``tools/bench`` at ``TEST.BATCH_SIZE`` 16
     with its train steps at 16 × 800² (busy share, peak memory, the
     profiled step's top device ops); (d) ``tools/train_net`` 4 steps from
     the init, then ``--eval-only --resume``: bbox, segm and sem_seg dicts
     (sem_seg alone for 20s), the same in both; no DCN; 20g, the dconv
     Cascade GN Panoptic FPN R101,
     ``Misc/panoptic_fpn_R_101_dconv_cascade_gn_3x.yaml`` (GN trunk, DCNv1
     in the 30 blocks of res3-res5 at STRIDE_IN_1X1 False, 3 Cascade
     stages): served at batch 16, trained at the YAML's batch of 32 or the
     largest of 24 and 16 that fits (printed), K1 launched 30 times per forward and
     K1, K2 and K5 30 times each per train step, counted, the DCN kernels'
     device ms in the profiled step; Panoptic FPN's RPN and box-head NMS
     inputs go to 10c;
  21. DeepLab V3+ R50,
     ``projects/DeepLab/configs/Cityscapes-SemanticSegmentation/deeplab_v3_plus_R_50_os16_poly_90k_bs16.yaml``
     (the DeepLab stem, BatchNorm, res5 at dilation 2 · (1, 2, 4), ASPP
     and the decoder on res2, 19 classes, hard pixel mining), at
     1024x2048, and 21v, DeepLab V3 R-103,
     ``deeplab_v3_R_103_os16_mg124_poly_90k_bs16.yaml`` (at 512², the JAX
     package's default sizes: the YAML sets only ``MIN_SIZE_*``); 22.
     PointRend R-CNN R50-FPN,
     ``projects/PointRend/configs/InstanceSegmentation/pointrend_rcnn_R_50_FPN_1x_coco.yaml``
     (``CoarseMaskHead`` 7², the point head, 5 subdivision steps to 224²),
     800²; 22s. PointRend's semantic FPN R101,
     ``projects/PointRend/configs/SemanticSegmentation/pointrend_semantic_R_101_FPN_1x_cityscapes.yaml``
     (2 refinement steps of 8192 points), 1024x2048; bf16, seeded weights,
     each: (a) ``DefaultPredictor`` requests, ``predict_fn`` at batch 1 and
     16 (peak memory, profile, the trunk's and the head's or the
     subdivision's time); (b) f32 at batch 1, card against CPU on the card's
     maps (the DeepLab head; the coarse heads and the point head on the same
     points; the box predictor) within SAME_INPUT_TOL of their scale, the
     TF32 control over it for the convolutional heads; (c) ``tools/bench``'s
     train steps at the YAML's batch (22s: 32 x 512x1024), with the
     hard-pixel-mining loss timed alone (21c); (d) ``tools/train_net`` 4
     steps and ``--eval-only --resume``: 21d with ``CityscapesSemSegEvaluator``
     on ``*_gtFine_labelTrainIds.png`` files that ``load_cityscapes_semantic``
     reads, 22d bbox and segm; no DCN kernel on any, PointRend R-CNN's NMS
     counted and its RPN and box-head rows added to 10c;
  23. the rotated Faster R-CNN R50-C4 (``configs/Base-RCNN-C4.yaml`` with
     RRPN, RROIHeads, 45 rotated anchors a cell, ROIAlignRotated; no YAML
     has it), 800², bf16 (``phase_rotated``): requests, ``predict_fn`` at
     batch 1 and 16, the f32 stages card against CPU with the TF32 control,
     ``SimpleTrainer`` steps at 16 on rotated gts (the synthetic scenes'
     boxes at seeded angles), ``RotatedCOCOEvaluator`` on 16 scenes; R1 and
     R2 against their plain versions on the path's own inputs (23e);
  24. TridentNet R50-C4 (``projects/TridentNet/configs/
     tridentnet_fast_R_50_C4_1x.yaml``), Fast and full (``phase_trident``):
     requests, ``predict_fn`` at batch 1 and 16 (full mode at 12: 16 is 48
     images through the trunk and res5, past 80 GB), the bench's train steps
     at the YAML's 16, ``tools/train_net`` and ``--eval-only``; full mode's
     merge rows go to 10c; no DCN and no rotated kernel on either;
  25. deployment (``phase_deploy``): (a) ``DefaultTrainer.test_with_TTA`` on
     ctdet DLA-34 (the config's ``TEST.AUG.MIN_SIZES`` rounded up to 32,
     with the flip: 18 variants) over 8 synthetic scenes with
     ``COCOEvaluator``, K1 launched exactly 16 x 18 x 8 times, the AP
     finite, its img/s; the merged detections of one image at two sizes
     with the flip, f32, card against CPU (``merged_close``: pairs within
     the tolerances, at most TTA_MAX_TIES near-ties a side unpaired;
     ``tools/tta_check.py`` runs it over more cases and wrong K1s); (b)
     ``torch.export`` of ctdet
     DLA-34 at 512² (batch 1 and 16) and RetinaNet R50-FPN at 800² (batch
     16), each ``.pt2`` loaded and run in a fresh process that imports the
     port only, with the plain versions replaced by a function that raises:
     K1 16 times a forward and the NMS as eager RetinaNet launches it
     (counted again after the timed calls, and added to the kernels' line
     as counted), none of JAX imported there, the
     outputs eager ``predict_fn``'s within EXPORT_TOL, the export seconds and
     sizes, eager against exported img/s; at PyTorch's TF32 defaults the
     loaded program still equals eager and the bare program (no
     ``ieee_f32``) does not (the control); Faster R-CNN R50-FPN exported
     at batch 1 (its two NMS nodes counted, the program not run); (c)
     int8 PTQ of DLA-34's weights, ``quantization_error`` under the JAX
     package's 0.08, the dequantized weights served; (d)
     ``utils/analysis.py``'s parameters and FLOPs of one image of DLA-34 at
     512², RetinaNet and Faster R-CNN at 800²; (e) ``hooks.TorchProfiler``
     over two DLA-34 train steps: its chrome traces name K1, K2 and K5;
  7. kernel times.
Weights are random, made from a seed (no trained checkpoint is in the repo);
the offset convs get random weights too, so the DCNs sample off the grid.
The R-CNNs' and segmentors' weights are calibrated on the card in f32; the
CenterNets' on the CPU. Each phase's seconds go to the report (``phase_s``).

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
import subprocess
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
from detectron2_centernet_tpu_torch.data import (DatasetCatalog, MetadataCatalog, RepeatFactorTrainingSampler,
                                                 build_detection_test_loader, build_detection_train_loader,
                                                 letterbox_transform, warp_image)
from detectron2_centernet_tpu_torch.data.datasets import (ensure_synthetic_datasets, load_cityscapes_instances,
                                                          load_lvis_json, load_voc_instances,
                                                          register_synthetic_instances)
from detectron2_centernet_tpu_torch.data.datasets.cityscapes import (CITYSCAPES_STUFF_CLASSES,
                                                                     CITYSCAPES_THING_CLASSES,
                                                                     load_cityscapes_semantic)
from detectron2_centernet_tpu_torch.data.datasets.pascal_voc import CLASS_NAMES as VOC_CLASS_NAMES
from detectron2_centernet_tpu_torch.engine import DefaultPredictor, DefaultTrainer, hooks
from detectron2_centernet_tpu_torch.engine.train_loop import HookBase, SimpleTrainer
from detectron2_centernet_tpu_torch.evaluation import COCOEval, RotatedCOCOEvaluator
from detectron2_centernet_tpu_torch.evaluation import evaluator as eval_loop
from detectron2_centernet_tpu_torch.models import build_model
from detectron2_centernet_tpu_torch.models import layers
from detectron2_centernet_tpu_torch.models.backbones import resnet as resnet_module
from detectron2_centernet_tpu_torch.models.backbones.resnet import DeformBottleneckBlock
from detectron2_centernet_tpu_torch.models.layers import DCNv2, DeformConvV2
from detectron2_centernet_tpu_torch.models.meta_arch import centernet, rcnn
from detectron2_centernet_tpu_torch.models.meta_arch import panoptic_fpn as panoptic_module
from detectron2_centernet_tpu_torch.models.meta_arch import rotated_rcnn as rotated_module
from detectron2_centernet_tpu_torch.models.meta_arch import semantic_seg as semseg_module
from detectron2_centernet_tpu_torch.ops import cuda_lib, dcn, fast_cocoeval
from detectron2_centernet_tpu_torch.ops import nms as nms_ops
from detectron2_centernet_tpu_torch.ops.nms import batched_nms_fixed
from detectron2_centernet_tpu_torch.ops import deform_conv as plain
from detectron2_centernet_tpu_torch.models.proposal_generator import rpn as rpn_ops
from detectron2_centernet_tpu_torch.models.proposal_generator import rrpn as rrpn_module
from detectron2_centernet_tpu_torch.models.roi_heads import point_head as point_head_ops
from detectron2_centernet_tpu_torch.models.roi_heads import roi_heads as roi_heads_ops
from detectron2_centernet_tpu_torch.ops import roi_align as roi_ops
from detectron2_centernet_tpu_torch.ops import roi_align_rotated as rot_ops
from detectron2_centernet_tpu_torch.solver import build_optimizer
from detectron2_centernet_tpu_torch.structures.keypoints import heatmaps_to_keypoints
from detectron2_centernet_tpu_torch.structures.masks import paste_masks_in_image
from detectron2_centernet_tpu_torch.tools import bench, rotated_ab, train_net

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
# f32 card vs CPU of a stage fed the same input on both sides (16b: each deformable block on
# its input, the heads on the card's maps), relative to its max |value|: they read 1.4e-6 to
# 7.0e-6 of their scale, and 5.0e-4 to 1.4e-3 with cuDNN's TF32 on (the blocks; the mask
# logits 1.2e-3, the box predictor's fc layers 0: cuBLAS's TF32 is off by default), on an
# H100, so the limit sits ~7-10x from each
SAME_INPUT_TOL = 5e-5
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


def seeded_weights(cfg, images: torch.Tensor, seed: int, device: str = "cpu") -> dict:
    """Random weights from ``seed``, on ``device`` in f32: the model's own init,
    random offset convs (N(0, 1/fan_in): offsets of about a pixel), and
    BatchNorm (and FrozenBatchNorm) statistics measured on ``images`` so
    activations keep their scale through the layers (with identity
    statistics they fade or grow, and the heatmap is flat). Returns the
    state dict for every model of the run."""
    cfg = cfg.clone()
    cfg.MODEL.DEVICE = device
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
            if isinstance(m, (DCNv2, DeformBottleneckBlock)):
                w = m.conv_offset_mask.weight if isinstance(m, DCNv2) else m.conv2_offset.weight
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


def dcn_bound(name, b, cin, cout, hw, dtype, stride=1, modulated=True):
    """Least time of one launch on an hw x hw input at ``stride`` (the work
    counted on its output grid), (ops_ms, bytes_ms): operations over the
    peak rate (the contractions on the bf16 tensor cores or the f32 pipes,
    the per-sample elementwise work on the f32 pipes, the two at once) and
    bytes over the HBM rate (each input read once, each output written
    once; no mask and no d mask when not ``modulated``)."""
    es = torch.tensor([], dtype=dtype).element_size()
    pix = b * plain.out_size(hw, hw, stride)[0] ** 2
    x_b, q_b, w_b, y_b = b * hw * hw * cin * es, pix * (27 if modulated else 18) * 4, cout * cin * 9 * es, \
        pix * cout * es
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
# the R-CNN heads' and variants' tools/train_net evaluations (11d-16sd), as PointRend's 22d: their masks and
# keypoints are pasted and scored on the host, twice a run
HEAD_EVAL_IMAGES = 16
BBOX_KEYS = ("AP", "AP50", "AP75", "APs", "APm", "APl")


def phase_evaluation(report, weights, out_dir):
    print(f"== 4d. evaluation: DefaultTrainer.test, ctdet DLA-34, 512², bf16, synthetic coco_2017_val "
          f"({EVAL_IMAGES} images of {EVAL_SIZE[0]}x{EVAL_SIZE[1]}), batch 16")
    cfg = ctdet_cfg(DLA, "bfloat16")
    cfg.OUTPUT_DIR = out_dir
    fresh_synthetic_val("coco_2017_val")  # over the builtin name, whose COCO files are not here
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


def fresh_synthetic_val(name: str = "coco_2017_val", keypoints: bool = False, num_images: int = EVAL_IMAGES):
    """``name`` (coco_2017_val, or with ``keypoints`` the person-keypoint
    keypoints_coco_2017_val) as the synthetic stand-in of ``num_images``
    images, afresh (its metadata may name a COCO json an earlier phase
    cached in a directory since removed)."""
    os.environ["DETECTRON2_SYNTH_DATA"] = "1"
    for catalog in (DatasetCatalog, MetadataCatalog):
        if name in catalog:
            catalog.remove(name)
    register_synthetic_instances(name, num_images=num_images, image_size=EVAL_SIZE, keypoints=keypoints)


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
    from detectron2_centernet_tpu_torch.tools import bench, train_net

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


def retinanet_weights(cfg, images: torch.Tensor, seed: int, device: str = "cpu") -> dict:
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
    NaN loss within 4 steps. The calibration runs on ``device`` (the CPU
    by default; phase 25 calibrates its own copy on the card)."""
    state = seeded_weights(cfg, images, seed, device)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for k, v in state.items():
            if k.startswith("head.") and k.endswith(".weight"):
                v.copy_(torch.randn(v.shape, generator=g).to(v.device) * math.sqrt(2.0 / v[0].numel()))
        cfg = cfg.clone()
        cfg.MODEL.DEVICE = device
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


NMS_KERNELS = ("nms_init", "nms_hist", "nms_choose", "nms_compact", "nms_sort", "nms_mask", "nms_scan",
               "nms_next")  # ops/csrc/nms.cu


def profiled(fn, calls=3):
    """``fn`` run ``calls`` times under the profiler: per call its kernel
    launches and device ms, the NMS pipeline's device ms (every kernel of
    ``ops/csrc/nms.cu``), and the events."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    nms = [e for e in kernels if any(name in e.key for name in NMS_KERNELS)]
    return dict(launches=sum(e.count for e in kernels) / calls, events=events,
                device_ms=sum(e.self_device_time_total for e in kernels) / calls / 1e3,
                nms_kernel_ms=sum(e.self_device_time_total for e in nms) / calls / 1e3)


def nms_work(boxes, scores, iou_threshold, keep, valid, elements=1 << 26):
    """(live candidates summed over every valid pick, valid picks) of the
    greedy NMS of these inputs, whose picks (``keep``, ``valid``) the plain
    loop gave (the argmax loop's work: the older bound). A live candidate
    is counted at each valid pick up to the first that suppresses or picks
    it: the IoUs of every valid pick against every candidate, in the plain
    loop's rounded steps, ``elements`` (pick, candidate) pairs at a time on
    the card, read back once."""
    rows, cands = scores.shape
    k = keep.shape[1]
    if k == 0 or cands == 0:
        return 0, int(valid.sum())
    areas = nms_ops._areas(boxes)
    index = torch.arange(cands, device=boxes.device)
    death = torch.full((rows, cands), k - 1, dtype=torch.int64, device=boxes.device)  # k - 1: never suppressed
    found = torch.zeros((rows, cands), dtype=torch.bool, device=boxes.device)
    step = max(1, elements // (rows * cands))
    for p0 in range(0, k, step):
        j, ok = keep[:, p0:p0 + step], valid[:, p0:p0 + step]
        box = torch.gather(boxes, 1, j[..., None].expand(-1, -1, 4))[:, :, None]
        lt = torch.maximum(box[..., :2], boxes[:, None, :, :2])
        rb = torch.minimum(box[..., 2:], boxes[:, None, :, 2:])
        wh = torch.clamp(rb - lt, min=0)
        inter = wh[..., 0] * wh[..., 1]
        iou = nms_ops._iou(inter, torch.gather(areas, 1, j)[..., None] + areas[:, None] - inter)
        removed = ((iou > iou_threshold) | (j[..., None] == index)) & ok[..., None]
        hit = removed.any(1)
        death = torch.where(hit & ~found, removed.to(torch.uint8).argmax(1) + p0, death)
        found |= hit
    total = (torch.gather(valid.cumsum(1), 1, death) * torch.isfinite(scores)).sum()
    return int(total), int(valid.sum())


def nms_sorted_work(scores, keep, valid):
    """(sorted candidates up to each row's last valid pick, summed over the
    rows; the IoUs greedy NMS cannot do without: one for each pair of kept
    picks, and one for each suppressed candidate up to the row's last pick,
    with a pick that suppresses it): the least the function needs, from the
    picks' positions in the pick order (score descending, index ascending;
    a stable sort here, off the NMS's path)."""
    live = scores > float("-inf")
    key = torch.where(live, -torch.where(scores == 0, torch.zeros_like(scores), scores), float("inf"))
    order = torch.sort(key, dim=1, stable=True).indices
    pos = torch.empty_like(order).scatter_(1, order, torch.arange(order.shape[1], device=order.device).expand_as(order))
    at = torch.where(valid, torch.gather(pos, 1, keep), -1)
    prefix, kept = at.max(1).values + 1, valid.sum(1)  # a row without a pick: 0, 0
    return int(prefix.sum()), int((kept * (kept - 1) // 2 + prefix - kept).sum())


# PR 13's kernel (one CTA per row, the picks' argmax loop; unchanged from PR 9 to 13) on each 10c case:
# (ms, the run that measured it), from PERF.md §6, on "NVIDIA H100 80GB HBM3, 700.00 W"
PR13_NMS_MS = {
    "retinanet": (0.233, "AV"), "rpn_test": (1.636, "AV"), "rpn_train": (3.254, "AV"), "box_head": (0.413, "AV"),
    "box_head_eval": (4.809, "AV"), "rpn_test_mask": (1.631, "AV"), "box_head_mask": (0.455, "AV"),
    "rpn_train_mask": (3.228, "AV"), "rpn_test_kp": (1.654, "AV"), "box_head_kp": (0.261, "AV"),
    "rpn_train_kp": (4.282, "AV"), "rpn_test_cascade": (1.643, "AV"), "box_head_cascade": (0.413, "AV"),
    "rpn_train_cascade": (4.559, "AV"), "rpn_test_c4": (5.078, "AV"), "box_head_c4": (0.421, "AV"),
    "rpn_train_c4": (15.911, "AV"), "rpn_test_dc5": (5.112, "AV"), "box_head_dc5": (0.454, "AV"),
    "rpn_train_dc5": (16.138, "AV"), "box_head_lvis_b1": (216.589, "BJ"), "box_head_lvis_b16": (366.710, "BJ"),
    "rpn_test_lvis": (1.656, "BG"), "rpn_train_lvis": (3.250, "BG"), "box_head_voc": (0.350, "BG"),
    "box_head_cityscapes": (0.290, "BG"),
}


def host_ms_behind(fn, cycles=40_000_000):
    """(host ms of ``fn()`` issued behind ``cycles`` of a queued device
    sleep, that sleep's device ms): a call that does not wait for the card
    returns long before the sleep ends."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    t0 = time.perf_counter()
    fn()
    host = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return host, start.elapsed_time(end)


def phase_nms_kernel(report, cases):
    """The NMS kernels against the plain loop and the algorithm's plain
    mirror on the card, on the inputs the main paths gave them: indices and
    validity exactly equal; the kernels and the loop timed, beside PR 13's
    kernel (its times from PERF.md, not measured here); the chunks each case
    took; the bound of each case; the host's time for a call issued behind
    queued device work, which fails the phase when the call waited for the
    card."""
    print("== 10c. the NMS kernels (ops/csrc/nms.cu) against the plain loop and nms_sorted_reference on the card, "
          "on the main paths' inputs")
    out = {}
    for name, (boxes, scores, thr, counts) in cases.items():
        rounds = nms_ops.rounds_taken()
        got = nms_ops.greedy_nms(boxes, scores, thr, counts)
        rounds = nms_ops.rounds_taken() - rounds
        want, plain_ms = timed_once(lambda: nms_ops.nms_fixed(boxes, scores, thr, counts))
        mirror = nms_ops.nms_sorted_reference(boxes, scores, thr, counts)
        torch.cuda.synchronize()
        equal = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        mirrored = torch.equal(got[0], mirror[0]) and torch.equal(got[1], mirror[1]) \
            and rounds == int(mirror[2].sum())
        rows, cands = scores.shape
        k = got[0].shape[1]
        kernel_ms = cuda_ms(lambda: nms_ops.greedy_nms(boxes, scores, thr, counts), iters=20)
        host_ms, queued_ms = host_ms_behind(lambda: nms_ops.greedy_nms(boxes, scores, thr, counts))
        live, picks = nms_work(boxes, scores, thr, *want)
        prefix, ious = nms_sorted_work(scores, *got)
        alive = torch.isfinite(scores)
        n_live, row_live = int(alive.sum()), int(alive.sum(1).max())
        # every score read once, the boxes of the sorted candidates up to each row's last pick, the per-row
        # counts, each output written once; ~20 f32 operations (an IoU in its rounded steps) per pair of kept
        # picks and per suppressed candidate up to the row's last pick
        count_bytes = 0 if isinstance(counts, int) else rows * 4
        bytes_ms = (rows * cands * 4 + prefix * 16 + count_bytes + rows * k * 9) / PEAK_BYTES * 1e3
        ops_ms = 20 * ious / PEAK_F32 * 1e3
        bound, by = bound_of(ops_ms, bytes_ms)
        # PR 9-13's bound, the argmax loop's work: every live candidate's box, ~20 operations per (valid pick,
        # live candidate)
        old_bound, old_by = bound_of(20 * live / PEAK_F32 * 1e3,
                                     (rows * cands * 4 + n_live * 16 + count_bytes + rows * k * 9) / PEAK_BYTES * 1e3)
        before_ms, before_run = PR13_NMS_MS.get(name, (None, None))
        max_out = counts if isinstance(counts, int) else sorted(set(counts), reverse=True)
        row = dict(rows=rows, candidates=cands, max_out=max_out, live_candidates=n_live, most_live_in_a_row=row_live,
                   valid_picks=picks, rounds=rounds, sorted_prefix=prefix, needed_ious=ious,
                   live_per_pick_sum=live, equal=equal, equal_to_mirror=mirrored, ms=kernel_ms, plain_ms=plain_ms,
                   host_ms=host_ms, queued_ms=queued_ms, pr13_ms=before_ms, pr13_run=before_run, bound_ms=bound,
                   bound_by=by, bytes_ms=bytes_ms, ops_ms=ops_ms, old_bound_ms=old_bound, old_bound_by=old_by)
        out[name] = row
        before = f"{before_ms:.3f} ms ({before_run})" if before_ms is not None else "not measured"
        print(f"  {name}: {rows} rows x {cands} candidates ({n_live} live, at most {row_live} in a row), picks "
              f"{max_out}, {picks} valid: {'equal' if equal else 'DIFFERENT'} to the loop, "
              f"{'equal' if mirrored else 'DIFFERENT'} to the mirror; {rounds} chunks ({rows} rows); kernels "
              f"{kernel_ms:.3f} ms (PR 13's kernel {before}, from PERF.md), plain loop {plain_ms:.3f} ms; bound "
              f"{bound:.4f} ms ({by}: bytes {bytes_ms:.4f}, operations {ops_ms:.4f}; {prefix} sorted candidates to "
              f"the last picks, {ious} IoUs needed); PR 9-13's bound {old_bound:.4f} ms ({old_by}); the host "
              f"{host_ms:.3f} ms for a call behind {queued_ms:.1f} ms of queued work")
        if not (equal and mirrored):
            raise SystemExit(f"the NMS kernels disagree with their plain versions on {name}")
        if host_ms > queued_ms / 2:
            raise SystemExit(f"the NMS call on {name} waited for the card: {host_ms:.3f} ms on the host behind "
                             f"{queued_ms:.1f} ms of queued work")
    report["nms_kernel"] = out
    return out


FASTER = "faster_rcnn_R_50_FPN_1x"
PROPOSALS = "rpn_R_50_FPN_1x"
RCNN_BATCH = 16  # predict_fn's batch (the YAML keeps TEST.BATCH_SIZE 1); SOLVER.IMS_PER_BATCH of Base-RCNN-FPN
RCNN_STEPS = 4  # tools/train_net's steps in 10e


def rcnn_cfg(name: str, dtype: str, folder: str = "COCO-Detection", extra=()):
    """``configs/<folder>/<name>.yaml`` (over its base YAML) read by the
    port's own YAML reader, with ``extra`` KEY VALUE pairs, the run's
    compute width, output directory and seed over it and no weights file
    (the YAML names ImageNet weights, which are not in the repository)."""
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join("configs", folder, name + ".yaml"))
    cfg.merge_from_list(list(extra) + ["TPU.DTYPE", dtype, "OUTPUT_DIR", "output/chip_smoke", "SEED", 0,
                                       "MODEL.WEIGHTS", ""])
    return cfg


CALIB_ROIS = 200  # C4: proposals of the first image that calibrate the res5 head and scale its predictor


def predictor_inputs(model, feats, boxes: torch.Tensor):
    """(state-dict prefix of each box predictor, the features it reads for
    the (R, 4) ``boxes`` of one image): the box head's output, each Cascade
    stage's, or C4's res5 output averaged."""
    pooled = model.pool(feats, boxes, boxes.shape[0])
    heads = model.model.roi_heads
    if hasattr(heads, "res5"):
        return [("roi_heads.box_predictor", heads.res5(pooled).mean((2, 3)))]
    if isinstance(heads.box_head, torch.nn.ModuleList):
        return [(f"roi_heads.box_predictor.{t}", head(pooled)) for t, head in enumerate(heads.box_head)]
    return [("roi_heads.box_predictor", heads.box_head(pooled))]


def rcnn_weights(cfg, images: torch.Tensor, seed: int, device: str = "cpu") -> Tuple[dict, dict]:
    """(``seeded_weights``: the model's own init with FrozenBN statistics
    measured on ``images`` (C4's res5 head's on the first image's proposals
    too), what a model initialised from ImageNet weights starts from; the
    same with each box predictor scaled on those proposals so that
    ``cls_score``'s logits spread with std 2 and ``bbox_pred``'s deltas with
    std 0.5, weights that detect to serve with). The init's N(0, 0.01)
    predictor puts every class near 1/81, under SCORE_THRESH_TEST 0.05:
    served, its NMS would get no candidate. ``device`` computes them (f32)."""
    init = seeded_weights(cfg, images, seed, device)
    cfg = cfg.clone()
    cfg.MODEL.DEVICE = device
    host = build_model(cfg)
    host.model.load_state_dict(init)
    with torch.no_grad():
        x = host.normalize(images[:1])
        feats, logits, deltas = host.model(x)
        boxes = host.proposals(logits, deltas, x.shape[2:], "test")[0][0]
        res5 = getattr(host.model.roi_heads, "res5", None)
        if res5 is not None:  # the trunk's calibration does not reach the head
            boxes = boxes[:CALIB_ROIS]  # the head costs ~1.5 GFLOP a roi on the CPU

            def calibrate(frozen, inputs):
                frozen.running_mean.copy_(inputs[0].float().mean((0, 2, 3)))
                frozen.running_var.copy_(inputs[0].float().var((0, 2, 3), unbiased=False))

            hooks = [m.register_forward_pre_hook(calibrate) for m in res5.modules()
                     if isinstance(m, layers.FrozenBatchNorm)]
            res5(host.pool(feats, boxes, boxes.shape[0]))
            for h in hooks:
                h.remove()
            init = host.model.state_dict()
        state = dict(init)
        for prefix, head in predictor_inputs(host, feats, boxes):
            for name, std in (("cls_score", 2.0), ("bbox_pred", 0.5)):
                key = f"{prefix}.{name}.weight"
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
    init, weights = rcnn_weights(rcnn_cfg(FASTER, "float32"), letterboxed(rng, "cpu", 2, size), seed=0, device="cuda")
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
    # (every (proposal, class) pair over 0.005), for 10c
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
    init, weights = rcnn_weights(rcnn_cfg(name, "float32", folder), letterboxed(rng, "cpu", 2, size), seed=0,
                                 device="cuda")
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
          f"{HEAD_EVAL_IMAGES} synthetic {val} images {' '.join(thresh)}")
    argv = ["--config-file", os.path.join("configs", folder, name + ".yaml"), "SOLVER.MAX_ITER", str(RCNN_STEPS),
            "SOLVER.IMS_PER_BATCH", str(RCNN_BATCH), "TEST.BATCH_SIZE", str(RCNN_BATCH), "MODEL.WEIGHTS", init_path,
            "OUTPUT_DIR", out_dir, "SEED", "0"] + thresh
    fresh_synthetic_val(val, keypoints=kind == "keypoint", num_images=HEAD_EVAL_IMAGES)
    log_path = f"output/chip_smoke_{kind}_rcnn_train_net_log.txt"
    nms_ops.greedy_nms.launches = 0
    trained, evaluated, resumed, train_s, eval_s = run_train_net(argv, log_path)
    nms_launches["train_net"] = nms_ops.greedy_nms.launches
    want = RCNN_STEPS + 2 * 2 * -(-HEAD_EVAL_IMAGES // RCNN_BATCH)
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


VARIANTS = {  # phase: (number, config folder, config name, its evaluation's mask task or None, extra KEY VALUE pairs)
    "cascade": ("13", "Misc", "cascade_mask_rcnn_R_50_FPN_1x", "segm", ()),
    "c4": ("14", "COCO-InstanceSegmentation", "mask_rcnn_R_50_C4_1x", "segm", ()),
    # the DC5 YAML sets no INPUT size (its reference resizes by MIN_SIZE_TRAIN, up to 800): 800² here, as the others
    "dc5": ("15", "COCO-Detection", "faster_rcnn_R_50_DC5_1x", None,
            ("INPUT.TRAIN_SIZE", "(800, 800)", "INPUT.TEST_SIZE", "(800, 800)")),
    # the deformable trunk (DCNv1 in res3-res5), as the YAML sets it, then with the stride in the 3x3 (the
    # C2-trained dconv configs' STRIDE_IN_1X1 False): the first block of res3-res5 runs the DCN at stride 2
    "dconv": ("16", "Misc", "mask_rcnn_R_50_FPN_1x_dconv_c3-c5", "segm", ()),
    "dconv_s3": ("16s", "Misc", "mask_rcnn_R_50_FPN_1x_dconv_c3-c5", "segm", ("MODEL.RESNETS.STRIDE_IN_1X1", "False")),
}
DCONV_BLOCKS = 4 + 6 + 3  # the DeformBottleneckBlocks of R50's res3-res5: one DCN launch each per forward
C4_PROPOSALS = "rpn_R_50_C4_1x"
HEAD_ROIS = 64  # 14b/15b: the card's first proposals of each image that feed both devices' box heads


def card_vs_cpu(checks, name, got, want, keep=None, rel=HEAD_TOL):
    """Record |card − CPU| against ``rel`` of the CPU's scale (over the rows ``keep``)."""
    diff = (got.cpu() - want).abs()
    err = (diff[keep] if keep is not None else diff).max().item()
    scale = want.abs().max().item()
    checks[name] = dict(max_abs_err=err, scale=scale, rel=rel, tol=rel * scale)


def variant_heads(model, feats, boxes, size, stage_boxes=None):
    """The f32 box-head outputs of 13b-15b on ``boxes`` (N, P, 4): the box
    predictor's (every Cascade stage's, each later stage on the previous
    one's refinements clipped, or on ``stage_boxes[t]`` when given: the
    card's, fed to the CPU; C4's res5 output before it)."""
    n, p = boxes.shape[:2]
    out = {}
    heads = model.model.roi_heads
    if isinstance(getattr(heads, "box_head", None), torch.nn.ModuleList):
        cur = boxes
        for t, b2b in enumerate(model.cascade_box2box):
            if t > 0:
                cur = rcnn.clip_boxes(out[f"stage{t - 1}_next"], size) if stage_boxes is None else \
                    stage_boxes[t].to(boxes.device)
            out[f"stage{t}_boxes"] = cur
            sc, dl = model.model.box_predict(model.pool(feats, cur.reshape(-1, 4), p), t)
            out[f"cls_score_stage{t}"], out[f"bbox_pred_stage{t}"] = sc, dl
            out[f"stage{t}_next"] = b2b.apply_deltas(dl, cur.reshape(-1, 4)).view(n, p, 4)
    elif hasattr(heads, "res5"):
        shared = model.model.res5_transform(model.pool(feats, boxes.reshape(-1, 4), p))
        out["res5_head"] = shared
        out["cls_score"], out["bbox_pred"] = model.model.box_predict_shared(shared)
    else:
        out["cls_score"], out["bbox_pred"] = model.model.box_predict(model.pool(feats, boxes.reshape(-1, 4), p))
    return out


@contextmanager
def counting_deform_blocks():
    """Count the forwards on the card of every ``DeformBottleneckBlock``
    (each launches K1 once) and those with autograd on (each launches K2
    and K5 in its backward): yields the counter {"forward", "train"}."""
    counts = {"forward": 0, "train": 0}
    real = DeformBottleneckBlock.forward

    def counted(self, x):
        if x.is_cuda:
            counts["forward"] += 1
            counts["train"] += int(torch.is_grad_enabled())
        return real(self, x)

    DeformBottleneckBlock.forward = counted
    try:
        yield counts
    finally:
        DeformBottleneckBlock.forward = real


def check_dconv_launches(where, launches, blocks, steps=None, per=DCONV_BLOCKS):
    """The deformable path's DCN launches: K1 once per block forward, ``per``
    (13, or R101's 30) per trunk forward; K2 and K5 once per block forward
    in training (``per`` a step, ``steps`` of them when given); K3 and K4
    never."""
    want = {"dcn_fwd": blocks["forward"], "dcn_bwd_dx": blocks["train"], "dcn_bwd_dq": 0, "dcn_bwd_dw": 0,
            "dcn_bwd_dqdw": blocks["train"]}
    if launches != want or blocks["forward"] % per or (steps is not None and blocks["train"] != per * steps):
        raise SystemExit(f"{where}: expected {per} K1 launches per forward and {per} of K1, K2 and K5 per train step "
                         f"({steps} steps), {want}; got {launches}")


def phase_rcnn_variant(report, out_dir, kind: str):
    """Phases 13 (Cascade Mask R-CNN R50-FPN), 14 (Mask R-CNN R50-C4, with
    the C4 ProposalNetwork), 15 (Faster R-CNN R50-DC5) and 16 (the dconv
    Mask R-CNN R50-FPN, as its YAML sets it and with ``STRIDE_IN_1X1``
    False) at full width through the port's entry points: (a) requests and
    predict_fn at batch 16; (b) the f32 heads (and for dconv each
    deformable block) card against CPU at batch 2 with the TF32 control;
    (c) tools/bench with its train steps at 16 × 800²; (d) tools/train_net
    4 steps then --eval-only --resume. Every NMS through the kernel; no DCN
    kernel anywhere but on the dconv path, where each trunk forward
    launches K1 13 times and each train step K1, K2 and K5 13 times each,
    counted."""
    with counting_deform_blocks() as counted:
        return _rcnn_variant(report, out_dir, kind, counted)


def _rcnn_variant(report, out_dir, kind, counted):
    number, folder, name, task, extra = VARIANTS[kind]
    dconv = kind.startswith("dconv")
    blocks, dcn_launches = collections.Counter(), collections.Counter()

    def settle(part, steps=None):
        """The dconv path's DCN launches of sub-phase ``part``, checked
        against its block forwards and added to the path's; then both counts
        start again from 0."""
        torch.cuda.synchronize()
        launches = read_launches()
        check_dconv_launches(f"{number}{part}", launches, counted, steps)
        dcn_launches.update(launches)
        blocks.update({f"{k}_{part}": v for k, v in counted.items()})
        reset_launches()
        counted.update(forward=0, train=0)
    cfg = rcnn_cfg(name, "bfloat16", folder, extra)
    m = cfg.MODEL
    size = tuple(cfg.INPUT.TEST_SIZE)
    trunk = {"cascade": f"FPN {m.FPN.OUT_CHANNELS}, {len(m.ROI_BOX_CASCADE_HEAD.IOUS)} class-agnostic stages at IoU "
                        f"{list(m.ROI_BOX_CASCADE_HEAD.IOUS)}",
             "c4": f"the trunk to res4, the res5 head on {m.ROI_BOX_HEAD.POOLER_RESOLUTION}² rois",
             "dc5": f"res5 dilated {m.RESNETS.RES5_DILATION}, the RPN and a {m.ROI_BOX_HEAD.POOLER_RESOLUTION}² "
                    f"pooler on it",
             "dconv": f"FPN {m.FPN.OUT_CHANNELS}, deformable res3-res5 (DCNv1, {DCONV_BLOCKS} blocks), STRIDE_IN_1X1 "
                      f"{m.RESNETS.STRIDE_IN_1X1}"}[kind.split("_")[0]]
    print(f"== {number}a. {name}.yaml: ResNet-{m.RESNETS.DEPTH} {m.RESNETS.NORM}, {trunk}, {m.ROI_HEADS.NUM_CLASSES} "
          f"classes, RPN {m.RPN.PRE_NMS_TOPK_TEST}/{m.RPN.POST_NMS_TOPK_TEST} at test and {m.RPN.PRE_NMS_TOPK_TRAIN}/"
          f"{m.RPN.POST_NMS_TOPK_TRAIN} at training, mask head {'on' if m.MASK_ON else 'off'}, bf16: DefaultPredictor "
          f"at {size[0]}², predict_fn at batch {RCNN_BATCH}")
    full = (m.RESNETS.DEPTH == 50 and m.ROI_HEADS.NUM_CLASSES == 80 and size == (800, 800)
            and tuple(cfg.INPUT.TRAIN_SIZE) == (800, 800) and m.ROI_HEADS.BATCH_SIZE_PER_IMAGE == 512
            and m.RESNETS.RES2_OUT_CHANNELS == 256 and m.RESNETS.WIDTH_PER_GROUP == 64)
    full &= {"cascade": m.FPN.OUT_CHANNELS == 256 and m.ROI_HEADS.NAME == "CascadeROIHeads" and m.MASK_ON
             and len(m.ROI_BOX_CASCADE_HEAD.IOUS) == 3 and m.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG
             and m.RPN.POST_NMS_TOPK_TRAIN == 2000 and m.ROI_MASK_HEAD.NUM_CONV == 4,
             "c4": m.ROI_HEADS.NAME == "Res5ROIHeads" and m.MASK_ON and m.ROI_BOX_HEAD.POOLER_RESOLUTION == 14
             and (m.RPN.PRE_NMS_TOPK_TEST, m.RPN.POST_NMS_TOPK_TEST) == (6000, 1000)
             and list(m.RESNETS.OUT_FEATURES) == ["res4"],
             "dc5": m.RESNETS.RES5_DILATION == 2 and m.ROI_BOX_HEAD.POOLER_RESOLUTION == 7
             and list(m.RPN.IN_FEATURES) == ["res5"] and not m.MASK_ON,
             "dconv": m.FPN.OUT_CHANNELS == 256 and m.MASK_ON and list(m.RESNETS.DEFORM_ON_PER_STAGE) == [
                 False, True, True, True] and not m.RESNETS.DEFORM_MODULATED and m.BACKBONE.FREEZE_AT == 2
             and m.RESNETS.STRIDE_IN_1X1 == (kind == "dconv")}[kind.split("_")[0]]
    if not full:
        raise SystemExit(f"{name} is not at full width here: {m}")
    rng = np.random.RandomState(23 + list(VARIANTS).index(kind))
    init, weights = rcnn_weights(rcnn_cfg(name, "float32", folder, extra), letterboxed(rng, "cpu", 2, size), seed=0,
                                 device="cuda")
    reset_launches()  # the count starts at the main path: the weights' calibration forwards are not on it
    counted.update(forward=0, train=0)
    predictor = DefaultPredictor(cfg)
    model = predictor.model
    model.model.load_state_dict(weights)
    if kind in ("c4", "dc5") and not (model.strides == model.roi_strides == [16]):
        raise SystemExit(f"{name}: the RPN and the pooler should read a stride-16 map, got {model.strides}")
    anchors = [a.shape[0] for a in model.anchors_per_level(size)]
    batch = letterboxed(rng, model.device, RCNN_BATCH, size)
    nms_launches = {}
    nms_ops.greedy_nms.launches = 0
    requests = []
    for h, w in ((480, 640), (800, 800), (375, 500)):
        im = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        inst = predictor(im)["instances"]
        check_detections(name, im, inst, model.score_threshold)
        extra_text = ""
        if m.MASK_ON:
            got = inst.pred_masks
            if not (got.dtype == bool and got.shape == (len(inst), h, w) and got.any()):
                raise SystemExit(f"{name}: bad pred_masks for a {h}x{w} image: {got.dtype} {got.shape}")
            extra_text = f", {int(got.sum(axis=(1, 2)).mean())} mask pixels per detection"
        requests.append(len(inst))
        print(f"  request {h}x{w}: {len(inst)} detections, top score {inst.scores.max():.4f}{extra_text}")
    latency = bench.request_ms(predictor, rng.randint(0, 256, (480, 640, 3)).astype(np.uint8))
    nms_inputs = []
    with capture_nms(nms_inputs):
        dets = model.predict_fn(batch)
        with torch.inference_mode():  # the training's proposals
            model.proposals(*model.model(model.normalize(batch))[1:], size, "train")
    torch.cuda.synchronize()
    nms_launches["serving"] = nms_ops.greedy_nms.launches
    calls = 3 + bench.REQUEST_WARMUP + bench.REQUESTS + 1
    if nms_launches["serving"] != 2 * calls + 1:
        raise SystemExit(f"expected two NMS kernel launches per call (RPN, boxes) and one for the training's "
                         f"proposals, {2 * calls + 1}, got {nms_launches['serving']}")
    nms_cases = {f"{k}_{kind}": c for k, c in zip(("rpn_test", "box_head", "rpn_train"), nms_inputs)}
    valid = (dets["scores"] > model.score_threshold).sum(1).cpu()
    side = 2 * (m.ROI_BOX_HEAD.POOLER_RESOLUTION // 2 if kind == "c4" else m.ROI_MASK_HEAD.POOLER_RESOLUTION)
    if not (dets["boxes"].shape == (RCNN_BATCH, 100, 4) and bool(torch.isfinite(dets["boxes"]).all())
            and bool(torch.isfinite(dets["scores"]).all()) and int(valid.min()) > 0
            and (not m.MASK_ON or (tuple(dets["masks"].shape) == (RCNN_BATCH, 100, side, side)
                                   and bool(torch.isfinite(dets["masks"]).all())))):
        raise SystemExit(f"{name}'s predict_fn returned malformed or empty detections: {valid.tolist()}, "
                         f"{ {k: tuple(v.shape) for k, v in dets.items()} }")
    predict_ms = cuda_ms(lambda: model.predict_fn(batch), iters=5)
    b16 = profiled(lambda: model.predict_fn(batch), calls=1)
    if dconv:  # every forward of 16a: 13 K1 launches each, nothing else
        b16["dcn_fwd_ms"] = dcn_device_ms(b16["events"])["dcn_fwd"]
        print(f"  DCN: {counted['forward']} K1 launches in {counted['forward'] // DCONV_BLOCKS} forwards; K1 on the "
              f"card in the profiled batch-{RCNN_BATCH} call: {b16['dcn_fwd_ms']:.3f} ms")
        settle("a")
    print(f"  request (480x640 → 800²) median {statistics.median(latency):.3f} ms of {bench.REQUESTS}; predict_fn "
          f"batch {RCNN_BATCH}: {predict_ms:.3f} ms = {RCNN_BATCH * 1e3 / predict_ms:.2f} img/s, {b16['device_ms']:.3f} "
          f"ms on the card (NMS kernel {b16['nms_kernel_ms']:.3f} ms); valid detections per image "
          f"{int(valid.min())}-{int(valid.max())} of 100; anchors per level {anchors}; NMS kernel launches "
          f"{nms_launches['serving']}; NMS rows: RPN {tuple(nms_inputs[0][1].shape)} at test, "
          f"{tuple(nms_inputs[2][1].shape)} at training, box head {tuple(nms_inputs[1][1].shape)}")
    print(b16["events"].table(sort_by="cuda_time_total", row_limit=12, max_name_column_width=90))
    out = dict(requests=requests, request_ms=latency, request_median_ms=statistics.median(latency),
               predict_fn_b16_ms=predict_ms, predict_fn_b16_device_ms=b16["device_ms"],
               predict_fn_b16_nms_kernel_ms=b16["nms_kernel_ms"], valid_per_image=valid.tolist(), anchors=anchors,
               predict_fn_b16_roi_align_ms=embedding_bag_ms(b16["events"])["forward"],
               predict_fn_b16_dcn_fwd_ms=b16.get("dcn_fwd_ms"))
    if kind == "c4":  # ROIAlign's and the res5 head's shares of a batch-16 call, each timed alone
        with torch.inference_mode():
            feats = model.model(model.normalize(batch))[0]
            boxes, _, _ = model.proposals(*model.model(model.normalize(batch))[1:], size, "test")
            flat = boxes.reshape(-1, 4)
            pool_ms = cuda_ms(lambda: model.pool(feats, flat, boxes.shape[1]), iters=3, warmup=1)
            pooled = model.pool(feats, flat, boxes.shape[1])
            res5_ms = cuda_ms(lambda: model.model.res5_transform(pooled), iters=3, warmup=1)
            del feats, pooled
        print(f"  of a batch-{RCNN_BATCH} call ({predict_ms:.3f} ms): ROIAlign of the {flat.shape[0]} proposals at 14² "
              f"{pool_ms:.3f} ms ({pool_ms / predict_ms:.0%}), the res5 head on them {res5_ms:.3f} ms "
              f"({res5_ms / predict_ms:.0%}), each alone; in the profile above ROIAlign's embedding_bag took "
              f"{out['predict_fn_b16_roi_align_ms']:.3f} ms")
        out.update(roi_align_b16_ms=pool_ms, res5_head_b16_ms=res5_ms)
    del predictor, dets

    top = 16  # the best-scored detection slots of each image for the mask check
    print(f"== {number}b. f32, batch 2, card against CPU: the box heads on the card's first {HEAD_ROIS} proposals of "
          f"each image (each stage fed the card's boxes; rois the two devices' log2 puts on other FPN levels left "
          f"out){', the RPN on res5' if kind == 'dc5' else ''}"
          f"{', the 13 deformable blocks each on the card input, the heads on the card maps' if dconv else ''}"
          f"{f', the mask logits on the top {top} detections and the pasted masks' if m.MASK_ON else ''}")
    cfg32 = rcnn_cfg(name, "float32", folder, extra)
    card = build_model(cfg32)
    cfg32.MODEL.DEVICE = "cpu"
    host = build_model(cfg32)
    for mdl in (card, host):
        mdl.model.load_state_dict(weights)
    x = batch[:2]
    checks = {}

    def heads_on(mdl, feats, boxes, dets_boxes=None, cls=None, stage_boxes=None):
        got = variant_heads(mdl, feats, boxes, size, stage_boxes)
        if dets_boxes is not None:
            mask_in = mdl.pool(feats, dets_boxes, top, None if kind == "c4" else mdl.mask_pooler_resolution)
            if kind == "c4":
                mask_in = mdl.model.res5_transform(mask_in)
            logits = mdl.model.mask_predict(mask_in)
            got["mask_logits"] = logits[torch.arange(len(cls), device=cls.device), cls]
        return got

    with torch.inference_mode():
        # dconv: the seeded deformable trunk magnifies rounding ~100x more than the plain one
        # (tools/rounding_gain.py: random features and offsets), so each block is held to the CPU on the
        # card's own input, and the heads read the card's maps on both sides
        blocks_io = {}
        hooks = [mod.register_forward_hook(lambda mod, inp, out, n=n: blocks_io.__setitem__(n, (inp[0], out)))
                 for n, mod in card.model.named_modules() if isinstance(mod, DeformBottleneckBlock)]
        feats_c, lg_c, dl_c = card.model(card.normalize(x))
        for h in hooks:
            h.remove()
        if dconv:
            feats_h = {k: v.cpu() for k, v in feats_c.items()}
        else:
            feats_h, lg_h, dl_h = host.model(host.normalize(x.cpu()))
        if kind == "dc5":
            for label, c, h in (("objectness_logits_res5", lg_c[0], lg_h[0]), ("anchor_deltas_res5", dl_c[0], dl_h[0])):
                card_vs_cpu(checks, label, c, h)
        props = card.proposals(lg_c, dl_c, size, "test")[0][:, :HEAD_ROIS].contiguous()
        dets = card.predict_fn(x)
        det_boxes = dets["boxes"][:, :top].reshape(-1, 4) if m.MASK_ON else None
        cls = torch.clamp(dets["classes"][:, :top].reshape(-1), 0, card.num_classes - 1) if m.MASK_ON else None
        got_c = heads_on(card, feats_c, props, det_boxes, cls)
        stage_boxes = [got_c.get(f"stage{t}_boxes") for t in range(len(card.cascade_box2box))]
        got_h = heads_on(host, feats_h, props.cpu(), None if det_boxes is None else det_boxes.cpu(),
                         None if cls is None else cls.cpu(), stage_boxes if kind == "cascade" else None)
        card_mods, host_mods = dict(card.model.named_modules()), dict(host.model.named_modules())
        for n, (inp, y) in blocks_io.items():  # K1 on the card, the plain DCN on the CPU, the same input
            key = "block_" + n.split("bottom_up.")[-1]
            got_c[key], got_h[key] = y, host_mods[n](inp.cpu())
            card_vs_cpu(checks, key, y, got_h[key], rel=SAME_INPUT_TOL)
        rel = SAME_INPUT_TOL if dconv else HEAD_TOL  # dconv: the heads read the card's maps on both sides
        flips = 0
        if kind == "cascade":
            for t in range(len(card.cascade_box2box)):
                b = got_c[f"stage{t}_boxes"].reshape(-1, 4)
                same = roi_ops.assign_boxes_to_levels(b, 2, 5).cpu() == roi_ops.assign_boxes_to_levels(b.cpu(), 2, 5)
                flips += int((~same).sum())
                for k in (f"cls_score_stage{t}", f"bbox_pred_stage{t}"):
                    card_vs_cpu(checks, k, got_c[k], got_h[k], same)
        else:
            for k in ("res5_head", "cls_score", "bbox_pred"):
                if k in got_c:
                    card_vs_cpu(checks, k, got_c[k], got_h[k], rel=rel)
        if m.MASK_ON:
            same = torch.ones(len(cls), dtype=torch.bool)
            if kind == "cascade":
                same = roi_ops.assign_boxes_to_levels(det_boxes, 2, 5).cpu() == \
                    roi_ops.assign_boxes_to_levels(det_boxes.cpu(), 2, 5)
                flips += int((~same).sum())
            card_vs_cpu(checks, "mask_logits", got_c["mask_logits"], got_h["mask_logits"], same, rel)
        # the control: cuDNN's TF32 on and the model's ieee_f32 bypassed, the same
        # inputs (dconv: each block on its input, the heads on the card's f32 maps,
        # as in the check); the check must see it (as phase 4b's C9 control)
        with pytorch_default_tf32(), bypass_ieee_f32(rcnn), bypass_ieee_f32(resnet_module):
            feats_t, lg_t, _ = (feats_c, lg_c, dl_c) if dconv else card.model(card.normalize(x))
            got_t = heads_on(card, feats_t, props, det_boxes, cls, stage_boxes if kind == "cascade" else None)
            got_t.update({"block_" + n.split("bottom_up.")[-1]: card_mods[n](inp) for n, (inp, _) in blocks_io.items()})
        tf32 = {}
        for k in checks:
            if k in got_t:
                card_vs_cpu(tf32, k, got_t[k], got_h[k], rel=checks[k]["rel"])
        if kind == "dc5":
            card_vs_cpu(tf32, "objectness_logits_res5", lg_t[0], lg_h[0])
        boundary = None
        if m.MASK_ON:
            b0 = dets["boxes"][0, :top]
            on_card = paste_masks_in_image(dets["masks"][0, :top], b0, size)
            on_host = paste_masks_in_image(dets["masks"][0, :top].cpu(), b0.cpu(), size)
            boundary = (torch.equal(on_card.cpu(), on_host), int(on_card.sum()))
    for k, v in checks.items():
        ok = v["max_abs_err"] <= v["tol"]
        print(f"  {k}: max_abs_err={v['max_abs_err']:.3e} (scale {v['scale']:.3e}, tol {v['rel']:.0e} x scale = "
              f"{v['tol']:.1e}) {'ok' if ok else 'FAIL'}; with cuDNN's TF32 on and ieee_f32 bypassed "
              f"{tf32[k]['max_abs_err']:.3e} = {tf32[k]['max_abs_err'] / v['tol']:.2f}x the tol" if k in tf32 else
              f"  {k}: max_abs_err={v['max_abs_err']:.3e} (tol {v['tol']:.1e}) {'ok' if ok else 'FAIL'}")
    over = {k: v["max_abs_err"] / checks[k]["tol"] for k, v in tf32.items()}
    heads_over = {k: v for k, v in over.items() if not k.startswith("block_")}
    blocks_over = {k: v for k, v in over.items() if k.startswith("block_")}
    print(f"  {flips} rois on another FPN level (tol 0.1%); the TF32 control's largest error in the heads is "
          f"{max(heads_over.values()):.1f}x its tol ({max(heads_over, key=heads_over.get)})"
          f"{'' if max(heads_over.values()) > 1 else ': FAIL'}"
          + (f"; its smallest in a deformable block {min(blocks_over.values()):.1f}x "
             f"({min(blocks_over, key=blocks_over.get)}; each must be over 1)" if blocks_over else "")
          + (f"; pasted masks of the top {top} detections of image 0 on the card and on the CPU: "
             f"{'equal' if boundary[0] else 'DIFFERENT'} ({boundary[1]} mask pixels)" if boundary else ""))
    rois = 2 * HEAD_ROIS * len(card.cascade_box2box) + 2 * top if kind == "cascade" else 0
    if not all(v["max_abs_err"] <= v["tol"] for v in checks.values()) or flips > 1e-3 * max(rois, 1) \
            or (boundary is not None and not boundary[0]):
        raise SystemExit(f"{name}'s f32 heads or host boundary differ between the card and the CPU")
    if not max(heads_over.values()) > 1 or (dconv and not min(blocks_over.values()) > 1):
        raise SystemExit(f"{name}'s f32 head or block check did not see TF32: {over}")
    out.update(card_vs_cpu=checks, tf32_bypass=tf32, level_flips=flips,
               host_boundary_equal=None if boundary is None else boundary[0])
    del card, host, feats_c, feats_h, feats_t
    if dconv:  # the card's f32 forwards: K1 only
        settle("b")

    config_file = os.path.join("configs", folder, name + ".yaml")
    print(f"== {number}c. tools/bench --config-file {folder}/{name}.yaml TEST.BATCH_SIZE {RCNN_BATCH} {' '.join(extra)} "
          f"(the model's own init; train at {RCNN_BATCH} x 800²)")
    captured, bench_training = [], bench.bench_training
    bench.bench_training = lambda c, w=None: captured.append(bench_training(c, w)) or captured[-1]
    nms_ops.greedy_nms.launches = 0
    try:
        result = bench.main(["--config-file", config_file, "TEST.BATCH_SIZE", str(RCNN_BATCH)] + list(extra))
    finally:
        bench.bench_training = bench_training
    torch.cuda.synchronize()
    nms_launches["bench"] = nms_ops.greedy_nms.launches
    calls = 2 + bench.ITERS + bench.REQUEST_WARMUP + bench.REQUESTS
    steps = bench.TRAIN_WARMUP + bench.TRAIN_STEPS + 1
    if nms_launches["bench"] != 2 * calls + steps:
        raise SystemExit(f"expected 2 NMS launches per bench call and 1 per step ({2 * calls + steps}), "
                         f"got {nms_launches['bench']}")
    extra_out = result["extra"]
    _, trainer, clock = captured[0]
    dcn_ms = None
    if dconv:  # the bench's forwards, and 13 x K1, K2 and K5 per train step
        settle("c", steps)
        dcn_ms = dcn_device_ms(clock.events)
    names = ["loss_rpn_cls", "loss_rpn_loc"]
    names += ([f"{k}_stage{t}" for t in range(3) for k in ("loss_cls", "loss_box_reg")] if kind == "cascade"
              else ["loss_cls", "loss_box_reg"]) + (["loss_mask"] if m.MASK_ON else []) + ["total_loss"]
    losses = {k: [v for v, _ in trainer.storage.history(k).values()] for k in names}
    keys = ("predictor_latency_ms", "train_step_ms", "train_busy_share", "peak_memory_gib")
    if not (result["metric"] == bench.metric_name(cfg) and result["value"] > 0 and extra_out["batch"] == RCNN_BATCH
            and extra_out["train_batch"] == RCNN_BATCH and all(extra_out.get(k) is not None for k in keys)):
        raise SystemExit(f"the bench's {name} line is not complete: {result}")
    if any(len(v) != steps or not all(math.isfinite(x) for x in v) for v in losses.values()):
        raise SystemExit(f"{name}'s bench losses are not finite at every step: {losses}")
    roi_align = embedding_bag_ms(clock.events)
    print(f"  {result['metric']}: {result['value']} img/s; request median {extra_out['predictor_latency_ms']:.3f} ms; "
          f"predict_fn batch {extra_out['batch']} {extra_out['predict_fn_ms']:.3f} ms; NMS kernel launches "
          f"{nms_launches['bench']}")
    print(f"  train at {extra_out['train_batch']} x 800²: total {' '.join(f'{v:.4f}' for v in losses['total_loss'])}; "
          f"step times (ms) {' '.join(f'{t:.1f}' for t in clock.times)}, median of {bench.TRAIN_STEPS} "
          f"{extra_out['train_step_ms']:.1f} ms = {extra_out['train_img_s']:.1f} img/s; card busy "
          f"{clock.device_ms:.1f} ms = {extra_out['train_busy_share']:.0%} of the median step; peak memory "
          f"{extra_out['peak_memory_gib']:.2f} GiB; ROIAlign's embedding_bag in the profiled step: forward "
          f"{roi_align['forward']:.2f} ms, backward {roi_align['backward']:.2f} ms"
          + (f"; the DCN kernels in the profiled step: K1 {dcn_ms['dcn_fwd']:.2f} ms, K2 {dcn_ms['dcn_bwd_dx']:.2f} ms, "
             f"K5 {dcn_ms['dcn_bwd_wq']:.2f} ms" if dcn_ms else ""))
    print(clock.events.table(sort_by="cuda_time_total", row_limit=15, max_name_column_width=90))
    out.update(bench=result, bench_losses=losses, bench_step_ms_all=clock.times,
               bench_profiled_device_ms=clock.device_ms, bench_roi_align_ms=roi_align, bench_dcn_ms=dcn_ms)
    del trainer, captured

    init_path = os.path.join(out_dir, "init_weights.pth")
    os.makedirs(out_dir, exist_ok=True)
    if dconv:
        # the offset convs start at 0, as the JAX package and the reference initialise them (an ImageNet
        # checkpoint has none): from the random ones that serve above, training through the 13 deformable
        # blocks diverges within two steps, in f32 as in bf16, with K2 and K5 equal to their plain versions
        # on those steps
        init = {k: torch.zeros_like(v) if ".conv2_offset." in k else v for k, v in init.items()}
    torch.save(init, init_path)
    val = cfg.DATASETS.TEST[0]
    # from the init with calibrated FrozenBN statistics, as 10e; its 80 classes
    # score near 1/81 there, so the threshold goes to 0.005 for detections to evaluate
    # (dconv: 0, since after its 4 steps every class scored under 0.005 and there
    # were no masks to evaluate; its top 20 detections an image, which keeps the
    # segm evaluation's time near the others')
    thresh = "0.0" if dconv else "0.005"
    print(f"== {number}d. tools/train_net on {name}.yaml: {RCNN_STEPS} steps at batch {RCNN_BATCH} from the init with "
          f"calibrated FrozenBN statistics (MODEL.WEIGHTS; DETECTRON2_SYNTH_DATA), then --eval-only --resume on the "
          f"{HEAD_EVAL_IMAGES} synthetic {val} images, ROI_HEADS.SCORE_THRESH_TEST {thresh}")
    argv = ["--config-file", config_file, "SOLVER.MAX_ITER", str(RCNN_STEPS), "SOLVER.IMS_PER_BATCH", str(RCNN_BATCH),
            "TEST.BATCH_SIZE", str(RCNN_BATCH), "MODEL.WEIGHTS", init_path, "MODEL.ROI_HEADS.SCORE_THRESH_TEST",
            thresh, "OUTPUT_DIR", out_dir, "SEED", "0"] + list(extra) + (["TEST.DETECTIONS_PER_IMAGE", "20"] if dconv else [])
    fresh_synthetic_val(val, num_images=HEAD_EVAL_IMAGES)
    log_path = f"output/chip_smoke_{kind}_rcnn_train_net_log.txt"
    nms_ops.greedy_nms.launches = 0
    trained, evaluated, resumed, train_s, eval_s = run_train_net(argv, log_path)
    nms_launches["train_net"] = nms_ops.greedy_nms.launches
    want = RCNN_STEPS + 2 * 2 * -(-HEAD_EVAL_IMAGES // RCNN_BATCH)
    if nms_launches["train_net"] != want:
        raise SystemExit(f"expected {want} NMS kernel launches in train_net, got {nms_launches['train_net']}")
    print(f"  train: {train_s:.1f} s; eval-only: {eval_s:.1f} s; iterations resumed at {resumed}; "
          + "; ".join(f"{t} " + ", ".join(f"{k} {trained[t][k]:.4f}" for k in ("AP", "AP50", "AP75") if k in trained[t])
                      for t in trained))
    if resumed != [0, RCNN_STEPS]:
        raise SystemExit(f"expected to start at iteration 0 and resume at {RCNN_STEPS}, got {resumed}")
    if set(trained) != ({"bbox", task} if task else {"bbox"}):
        raise SystemExit(f"{name}'s evaluation has other tasks than expected: {sorted(trained)}")
    if not same_results(trained, evaluated):
        raise SystemExit(f"{name}'s evaluation after training and the --eval-only --resume one differ: "
                         f"{trained} vs {evaluated}")
    if not all(math.isfinite(trained[t][k]) for t in trained for k in ("AP", "AP50", "AP75")):
        raise SystemExit(f"{name}'s AP dicts are not finite: {trained}")
    print(f"  the two evaluation dicts are identical ({', '.join(sorted(trained))}); NMS kernel launches "
          f"{nms_launches['train_net']}; log in {log_path}")
    out.update(train_net=dict(train_s=train_s, eval_only_s=eval_s, resumed=resumed, results=trained))
    if dconv:
        settle("d", RCNN_STEPS)

    if kind == "c4":
        print(f"== {number}e. ProposalNetwork ({C4_PROPOSALS}.yaml, bf16): predict_fn and loss_fn on 2 images of 800²")
        pcfg = rcnn_cfg(C4_PROPOSALS, "bfloat16")
        rpn_model = build_model(pcfg)
        own = rpn_model.model.state_dict()
        rpn_model.model.load_state_dict({k: v for k, v in weights.items() if k in own})
        nms_ops.greedy_nms.launches = 0
        props = rpn_model.predict_fn(batch[:2])
        g = torch.Generator(device="cuda").manual_seed(0)
        xy = torch.rand(2, 8, 2, generator=g, device="cuda") * 600
        gt = torch.cat([xy, xy + 32 + torch.rand(2, 8, 2, generator=g, device="cuda") * 160], -1)
        rpn_model.model.train()
        total, rpn_losses = rpn_model.loss_fn({"image": batch[:2], "gt_boxes": gt, "gt_valid": torch.ones(
            2, 8, dtype=torch.bool, device="cuda"), "generator": g})
        total.backward()
        torch.cuda.synchronize()
        nms_launches["proposal_network"] = nms_ops.greedy_nms.launches
        grads_finite = all(bool(torch.isfinite(p.grad).all()) for p in rpn_model.model.parameters()
                           if p.grad is not None)
        pvalid = (props["scores"] > 0).sum(1).tolist()
        print(f"  proposals {tuple(props['boxes'].shape)}, valid per image {pvalid}; losses "
              f"{ {k: round(v.item(), 5) for k, v in rpn_losses.items()} }, gradients finite: {grads_finite}; NMS "
              f"kernel launches {nms_launches['proposal_network']}")
        if not (props["boxes"].shape == (2, pcfg.MODEL.RPN.POST_NMS_TOPK_TEST, 4) and min(pvalid) > 0
                and bool(torch.isfinite(total)) and grads_finite and nms_launches["proposal_network"] == 1):
            raise SystemExit("the C4 ProposalNetwork's forward or loss failed")
        out.update(proposal_network=dict(valid=pvalid, losses={k: v.item() for k, v in rpn_losses.items()}))
        del rpn_model

    torch.cuda.synchronize()
    launches = read_launches()
    if dconv:  # 16a-16d, each checked above
        launches = {k: dcn_launches[k] for k in launches}
        out.update(deform_block_calls=dict(blocks))
    print(f"  DCN kernel launches on the {name} path ({number}a-{number}{'e' if kind == 'c4' else 'd'}): {launches}; "
          f"NMS kernel launches {nms_launches}")
    if any(launches.values()) != dconv or (dconv and not all(launches[k] for k in ("dcn_fwd", "dcn_bwd_dx",
                                                                                      "dcn_bwd_dqdw"))):
        raise SystemExit(f"the {name} path launched {'no' if dconv else ''} DCN kernels: {launches}")
    out.update(launches=launches, nms_kernel_launches=nms_launches)
    report[f"{kind}_rcnn"] = out
    return launches, nms_launches, nms_cases


# The DCN shapes of the dconv Mask R-CNN R50-FPN at 800², batch 16: (channels in and out, the input's side,
# stride, dilation, where). Stride 1: the blocks of res3-res5 (4, 6, 3 of them); stride 2: the first block of
# each with STRIDE_IN_1X1 False; dilation 2: a deformable DC5 res5 (no public config pairs them).
DCONV_SHAPES = [
    (128, 100, 1, 1, "res3"), (256, 50, 1, 1, "res4"), (512, 25, 1, 1, "res5"),
    (128, 200, 2, 1, "res3.0 s2"), (256, 100, 2, 1, "res4.0 s2"), (512, 50, 2, 1, "res5.0 s2"),
    (512, 50, 1, 2, "res5 d2"),
]
DCONV_TIMED = ("dcn_fwd", "dcn_bwd_dx", "dcn_bwd_dqdw")  # the deformable trunk's kernels, forward and training


def dconv_case(b, c, hw, stride, dtype, seed, modulated, regime="1px"):
    """Inputs of one deformable-trunk DCN launch on the card: x (b, c, hw,
    hw), offset of ``regime`` and mask (None when not ``modulated``) on the
    output grid of ``stride``, weight, the output cotangent."""
    ho = plain.out_size(hw, hw, stride)[0]
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = lambda *sh: torch.randn(*sh, generator=g, device="cuda")
    x = n(b, c, hw, hw).to(dtype)
    offset = n(b, 18, ho, ho) if regime == "1px" else \
        (torch.rand(b, 18, ho, ho, generator=g, device="cuda") * 2 - 1) * 8.0
    mask = torch.rand(b, 9, ho, ho, generator=g, device="cuda") if modulated else None
    weight = (n(c, c, 3, 3) / math.sqrt(9 * c)).to(dtype)
    return (x, offset, mask, weight), n(b, c, ho, ho).to(dtype)


def dconv_call(name, args, cot, stride, dilation, impl):
    """One kernel (``impl`` "kernel") or its plain version ("plain") on one
    deformable-trunk case."""
    geo = dict(stride=stride, dilation=dilation)
    if name == "dcn_fwd":
        fn = dcn.modulated_deform_conv if impl == "kernel" else plain.modulated_deform_conv
        return lambda: fn(*args, **geo)
    fn = KERNELS[name][0] if impl == "kernel" else PLAIN[name]
    return lambda: fn(*args, cot, **geo)


def phase_dconv_kernels(report):
    """Phase 16k: K1, K2 and K5 against their plain versions at every DCN
    shape of the deformable trunk (stride 1 at res3-res5, the stride-2
    transitions, dilation 2 at 512 x 50²), batch 1 and 16, modulated and
    not, bf16 and (batch 1) f32, offsets of ~1 px and ±8 px at batch 1, and
    at 20g's train batch of 24 as the R101 path runs them (bf16,
    unmodulated), with the DLA shapes' tolerances; then each kernel's time at batch 16, bf16,
    unmodulated (the main path's form) beside its plain version's and its
    bound (``dcn_bound`` at the shape). A CUDA call at stride 3 raises."""
    print("== 16k. K1, K2 and K5 against their plain versions at the deformable trunk's shapes (batch 1 and 16, "
          "modulated and not; bf16, and f32 at batch 1; batch 24 unmodulated), then their times at batch 16")
    rows, bad = [], []
    for c, hw, stride, dilation, where in DCONV_SHAPES:
        for b, dtype, regime, forms in ((1, torch.float32, "1px", (True, False)),
                                        (1, torch.bfloat16, "1px", (True, False)),
                                        (1, torch.bfloat16, "8px", (True, False)),
                                        (RCNN_BATCH, torch.bfloat16, "1px", (True, False)),
                                        (DCONV_TRAIN_BATCH, torch.bfloat16, "1px", (False,))):  # 20gc's launches
            for modulated in forms:
                args, cot = dconv_case(b, c, hw, stride, dtype, seed=c + hw + stride, modulated=modulated,
                                       regime=regime)
                errs = {}
                for name in DCONV_TIMED:
                    got = as_tuple(dconv_call(name, args, cot, stride, dilation, "kernel")())
                    want = as_tuple(dconv_call(name, args, cot, stride, dilation, "plain")())
                    torch.cuda.synchronize()
                    if any((a is None) != (w is None) for a, w in zip(got, want)):
                        raise SystemExit(f"{name} at {where}: d mask present on one side only")
                    pairs = [(a, w) for a, w in zip(got, want) if w is not None]
                    err = max(rel_err(a, w) for a, w in pairs)
                    row = dict(kernel=name, c=c, hw=hw, stride=stride, dilation=dilation, where=where, batch=b,
                               dtype=str(dtype).split(".")[1], regime=regime, modulated=modulated, max_rel_err=err,
                               max_abs_err=max((a.float() - w.float()).abs().max().item() for a, w in pairs),
                               tol=TOL[dtype], ok=err <= TOL[dtype] and all(bool(torch.isfinite(a).all())
                                                                           for a, _ in pairs))
                    rows.append(row)
                    errs[name] = err
                    if not row["ok"]:
                        bad.append(row)
                    del got, want
                print(f"  {where:10s} {c:3d}ch {hw:3d}²→{plain.out_size(hw, hw, stride)[0]:3d}² d{dilation} b{b:<2d} "
                      f"{str(dtype).split('.')[1]:8s} {regime} {'mod  ' if modulated else 'unmod'} tol "
                      f"{TOL[dtype]:.0e}: " + " ".join(f"{k}={v:.1e}" for k, v in errs.items()))
                del args, cot
    report["dconv_kernel_vs_plain"] = rows
    if bad:
        raise SystemExit(f"kernels disagree with their plain versions at the deformable shapes: {bad}")
    try:
        args, cot = dconv_case(1, 16, 12, 1, torch.bfloat16, seed=0, modulated=False)
        dcn.modulated_deform_conv(args[0], torch.zeros(1, 18, 4, 4, device="cuda"), None, args[3], stride=3)
        raise SystemExit("a CUDA call at stride 3 did not raise")
    except ValueError as e:
        print(f"  a CUDA call at stride 3 raises: {e}")

    timing = []
    for c, hw, stride, dilation, where in DCONV_SHAPES:
        args, cot = dconv_case(RCNN_BATCH, c, hw, stride, torch.bfloat16, seed=c, modulated=False)
        ho = plain.out_size(hw, hw, stride)[0]
        for name in DCONV_TIMED:
            ms = cuda_ms(dconv_call(name, args, cot, stride, dilation, "kernel"), iters=5)
            plain_ms = cuda_ms(dconv_call(name, args, cot, stride, dilation, "plain"), iters=2, warmup=1)
            bound_ms, bound_by = bound_of(*dcn_bound(name, RCNN_BATCH, c, c, hw, torch.bfloat16, stride, False))
            timing.append(dict(kernel=name, where=where, c=c, hw=hw, out_hw=ho, stride=stride, dilation=dilation,
                               batch=RCNN_BATCH, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by))
            print(f"  {name:12s} {where:10s} {c:3d}ch {hw:3d}²→{ho:3d}² d{dilation} b{RCNN_BATCH}: {ms:8.3f} ms, "
                  f"plain {plain_ms:9.3f} ms, bound {bound_ms:.3f} ms ({bound_by}), {ms / bound_ms:.1f}x the bound")
        del args, cot
    report["dconv_kernel_ms"] = timing
    return rows, timing


FAST = "fast_rcnn_R_50_FPN_1x"


def dump_proposals(rpn_model, cfg, dataset: str, path: str, topk: int) -> dict:
    """The reference's Fast R-CNN workflow, its first half: the
    ProposalNetwork's top ``topk`` proposals of every image of ``dataset``
    (the test loader's letterbox to the config's size, ``TEST.BATCH_SIZE``
    images a forward), mapped back to the image's pixels and pickled as the
    reference's proposal files are (``ids``, ``boxes`` XYXY_ABS,
    ``objectness_logits``, ``bbox_mode``). Returns {"images", "proposals",
    "forwards"}."""
    import pickle

    from detectron2_centernet_tpu_torch.data import build_detection_test_loader

    rpn_model.post_nms_topk["test"] = topk
    ids, boxes, logits, forwards = [], [], [], 0
    loader = build_detection_test_loader(cfg, dataset)
    for batch in loader:
        images = torch.from_numpy(batch["image"]).to("cuda").permute(0, 3, 1, 2).contiguous()
        with torch.inference_mode():
            x = rpn_model.normalize(images)
            _, lg, dl = rpn_model.model(x)
            pb, plog, pv = rpn_model.proposals(lg, dl, tuple(x.shape[2:]), "test")
        forwards += 1
        pb, plog, pv = pb.cpu().numpy(), plog.float().cpu().numpy(), pv.cpu().numpy()
        for i, image_id in enumerate(batch["image_id"]):  # as the dataset gave them (ROADMAP C22)
            m = batch["warp"][i].astype(np.float64)  # source → network input; the letterbox neither flips nor turns
            b = (pb[i][pv[i]].astype(np.float64) - np.tile(m[:, 2], 2)) / np.tile(np.diag(m[:, :2]), 2)
            ids.append(image_id)
            boxes.append(b.astype(np.float32))
            logits.append(plog[i][pv[i]].astype(np.float32))
    with open(path, "wb") as f:
        pickle.dump({"ids": ids, "boxes": boxes, "objectness_logits": logits, "bbox_mode": 0}, f)
    return dict(images=len(ids), proposals=[len(b) for b in boxes], forwards=forwards)


def phase_fast_rcnn(report, out_dir):
    """Phase 17: Fast R-CNN R50-FPN (``fast_rcnn_R_50_FPN_1x.yaml``:
    ``MODEL.LOAD_PROPOSALS``, ``PrecomputedProposals``) at full width in the
    reference's workflow: (a) the ProposalNetwork (``rpn_R_50_FPN_1x.yaml``)
    writes the proposal files of the synthetic train and val scenes (2000
    and 1000 a image, as the reference's files hold); (b) ``predict_fn`` at
    batch 16 on the test loader's proposals, ``DefaultPredictor`` raising;
    (c) ``tools/bench``'s train steps (``bench.bench_training``; its
    requests go through ``DefaultPredictor``) at 16 × 800² on
    ``PROPOSAL_FILES_TRAIN``: step time, busy share, peak memory; (d)
    ``tools/train_net`` 4 steps from the calibrated init on
    ``PROPOSAL_FILES_TRAIN``, then ``--eval-only --resume`` on
    ``PROPOSAL_FILES_TEST``. Every NMS through the kernel (the RPN's in (a),
    the box head's after), counted; no DCN anywhere."""
    os.makedirs(out_dir, exist_ok=True)
    train_pkl, val_pkl = os.path.join(out_dir, "train_proposals.pkl"), os.path.join(out_dir, "val_proposals.pkl")
    files = ("DATASETS.PROPOSAL_FILES_TRAIN", repr((train_pkl,)), "DATASETS.PROPOSAL_FILES_TEST", repr((val_pkl,)))
    cfg = rcnn_cfg(FAST, "bfloat16", extra=files + ("TEST.BATCH_SIZE", str(RCNN_BATCH)))
    m, d = cfg.MODEL, cfg.DATASETS
    size = tuple(cfg.INPUT.TEST_SIZE)
    full = (m.LOAD_PROPOSALS and m.PROPOSAL_GENERATOR.NAME == "PrecomputedProposals" and m.RESNETS.DEPTH == 50
            and m.FPN.OUT_CHANNELS == 256 and m.ROI_HEADS.NUM_CLASSES == 80 and m.ROI_HEADS.BATCH_SIZE_PER_IMAGE == 512
            and size == tuple(cfg.INPUT.TRAIN_SIZE) == (800, 800) and cfg.SOLVER.IMS_PER_BATCH == RCNN_BATCH
            and (d.PRECOMPUTED_PROPOSAL_TOPK_TRAIN, d.PRECOMPUTED_PROPOSAL_TOPK_TEST) == (2000, 1000))
    if not full:
        raise SystemExit(f"{FAST} is not at full width here: {m}, {d}")
    train, val = d.TRAIN[0], d.TEST[0]
    print(f"== 17a. {FAST}.yaml: ResNet-{m.RESNETS.DEPTH} {m.RESNETS.NORM}, FPN {m.FPN.OUT_CHANNELS}, precomputed "
          f"proposals (top {d.PRECOMPUTED_PROPOSAL_TOPK_TRAIN} at training, {d.PRECOMPUTED_PROPOSAL_TOPK_TEST} at "
          f"test), 80 classes, bf16; the files written by the {PROPOSALS}.yaml ProposalNetwork on the synthetic {train} "
          f"and {val} scenes at {size[0]}²")
    rng = np.random.RandomState(30)
    reset_launches()
    init, weights = rcnn_weights(rcnn_cfg(FAST, "float32"), letterboxed(rng, "cpu", 2, size), seed=0, device="cuda")
    os.environ["DETECTRON2_SYNTH_DATA"] = "1"
    ensure_synthetic_datasets([train])
    fresh_synthetic_val(val)
    pcfg = rcnn_cfg(PROPOSALS, "bfloat16", extra=("TEST.BATCH_SIZE", str(RCNN_BATCH)))
    rpn_model = build_model(pcfg)
    own = rpn_model.model.state_dict()
    rpn_model.model.load_state_dict({k: v for k, v in weights.items() if k in own})
    nms_launches = {}
    nms_ops.greedy_nms.launches = 0
    dumped = {name: dump_proposals(rpn_model, pcfg, name, path, k) for name, path, k in (
        (train, train_pkl, d.PRECOMPUTED_PROPOSAL_TOPK_TRAIN), (val, val_pkl, d.PRECOMPUTED_PROPOSAL_TOPK_TEST))}
    torch.cuda.synchronize()
    nms_launches["proposal_files"] = nms_ops.greedy_nms.launches
    forwards = sum(v["forwards"] for v in dumped.values())
    for name, v in dumped.items():
        print(f"  {name}: {v['images']} images, {min(v['proposals'])}-{max(v['proposals'])} proposals each, "
              f"{v['forwards']} forwards")
    if nms_launches["proposal_files"] != forwards or not all(min(v["proposals"]) > 0 for v in dumped.values()):
        raise SystemExit(f"the proposal files are empty or their NMS launches are not one per forward: {dumped}, "
                         f"{nms_launches}")
    del rpn_model

    print(f"== 17b. predict_fn at batch {RCNN_BATCH} on the test loader's proposals (the mapper's top "
          f"{d.PRECOMPUTED_PROPOSAL_TOPK_TEST}); DefaultPredictor raises")
    from detectron2_centernet_tpu_torch.data import build_detection_test_loader

    model = build_model(cfg)
    model.model.load_state_dict(weights)
    batch = next(iter(build_detection_test_loader(cfg, val)))
    images = torch.from_numpy(batch["image"]).to("cuda").permute(0, 3, 1, 2).contiguous()
    props = [torch.from_numpy(batch[k]).to("cuda") for k in ("proposal_boxes", "proposal_valid")]
    nms_ops.greedy_nms.launches = 0
    dets = model.predict_fn(images, *props)
    predict_ms = cuda_ms(lambda: model.predict_fn(images, *props), iters=5)
    torch.cuda.synchronize()
    nms_launches["serving"] = nms_ops.greedy_nms.launches
    valid = (dets["scores"] > model.score_threshold).sum(1).cpu()
    if not (dets["boxes"].shape == (RCNN_BATCH, 100, 4) and bool(torch.isfinite(dets["boxes"]).all())
            and int(valid.min()) > 0 and nms_launches["serving"] == 1 + 2 + 5):
        raise SystemExit(f"Fast R-CNN's predict_fn: malformed or empty detections, or not one NMS launch per call: "
                         f"{valid.tolist()}, {nms_launches}")
    try:
        DefaultPredictor(cfg)
        raise SystemExit("DefaultPredictor did not raise under MODEL.LOAD_PROPOSALS")
    except ValueError as e:
        print(f"  DefaultPredictor raises: {e}")
    print(f"  predict_fn batch {RCNN_BATCH}: {predict_ms:.3f} ms = {RCNN_BATCH * 1e3 / predict_ms:.2f} img/s; valid "
          f"detections per image {int(valid.min())}-{int(valid.max())} of 100; valid proposals per image "
          f"{int(props[1].sum(1).min())}-{int(props[1].sum(1).max())}; NMS kernel launches {nms_launches['serving']}")
    out = dict(proposal_files=dumped, predict_fn_b16_ms=predict_ms, valid_per_image=valid.tolist())
    del model, dets

    steps = bench.TRAIN_WARMUP + bench.TRAIN_STEPS + 1
    print(f"== 17c. tools/bench's train steps (bench.bench_training) on {FAST}.yaml: {steps} steps at batch "
          f"{cfg.SOLVER.IMS_PER_BATCH} x {cfg.INPUT.TRAIN_SIZE[0]}² from the model's own init, the mapper's top "
          f"{d.PRECOMPUTED_PROPOSAL_TOPK_TRAIN} proposals of the train file")
    nms_ops.greedy_nms.launches = 0
    entries, trainer, clock = bench.bench_training(cfg)
    torch.cuda.synchronize()
    nms_launches["bench"] = nms_ops.greedy_nms.launches
    histories = trainer.storage.histories()
    losses = {k: [v for v, _ in histories[k].values()] for k in ("loss_cls", "loss_box_reg", "total_loss")
              if k in histories}
    roi_align = embedding_bag_ms(clock.events)
    print(f"  total {' '.join(f'{v:.4f}' for v in losses.get('total_loss', []))}; step times (ms) "
          f"{' '.join(f'{t:.1f}' for t in clock.times)}, median of {bench.TRAIN_STEPS} {entries['train_step_ms']:.1f} ms "
          f"= {entries['train_img_s']:.1f} img/s; card busy {clock.device_ms:.1f} ms = "
          f"{entries['train_busy_share']:.0%} of the median step; peak memory {entries['peak_memory_gib']:.2f} GiB; "
          f"ROIAlign's embedding_bag in the profiled step: forward {roi_align['forward']:.2f} ms, backward "
          f"{roi_align['backward']:.2f} ms; NMS kernel launches {nms_launches['bench']}")
    print(clock.events.table(sort_by="cuda_time_total", row_limit=12, max_name_column_width=90))
    if not (entries["train_batch"] == RCNN_BATCH and all(entries[k] is not None for k in (
            "train_step_ms", "train_busy_share", "peak_memory_gib")) and len(losses) == 3
            and all(len(v) == steps and all(math.isfinite(x) for x in v) for v in losses.values())
            and not any(k.startswith("loss_rpn") for k in histories) and nms_launches["bench"] == 0):
        raise SystemExit(f"Fast R-CNN's bench training: {entries}, losses {losses}, NMS launches "
                         f"{nms_launches['bench']} (expected none: no RPN, no box-head NMS in training)")
    out.update(bench_training=entries, bench_losses=losses, bench_step_ms_all=clock.times,
               bench_profiled_device_ms=clock.device_ms, bench_roi_align_ms=roi_align)
    del trainer, clock

    init_path = os.path.join(out_dir, "init_weights.pth")
    torch.save(init, init_path)
    print(f"== 17d. tools/train_net on {FAST}.yaml: {RCNN_STEPS} steps at batch {RCNN_BATCH} from the init with "
          f"calibrated FrozenBN statistics on the train proposal file, then --eval-only --resume on the {EVAL_IMAGES} "
          f"synthetic {val} images and their file, ROI_HEADS.SCORE_THRESH_TEST 0.005")
    argv = ["--config-file", os.path.join("configs", "COCO-Detection", FAST + ".yaml"), "SOLVER.MAX_ITER",
            str(RCNN_STEPS), "SOLVER.IMS_PER_BATCH", str(RCNN_BATCH), "TEST.BATCH_SIZE", str(RCNN_BATCH),
            "MODEL.WEIGHTS", init_path, "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.005", "OUTPUT_DIR", out_dir,
            "SEED", "0"] + list(files)
    log_path = "output/chip_smoke_fast_rcnn_train_net_log.txt"
    nms_ops.greedy_nms.launches = 0
    trained, evaluated, resumed, train_s, eval_s = run_train_net(argv, log_path)
    nms_launches["train_net"] = nms_ops.greedy_nms.launches
    with open(os.path.join(out_dir, "metrics.json")) as f:
        metrics = [json.loads(line) for line in f if line.strip()]
    loss_keys = sorted({k for row in metrics for k in row if k.startswith("loss")})
    want = 2 * -(-EVAL_IMAGES // RCNN_BATCH)  # the box head's NMS per eval batch; no RPN, so none in training
    print(f"  train: {train_s:.1f} s; eval-only: {eval_s:.1f} s; iterations resumed at {resumed}; losses "
          f"{loss_keys}; bbox " + ", ".join(f"{k} {trained['bbox'][k]:.4f}" for k in ("AP", "AP50", "AP75"))
          + f"; NMS kernel launches {nms_launches['train_net']}")
    if resumed != [0, RCNN_STEPS] or loss_keys != ["loss_box_reg", "loss_cls"] or not same_results(trained, evaluated) \
            or not all(math.isfinite(trained["bbox"][k]) for k in ("AP", "AP50", "AP75")) \
            or not all(math.isfinite(row["total_loss"]) for row in metrics if "total_loss" in row) \
            or nms_launches["train_net"] != want:
        raise SystemExit(f"Fast R-CNN's train_net: resumed {resumed}, losses {loss_keys}, {trained} vs {evaluated}, "
                         f"NMS launches {nms_launches['train_net']} (expected {want})")
    out.update(train_net=dict(train_s=train_s, eval_only_s=eval_s, resumed=resumed, results=trained, losses=loss_keys))
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"  DCN kernel launches on the Fast R-CNN path (17a-17d): {launches}; NMS kernel launches {nms_launches}")
    if any(launches.values()):
        raise SystemExit(f"the Fast R-CNN path launched DCN kernels: {launches}")
    out.update(launches=launches, nms_kernel_launches=nms_launches)
    report["fast_rcnn"] = out
    return launches, nms_launches


LVIS_FOLDER, LVIS = "LVIS-InstanceSegmentation", "mask_rcnn_R_50_FPN_1x"
# LVIS v1's 1203 categories by frequency bucket: 337 rare, 461 common, 405 frequent
LVIS_BUCKETS = (("r", 337), ("c", 461), ("f", 405))
LVIS_TRAIN_IMAGES, LVIS_VAL_IMAGES = 48, 8
# the config's 0.001 is for LVIS v1's 100 170 training images; over 48 images every category is in
# more than 1/48 of them, so 0.25 keeps the rare categories repeated
LVIS_REPEAT_THRESHOLD = 0.25
EVAL_BATCH = 4  # TEST.BATCH_SIZE of the three evaluations (the YAMLs keep 1)


def lvis_scenes(path: str, n: int, seed: int, size=EVAL_SIZE) -> dict:
    """Write an LVIS v1 json of ``n`` synthetic scenes (coloured rectangles,
    each with its rectangle as a polygon) to ``path``; return each image's
    pixels by image id. Its 1203 categories carry LVIS v1's rare, common and
    frequent counts; each image holds two of 4 frequent categories, every
    second one one of 12 common ones, every third one a rare one of its own
    (so the images' repeat factors differ); each names two other frequent
    ones as negative and its first as not exhaustive, and is named by
    ``coco_url``."""
    rng = np.random.RandomState(seed)
    freq = [b for b, k in LVIS_BUCKETS for _ in range(k)]
    ids = {b: [i + 1 for i, f in enumerate(freq) if f == b] for b, _ in LVIS_BUCKETS}
    h, w = size
    images, anns, pixels = [], [], {}
    for i in range(n):
        img_id = 1000 * seed + i
        img = np.full((h, w, 3), 32, np.uint8)
        cats = [int(c) for c in rng.choice(ids["f"][:4], 2)] + [int(rng.choice(ids["c"][:12]))] * (i % 2 == 0) \
            + [ids["r"][i]] * (i % 3 == 0)
        for c in cats:
            bw, bh = int(rng.randint(40, w // 2)), int(rng.randint(40, h // 2))
            x0, y0 = int(rng.randint(0, w - bw)), int(rng.randint(0, h - bh))
            img[y0:y0 + bh, x0:x0 + bw] = rng.randint(64, 255, 3)
            anns.append({"id": len(anns) + 1, "image_id": img_id, "category_id": c, "bbox": [x0, y0, bw, bh],
                         "area": bw * bh, "segmentation": [[x0, y0, x0 + bw, y0, x0 + bw, y0 + bh, x0, y0 + bh]]})
        images.append({"id": img_id, "height": h, "width": w,
                       "coco_url": f"http://images.cocodataset.org/val2017/{img_id:012d}.jpg",
                       "neg_category_ids": [int(c) for c in rng.choice(ids["f"][4:40], 2, replace=False)],
                       "not_exhaustive_category_ids": [cats[0]]})
        pixels[img_id] = img
    categories = [{"id": i + 1, "name": f"category_{i + 1}", "synonyms": [f"category_{i + 1}"], "frequency": f}
                  for i, f in enumerate(freq)]
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": categories}, f)
    return pixels


def voc_tree(root: str, n: int, seed: int, size=(375, 500)):
    """A VOC2007 tree of ``n`` images (``Annotations/*.xml``,
    ``ImageSets/Main/test.txt``; file ids "000005", "000012", ...), a few
    objects of the 20 classes each, some difficult; returns (its directory,
    each image's pixels by file id)."""
    rng = np.random.RandomState(seed)
    d = os.path.join(root, "VOC2007")
    for sub in ("Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    h, w = size
    ids = [f"{5 + 7 * i:06d}" for i in range(n)]
    pixels = {}
    for fid in ids:
        img = np.full((h, w, 3), 32, np.uint8)
        objs = []
        for j in range(rng.randint(2, 6)):
            bw, bh = int(rng.randint(30, w // 2)), int(rng.randint(30, h // 2))
            x0, y0 = int(rng.randint(1, w - bw)), int(rng.randint(1, h - bh))
            img[y0:y0 + bh, x0:x0 + bw] = rng.randint(64, 255, 3)
            objs.append(f"<object><name>{VOC_CLASS_NAMES[rng.randint(20)]}</name><difficult>{int(j == 1)}"
                        f"</difficult><bndbox><xmin>{x0}</xmin><ymin>{y0}</ymin><xmax>{x0 + bw}</xmax>"
                        f"<ymax>{y0 + bh}</ymax></bndbox></object>")
        with open(os.path.join(d, "Annotations", fid + ".xml"), "w") as f:
            f.write(f"<annotation><size><width>{w}</width><height>{h}</height><depth>3</depth></size>"
                    f"{''.join(objs)}</annotation>")
        pixels[fid] = img
    with open(os.path.join(d, "ImageSets", "Main", "test.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    return d, pixels


def cityscapes_tree(root: str, n: int, seed: int, size=(1024, 2048)):
    """A Cityscapes val split of ``n`` images over two cities
    (``gtFine/<city>/*_gtFine_polygons.json``; each
    ``leftImg8bit/<city>/*_leftImg8bit.png`` an empty file, whose name the
    loader globs): cars, persons and the other thing classes as polygons of
    8-16 points at street sizes, a ``cargroup`` crowd, a ``road`` and a
    2-point polygon; returns (image dir, gtFine dir, pixels by file name)."""
    rng = np.random.RandomState(seed)
    image_dir = os.path.join(root, "cityscapes", "leftImg8bit", "val")
    gt_dir = os.path.join(root, "cityscapes", "gtFine", "val")
    h, w = size
    pixels = {}
    for i in range(n):
        city = ("frankfurt", "lindau")[i % 2]
        base = f"{city}_{i:06d}_000019"
        for d in (image_dir, gt_dir):
            os.makedirs(os.path.join(d, city), exist_ok=True)
        open(os.path.join(image_dir, city, base + "_leftImg8bit.png"), "wb").close()
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        objects = []
        for label in ["car"] * 4 + ["person"] * 3 + ["rider", "truck", "bicycle", "cargroup", "road"]:
            r, cx, cy = rng.uniform(20, 160), rng.uniform(200, w - 200), rng.uniform(300, h - 200)
            t = np.sort(rng.uniform(0, 2 * np.pi, rng.randint(8, 17)))
            poly = np.stack([cx + r * 1.5 * np.cos(t), cy + r * np.sin(t)], 1).round(1)
            img[int(cy - r * 0.7):int(cy + r * 0.7), int(cx - r):int(cx + r)] = rng.randint(64, 255, 3)
            objects.append({"label": label, "polygon": poly.tolist()})
        objects.append({"label": "car", "polygon": [[10.0, 20.0], [30.0, 40.0]]})
        with open(os.path.join(gt_dir, city, base + "_gtFine_polygons.json"), "w") as f:
            json.dump({"imgHeight": h, "imgWidth": w, "objects": objects}, f)
        pixels[base + "_leftImg8bit.png"] = img
    return image_dir, gt_dir, pixels


def register_with_pixels(name: str, load, pixels: dict, **meta) -> None:
    """``name``, afresh, as the records of the ported loader ``load`` with
    each image's pixels in its ``image`` field (the mapper reads them there:
    the card's machine may have no PIL), and the metadata ``meta``."""
    for catalog in (DatasetCatalog, MetadataCatalog):
        if name in catalog:
            catalog.remove(name)
    DatasetCatalog.register(name, lambda: [dict(r, image=pixels[r["image_id"]]) for r in load()])
    MetadataCatalog.get(name).set(**meta)


def evaluate_on_card(model, cfg, name):
    """``tools/train_net``'s evaluator of ``name`` through
    ``inference_on_dataset`` and the test loader on the card: (its results,
    the image ids its ``process()`` saw, timings: the loop's wall seconds,
    the host seconds of its post-processing and ``process()`` calls and of
    ``evaluate()``, the NMS kernel's launches)."""
    evaluator = train_net.Trainer.build_evaluator(cfg, name)
    seen, timing = [], {}
    process, evaluate = evaluator.process, evaluator.evaluate

    def recording(inputs, outputs):
        seen.extend(i["image_id"] for i in inputs)
        process(inputs, outputs)

    def timed():
        t0 = time.perf_counter()
        results = evaluate()
        timing["evaluate_s"] = time.perf_counter() - t0
        return results

    evaluator.process, evaluator.evaluate = recording, timed
    nms_ops.greedy_nms.launches = 0
    t0 = time.perf_counter()
    results = eval_loop.inference_on_dataset(model.predict_fn, build_detection_test_loader(cfg, name), evaluator,
                                             model.postprocess, model.device)
    torch.cuda.synchronize()
    stats = eval_loop.LAST_INFERENCE_STATS
    timing.update(wall_s=time.perf_counter() - t0, host_process_s=stats["eval_s"], images=stats["total_images"],
                  evaluator=type(evaluator).__name__, nms_launches=nms_ops.greedy_nms.launches)
    timing["host_s"] = timing["host_process_s"] + timing["evaluate_s"]
    return results, seen, timing


def check_finite(where, results, task, keys):
    numbers = results.get(task, {})
    if not all(k in numbers and math.isfinite(numbers[k]) for k in keys):
        raise SystemExit(f"{where}: the {task} numbers are not complete and finite: {results}")


def phase_lvis(report, out_dir):
    """Phase 18: LVIS v1 Mask R-CNN R50-FPN at full width (1203 classes, 300
    detections an image at SCORE_THRESH_TEST 1e-4) through the port's entry
    points: (a) requests and predict_fn at batch 1 and 16, peak memory, the
    profiled call's NMS and mask-predictor shares; (b) the f32 box predictor
    and chosen-class mask logits card against CPU on the card's maps, with
    the TF32 control; (c) tools/bench's train steps at batch 16 from a
    RepeatFactorTrainingSampler over an LVIS json this phase writes; (d)
    LVISEvaluator through tools/train_net's build_evaluator and
    inference_on_dataset. Every NMS through the kernel, no DCN kernel."""
    cfg = rcnn_cfg(LVIS, "bfloat16", LVIS_FOLDER)
    m = cfg.MODEL
    size = tuple(cfg.INPUT.TEST_SIZE)
    k = int(cfg.TEST.DETECTIONS_PER_IMAGE)
    c = int(m.ROI_HEADS.NUM_CLASSES)
    print(f"== 18a. {LVIS_FOLDER}/{LVIS}.yaml: ResNet-{m.RESNETS.DEPTH} {m.RESNETS.NORM}, FPN {m.FPN.OUT_CHANNELS}, "
          f"{c} classes, {k} detections an image at SCORE_THRESH_TEST {m.ROI_HEADS.SCORE_THRESH_TEST}, mask head of "
          f"{m.ROI_MASK_HEAD.NUM_CONV} convs of {m.ROI_MASK_HEAD.CONV_DIM}, {cfg.DATALOADER.SAMPLER_TRAIN}, bf16: "
          f"DefaultPredictor at {size[0]}², predict_fn at batch 1 and {RCNN_BATCH}")
    if not (m.RESNETS.DEPTH == 50 and m.FPN.OUT_CHANNELS == 256 and size == (800, 800) and c == 1203 and k == 300
            and m.ROI_HEADS.SCORE_THRESH_TEST == 1e-4 and m.MASK_ON and m.ROI_MASK_HEAD.NUM_CONV == 4
            and m.ROI_MASK_HEAD.CONV_DIM == 256 and m.RPN.POST_NMS_TOPK_TEST == 1000
            and m.ROI_HEADS.BATCH_SIZE_PER_IMAGE == 512
            and cfg.DATALOADER.SAMPLER_TRAIN == "RepeatFactorTrainingSampler"):
        raise SystemExit(f"{LVIS} is not at full width here: {m}")
    rng = np.random.RandomState(18)
    reset_launches()
    init, weights = rcnn_weights(rcnn_cfg(LVIS, "float32", LVIS_FOLDER), letterboxed(rng, "cpu", 2, size), seed=0,
                                 device="cuda")
    del init
    predictor = DefaultPredictor(cfg)
    model = predictor.model
    model.model.load_state_dict(weights)
    nms_launches = {}
    nms_ops.greedy_nms.launches = 0
    for h, w in ((480, 640), (800, 800)):
        im = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        inst = predictor(im)["instances"]
        b = inst.pred_boxes.tensor
        if not (0 < len(inst) <= k and np.isfinite(b).all() and (b >= 0).all() and (b[:, [0, 2]] <= w).all()
                and (b[:, [1, 3]] <= h).all() and (inst.scores > 1e-4).all() and (inst.pred_classes < c).all()
                and inst.pred_masks.dtype == bool and inst.pred_masks.shape == (len(inst), h, w)
                and inst.pred_masks.any()):
            raise SystemExit(f"{LVIS}: bad detections for a {h}x{w} image: {inst}")
        print(f"  request {h}x{w}: {len(inst)} detections of {len(np.unique(inst.pred_classes))} classes, scores "
              f"{inst.scores.min():.2e}-{inst.scores.max():.4f}, {int(inst.pred_masks.sum(axis=(1, 2)).mean())} mask "
              f"pixels per detection")
    latency = bench.request_ms(predictor, rng.randint(0, 256, (480, 640, 3)).astype(np.uint8))
    b1, b16 = letterboxed(rng, model.device, 1, size), letterboxed(rng, model.device, RCNN_BATCH, size)
    nms_inputs = []
    with capture_nms(nms_inputs):
        d1 = model.predict_fn(b1)
        d16 = model.predict_fn(b16)
        with torch.inference_mode():  # the training's proposals
            model.proposals(*model.model(model.normalize(b16))[1:], size, "train")
    torch.cuda.synchronize()
    nms_launches["serving"] = nms_ops.greedy_nms.launches
    calls = 2 + bench.REQUEST_WARMUP + bench.REQUESTS + 2
    if nms_launches["serving"] != 2 * calls + 1:
        raise SystemExit(f"expected two NMS kernel launches per call (RPN, boxes) and one for the training's "
                         f"proposals, {2 * calls + 1}, got {nms_launches['serving']}")
    nms_cases = {"box_head_lvis_b1": nms_inputs[1], "rpn_test_lvis": nms_inputs[2], "box_head_lvis_b16": nms_inputs[3],
                 "rpn_train_lvis": nms_inputs[4]}
    live = {n: int(torch.isfinite(nms_cases[n][1]).sum(1).max()) for n in ("box_head_lvis_b1", "box_head_lvis_b16")}
    valid = (d16["scores"] > 1e-4).sum(1).cpu()
    if not (tuple(d16["masks"].shape) == (RCNN_BATCH, k, 28, 28) and tuple(d1["masks"].shape) == (1, k, 28, 28)
            and bool(torch.isfinite(d16["masks"]).all()) and int(valid.min()) > 0):
        raise SystemExit(f"{LVIS}'s predict_fn returned malformed masks or no detections: "
                         f"{tuple(d16['masks'].shape)}, {valid.tolist()}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms_b1 = cuda_ms(lambda: model.predict_fn(b1), iters=5)
    ms_b16 = cuda_ms(lambda: model.predict_fn(b16), iters=3, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    p1 = profiled(lambda: model.predict_fn(b1), calls=1)
    p16 = profiled(lambda: model.predict_fn(b16), calls=1)
    bmm = {n: sum(e.device_time_total for e in p["events"] if e.key == "aten::bmm") / 1e3
           for n, p in (("b1", p1), ("b16", p16))}
    # the mask head alone on the batch-16 detections, and at batch 1 against the whole (300, 1203, 28, 28)
    # tensor (at batch 16 the whole tensor would be 18 GB)
    with torch.inference_mode():
        feats = model.model(model.normalize(b16))[0]
        cls = torch.clamp(d16["classes"].reshape(-1), 0, c - 1)
        pooled = model.pool(feats, d16["boxes"].reshape(-1, 4), k, model.mask_pooler_resolution)
        head_b16 = cuda_ms(lambda: model.model.mask_predict(pooled, cls), iters=3, warmup=1)
        head_b1 = cuda_ms(lambda: model.model.mask_predict(pooled[:k], cls[:k]), iters=5)
        whole_b1 = cuda_ms(lambda: model.model.mask_predict(pooled[:k]), iters=3, warmup=1)
        rows = model.model.mask_predict(pooled[:k], cls[:k]).float()
        whole = model.model.mask_predict(pooled[:k])[torch.arange(k, device=cls.device), cls[:k]].float()
        rows_err = ((rows - whole).abs().max() / whole.abs().max()).item()
    del feats, pooled
    print(f"  request (480x640 → 800²) median {statistics.median(latency):.3f} ms of {bench.REQUESTS}; predict_fn "
          f"batch 1 {ms_b1:.3f} ms ({p1['device_ms']:.3f} on the card, NMS kernel {p1['nms_kernel_ms']:.3f} = "
          f"{p1['nms_kernel_ms'] / p1['device_ms']:.0%}, chosen-class mask predictor {bmm['b1']:.3f}); batch "
          f"{RCNN_BATCH} {ms_b16:.3f} ms = {RCNN_BATCH * 1e3 / ms_b16:.2f} img/s ({p16['device_ms']:.3f} on the card, "
          f"NMS kernel {p16['nms_kernel_ms']:.3f} = {p16['nms_kernel_ms'] / p16['device_ms']:.0%}, chosen-class mask "
          f"predictor {bmm['b16']:.3f}); peak memory {peak:.2f} GiB; valid detections per image "
          f"{int(valid.min())}-{int(valid.max())} of {k}; live candidates in the box head's rows: at most "
          f"{live['box_head_lvis_b1']} (batch 1), {live['box_head_lvis_b16']} (batch {RCNN_BATCH}) of "
          f"{nms_cases['box_head_lvis_b16'][1].shape[1]}; NMS kernel launches {nms_launches['serving']}")
    print(f"  the mask head alone: batch {RCNN_BATCH} ({RCNN_BATCH * k} rois, the chosen class) {head_b16:.3f} ms = "
          f"{head_b16 / ms_b16:.0%} of the call; batch 1 chosen class {head_b1:.3f} ms, all {c} classes "
          f"{whole_b1:.3f} ms; the chosen rows against the whole tensor's: {rows_err:.2e} of its scale")
    print(p16["events"].table(sort_by="cuda_time_total", row_limit=12, max_name_column_width=90))
    out = dict(request_ms=latency, request_median_ms=statistics.median(latency), predict_fn_b1_ms=ms_b1,
               predict_fn_b16_ms=ms_b16, img_s_b16=RCNN_BATCH * 1e3 / ms_b16, peak_memory_gib=peak,
               device_ms_b1=p1["device_ms"], device_ms_b16=p16["device_ms"], nms_kernel_ms_b1=p1["nms_kernel_ms"],
               nms_kernel_ms_b16=p16["nms_kernel_ms"], mask_predictor_ms=bmm, mask_head_b16_ms=head_b16,
               mask_head_b1_ms=head_b1, mask_head_b1_all_classes_ms=whole_b1, chosen_rows_vs_whole=rows_err,
               live_in_box_head_rows=live, valid_per_image=valid.tolist())
    if rows_err > 1e-2:
        raise SystemExit(f"the chosen-class mask logits differ from the whole tensor's rows: {rows_err:.3e}")
    del predictor, d1, d16

    top = 16
    print(f"== 18b. f32, batch 2, card against CPU on the card's maps: the box predictor on the first {HEAD_ROIS} "
          f"proposals of each image, the chosen-class mask logits of the top {top} detections; with cuDNN's TF32 "
          f"and ieee_f32 bypassed as the control")
    cfg32 = rcnn_cfg(LVIS, "float32", LVIS_FOLDER)
    card = build_model(cfg32)
    cfg32.MODEL.DEVICE = "cpu"
    host = build_model(cfg32)
    for mdl in (card, host):
        mdl.model.load_state_dict(weights)
    x = b16[:2]
    checks, tf32 = {}, {}
    with torch.inference_mode():
        dets = card.predict_fn(x)
        feats, lg, dl = card.model(card.normalize(x))
        props = card.proposals(lg, dl, size, "test")[0][:, :HEAD_ROIS]
        pooled = card.pool(feats, props.reshape(-1, 4), HEAD_ROIS)
        boxes = dets["boxes"][:, :top].reshape(-1, 4)
        cls = torch.clamp(dets["classes"][:, :top].reshape(-1), 0, c - 1)
        mpooled = card.pool(feats, boxes, top, card.mask_pooler_resolution)
        want = dict(zip(("cls_score", "bbox_pred"), host.model.box_predict(pooled.cpu())),
                    mask_logits=host.model.mask_predict(mpooled.cpu(), cls.cpu()))
        got = dict(zip(("cls_score", "bbox_pred"), card.model.box_predict(pooled)),
                   mask_logits=card.model.mask_predict(mpooled, cls))
        with pytorch_default_tf32(), bypass_ieee_f32(rcnn):
            ctrl = dict(zip(("cls_score", "bbox_pred"), card.model.box_predict(pooled)),
                        mask_logits=card.model.mask_predict(mpooled, cls))
    for n in got:
        card_vs_cpu(checks, n, got[n], want[n], rel=SAME_INPUT_TOL)
        card_vs_cpu(tf32, n, ctrl[n], want[n], rel=SAME_INPUT_TOL)
    for n, ch in checks.items():
        print(f"  {n}: max_abs_err={ch['max_abs_err']:.3e} (scale {ch['scale']:.3e}, tol {SAME_INPUT_TOL:.0e} x "
              f"scale) {'ok' if ch['max_abs_err'] <= ch['tol'] else 'FAIL'}; TF32 control "
              f"{tf32[n]['max_abs_err'] / tf32[n]['tol']:.2f}x the tol")
    if any(ch["max_abs_err"] > ch["tol"] for ch in checks.values()):
        raise SystemExit(f"{LVIS}'s f32 heads differ between the card and the CPU: {checks}")
    if not max(t["max_abs_err"] / t["tol"] for t in tf32.values()) > 1:
        raise SystemExit(f"{LVIS}'s f32 head check did not see TF32: {tf32}")
    out.update(card_vs_cpu=checks, tf32_control=tf32)
    del card, host, feats, dets

    steps = bench.TRAIN_WARMUP + bench.TRAIN_STEPS + 1
    data = os.path.join(out_dir, "lvis")
    os.makedirs(data, exist_ok=True)
    train, val = "chip_smoke_lvis_v1_train", "chip_smoke_lvis_v1_val"
    train_json, val_json = os.path.join(data, "lvis_v1_train.json"), os.path.join(data, "lvis_v1_val.json")
    pixels = lvis_scenes(train_json, LVIS_TRAIN_IMAGES, seed=1)
    register_with_pixels(train, lambda: load_lvis_json(train_json, data, train), pixels, json_file=train_json,
                         image_root=data, evaluator_type="lvis")
    print(f"== 18c. tools/bench's train steps at batch {RCNN_BATCH} x 800² ({steps}, the last profiled) from the "
          f"model's init, RepeatFactorTrainingSampler (REPEAT_THRESHOLD {LVIS_REPEAT_THRESHOLD}) over the "
          f"{LVIS_TRAIN_IMAGES} images of an LVIS json (load_lvis_json)")
    tcfg = rcnn_cfg(LVIS, "bfloat16", LVIS_FOLDER, extra=("DATASETS.TRAIN", f"('{train}',)",
                                                          "DATALOADER.REPEAT_THRESHOLD", str(LVIS_REPEAT_THRESHOLD)))
    nms_ops.greedy_nms.launches = 0
    entries, trainer, clock = bench.bench_training(tcfg)
    torch.cuda.synchronize()
    nms_launches["bench_training"] = nms_ops.greedy_nms.launches
    sampler = trainer.data_loader.sampler
    records = DatasetCatalog.get(train)
    cats = [np.unique([a["category_id"] for a in r["annotations"]]) for r in records]
    share = {int(x): np.mean([x in cs for cs in cats]) for x in np.unique(np.concatenate(cats))}
    recount = np.array([max(max(1.0, math.sqrt(LVIS_REPEAT_THRESHOLD / share[int(x)])) for x in cs) for cs in cats])
    names = ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "loss_mask", "total_loss")
    losses = {n: [v for v, _ in trainer.storage.history(n).values()] for n in names}
    print(f"  sampler {type(sampler).__name__}: repeat factors {sampler.repeat_factors.min():.3f}-"
          f"{sampler.repeat_factors.max():.3f} (mean {sampler.repeat_factors.mean():.3f}), a numpy recount's largest "
          f"difference {np.abs(sampler.repeat_factors - recount).max():.1e}; loss_mask "
          f"{' '.join(f'{v:.4f}' for v in losses['loss_mask'])}; loss_cls {' '.join(f'{v:.4f}' for v in losses['loss_cls'])}")
    print(f"  step times (ms) {' '.join(f'{t:.1f}' for t in clock.times)}, median of {bench.TRAIN_STEPS} "
          f"{entries['train_step_ms']:.1f} ms = {entries['train_img_s']:.1f} img/s; card busy {clock.device_ms:.1f} ms = "
          f"{entries['train_busy_share']:.0%} of the median step; peak memory {entries['peak_memory_gib']:.2f} GiB; "
          f"NMS kernel launches {nms_launches['bench_training']}")
    print(clock.events.table(sort_by="cuda_time_total", row_limit=12, max_name_column_width=90))
    if not (isinstance(sampler, RepeatFactorTrainingSampler) and np.allclose(sampler.repeat_factors, recount, rtol=1e-12)
            and sampler.repeat_factors.max() > 1.0 and nms_launches["bench_training"] == steps
            and all(len(v) == steps and all(math.isfinite(x) for x in v) for v in losses.values())):
        raise SystemExit(f"{LVIS}'s training: sampler {type(sampler).__name__}, factors {sampler.repeat_factors} vs "
                         f"{recount}, NMS launches {nms_launches['bench_training']}, losses {losses}")
    out.update(bench_training=entries, bench_losses=losses, bench_step_ms_all=clock.times,
               bench_profiled_device_ms=clock.device_ms, repeat_factors=sampler.repeat_factors.tolist(),
               repeat_factors_recount_max_diff=float(np.abs(sampler.repeat_factors - recount).max()))
    del trainer, clock

    pixels = lvis_scenes(val_json, LVIS_VAL_IMAGES, seed=2)
    register_with_pixels(val, lambda: load_lvis_json(val_json, data, val), pixels, json_file=val_json,
                         image_root=data, evaluator_type="lvis")
    print(f"== 18d. LVISEvaluator (tools/train_net's build_evaluator) through inference_on_dataset on the "
          f"{LVIS_VAL_IMAGES} images of an LVIS json, batch {EVAL_BATCH}, the serving weights")
    ecfg = rcnn_cfg(LVIS, "bfloat16", LVIS_FOLDER, extra=("TEST.BATCH_SIZE", str(EVAL_BATCH)))
    ecfg.OUTPUT_DIR = data
    model = build_model(ecfg)
    model.model.load_state_dict(weights)
    results, seen, timing = evaluate_on_card(model, ecfg, val)
    nms_launches["evaluation"] = timing["nms_launches"]
    print(f"  {timing['evaluator']}: " + ", ".join(f"{n} {v:.4f}" for n, v in results.get("bbox", {}).items())
          + f"; {timing['images']} images in {timing['wall_s']:.2f} s, host {timing['host_s']:.2f} s (post-processing "
          f"and process() {timing['host_process_s']:.2f}, evaluate() {timing['evaluate_s']:.2f}); NMS kernel launches "
          f"{timing['nms_launches']}")
    check_finite(LVIS, results, "bbox", ("AP", "AP50", "AP75", "APr", "APc", "APf"))
    if timing["evaluator"] != "LVISEvaluator" or seen != [r["image_id"] for r in DatasetCatalog.get(val)] \
            or timing["nms_launches"] != 2 * -(-LVIS_VAL_IMAGES // EVAL_BATCH):
        raise SystemExit(f"{LVIS}'s evaluation: {timing}, ids {seen}")
    out.update(evaluation=dict(results=results, **timing))
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"  DCN kernel launches on the LVIS path (18a-18d): {launches}; NMS kernel launches {nms_launches}")
    if any(launches.values()):
        raise SystemExit(f"the LVIS path launched DCN kernels: {launches}")
    out.update(launches=launches, nms_kernel_launches=nms_launches)
    report["lvis_rcnn"] = out
    return launches, nms_launches, nms_cases


def phase_voc_cityscapes(report, out_dir):
    """Phase 19: Faster R-CNN R50-FPN on a Pascal VOC tree (20 classes) and
    Mask R-CNN R50-FPN on a Cityscapes val split (8 classes, 2048x1024
    images to 1024²), each written in its own file format, loaded by the
    ported loader and evaluated on the card through tools/train_net's
    build_evaluator and inference_on_dataset: the string image ids reach
    the evaluator as the dataset gave them, the numbers are finite, the
    host seconds are reported. Every NMS through the kernel, no DCN."""
    reset_launches()
    out, nms_launches, nms_cases = {}, {}, {}
    specs = (("voc", "PascalVOC-Detection", "faster_rcnn_R_50_FPN", 20, 8, "bbox", ("AP", "AP50", "AP75")),
             # Cityscapes: 2 images; the evaluator's per-class mask loops run on the host (PERF.md §3: ~5 s an image)
             ("cityscapes", "Cityscapes", "mask_rcnn_R_50_FPN", 8, 2, "segm", ("AP", "AP50")))
    for number, (kind, folder, name, classes, n, task, keys) in zip("ab", specs):
        cfg = rcnn_cfg(name, "bfloat16", folder, extra=("TEST.BATCH_SIZE", str(EVAL_BATCH)))
        cfg.OUTPUT_DIR = out_dir
        size = tuple(cfg.INPUT.TEST_SIZE)
        if not (cfg.MODEL.RESNETS.DEPTH == 50 and cfg.MODEL.FPN.OUT_CHANNELS == 256
                and cfg.MODEL.ROI_HEADS.NUM_CLASSES == classes and cfg.MODEL.MASK_ON == (kind == "cityscapes")
                and size == ((800, 800) if kind == "voc" else (1024, 1024))):
            raise SystemExit(f"{name} is not at full width here: {cfg.MODEL}")
        if kind == "voc":
            d, pixels = voc_tree(out_dir, n, seed=19)
            dataset = "chip_smoke_voc_2007_test"
            register_with_pixels(dataset, lambda d=d: load_voc_instances(d, "test"), pixels,
                                 thing_classes=list(VOC_CLASS_NAMES), dirname=d, year=2007, split="test",
                                 evaluator_type="pascal_voc")
        else:
            image_dir, gt_dir, pixels = cityscapes_tree(out_dir, n, seed=19)
            dataset = "chip_smoke_cityscapes_fine_instance_seg_val"
            register_with_pixels(dataset, lambda i=image_dir, g=gt_dir: load_cityscapes_instances(i, g), pixels,
                                 thing_classes=list(CITYSCAPES_THING_CLASSES), evaluator_type="cityscapes_instance",
                                 image_dir=image_dir, gt_dir=gt_dir)
        records = DatasetCatalog.get(dataset)
        print(f"== 19{number}. {folder}/{name}.yaml ({classes} classes, {size[0]}², bf16, seeded weights that detect): "
              f"{n} images of {records[0]['height']}x{records[0]['width']} in its own file format, "
              f"{sum(len(r['annotations']) for r in records)} objects; the evaluator of evaluator_type "
              f"'{MetadataCatalog.get(dataset).evaluator_type}' through inference_on_dataset, batch {EVAL_BATCH}")
        rng = np.random.RandomState(190 + len(kind))
        _, weights = rcnn_weights(rcnn_cfg(name, "float32", folder), letterboxed(rng, "cpu", 2, size), seed=0,
                                  device="cuda")
        model = build_model(cfg)
        model.model.load_state_dict(weights)
        inputs = []
        with capture_nms(inputs):
            results, seen, timing = evaluate_on_card(model, cfg, dataset)
        nms_launches[kind] = timing["nms_launches"]
        nms_cases[f"box_head_{kind}"] = inputs[1]  # the first batch's
        print(f"  {timing['evaluator']}: " + ", ".join(f"{k} {v:.4f}" for k, v in results.get(task, {}).items()
                                                     if k in keys) + f"; ids seen {seen[:2]}...; {timing['images']} "
              f"images in {timing['wall_s']:.2f} s, host {timing['host_s']:.2f} s (post-processing and process() "
              f"{timing['host_process_s']:.2f}, evaluate() {timing['evaluate_s']:.2f}); NMS kernel launches "
              f"{timing['nms_launches']}")
        check_finite(name, results, task, keys)
        want_ids = [r["image_id"] for r in records]
        if not (seen == want_ids and all(isinstance(i, str) for i in seen)
                and timing["nms_launches"] == 2 * -(-n // EVAL_BATCH)):
            raise SystemExit(f"{name}: the evaluator saw the ids {seen} (the dataset's {want_ids}); {timing}")
        out[kind] = dict(results=results, ids=seen, **timing)
        del model
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"  DCN kernel launches on the VOC and Cityscapes paths: {launches}; NMS kernel launches {nms_launches}")
    if any(launches.values()):
        raise SystemExit(f"the VOC or Cityscapes path launched DCN kernels: {launches}")
    out.update(launches=launches, nms_kernel_launches=nms_launches)
    report["voc_cityscapes"] = out
    return launches, nms_launches, nms_cases


SEGMENTATION = {  # kind: (sub-phase, config folder, config name)
    "panoptic": ("20", "COCO-PanopticSegmentation", "panoptic_fpn_R_50_1x"),
    "semantic": ("20s", "Misc", "semantic_R_50_FPN_1x"),
    "panoptic_dconv": ("20g", "Misc", "panoptic_fpn_R_101_dconv_cascade_gn_3x"),
}
R101_DEFORM_BLOCKS = 4 + 23 + 3  # the DeformBottleneckBlocks of R101's res3-res5: one K1 launch each per forward
# 20g's train batch, cut from the YAML's SOLVER.IMS_PER_BATCH of 32: on "NVIDIA H100 80GB HBM3, 700.00 W" batch 32
# asked for 4.12 GiB more with 76.8 GiB in use, batch 24 peaked at 56.88 GiB (chip_smoke.py's 20gc)
DCONV_TRAIN_BATCH = 24


def check_segmentation(name, out, size, num_classes, panoptic):
    """A request's ``sem_seg`` (H, W) int64 labels of the head's classes
    and, for Panoptic FPN, the instances' masks and ``panoptic_seg``: int32
    segment ids, each id of ``segments_info`` (things then stuff, 1, 2, ...)
    and no other."""
    h, w = size
    sem = out["sem_seg"]
    ok = sem.shape == (h, w) and sem.dtype == np.int64 and 0 <= sem.min() and sem.max() < num_classes
    if panoptic:
        inst = out["instances"]
        pan, info = out["panoptic_seg"]
        ids = [s["id"] for s in info]
        things = [s for s in info if s["isthing"]]
        ok &= (inst.pred_masks.dtype == bool and inst.pred_masks.shape == (len(inst), h, w) and pan.shape == (h, w)
               and pan.dtype == np.int32 and ids == list(range(1, len(info) + 1))
               and set(np.unique(pan).tolist()) <= {0, *ids} and all(s["score"] >= 0.5 for s in things)
               and [s["isthing"] for s in info] == sorted((s["isthing"] for s in info), reverse=True))
    if not ok:
        raise SystemExit(f"{name}: a malformed segmentation for a {h}x{w} image: {out}")


def phase_segmentation(report, out_dir):
    """Phase 20: Panoptic FPN R50 (20), Semantic FPN R50 (20s) and the dconv
    Cascade GN Panoptic FPN R101 (20g) at full width through the port's
    entry points. 20a/20sa: requests (the label maps, the instances and the
    panoptic segments checked), predict_fn at batch 1 and 16 with seeded
    weights that detect, the batch-16 profile, the label maps' and the
    panoptic merge's time; 20b/20sb: f32 card against CPU on the card's
    maps (the box predictor and the mask logits, the sem-seg head) within
    SAME_INPUT_TOL of their scale, the TF32 control over it; 20c/20sc:
    tools/bench with its train steps at 16 x 800²; 20d/20sd: tools/train_net
    4 steps from the init, then --eval-only --resume: bbox, segm and sem_seg
    dicts (sem_seg alone for Semantic FPN). 20g: served at batch 16 and
    trained at batch 24 (the YAML's 32 does not fit the card), K1 30
    times per forward and K1, K2 and K5 30 times each per train step,
    counted, the DCN kernels' device ms in the profiled step. Every NMS
    through the kernel; no DCN kernel on the R50 paths."""
    out, nms_launches, nms_cases, dcn_launches = {}, {}, {}, {}
    for kind in ("panoptic", "semantic"):
        scratch = os.path.join(out_dir, kind)
        os.makedirs(scratch, exist_ok=True)
        out[kind] = _segmentation_r50(kind, scratch, nms_launches, nms_cases)
    with counting_deform_blocks() as counted:
        out["panoptic_dconv"] = _segmentation_dconv(counted, nms_launches, dcn_launches)
    report["segmentation"] = out
    return dcn_launches, nms_launches, nms_cases


def _segmentation_r50(kind, out_dir, nms_launches, nms_cases):
    number, folder, name = SEGMENTATION[kind]
    panoptic = kind == "panoptic"
    cfg = rcnn_cfg(name, "bfloat16", folder)
    m = cfg.MODEL
    s = m.SEM_SEG_HEAD
    size = tuple(cfg.INPUT.TEST_SIZE)
    print(f"== {number}a. {folder}/{name}.yaml: {m.META_ARCHITECTURE}, ResNet-{m.RESNETS.DEPTH} {m.RESNETS.NORM}, FPN "
          f"{m.FPN.OUT_CHANNELS}, SemSegFPNHead of {s.CONVS_DIM} on {list(s.IN_FEATURES)}, {s.NUM_CLASSES} stuff "
          f"classes" + (f", Mask R-CNN of {m.ROI_HEADS.NUM_CLASSES} thing classes, the panoptic merge" if panoptic else "")
          + f", bf16: DefaultPredictor at {size[0]}², predict_fn at batch 1 and {RCNN_BATCH}")
    full = (m.RESNETS.DEPTH == 50 and m.FPN.OUT_CHANNELS == 256 and size == (800, 800) and s.NUM_CLASSES == 54
            and s.CONVS_DIM == 128 and list(s.IN_FEATURES) == ["p2", "p3", "p4", "p5"] and s.COMMON_STRIDE == 4)
    if panoptic:
        full &= (m.META_ARCHITECTURE == "PanopticFPN" and m.MASK_ON and m.ROI_HEADS.NUM_CLASSES == 80
                 and s.LOSS_WEIGHT == 0.5 and m.PANOPTIC_FPN.COMBINE.ENABLED)
    if not full:
        raise SystemExit(f"{name} is not at full width here: {m}")
    rng = np.random.RandomState(200 + len(kind))
    reset_launches()
    calib = letterboxed(rng, "cpu", 2, size)
    cfg32 = rcnn_cfg(name, "float32", folder)
    if panoptic:
        init, weights = rcnn_weights(cfg32, calib, seed=0, device="cuda")
    else:
        init = weights = seeded_weights(cfg32, calib, seed=0, device="cuda")
    predictor = DefaultPredictor(cfg)
    model = predictor.model
    model.model.load_state_dict(weights)
    res = {}
    nms_ops.greedy_nms.launches = 0
    for h, w in ((480, 640), (800, 800), (375, 500)):
        im = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        got = predictor(im)
        check_segmentation(name, got, (h, w), s.NUM_CLASSES, panoptic)
        text = f"{len(np.unique(got['sem_seg']))} labels in sem_seg"
        if panoptic:
            inst = got["instances"]
            check_detections(name, im, inst, model.score_threshold)
            info = got["panoptic_seg"][1]
            text += (f"; {len(inst)} detections, top score {inst.scores.max():.4f}; panoptic segments "
                     f"{sum(x['isthing'] for x in info)} things, {sum(not x['isthing'] for x in info)} stuff")
        print(f"  request {h}x{w}: {text}")
    latency = bench.request_ms(predictor, rng.randint(0, 256, (480, 640, 3)).astype(np.uint8))
    b1, b16 = letterboxed(rng, model.device, 1, size), letterboxed(rng, model.device, RCNN_BATCH, size)
    nms_inputs = []
    with capture_nms(nms_inputs):
        d16 = model.predict_fn(b16)
        if panoptic:
            with torch.inference_mode():  # the training's proposals
                model.proposals(*model.model(model.normalize(b16))[1:], size, "train")
    torch.cuda.synchronize()
    nms_launches[kind] = {"serving": nms_ops.greedy_nms.launches}
    calls = 3 + bench.REQUEST_WARMUP + bench.REQUESTS + 1
    if nms_launches[kind]["serving"] != (2 * calls + 1 if panoptic else 0):
        raise SystemExit(f"{name}: expected {2 * calls + 1 if panoptic else 0} NMS kernel launches, got "
                         f"{nms_launches[kind]['serving']}")
    if panoptic:
        nms_cases.update({f"{k}_panoptic": c for k, c in zip(("rpn_test", "box_head", "rpn_train"), nms_inputs)})
    logits = d16["sem_seg"]
    if not (logits.dtype == torch.float32 and tuple(logits.shape) == (RCNN_BATCH, 54, *size)
            and bool(torch.isfinite(logits).all())):
        raise SystemExit(f"{name}'s predict_fn gave malformed sem-seg logits: {logits.dtype} {tuple(logits.shape)}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms_b1 = cuda_ms(lambda: model.predict_fn(b1), iters=5)
    ms_b16 = cuda_ms(lambda: model.predict_fn(b16), iters=3, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    p16 = profiled(lambda: model.predict_fn(b16), calls=1)
    # the host boundary of a batch of 16 480x640 images letterboxed to 800²: the label maps on the card, then
    # postprocess (the masks pasted and, for Panoptic FPN, the merge on the card), the merge timed alone
    warps, sizes = [letterbox_transform(480, 640, size)] * RCNN_BATCH, [(480, 640)] * RCNN_BATCH
    merge_s = []
    real_merge = panoptic_module.combine_semantic_and_instance_outputs

    def timed_merge(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = real_merge(*args)
        merge_s.append(time.perf_counter() - t0)
        return result

    labels_ms = cuda_ms(lambda: model.device_postprocess(d16, warps, sizes), iters=3, warmup=1)
    panoptic_module.combine_semantic_and_instance_outputs = timed_merge
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = {k: v.cpu().numpy() for k, v in model.device_postprocess(d16, warps, sizes).items()}
        results = model.postprocess(host, warps, sizes)
        boundary_s = time.perf_counter() - t0
    finally:
        panoptic_module.combine_semantic_and_instance_outputs = real_merge
    for r in results:
        check_segmentation(name, r, (480, 640), s.NUM_CLASSES, panoptic)
    res.update(request_ms=latency, request_median_ms=statistics.median(latency), predict_fn_b1_ms=ms_b1,
               predict_fn_b16_ms=ms_b16, img_s_b1=1e3 / ms_b1, img_s_b16=RCNN_BATCH * 1e3 / ms_b16,
               peak_memory_gib_b16=peak, device_ms_b16=p16["device_ms"], nms_kernel_ms_b16=p16["nms_kernel_ms"],
               label_maps_b16_ms=labels_ms, host_boundary_b16_ms=boundary_s * 1e3,
               merge_ms_per_image=statistics.mean(merge_s) * 1e3 if merge_s else None)
    print(f"  request (480x640 → 800²) median {res['request_median_ms']:.3f} ms of {bench.REQUESTS}; predict_fn batch 1 "
          f"{ms_b1:.3f} ms = {res['img_s_b1']:.2f} img/s; batch {RCNN_BATCH} {ms_b16:.3f} ms = {res['img_s_b16']:.2f} "
          f"img/s ({p16['device_ms']:.3f} ms on the card, NMS kernel {p16['nms_kernel_ms']:.3f}); peak memory "
          f"{peak:.2f} GiB; the batch's label maps (un-warp and argmax on the card) {labels_ms:.3f} ms; its host "
          f"boundary {res['host_boundary_b16_ms']:.1f} ms"
          + (f", of which the panoptic merge {res['merge_ms_per_image']:.3f} ms per image" if panoptic else ""))
    print(p16["events"].table(sort_by="cuda_time_total", row_limit=12, max_name_column_width=90))
    del predictor, d16, logits, host, results

    print(f"== {number}b. f32, batch 2, card against CPU on the card's maps: the sem-seg head"
          + (f", the box predictor on the first {HEAD_ROIS} proposals of each image and the mask logits of the top 16 "
             f"detections" if panoptic else "") + "; with cuDNN's TF32 and ieee_f32 bypassed as the control")
    card = build_model(cfg32)
    cfg_host = cfg32.clone()
    cfg_host.MODEL.DEVICE = "cpu"
    host_model = build_model(cfg_host)
    for mdl in (card, host_model):
        mdl.model.load_state_dict(weights)
    x = b16[:2]
    checks, tf32 = {}, {}
    owner = panoptic_module if panoptic else semseg_module

    def head(mdl, feats):
        if panoptic:
            return mdl.sem_seg_logits(feats)
        with semseg_module.ieee_f32():
            return mdl.model.sem_seg_head(feats)

    with torch.inference_mode():
        if panoptic:
            feats, lg, dl = card.model(card.normalize(x))
            dets = card.predict_fn(x)
            props = card.proposals(lg, dl, size, "test")[0][:, :HEAD_ROIS]
            pooled = card.pool(feats, props.reshape(-1, 4), HEAD_ROIS)
            cls = torch.clamp(dets["classes"][:, :16].reshape(-1), 0, 79)
            mpooled = card.pool(feats, dets["boxes"][:, :16].reshape(-1, 4), 16, card.mask_pooler_resolution)
        else:
            with semseg_module.ieee_f32():
                feats = card.model.backbone(card.normalize(x))
        maps = {f: feats[f] for f in s.IN_FEATURES}
        want = {"sem_seg_logits": head(host_model, {f: v.cpu() for f, v in maps.items()})}
        got = {"sem_seg_logits": head(card, maps)}
        if panoptic:
            want.update(zip(("cls_score", "bbox_pred"), host_model.model.box_predict(pooled.cpu())))
            want["mask_logits"] = host_model.model.mask_predict(mpooled.cpu(), cls.cpu())
            got.update(zip(("cls_score", "bbox_pred"), card.model.box_predict(pooled)))
            got["mask_logits"] = card.model.mask_predict(mpooled, cls)
        with pytorch_default_tf32(), bypass_ieee_f32(owner), bypass_ieee_f32(rcnn):
            ctrl = {"sem_seg_logits": head(card, maps)}
            if panoptic:
                ctrl.update(zip(("cls_score", "bbox_pred"), card.model.box_predict(pooled)))
                ctrl["mask_logits"] = card.model.mask_predict(mpooled, cls)
    for n in got:
        card_vs_cpu(checks, n, got[n], want[n], rel=SAME_INPUT_TOL)
        card_vs_cpu(tf32, n, ctrl[n], want[n], rel=SAME_INPUT_TOL)
        print(f"  {n}: max_abs_err={checks[n]['max_abs_err']:.3e} (scale {checks[n]['scale']:.3e}, tol "
              f"{SAME_INPUT_TOL:.0e} x scale) {'ok' if checks[n]['max_abs_err'] <= checks[n]['tol'] else 'FAIL'}; "
              f"TF32 control {tf32[n]['max_abs_err'] / tf32[n]['tol']:.2f}x the tol")
    if any(ch["max_abs_err"] > ch["tol"] for ch in checks.values()):
        raise SystemExit(f"{name}'s f32 heads differ between the card and the CPU: {checks}")
    if not tf32["sem_seg_logits"]["max_abs_err"] > tf32["sem_seg_logits"]["tol"]:
        raise SystemExit(f"{name}'s f32 sem-seg head check did not see TF32: {tf32}")
    res.update(card_vs_cpu=checks, tf32_control=tf32)
    del card, host_model, feats, maps

    print(f"== {number}c. tools/bench --config-file {folder}/{name}.yaml TEST.BATCH_SIZE {RCNN_BATCH} (the model's "
          f"own init; train steps at {RCNN_BATCH} x 800² on the synthetic {cfg.DATASETS.TRAIN[0]})")
    captured, bench_training = [], bench.bench_training
    bench.bench_training = lambda c, w=None: captured.append(bench_training(c, w)) or captured[-1]
    nms_ops.greedy_nms.launches = 0
    try:
        result = bench.main(["--config-file", os.path.join("configs", folder, name + ".yaml"),
                             "TEST.BATCH_SIZE", str(RCNN_BATCH)])
    finally:
        bench.bench_training = bench_training
    torch.cuda.synchronize()
    nms_launches[kind]["bench"] = nms_ops.greedy_nms.launches
    calls = 2 + bench.ITERS + bench.REQUEST_WARMUP + bench.REQUESTS
    steps = bench.TRAIN_WARMUP + bench.TRAIN_STEPS + 1
    want_nms = 2 * calls + steps if panoptic else 0
    extra = result["extra"]
    _, trainer, clock = captured[0]
    names = (("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "loss_mask") if panoptic else ()) \
        + ("loss_sem_seg", "total_loss")
    losses = {k: [v for v, _ in trainer.storage.history(k).values()] for k in names}
    metric = f"{'panoptic' if panoptic else 'semantic'}_fpn_res50_fpn_800_infer_throughput"
    if not (result["metric"] == metric and result["value"] > 0 and extra["batch"] == RCNN_BATCH
            and extra["train_batch"] == RCNN_BATCH and nms_launches[kind]["bench"] == want_nms
            and (result["vs_baseline"] is None) == (not panoptic)
            and all(extra.get(k) is not None for k in ("predictor_latency_ms", "train_step_ms", "train_busy_share",
                                                        "peak_memory_gib"))
            and all(len(v) == steps and all(math.isfinite(a) for a in v) for v in losses.values())):
        raise SystemExit(f"the bench's {name} line is not complete or its losses not finite ({want_nms} NMS launches "
                         f"expected, {nms_launches[kind]['bench']}): {result}, {losses}")
    top = [(e.key, e.self_device_time_total / 1e3) for e in sorted(
        (e for e in clock.events if e.device_type == DeviceType.CUDA and not e.is_user_annotation),
        key=lambda e: -e.self_device_time_total)[:8]]
    print(f"  {result['metric']}: {result['value']} img/s (vs_baseline {result['vs_baseline']}); request median "
          f"{extra['predictor_latency_ms']:.3f} ms; predict_fn batch {extra['batch']} {extra['predict_fn_ms']:.3f} ms")
    print(f"  train at {extra['train_batch']} x 800²: loss_sem_seg {' '.join(f'{v:.4f}' for v in losses['loss_sem_seg'])}"
          f"; total {' '.join(f'{v:.4f}' for v in losses['total_loss'])}; step times (ms) "
          f"{' '.join(f'{t:.1f}' for t in clock.times)}, median of {bench.TRAIN_STEPS} {extra['train_step_ms']:.1f} ms = "
          f"{extra['train_img_s']:.1f} img/s; card busy {clock.device_ms:.1f} ms = {extra['train_busy_share']:.0%} of "
          f"the median step; peak memory {extra['peak_memory_gib']:.2f} GiB; NMS kernel launches "
          f"{nms_launches[kind]['bench']}")
    print(clock.events.table(sort_by="cuda_time_total", row_limit=12, max_name_column_width=90))
    res.update(bench=result, bench_losses=losses, bench_step_ms_all=clock.times,
               bench_profiled_device_ms=clock.device_ms, bench_top_device_ops_ms=top)
    del trainer, captured

    init_path = os.path.join(out_dir, "init_weights.pth")
    torch.save(init, init_path)
    val = cfg.DATASETS.TEST[0]
    tasks = {"bbox", "segm", "sem_seg"} if panoptic else {"sem_seg"}
    # from the init (calibrated FrozenBN statistics), as 11d: 80 classes near 1/81, so the threshold goes to
    # 0.005 for detections to evaluate
    thresh = ["MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.005"] if panoptic else []
    print(f"== {number}d. tools/train_net on {name}.yaml: {RCNN_STEPS} steps at batch {RCNN_BATCH} from the init "
          f"(MODEL.WEIGHTS; DETECTRON2_SYNTH_DATA: the synthetic {cfg.DATASETS.TRAIN[0]}), then --eval-only --resume "
          f"on the synthetic {val} {' '.join(thresh)}")
    os.environ["DETECTRON2_SYNTH_DATA"] = "1"
    argv = ["--config-file", os.path.join("configs", folder, name + ".yaml"), "SOLVER.MAX_ITER", str(RCNN_STEPS),
            "SOLVER.IMS_PER_BATCH", str(RCNN_BATCH), "TEST.BATCH_SIZE", str(RCNN_BATCH), "MODEL.WEIGHTS", init_path,
            "OUTPUT_DIR", out_dir, "SEED", "0"] + thresh
    log_path = f"output/chip_smoke_{kind}_train_net_log.txt"
    nms_ops.greedy_nms.launches = 0
    trained, evaluated, resumed, train_s, eval_s = run_train_net(argv, log_path)
    nms_launches[kind]["train_net"] = nms_ops.greedy_nms.launches
    val_images = len(DatasetCatalog.get(val))
    want_nms = RCNN_STEPS + 2 * 2 * -(-val_images // RCNN_BATCH) if panoptic else 0
    print(f"  train: {train_s:.1f} s; eval-only: {eval_s:.1f} s; iterations resumed at {resumed}; "
          + "; ".join(f"{t} " + ", ".join(f"{k} {v:.4f}" for k, v in trained[t].items()
                                          if k in ("AP", "AP50", "mIoU", "fwIoU", "mACC", "pACC")) for t in trained)
          + f"; NMS kernel launches {nms_launches[kind]['train_net']}")
    if not (resumed == [0, RCNN_STEPS] and set(trained) == tasks and same_results(trained, evaluated)
            and nms_launches[kind]["train_net"] == want_nms
            and all(math.isfinite(trained[t][k]) for t in tasks - {"sem_seg"} for k in ("AP", "AP50"))
            and all(math.isfinite(trained["sem_seg"][k]) for k in ("fwIoU", "mACC", "pACC"))):
        raise SystemExit(f"{name}'s train_net: resumed {resumed}, NMS launches {nms_launches[kind]['train_net']} "
                         f"(expected {want_nms}), results {trained} vs {evaluated}")
    res.update(train_net=dict(train_s=train_s, eval_only_s=eval_s, resumed=resumed, results=trained))
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"  DCN kernel launches on the {name} path ({number}a-{number}d): {launches}; NMS kernel launches "
          f"{nms_launches[kind]}")
    if any(launches.values()):
        raise SystemExit(f"the {name} path launched DCN kernels: {launches}")
    res.update(launches=launches, nms_kernel_launches=nms_launches[kind])
    return res


def _segmentation_dconv(counted, nms_launches, dcn_launches):
    number, folder, name = SEGMENTATION["panoptic_dconv"]
    cfg = rcnn_cfg(name, "bfloat16", folder)
    m = cfg.MODEL
    size = tuple(cfg.INPUT.TEST_SIZE)

    def settle(part, steps=None):
        """Sub-phase ``part``'s DCN launches, checked against its block
        forwards and added to the path's; both counts start again from 0."""
        torch.cuda.synchronize()
        launches = read_launches()
        check_dconv_launches(f"{number}{part}", launches, counted, steps, per=R101_DEFORM_BLOCKS)
        for k, v in launches.items():
            dcn_launches[k] = dcn_launches.get(k, 0) + v
        blocks = dict(counted)
        reset_launches()
        counted.update(forward=0, train=0)
        return blocks

    print(f"== {number}a. {folder}/{name}.yaml: PanopticFPN, ResNet-{m.RESNETS.DEPTH} {m.RESNETS.NORM}, deformable "
          f"res3-res5 ({R101_DEFORM_BLOCKS} blocks, DCNv1, STRIDE_IN_1X1 {m.RESNETS.STRIDE_IN_1X1}), FPN "
          f"{m.FPN.OUT_CHANNELS}, {m.ROI_HEADS.NAME} ({len(m.ROI_BOX_CASCADE_HEAD.IOUS)} stages), "
          f"{m.SEM_SEG_HEAD.NUM_CLASSES} stuff classes, bf16: DefaultPredictor at {size[0]}², predict_fn at batch "
          f"{RCNN_BATCH}")
    if not (m.META_ARCHITECTURE == "PanopticFPN" and m.RESNETS.DEPTH == 101 and m.RESNETS.NORM == "GN"
            and list(m.RESNETS.DEFORM_ON_PER_STAGE) == [False, True, True, True] and not m.RESNETS.DEFORM_MODULATED
            and not m.RESNETS.STRIDE_IN_1X1 and m.ROI_HEADS.NAME == "CascadeROIHeads"
            and m.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG and m.RPN.POST_NMS_TOPK_TRAIN == 2000 and m.MASK_ON
            and m.FPN.OUT_CHANNELS == 256 and size == (800, 800) and cfg.SOLVER.IMS_PER_BATCH == 32
            and m.SEM_SEG_HEAD.NUM_CLASSES == 54 and not cfg.DATALOADER.FILTER_EMPTY_ANNOTATIONS):
        raise SystemExit(f"{name} is not at full width here: {m}")
    rng = np.random.RandomState(207)
    _, weights = rcnn_weights(rcnn_cfg(name, "float32", folder), letterboxed(rng, "cpu", 2, size), seed=0,
                              device="cuda")
    reset_launches()  # the count starts at the main path: the weights' calibration forwards are not on it
    counted.update(forward=0, train=0)
    predictor = DefaultPredictor(cfg)
    model = predictor.model
    model.model.load_state_dict(weights)
    nms_ops.greedy_nms.launches = 0
    for h, w in ((480, 640), (800, 800)):
        im = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        got = predictor(im)
        check_segmentation(name, got, (h, w), m.SEM_SEG_HEAD.NUM_CLASSES, True)
        check_detections(name, im, got["instances"], model.score_threshold)
        print(f"  request {h}x{w}: {len(got['instances'])} detections, {len(got['panoptic_seg'][1])} panoptic "
              f"segments")
    b16 = letterboxed(rng, model.device, RCNN_BATCH, size)
    d16 = model.predict_fn(b16)
    if tuple(d16["sem_seg"].shape) != (RCNN_BATCH, 54, *size) or tuple(d16["masks"].shape)[:2] != (RCNN_BATCH, 100):
        raise SystemExit(f"{name}'s predict_fn: {({k: tuple(v.shape) for k, v in d16.items()})}")
    ms_b16 = cuda_ms(lambda: model.predict_fn(b16), iters=3, warmup=1)
    p16 = profiled(lambda: model.predict_fn(b16), calls=1)
    k1_ms = dcn_device_ms(p16["events"])["dcn_fwd"]
    torch.cuda.synchronize()
    nms_launches["panoptic_dconv"] = {"serving": nms_ops.greedy_nms.launches}
    if nms_launches["panoptic_dconv"]["serving"] != 2 * (2 + 1 + 4 + 1):
        raise SystemExit(f"{name}: expected two NMS launches per call, got {nms_launches['panoptic_dconv']}")
    blocks = settle("a")
    res = dict(predict_fn_b16_ms=ms_b16, img_s_b16=RCNN_BATCH * 1e3 / ms_b16, device_ms_b16=p16["device_ms"],
               nms_kernel_ms_b16=p16["nms_kernel_ms"], dcn_fwd_ms_b16=k1_ms, block_forwards_a=blocks["forward"])
    print(f"  predict_fn batch {RCNN_BATCH}: {ms_b16:.3f} ms = {res['img_s_b16']:.2f} img/s, {p16['device_ms']:.3f} ms "
          f"on the card (K1 {k1_ms:.3f} ms, NMS kernel {p16['nms_kernel_ms']:.3f} ms); {blocks['forward']} K1 launches "
          f"in {blocks['forward'] // R101_DEFORM_BLOCKS} forwards")
    print(p16["events"].table(sort_by="cuda_time_total", row_limit=12, max_name_column_width=90))
    del predictor, model, d16

    steps = bench.TRAIN_WARMUP + bench.TRAIN_STEPS + 1
    print(f"== {number}c. tools/bench's train steps (bench.bench_training) at batch {DCONV_TRAIN_BATCH} x 800² (the "
          f"YAML's {cfg.SOLVER.IMS_PER_BATCH} does not fit; {steps} steps, the last profiled) from the model's init, "
          f"the synthetic {cfg.DATASETS.TRAIN[0]}")
    tcfg = rcnn_cfg(name, "bfloat16", folder, extra=("SOLVER.IMS_PER_BATCH", str(DCONV_TRAIN_BATCH)))
    nms_ops.greedy_nms.launches = 0
    entries, trainer, clock = bench.bench_training(tcfg)
    torch.cuda.synchronize()
    nms_launches["panoptic_dconv"]["bench_training"] = nms_ops.greedy_nms.launches
    blocks = settle("c", steps)
    names = ("loss_rpn_cls", "loss_rpn_loc", "loss_cls_stage0", "loss_cls_stage2", "loss_mask", "loss_sem_seg",
             "total_loss")
    losses = {k: [v for v, _ in trainer.storage.history(k).values()] for k in names}
    dcn_ms = dcn_device_ms(clock.events)
    if not (nms_launches["panoptic_dconv"]["bench_training"] == steps
            and all(len(v) == steps and all(math.isfinite(a) for a in v) for v in losses.values())):
        raise SystemExit(f"{name}'s training: NMS launches {nms_launches['panoptic_dconv']}, losses {losses}")
    print(f"  batch {entries['train_batch']}: loss_sem_seg {' '.join(f'{v:.4f}' for v in losses['loss_sem_seg'])}; "
          f"total {' '.join(f'{v:.4f}' for v in losses['total_loss'])}; step times (ms) "
          f"{' '.join(f'{t:.1f}' for t in clock.times)}, median of {bench.TRAIN_STEPS} {entries['train_step_ms']:.1f} "
          f"ms = {entries['train_img_s']:.1f} img/s; card busy {clock.device_ms:.1f} ms = "
          f"{entries['train_busy_share']:.0%} of the median step; peak memory {entries['peak_memory_gib']:.2f} GiB; "
          f"the profiled step's DCN device ms: K1 {dcn_ms['dcn_fwd']:.2f}, K2 {dcn_ms['dcn_bwd_dx']:.2f}, K5 (with "
          f"its split sum) {dcn_ms['dcn_bwd_wq']:.2f}; {blocks['train']} block forwards with autograd in {steps} steps")
    print(clock.events.table(sort_by="cuda_time_total", row_limit=15, max_name_column_width=90))
    res.update(bench_training=entries, bench_losses=losses, bench_step_ms_all=clock.times,
               bench_profiled_device_ms=clock.device_ms, bench_dcn_device_ms=dcn_ms, block_forwards_c=blocks["train"],
               launches=dict(dcn_launches), nms_kernel_launches=nms_launches["panoptic_dconv"])
    del trainer, clock
    print(f"  DCN kernel launches on the {name} path: {dcn_launches}; NMS kernel launches "
          f"{nms_launches['panoptic_dconv']}")
    return res


SLICE16 = {  # kind: (sub-phase, YAML)
    "deeplab_v3_plus": ("21", "projects/DeepLab/configs/Cityscapes-SemanticSegmentation/"
                              "deeplab_v3_plus_R_50_os16_poly_90k_bs16.yaml"),
    "deeplab_v3": ("21v", "projects/DeepLab/configs/Cityscapes-SemanticSegmentation/"
                          "deeplab_v3_R_103_os16_mg124_poly_90k_bs16.yaml"),
    "pointrend_rcnn": ("22", "projects/PointRend/configs/InstanceSegmentation/pointrend_rcnn_R_50_FPN_1x_coco.yaml"),
    "pointrend_semantic": ("22s", "projects/PointRend/configs/SemanticSegmentation/"
                                  "pointrend_semantic_R_101_FPN_1x_cityscapes.yaml"),
}
POINTREND_SEM_TRAIN_BATCH = 32  # 22s's train batch: the YAML's SOLVER.IMS_PER_BATCH
POINTREND_EVAL_IMAGES = 16  # 22d's synthetic coco_2017_val: 1600 detections of 224² masks to paste and score
SEM_SEG_EVAL_IMAGES = 4  # 21d's Cityscapes val split at 2048x1024


def yaml_cfg(path: str, dtype: str, extra=()):
    """The YAML at ``path`` read by the port's own reader, with ``extra``, the
    run's compute width, output directory and seed over it and no weights
    file (the YAMLs name ImageNet or DeepLab weights that are not here)."""
    cfg = get_cfg()
    cfg.merge_from_file(path)
    cfg.merge_from_list(list(extra) + ["TPU.DTYPE", dtype, "OUTPUT_DIR", "output/chip_smoke", "SEED", 0,
                                       "MODEL.WEIGHTS", ""])
    return cfg


def slice16_full_width(kind, cfg) -> bool:
    """The YAML's own widths and sizes, as the JAX package reads them."""
    m, s, ph = cfg.MODEL, cfg.MODEL.SEM_SEG_HEAD, cfg.MODEL.POINT_HEAD
    r = m.RESNETS
    if kind.startswith("deeplab"):
        plus = kind == "deeplab_v3_plus"
        return (m.BACKBONE.NAME == "build_resnet_deeplab_backbone" and r.DEPTH == (50 if plus else 101)
                and r.STEM_TYPE == "deeplab" and r.STEM_OUT_CHANNELS == 128 and r.RES5_DILATION == 2
                and list(r.RES5_MULTI_GRID) == [1, 2, 4] and s.NUM_CLASSES == 19 and s.CONVS_DIM == 256
                and list(s.ASPP_DILATIONS) == [6, 12, 18] and s.LOSS_TYPE == "hard_pixel_mining"
                and s.NAME == ("DeepLabV3PlusHead" if plus else "DeepLabV3Head")
                and s.COMMON_STRIDE == (4 if plus else 16) and cfg.SOLVER.IMS_PER_BATCH == 16
                and tuple(cfg.INPUT.TEST_SIZE) == ((1024, 2048) if plus else (512, 512)))
    full = (r.DEPTH == (50 if kind == "pointrend_rcnn" else 101) and m.FPN.OUT_CHANNELS == 256
            and ph.FC_DIM == 256 and ph.NUM_FC == 3)
    if kind == "pointrend_rcnn":
        return full and (m.ROI_HEADS.NAME == "PointRendROIHeads" and m.ROI_MASK_HEAD.NAME == "CoarseMaskHead"
                         and m.ROI_MASK_HEAD.FC_DIM == 1024 and m.ROI_HEADS.NUM_CLASSES == 80
                         and ph.TRAIN_NUM_POINTS == 196 and ph.SUBDIVISION_STEPS == 5
                         and ph.SUBDIVISION_NUM_POINTS == 784 and tuple(cfg.INPUT.TEST_SIZE) == (800, 800))
    return full and (s.NAME == "PointRendSemSegHead" and ph.COARSE_SEM_SEG_HEAD_NAME == "SemSegFPNHead"
                     and s.NUM_CLASSES == 19 and s.CONVS_DIM == 128 and ph.TRAIN_NUM_POINTS == 2048
                     and ph.SUBDIVISION_STEPS == 2 and ph.SUBDIVISION_NUM_POINTS == 8192
                     and cfg.SOLVER.IMS_PER_BATCH == 32 and tuple(cfg.INPUT.TEST_SIZE) == (1024, 2048))


def synthetic_stand_in(name: str) -> None:
    """``name`` afresh as its synthetic stand-in: a builtin Cityscapes split
    whose files are not here loads as an empty list, which
    ``ensure_synthetic_datasets`` (as the JAX package's) keeps."""
    for catalog in (DatasetCatalog, MetadataCatalog):
        if name in catalog:
            catalog.remove(name)
    ensure_synthetic_datasets([name])


def random_images(rng, dev, n, size):
    """``n`` (3, H, W) images of uniform 0..255 pixels at ``size``, on ``dev``."""
    return torch.from_numpy(rng.randint(0, 256, (n, 3, *size)).astype(np.float32)).to(dev)


def cityscapes_sem_seg_tree(root: str, n: int, seed: int, size=(1024, 2048)):
    """A Cityscapes val split for semantic segmentation: ``n`` images over two
    cities, each ``leftImg8bit/<city>/*_leftImg8bit.png`` an empty file (the
    loader globs the names; the pixels go in the records) beside its
    ``gtFine/<city>/*_gtFine_labelTrainIds.png`` (uint8 train ids: blocks of
    the 19 classes, a tenth ignored, 255), which ``load_cityscapes_semantic``
    names and ``CityscapesSemSegEvaluator`` reads; returns (image dir,
    gtFine dir, pixels by file name)."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    image_dir = os.path.join(root, "cityscapes", "leftImg8bit", "val")
    gt_dir = os.path.join(root, "cityscapes", "gtFine", "val")
    h, w = size
    pixels = {}
    for i in range(n):
        city = ("frankfurt", "lindau")[i % 2]
        base = f"{city}_{i:06d}_000019"
        for d in (image_dir, gt_dir):
            os.makedirs(os.path.join(d, city), exist_ok=True)
        open(os.path.join(image_dir, city, base + "_leftImg8bit.png"), "wb").close()
        labels = np.kron(rng.randint(0, 19, (h // 64, w // 64)), np.ones((64, 64), np.int64)).astype(np.uint8)
        labels[rng.rand(h, w) < 0.1] = 255
        Image.fromarray(labels).save(os.path.join(gt_dir, city, base + "_gtFine_labelTrainIds.png"))
        pixels[base + "_leftImg8bit.png"] = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    return image_dir, gt_dir, pixels


def slice16_heads(kind, model, x, size):
    """The f32 head outputs 21b/22b compare, the card's maps fed to the
    model's ``model``: the DeepLab head on the trunk's; PointRend's coarse
    sem-seg head and its point head on the 8192 points of least top-2 gap of
    the card's coarse logits; the R-CNN's box predictor on the first
    HEAD_ROIS proposals, the coarse mask logits of the top 16 detections and
    the point head on their subdivision's first-step points. Returns
    ({name: output}, the inputs to feed the CPU)."""
    net = model.model
    with torch.inference_mode():
        if kind == "pointrend_rcnn":
            feats, lg, dl = net(model.normalize(x))
            props = model.proposals(lg, dl, size, "test")[0][:, :HEAD_ROIS]
            dets = model.predict_fn(x)
            top = min(16, dets["boxes"].shape[1])
            boxes = dets["boxes"][:, :top].reshape(-1, 4)
            cls = torch.clamp(dets["classes"][:, :top].reshape(-1), 0, model.num_classes - 1)
            pooled = model.pool(feats, props.reshape(-1, 4), props.shape[1])
            mpooled = model.pool(feats, boxes, top, model.mask_pooler_resolution)
            fine = model.pool(feats, boxes, top, 2 * model.mask_pooler_resolution)
            return {"pooled": pooled, "mpooled": mpooled, "cls": cls, "fine": fine}
        with layers.ieee_f32():
            feats = net.backbone(model.normalize(x))
        return {"feats": feats}


def slice16_outputs(kind, model, inputs):
    net, dev = model.model, model.device
    on = {k: (v.to(dev) if torch.is_tensor(v) else v) for k, v in inputs.items()}
    out = {}
    with torch.inference_mode():
        if kind == "pointrend_rcnn":
            out["cls_score"], out["bbox_pred"] = net.box_predict(on["pooled"])
            coarse = net.mask_predict(on["mpooled"], on["cls"])  # (R, 7, 7)
            out["coarse_mask_logits"] = coarse
            up = torch.nn.functional.interpolate(coarse[:, None], scale_factor=2, mode="bilinear",
                                                 align_corners=False)[:, 0]
            coords = torch.rand(up.shape[0], 196, 2, generator=torch.Generator().manual_seed(5)).to(dev)
            out["point_logits"] = net.point_predict(point_head_ops.point_sample(on["fine"], coords),
                                                    point_head_ops.point_sample(up[:, None], coords))
            return out
        head = net.sem_seg_head
        feats = {k: on["feats"][k].to(dev) for k in on["feats"]}
        with semseg_module.ieee_f32():
            if kind.startswith("deeplab"):
                out["sem_seg_logits"] = head(feats)
                return out
            coarse = head.coarse_sem_seg_head(feats)
            out["coarse_sem_seg_logits"] = coarse
            n, c, h, w = coarse.shape
            coords = torch.rand(n, 8192, 2, generator=torch.Generator().manual_seed(6)).to(dev)
            fine = torch.cat([feats[f] for f in head.in_features], 1).float()
            out["point_logits"] = head.point_head(point_head_ops.point_sample(fine, coords),
                                                  point_head_ops.point_sample(coarse, coords))
    return out


def phase_slice16(report, out_dir):
    """Phases 21 and 22: DeepLab V3+ R50 (21), DeepLab V3 R-103 (21v),
    PointRend R-CNN R50-FPN (22) and PointRend's semantic FPN R101 (22s),
    each from its YAML at full width with seeded weights, bf16: (a)
    ``DefaultPredictor`` requests (median of 10), ``predict_fn`` at batch 1
    and 16 (peak memory, the batch-16 profile; the trunk's and the head's
    time, or the subdivision's); (b) f32 at batch 1, card against CPU on the
    card's maps (the DeepLab head; PointRend's coarse heads and point head
    on the same points; the box predictor), within SAME_INPUT_TOL of their
    scale, the TF32 control over it for the convolutional heads; (c)
    ``tools/bench``'s train steps (``bench.bench_training``) at the YAML's
    batch (22s: POINTREND_SEM_TRAIN_BATCH), busy share, peak memory, every
    loss finite; 21c also times the hard-pixel-mining loss at 16 x
    512x1024; (d) 21d: ``tools/train_net`` 4 steps, then ``--eval-only
    --resume`` with ``CityscapesSemSegEvaluator`` on a Cityscapes split of
    ``*_gtFine_labelTrainIds.png`` files read by ``load_cityscapes_semantic``;
    22d: the same with bbox and segm on the synthetic coco_2017_val. No DCN
    kernel on any of them; PointRend R-CNN's NMS through the kernel, its
    RPN and box-head rows to 10c."""
    out, nms_launches, nms_cases = {}, {}, {}
    for kind in SLICE16:
        scratch = os.path.join(out_dir, kind)
        os.makedirs(scratch, exist_ok=True)
        out[kind] = _slice16_path(kind, scratch, nms_launches, nms_cases)
        torch.cuda.empty_cache()
    report["slice16"] = out
    return {k: sum(r["launches"][k] for r in out.values()) for k in KERNELS}, nms_launches, nms_cases


def _slice16_path(kind, out_dir, nms_launches, nms_cases):
    number, yaml = SLICE16[kind]
    semantic = kind != "pointrend_rcnn"
    cfg = yaml_cfg(yaml, "bfloat16")
    m = cfg.MODEL
    size = tuple(cfg.INPUT.TEST_SIZE)
    classes = m.SEM_SEG_HEAD.NUM_CLASSES if semantic else m.ROI_HEADS.NUM_CLASSES
    if not slice16_full_width(kind, cfg):
        raise SystemExit(f"{yaml} is not at full width here: {m}")
    head = m.SEM_SEG_HEAD.NAME if semantic else f"{m.ROI_MASK_HEAD.NAME} + PointHead"
    print(f"== {number}a. {yaml}: {m.META_ARCHITECTURE}, ResNet-{m.RESNETS.DEPTH} {m.RESNETS.NORM} "
          f"({m.BACKBONE.NAME}), {head}, {classes} classes, bf16: DefaultPredictor at {size[0]}x{size[1]}, "
          f"predict_fn at batch 1 and {RCNN_BATCH}" + (" (no INPUT.TEST_SIZE in the YAML: the JAX package's "
                                                       "default, 512²)" if kind == "deeplab_v3" else ""))
    rng = np.random.RandomState(210 + len(kind))
    reset_launches()
    # the R-CNN's weights are calibrated on the letterboxed photos it serves (as 11a), the segmentors' on full frames
    calib = random_images(rng, "cpu", 2, size) if semantic else letterboxed(rng, "cpu", 2, size)
    cfg32 = yaml_cfg(yaml, "float32")
    if semantic:
        init = weights = seeded_weights(cfg32, calib, seed=0, device="cuda")
    else:
        init, weights = rcnn_weights(cfg32, calib, seed=0, device="cuda")
    predictor = DefaultPredictor(cfg)
    model = predictor.model
    model.model.load_state_dict(weights)
    res = {}
    nms_ops.greedy_nms.launches = 0
    request_sizes = ((1024, 2048), (480, 640), (375, 500)) if size[1] == 2048 else ((480, 640), (800, 800), (375, 500))
    for h, w in request_sizes:
        im = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        got = predictor(im)
        if semantic:
            check_segmentation(yaml, got, (h, w), classes, False)
            text = f"{len(np.unique(got['sem_seg']))} labels in sem_seg"
        else:
            inst = got["instances"]
            check_detections(yaml, im, inst, model.score_threshold)
            if not (inst.pred_masks.dtype == bool and inst.pred_masks.shape == (len(inst), h, w)):
                raise SystemExit(f"{yaml}: malformed masks {inst.pred_masks.shape}")
            text = f"{len(inst)} detections, top score {inst.scores.max():.4f}, {int(inst.pred_masks.sum())} mask px"
        print(f"  request {h}x{w}: {text}")
    latency = bench.request_ms(predictor, rng.randint(0, 256, (*request_sizes[0], 3)).astype(np.uint8))
    images = random_images if semantic else letterboxed
    b1, b16 = images(rng, model.device, 1, size), images(rng, model.device, RCNN_BATCH, size)
    nms_inputs = []
    with capture_nms(nms_inputs):
        d16 = model.predict_fn(b16)
        if not semantic:
            with torch.inference_mode():  # the training's proposals
                model.proposals(*model.model(model.normalize(b16))[1:], size, "train")
    torch.cuda.synchronize()
    calls = 3 + bench.REQUEST_WARMUP + bench.REQUESTS + 1
    nms_launches[kind] = {"serving": nms_ops.greedy_nms.launches}
    if nms_launches[kind]["serving"] != (0 if semantic else 2 * calls + 1):
        raise SystemExit(f"{yaml}: expected {0 if semantic else 2 * calls + 1} NMS kernel launches, got "
                         f"{nms_launches[kind]['serving']}")
    if semantic:
        out16 = d16["sem_seg"]
        ok = out16.dtype == torch.float32 and tuple(out16.shape) == (RCNN_BATCH, classes, *size)
    else:
        nms_cases.update({f"{k}_pointrend": c for k, c in zip(("rpn_test", "box_head", "rpn_train"), nms_inputs)})
        out16 = d16["masks"]
        side = m.ROI_MASK_HEAD.OUTPUT_SIDE_RESOLUTION * 2 ** m.POINT_HEAD.SUBDIVISION_STEPS
        ok = tuple(out16.shape) == (RCNN_BATCH, cfg.TEST.DETECTIONS_PER_IMAGE, side, side)
    if not (ok and bool(torch.isfinite(out16).all())):
        raise SystemExit(f"{yaml}'s predict_fn gave malformed outputs: {out16.dtype} {tuple(out16.shape)}")
    del d16, out16
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms_b1 = cuda_ms(lambda: model.predict_fn(b1), iters=5)
    ms_b16 = cuda_ms(lambda: model.predict_fn(b16), iters=3, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    p16 = profiled(lambda: model.predict_fn(b16), calls=1)
    net = model.model
    with torch.inference_mode(), layers.ieee_f32(), torch.autocast("cuda", dtype=torch.bfloat16):
        x16 = model.normalize(b16).to(torch.bfloat16)
        trunk_ms = cuda_ms(lambda: net.backbone(x16), iters=3, warmup=1)
        feats = net.backbone(x16)
        if semantic:
            stage = "the sem-seg head" + (" with the subdivision" if kind == "pointrend_semantic" else "")
            stage_ms = cuda_ms(lambda: net.sem_seg_head(feats), iters=3, warmup=1)
        else:  # the subdivision of the batch's 1600 detections' coarse logits, 7² → 224²
            dets = model.predict_fn(b16)
            k = dets["boxes"].shape[1]
            boxes = dets["boxes"].reshape(-1, 4)
            cls = torch.clamp(dets["classes"].reshape(-1), 0, classes - 1)
            sel = net.mask_predict(model.pool(feats, boxes, k, model.mask_pooler_resolution), cls)
            fine = model.pool(feats, boxes, k, 2 * model.mask_pooler_resolution)
            stage = f"the subdivision of {boxes.shape[0]} detections"
            stage_ms = cuda_ms(lambda: point_head_ops.refine_mask_with_points(
                sel, fine, net.point_predict, model.point_subdiv_num, model.point_steps), iters=3, warmup=1)
    del feats
    res.update(request_ms=latency, request_median_ms=statistics.median(latency), predict_fn_b1_ms=ms_b1,
               predict_fn_b16_ms=ms_b16, img_s_b1=1e3 / ms_b1, img_s_b16=RCNN_BATCH * 1e3 / ms_b16,
               peak_memory_gib_b16=peak, device_ms_b16=p16["device_ms"], nms_kernel_ms_b16=p16["nms_kernel_ms"],
               trunk_b16_ms=trunk_ms, stage_b16_ms=stage_ms, stage=stage)
    print(f"  request ({request_sizes[0][0]}x{request_sizes[0][1]}) median {res['request_median_ms']:.3f} ms of "
          f"{bench.REQUESTS}; predict_fn batch 1 {ms_b1:.3f} ms = {res['img_s_b1']:.2f} img/s; batch {RCNN_BATCH} "
          f"{ms_b16:.3f} ms = {res['img_s_b16']:.2f} img/s ({p16['device_ms']:.3f} ms on the card, NMS kernel "
          f"{p16['nms_kernel_ms']:.3f}); peak memory {peak:.2f} GiB; at batch {RCNN_BATCH} the trunk "
          f"{trunk_ms:.3f} ms, {stage} {stage_ms:.3f} ms")
    print(p16["events"].table(sort_by="cuda_time_total", row_limit=10, max_name_column_width=90))
    del predictor

    print(f"== {number}b. f32, batch 1, card against CPU on the card's maps"
          + (": the DeepLab head" if kind.startswith("deeplab") else
             ": the coarse sem-seg head, the point head on 8192 points" if semantic else
             f": the box predictor on {HEAD_ROIS} proposals, the coarse mask logits of the top 16 detections, the "
             "point head on 196 points of each") + "; with cuDNN's TF32 and ieee_f32 bypassed as the control")
    card = build_model(cfg32)
    cfg_host = cfg32.clone()
    cfg_host.MODEL.DEVICE = "cpu"
    host_model = build_model(cfg_host)
    for mdl in (card, host_model):
        mdl.model.load_state_dict(weights)
    inputs = slice16_heads(kind, card, b1, size)
    cpu_inputs = {k: ({f: t.cpu() for f, t in v.items()} if isinstance(v, dict) else
                      v.cpu() if torch.is_tensor(v) else v) for k, v in inputs.items()}
    got, want = slice16_outputs(kind, card, inputs), slice16_outputs(kind, host_model, cpu_inputs)
    with pytorch_default_tf32(), bypass_ieee_f32(semseg_module), bypass_ieee_f32(rcnn):
        ctrl = slice16_outputs(kind, card, inputs)
    checks, tf32 = {}, {}
    for n in got:
        card_vs_cpu(checks, n, got[n], want[n], rel=SAME_INPUT_TOL)
        card_vs_cpu(tf32, n, ctrl[n], want[n], rel=SAME_INPUT_TOL)
        print(f"  {n}: max_abs_err={checks[n]['max_abs_err']:.3e} (scale {checks[n]['scale']:.3e}, tol "
              f"{SAME_INPUT_TOL:.0e} x scale) {'ok' if checks[n]['max_abs_err'] <= checks[n]['tol'] else 'FAIL'}; "
              f"TF32 control {tf32[n]['max_abs_err'] / tf32[n]['tol']:.2f}x the tol")
    if any(ch["max_abs_err"] > ch["tol"] for ch in checks.values()):
        raise SystemExit(f"{yaml}'s f32 heads differ between the card and the CPU: {checks}")
    convolutional = [n for n in got if n.endswith("sem_seg_logits") or n == "coarse_mask_logits"]
    if not all(tf32[n]["max_abs_err"] > tf32[n]["tol"] for n in convolutional if n != "coarse_mask_logits"):
        raise SystemExit(f"{yaml}'s f32 head check did not see TF32: {tf32}")
    res.update(card_vs_cpu=checks, tf32_control=tf32)
    del card, host_model, inputs, cpu_inputs, got, want, ctrl

    batch = POINTREND_SEM_TRAIN_BATCH if kind == "pointrend_semantic" else int(cfg.SOLVER.IMS_PER_BATCH)
    train_size = tuple(cfg.INPUT.TRAIN_SIZE)
    print(f"== {number}c. tools/bench's train steps (bench.bench_training) at {batch} x {train_size[0]}x{train_size[1]} "
          f"on the synthetic {cfg.DATASETS.TRAIN[0]}, the model's own init")
    if kind == "deeplab_v3_plus":  # the hard-pixel-mining loss alone, forward and backward, at the train batch
        lg = torch.randn(batch, classes, *train_size, device=model.device, requires_grad=True)
        tg = torch.randint(0, classes, (batch, *train_size), device=model.device)
        loss_ms = {}
        for top_k in (1.0, model.loss_top_k):
            loss_ms[top_k] = cuda_ms(lambda: semseg_module.sem_seg_loss(lg, tg, 255, top_k).backward(), iters=5)
        res["sem_seg_loss_ms"] = {str(k): v for k, v in loss_ms.items()}
        print(f"  sem_seg_loss forward + backward on ({batch}, {classes}, {train_size[0]}, {train_size[1]}) f32 logits: "
              f"all pixels {loss_ms[1.0]:.3f} ms; hard pixel mining (top {model.loss_top_k:.0%}) "
              f"{loss_ms[model.loss_top_k]:.3f} ms")
        del lg, tg
    nms_ops.greedy_nms.launches = 0
    synthetic_stand_in(cfg.DATASETS.TRAIN[0])
    train_cfg = cfg.clone()
    train_cfg.SOLVER.IMS_PER_BATCH = batch
    entries, trainer, clock = bench.bench_training(train_cfg)
    torch.cuda.synchronize()
    steps = bench.TRAIN_WARMUP + bench.TRAIN_STEPS + 1
    nms_launches[kind]["bench"] = nms_ops.greedy_nms.launches
    names = ("loss_sem_seg",) + (("loss_sem_seg_point",) if kind == "pointrend_semantic" else ()) if semantic else (
        "loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "loss_mask", "loss_mask_point")
    losses = {k: [v for v, _ in trainer.storage.history(k).values()] for k in names + ("total_loss",)}
    if not (all(len(v) == steps and all(math.isfinite(a) for a in v) for v in losses.values())
            and nms_launches[kind]["bench"] == (0 if semantic else steps)):
        raise SystemExit(f"{yaml}'s train steps: losses {losses}, NMS launches {nms_launches[kind]['bench']}")
    top = [(e.key, e.self_device_time_total / 1e3) for e in sorted(
        (e for e in clock.events if e.device_type == DeviceType.CUDA and not e.is_user_annotation),
        key=lambda e: -e.self_device_time_total)[:8]]
    print(f"  total loss {' '.join(f'{v:.4f}' for v in losses['total_loss'])}; step times (ms) "
          f"{' '.join(f'{t:.1f}' for t in clock.times)}, median of {bench.TRAIN_STEPS} {entries['train_step_ms']:.1f} ms "
          f"= {entries['train_img_s']:.1f} img/s; card busy {clock.device_ms:.1f} ms = "
          f"{entries['train_busy_share']:.0%} of the median step; peak memory {entries['peak_memory_gib']:.2f} GiB")
    print(clock.events.table(sort_by="cuda_time_total", row_limit=10, max_name_column_width=90))
    res.update(train=entries, train_losses=losses, train_step_ms_all=clock.times,
               train_profiled_device_ms=clock.device_ms, train_top_device_ops_ms=top)
    del trainer, clock

    if kind in ("deeplab_v3_plus", "pointrend_rcnn"):
        init_path = os.path.join(out_dir, "init_weights.pth")
        torch.save(init, init_path)
        os.environ["DETECTRON2_SYNTH_DATA"] = "1"
        if semantic:
            image_dir, gt_dir, pixels = cityscapes_sem_seg_tree(out_dir, SEM_SEG_EVAL_IMAGES, seed=21)
            val = "chip_smoke_cityscapes_fine_sem_seg_val"
            register_with_pixels(val, lambda i=image_dir, g=gt_dir: load_cityscapes_semantic(i, g), pixels,
                                 stuff_classes=list(CITYSCAPES_STUFF_CLASSES), evaluator_type="cityscapes_sem_seg",
                                 ignore_label=255, image_dir=image_dir, gt_dir=gt_dir)
            tasks, extra = {"sem_seg"}, ["DATASETS.TEST", f"('{val}',)", "TEST.BATCH_SIZE", str(EVAL_BATCH)]
        else:
            val = "coco_2017_val"
            for catalog in (DatasetCatalog, MetadataCatalog):
                if val in catalog:
                    catalog.remove(val)
            register_synthetic_instances(val, num_images=POINTREND_EVAL_IMAGES, image_size=EVAL_SIZE)
            # from the init (calibrated FrozenBN statistics), as 11d: 80 classes near 1/81
            tasks, extra = {"bbox", "segm"}, ["MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.005",
                                              "TEST.BATCH_SIZE", str(RCNN_BATCH)]
        print(f"== {number}d. tools/train_net on {yaml}: {RCNN_STEPS} steps at batch {batch} from the init "
              f"(MODEL.WEIGHTS; DETECTRON2_SYNTH_DATA: the synthetic {cfg.DATASETS.TRAIN[0]}), then --eval-only "
              f"--resume on {val} ({len(DatasetCatalog.get(val))} images) {' '.join(extra)}")
        argv = ["--config-file", yaml, "SOLVER.MAX_ITER", str(RCNN_STEPS), "SOLVER.IMS_PER_BATCH", str(batch),
                "MODEL.WEIGHTS", init_path, "OUTPUT_DIR", out_dir, "SEED", "0"] + extra
        nms_ops.greedy_nms.launches = 0
        trained, evaluated, resumed, train_s, eval_s = run_train_net(argv, f"output/chip_smoke_{kind}_train_net_log.txt")
        nms_launches[kind]["train_net"] = nms_ops.greedy_nms.launches
        keys = ("IoU",) if semantic else ("AP", "AP50")
        print(f"  train: {train_s:.1f} s; eval-only: {eval_s:.1f} s; iterations resumed at {resumed}; "
              + "; ".join(f"{t} " + ", ".join(f"{k} {trained[t][k]:.4f}" for k in keys) for t in sorted(trained))
              + f"; NMS kernel launches {nms_launches[kind]['train_net']}")
        want_nms = 0 if semantic else RCNN_STEPS + 2 * 2 * -(-POINTREND_EVAL_IMAGES // RCNN_BATCH)
        if not (resumed == [0, RCNN_STEPS] and set(trained) == tasks and same_results(trained, evaluated)
                and nms_launches[kind]["train_net"] == want_nms
                and all(math.isfinite(trained[t][k]) for t in tasks for k in keys)):
            raise SystemExit(f"{yaml}'s train_net: resumed {resumed}, NMS launches {nms_launches[kind]['train_net']} "
                             f"(expected {want_nms}), results {trained} vs {evaluated}")
        if semantic and not len(trained["sem_seg"]) == 1 + classes:
            raise SystemExit(f"{yaml}: CityscapesSemSegEvaluator gave {trained['sem_seg']}")
        res.update(train_net=dict(train_s=train_s, eval_only_s=eval_s, resumed=resumed, results=trained))
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"  DCN kernel launches on the {kind} path: {launches}; NMS kernel launches {nms_launches[kind]}")
    if any(launches.values()):
        raise SystemExit(f"the {yaml} path launched DCN kernels: {launches}")
    res.update(launches=launches, nms_kernel_launches=nms_launches[kind], train_batch=batch)
    return res


# -- phases 23 and 24: the rotated Faster R-CNN and TridentNet ----------------------------------------------------

ROTATED = ["MODEL.RESNETS.DEPTH", 50, "MODEL.MASK_ON", False, "MODEL.PROPOSAL_GENERATOR.NAME", "RRPN",
           "MODEL.ROI_HEADS.NAME", "RROIHeads", "MODEL.ANCHOR_GENERATOR.NAME", "RotatedAnchorGenerator",
           "MODEL.ROI_BOX_HEAD.POOLER_TYPE", "ROIAlignRotated", "MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS", [10, 10, 5, 5, 1]]
ROTATED_YAML = "configs/Base-RCNN-C4.yaml"
TRIDENT_YAML = "projects/TridentNet/configs/tridentnet_fast_R_50_C4_1x.yaml"
ROTATED_EVAL_IMAGES = 16  # 23d's synthetic scenes
TRIDENT_TRAIN_BATCH = 16  # SOLVER.IMS_PER_BATCH of Base-TridentNet-Fast-C4.yaml: 48 images at res4
TRIDENT_STEPS = 2  # tools/train_net's steps in 24d before its --eval-only
ROTATED_ANGLE = 45.0  # 23c's gts: the synthetic scenes' boxes at seeded angles in ±45°
# the least f32 operations of one rotated IoU, as R1's and R2's first kernels (one IoU from the boxes' five
# numbers) counted them, kept so that the bounds before and after their redesign are one yardstick: a pair whose
# circles lie apart takes the test alone (two sqrt, ~14 operations); the others the corners (two sincos, ~40),
# four clips of at most 8 vertices (~12 operations a vertex an edge) and the shoelace sum, ~400
IOU_FAR_OPS, IOU_CLIP_OPS = 14, 400
# 23e: the rows of each case the plain argmax loop takes (None: all); it costs ~150 small launches a pick, 3 s
# for a test row's 1000 picks
ROTATED_PLAIN_ROWS = rotated_ab.PLAIN_ROWS
# 23e: R1's and R2's times before their redesign (PERF.md, runs CO; CJ where CO took none), in ms: (the plain
# rows, all rows)
ROTATED_MS_BEFORE = {"rrpn_matching": (0.740, None), "proposal_sampling": (0.348, None),
                   "rpn_test_rotated": (4.912, 8.386), "rpn_train_rotated": (6.264, 19.722),
                   "box_head_rotated": (0.428, None)}
ROTATED_CASES = None  # --rotated-cases: where 23e saves its inputs for tools/rotated_ab.py
TRIDENT_FULL_BATCH = 12  # 24b's predict_fn batch, the largest of 8, 12, 16 that fits in 80 GB: 16 is 48 images
# through res4 and 48 000 rois through res5


def rotated_cfg(dtype: str):
    """``configs/Base-RCNN-C4.yaml`` with the rotated R-CNN's overrides (RRPN,
    RROIHeads, rotated anchors at the defaults' sizes, ratios and angles: 45 a
    cell, ROIAlignRotated, box weights (10, 10, 5, 5, 1)), the C4 base's RPN
    top-k on res4, 800² inputs. Neither this repo nor the reference has a
    rotated YAML."""
    return yaml_cfg(ROTATED_YAML, dtype, ROTATED)


@contextmanager
def capture_rotated(iou_into, nms_into):
    """Record the arguments of every rotated IoU and rotated NMS call of the
    rotated R-CNN (the names ``rrpn`` and ``rotated_rcnn`` call), each call
    going on to its kernel, whose wrapper counts it."""
    real_iou, real_nms = rot_ops.pairwise_iou_rotated, rot_ops.nms_rotated

    def iou(a, b):
        iou_into.append((a.clone(), b.clone()))
        return real_iou(a, b)

    def nms(boxes, scores, thr, max_out=100, classes=None):
        counts = max_out if isinstance(max_out, int) else tuple(int(c) for c in max_out)
        nms_into.append((boxes.clone(), scores.clone(), None if classes is None else classes.clone(), float(thr),
                         counts))
        return real_nms(boxes, scores, thr, max_out, classes)

    for mod in (rrpn_module, rotated_module):
        mod.pairwise_iou_rotated, mod.nms_rotated = iou, nms
    try:
        yield
    finally:
        for mod in (rrpn_module, rotated_module):
            mod.pairwise_iou_rotated, mod.nms_rotated = real_iou, real_nms


def reset_rotated_launches():
    rot_ops.pairwise_iou_rotated.launches = rot_ops.nms_rotated.launches = 0


def read_rotated_launches():
    return {"iou_rotated": rot_ops.pairwise_iou_rotated.launches, "nms_rotated": rot_ops.nms_rotated.launches}


def near_pairs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, 5) x (M, 5) → (N, M): the pairs ``rotated::iou`` clips (its circles
    test, ``far_apart`` in csrc/iou_rotated.cuh, false)."""
    a, b = a.float(), b.float()
    r = 0.5 * (torch.sqrt(a[:, 2] ** 2 + a[:, 3] ** 2)[:, None] + torch.sqrt(b[:, 2] ** 2 + b[:, 3] ** 2)[None])
    margin = 1e-3 * r + 1e-4 * ((a[:, 0].abs() + a[:, 1].abs())[:, None] + (b[:, 0].abs() + b[:, 1].abs())[None]) \
        + 1e-3
    d2 = (a[:, 0, None] - b[None, :, 0]) ** 2 + (a[:, 1, None] - b[None, :, 1]) ** 2
    return d2 <= (r + margin) ** 2


def rotated_iou_ops(a: torch.Tensor, b: torch.Tensor) -> int:
    """The f32 operations R1 needs for (B, N, 5) x (B or 1, M, 5) (or 2-d) pairs."""
    a = a if a.dim() == 3 else a[None]
    b = b if b.dim() == 3 else b[None]
    near = sum(int(near_pairs(a[i], b[i if b.shape[0] > 1 else 0]).sum()) for i in range(a.shape[0]))
    pairs = a.shape[0] * a.shape[1] * b.shape[1]
    return near * IOU_CLIP_OPS + (pairs - near) * IOU_FAR_OPS


def rotated_nms_work(boxes, scores, classes, keep, valid):
    """(sorted candidates up to each row's last valid pick, summed over the
    rows; the f32 operations of the IoUs greedy NMS cannot do without: one
    per pair of kept picks of a class, as ``rotated::iou`` costs it, and a
    clip per suppressed candidate up to the row's last pick, which some pick
    overlaps)."""
    prefix, needed = nms_sorted_work(scores, keep, valid)  # needed = kept pairs + suppressed, every row
    ops = 0
    for r in range(scores.shape[0]):
        k = keep[r][valid[r]]
        if len(k) < 2:
            continue
        pairs = torch.ones(len(k), len(k), dtype=torch.bool, device=k.device).triu(1)
        if classes is not None:
            pairs &= classes[r, k][:, None] == classes[r, k][None, :]
        near = near_pairs(boxes[r, k], boxes[r, k]) & pairs
        ops += int(near.sum()) * IOU_CLIP_OPS + int((pairs & ~near).sum()) * IOU_FAR_OPS
        needed -= len(k) * (len(k) - 1) // 2  # the kept pairs, counted above by class
    return prefix, ops + needed * IOU_CLIP_OPS


def rotated_batches(cfg, seed: int):
    """The train loader's batches of the synthetic scenes with each gt box
    made rotated: XYXY → (cx, cy, w, h) and an angle drawn in ±45° from
    ``seed`` (as ``tests/modeling/test_rotated_rcnn.py`` builds its gts): the
    (N, M, 5) batches ``RotatedRCNN.loss_fn`` takes (the mapper's XYXY ones
    raise)."""
    rng = np.random.RandomState(seed)
    loader = DefaultTrainer.build_train_loader(cfg)
    try:
        for batch in loader:
            b = batch["gt_boxes"]
            angle = rng.uniform(-ROTATED_ANGLE, ROTATED_ANGLE, b.shape[:2]).astype(np.float32)
            batch["gt_boxes"] = np.stack([(b[..., 0] + b[..., 2]) / 2, (b[..., 1] + b[..., 3]) / 2,
                                          b[..., 2] - b[..., 0], b[..., 3] - b[..., 1], angle], -1).astype(np.float32)
            yield batch
    finally:
        loader.close()


def check_rotated_detections(name, img, inst, score_threshold, classes=80):
    """Some detections, finite rotated (cx, cy, w, h, angle) boxes centred in
    the image, angles in [-180, 180), above the threshold, of the classes."""
    b, (h, w) = inst.pred_boxes.tensor, img.shape[:2]
    if not (len(inst) > 0 and b.shape[1] == 5 and np.isfinite(b).all() and np.isfinite(inst.scores).all()
            and (b[:, 2:4] >= 0).all() and (b[:, 4] >= -180).all() and (b[:, 4] < 180).all()
            and (inst.scores > score_threshold).all() and (inst.pred_classes < classes).all()):
        raise SystemExit(f"{name}: bad rotated detections for a {h}x{w} image: {inst}")


def phase_rotated(report, out_dir):
    """Phase 23: the rotated Faster R-CNN R50-C4 at full width (``rotated_cfg``:
    RRPN on res4, 45 rotated anchors a cell, 6000/1000 proposals at test and
    12 000/2000 at training, ROIAlignRotated at 7², 2 fc of 1024, a
    class-agnostic 5-d predictor, 80 classes), bf16, seeded weights
    (``rcnn_weights``, calibrated on the card): (a) ``DefaultPredictor``
    requests (median of 10), ``predict_fn`` at batch 1 and 16 (peak memory,
    the batch-16 profile, ROIAlignRotated's and the two kernels' share);
    (b) f32, batch 1, card against CPU: the RPN head, then on the card's
    first HEAD_ROIS proposals the rotated pools and the box predictor, within
    HEAD_TOL (SAME_INPUT_TOL for the pools, which read the card's maps on
    both sides), with cuDNN's TF32 as the control; (c) ``SimpleTrainer``
    steps (``bench.TRAIN_WARMUP`` + ``bench.TRAIN_STEPS`` + 1 profiled) at 16
    x 800² on the synthetic scenes with rotated gts (``rotated_batches``),
    busy share, peak memory, every loss finite; (d) ``RotatedCOCOEvaluator``
    on 16 synthetic scenes through ``inference_on_dataset``; (e) R1 against
    its plain clip on the captured matching and sampling inputs (1e-5), R2
    against the plain argmax loop on the captured RPN rows (test and
    training) and box-head rows, index for index but for counted ties within
    1e-5 of the threshold (at most 0.1% of the picks). No DCN kernel and no
    axis-aligned NMS (``greedy_nms``) anywhere on it. Returns (the DCN
    launches, the rotated kernels' launches, their checks by case)."""
    cfg = rotated_cfg("bfloat16")
    m = cfg.MODEL
    size = tuple(cfg.INPUT.TEST_SIZE)
    print(f"== 23a. rotated Faster R-CNN R50-C4 ({ROTATED_YAML} + RRPN / RROIHeads, {m.ANCHOR_GENERATOR.SIZES} x "
          f"{m.ANCHOR_GENERATOR.ASPECT_RATIOS} x {m.ANCHOR_GENERATOR.ANGLES}, RPN top-k {m.RPN.PRE_NMS_TOPK_TEST}/"
          f"{m.RPN.POST_NMS_TOPK_TEST} at test, {m.RPN.PRE_NMS_TOPK_TRAIN}/{m.RPN.POST_NMS_TOPK_TRAIN} at training), bf16: "
          f"DefaultPredictor, predict_fn at batch 1 and {RCNN_BATCH}")
    rng = np.random.RandomState(230)
    cfg32 = rotated_cfg("float32")
    init, weights = rcnn_weights(cfg32, letterboxed(rng, "cpu", 2, size), seed=0, device="cuda")
    predictor = DefaultPredictor(cfg)
    model = predictor.model
    if type(model).__name__ != "RotatedRCNN" or model.anchor_generator.num_anchors != [45]:
        raise SystemExit(f"the rotated config built {type(model).__name__} with {model.anchor_generator.num_anchors}")
    model.model.load_state_dict(weights)
    res, cases, iou_inputs = {}, {}, []
    reset_launches()
    reset_rotated_launches()
    nms_ops.greedy_nms.launches = 0
    for h, w in ((480, 640), (800, 800), (375, 500)):
        im = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        inst = predictor(im)["instances"]
        check_rotated_detections("rotated", im, inst, model.score_threshold)
        print(f"  request {h}x{w}: {len(inst)} detections, top score {inst.scores.max():.4f}, angles "
              f"{inst.pred_boxes.tensor[:, 4].min():.1f}..{inst.pred_boxes.tensor[:, 4].max():.1f}")
    latency = bench.request_ms(predictor, rng.randint(0, 256, (480, 640, 3)).astype(np.uint8))
    b1, b16 = letterboxed(rng, model.device, 1, size), letterboxed(rng, model.device, RCNN_BATCH, size)
    nms_inputs = []
    with capture_rotated(iou_inputs, nms_inputs):
        d16 = model.predict_fn(b16)
    cases.update(zip(("rpn_test_rotated", "box_head_rotated"), nms_inputs))
    if not (tuple(d16["boxes"].shape) == (RCNN_BATCH, cfg.TEST.DETECTIONS_PER_IMAGE, 5)
            and bool(torch.isfinite(d16["boxes"]).all())):
        raise SystemExit(f"the rotated predict_fn gave {tuple(d16['boxes'].shape)}")
    serving = read_rotated_launches()
    calls = 3 + bench.REQUEST_WARMUP + bench.REQUESTS + 1
    if serving["nms_rotated"] != 2 * calls or serving["iou_rotated"] != 0:
        raise SystemExit(f"rotated serving: expected {2 * calls} R2 and no R1 launches, got {serving}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms_b1 = cuda_ms(lambda: model.predict_fn(b1), iters=5)
    ms_b16 = cuda_ms(lambda: model.predict_fn(b16), iters=3, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    p16 = profiled(lambda: model.predict_fn(b16), calls=1)
    kernel_ms = {k: sum(e.self_device_time_total for e in p16["events"] if e.device_type == DeviceType.CUDA
                        and not e.is_user_annotation and any(n in e.key.lower() for n in names)) / 1e3
                 for k, names in (("roi_align_rotated_embedding_bag", ("embeddingbag",)),
                                  ("nms_rotated", NMS_KERNELS))}
    res.update(request_ms=latency, request_median_ms=statistics.median(latency), predict_fn_b1_ms=ms_b1,
               predict_fn_b16_ms=ms_b16, img_s_b1=1e3 / ms_b1, img_s_b16=RCNN_BATCH * 1e3 / ms_b16,
               peak_memory_gib_b16=peak, device_ms_b16=p16["device_ms"], kernel_ms_b16=kernel_ms)
    print(f"  request (480x640) median {res['request_median_ms']:.3f} ms of {bench.REQUESTS}; predict_fn batch 1 "
          f"{ms_b1:.3f} ms = {res['img_s_b1']:.2f} img/s; batch {RCNN_BATCH} {ms_b16:.3f} ms = {res['img_s_b16']:.2f} "
          f"img/s ({p16['device_ms']:.3f} ms on the card: ROIAlignRotated's embedding_bag "
          f"{kernel_ms['roi_align_rotated_embedding_bag']:.3f} ms, R2 {kernel_ms['nms_rotated']:.3f} ms); peak memory "
          f"{peak:.2f} GiB")
    print(p16["events"].table(sort_by="cuda_time_total", row_limit=10, max_name_column_width=90))
    del predictor, d16

    print(f"== 23b. f32, batch 1, card against CPU: the RPN head; on the card's first {HEAD_ROIS} proposals the "
          f"rotated pools (the card's maps on both sides) and the box predictor; cuDNN's TF32 as the control")
    card = build_model(cfg32)
    cfg_host = cfg32.clone()
    cfg_host.MODEL.DEVICE = "cpu"
    host = build_model(cfg_host)
    for mdl in (card, host):
        mdl.model.load_state_dict(weights)
    checks, tf32 = {}, {}
    with torch.inference_mode():
        def stages(mdl, feats, lg, dl, props):
            out = {"objectness_logits": lg[0], "anchor_deltas": dl[0]}
            out["pooled"] = mdl.pool({k: v.to(mdl.device) for k, v in feats_c.items()}, props.to(mdl.device).reshape(-1, 5),
                                     props.shape[1])
            out["cls_score"], out["bbox_pred"] = mdl.model.box_predict(mdl.pool(feats, props.to(mdl.device).reshape(-1, 5),
                                                                                props.shape[1]))
            return out

        feats_c, lg_c, dl_c = card.model(card.normalize(b1))
        props = card.proposals(lg_c, dl_c, size, "test")[0][:, :HEAD_ROIS].contiguous()
        got = stages(card, feats_c, lg_c, dl_c, props)
        feats_h, lg_h, dl_h = host.model(host.normalize(b1.cpu()))
        want = stages(host, feats_h, lg_h, dl_h, props.cpu())
        with pytorch_default_tf32(), bypass_ieee_f32(rcnn), bypass_ieee_f32(resnet_module):
            feats_t, lg_t, dl_t = card.model(card.normalize(b1))
            ctrl = stages(card, feats_t, lg_t, dl_t, props)
    for k in got:
        rel = SAME_INPUT_TOL if k == "pooled" else HEAD_TOL
        card_vs_cpu(checks, k, got[k], want[k], rel=rel)
        card_vs_cpu(tf32, k, ctrl[k], want[k], rel=rel)
        print(f"  {k}: max_abs_err={checks[k]['max_abs_err']:.3e} (scale {checks[k]['scale']:.3e}, tol {rel:.0e} x "
              f"scale) {'ok' if checks[k]['max_abs_err'] <= checks[k]['tol'] else 'FAIL'}; TF32 control "
              f"{tf32[k]['max_abs_err'] / tf32[k]['tol']:.2f}x the tol")
    if any(v["max_abs_err"] > v["tol"] for v in checks.values()):
        raise SystemExit(f"the rotated R-CNN's f32 stages differ between the card and the CPU: {checks}")
    if not max(v["max_abs_err"] / v["tol"] for k, v in tf32.items() if k != "pooled") > 1:
        raise SystemExit(f"the rotated R-CNN's f32 check did not see TF32: {tf32}")
    res.update(card_vs_cpu=checks, tf32_control=tf32)
    del card, host, feats_c, feats_h, feats_t

    steps = bench.TRAIN_WARMUP + bench.TRAIN_STEPS + 1
    print(f"== 23c. SimpleTrainer: {steps} steps at {RCNN_BATCH} x 800² on the synthetic coco_2017_train, each gt "
          f"box turned by a seeded angle in ±{ROTATED_ANGLE:.0f}° ((N, M, 5) batches), from the init")
    synthetic_stand_in(cfg.DATASETS.TRAIN[0])
    train_cfg = cfg.clone()
    train_cfg.SOLVER.IMS_PER_BATCH = RCNN_BATCH
    train_cfg.SOLVER.MAX_ITER = steps
    tmodel = build_model(train_cfg)
    tmodel.model.load_state_dict(init)
    optimizer, scheduler = build_optimizer(train_cfg, tmodel.model)
    trainer = SimpleTrainer(tmodel, rotated_batches(train_cfg, seed=23), optimizer, scheduler)
    clock = bench.StepClock(bench.Clock("cuda"), profiled=steps - 1)
    train_nms = []
    trainer.register_hooks([clock])
    capture = capture_rotated(iou_inputs, train_nms)

    class CaptureFirst(HookBase):  # the first step's rotated IoU and NMS inputs
        def before_step(self):
            if self.trainer.iter == 0:
                capture.__enter__()

        def after_step(self):
            if self.trainer.iter == 0:
                capture.__exit__(None, None, None)

    trainer.register_hooks([CaptureFirst()])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.train(0, steps)
    torch.cuda.synchronize()
    peak_train = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = statistics.median(clock.times[bench.TRAIN_WARMUP:])
    names = ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "total_loss")
    losses = {k: [v for v, _ in trainer.storage.history(k).values()] for k in names}
    if not all(len(v) == steps and all(math.isfinite(a) for a in v) for v in losses.values()):
        raise SystemExit(f"the rotated train steps: losses {losses}")
    cases["rpn_train_rotated"] = train_nms[0]  # the first step's 16 rows of 12 000
    busy = clock.device_ms / step_ms
    res.update(train=dict(train_step_ms=step_ms, train_img_s=RCNN_BATCH * 1e3 / step_ms, train_batch=RCNN_BATCH,
                          train_busy_share=busy, peak_memory_gib=peak_train), train_losses=losses,
               train_step_ms_all=clock.times, train_profiled_device_ms=clock.device_ms)
    print(f"  total loss {' '.join(f'{v:.4f}' for v in losses['total_loss'])}; step times (ms) "
          f"{' '.join(f'{t:.1f}' for t in clock.times)}, median of {bench.TRAIN_STEPS} {step_ms:.1f} ms = "
          f"{RCNN_BATCH * 1e3 / step_ms:.1f} img/s; card busy {clock.device_ms:.1f} ms = {busy:.0%} of the median "
          f"step; peak memory {peak_train:.2f} GiB")
    print(clock.events.table(sort_by="cuda_time_total", row_limit=10, max_name_column_width=90))
    del trainer, tmodel, optimizer, clock

    val = "chip_smoke_rotated_val"
    print(f"== 23d. RotatedCOCOEvaluator through inference_on_dataset: {ROTATED_EVAL_IMAGES} synthetic scenes "
          f"({EVAL_SIZE[0]}x{EVAL_SIZE[1]}, their XYWH gts at angle 0), batch {RCNN_BATCH}, the served weights")
    for catalog in (DatasetCatalog, MetadataCatalog):
        if val in catalog:
            catalog.remove(val)
    register_synthetic_instances(val, num_images=ROTATED_EVAL_IMAGES, image_size=EVAL_SIZE)
    eval_cfg = cfg.clone()
    eval_cfg.TEST.BATCH_SIZE = RCNN_BATCH
    emodel = build_model(eval_cfg)
    emodel.model.load_state_dict(weights)
    loader = DefaultTrainer.build_test_loader(eval_cfg, val)
    t0 = time.perf_counter()
    try:
        result = eval_loop.inference_on_dataset(emodel.predict_fn, loader, RotatedCOCOEvaluator(val),
                                                postprocess=emodel.postprocess, device=emodel.device)
    finally:
        loader.close()
    eval_s = time.perf_counter() - t0
    if not (set(result.get("bbox", {})) == {"AP", "AP50", "AP75"} and all(math.isfinite(v) for v in result["bbox"].values())):
        raise SystemExit(f"RotatedCOCOEvaluator gave {result}")
    print(f"  {result['bbox']} in {eval_s:.1f} s")
    res.update(evaluation=result["bbox"], eval_s=eval_s)
    del emodel
    torch.cuda.synchronize()
    launches, rotated = read_launches(), read_rotated_launches()
    nms_axis = nms_ops.greedy_nms.launches
    print(f"  launches on the rotated path: R1 {rotated['iou_rotated']}, R2 {rotated['nms_rotated']}; DCN {launches}; "
          f"axis-aligned NMS {nms_axis}")
    if any(launches.values()) or nms_axis or not (rotated["iou_rotated"] > 0 and rotated["nms_rotated"] > 0):
        raise SystemExit(f"the rotated path's launches: DCN {launches}, greedy_nms {nms_axis}, rotated {rotated}")
    res.update(launches=launches, rotated_launches=rotated)
    checks = phase_rotated_kernels(res, iou_inputs, cases)
    report["rotated"] = res
    return launches, rotated, checks


def timed_once(fn):
    """(``fn()``, its ms on the card's clock): one call, no warm-up (the plain
    versions' thousands of small launches dwarf their first call's)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def phase_rotated_kernels(res, iou_inputs, cases):
    """23e: R1 and R2 against their plain versions on the card, on the inputs
    the rotated path gave them, timed beside their bounds."""
    print("== 23e. R1 (csrc/iou_rotated.cu) and R2 (nms.cu's rotated pipeline) against their plain versions on the "
          "card, on the rotated path's inputs")
    out = {}
    # the first matching chunk (the gts against the anchors, one 2-d set) and the first proposal sampling
    picked = {"rrpn_matching": next(c for c in iou_inputs if c[1].dim() == 2),
              "proposal_sampling": next(c for c in iou_inputs if c[1].dim() == 3)}
    if ROTATED_CASES:
        cpu = lambda t: t.cpu() if isinstance(t, torch.Tensor) else t  # noqa: E731
        torch.save({"iou": {k: tuple(map(cpu, v)) for k, v in picked.items()},
                    "nms": {k: tuple(map(cpu, v)) for k, v in cases.items()}}, ROTATED_CASES)
        print(f"  the inputs saved to {ROTATED_CASES}")
    for name, (a, b) in picked.items():
        got = rot_ops.pairwise_iou_rotated(a, b)
        want, plain_ms = timed_once(lambda: rot_ops.pairwise_iou_rotated_plain(a, b))
        # a pair clipped by a box of no area (the gt slots past an image's gts, appended to its proposals) is
        # f32 noise in both versions, as in the JAX package's: the matcher masks those slots out
        keep = (b[..., 2] * b[..., 3] > 0).unsqueeze(-2).expand_as(got)
        err = (got - want).abs()[keep].max().item()
        ms = cuda_ms(lambda: rot_ops.pairwise_iou_rotated(a, b), iters=10)
        ops = rotated_iou_ops(a, b)
        nbytes = (a.numel() + b.numel() + got.numel()) * 4
        bound, by = bound_of(ops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3)
        stages = rotated_ab.stage_table(lambda: rot_ops.pairwise_iou_rotated(a, b), calls=1)
        out[name] = dict(shape=[list(a.shape), list(b.shape)], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound, bound_by=by, ops=ops, bytes=nbytes, noise_pairs=int((~keep).sum()),
                         ms_before=ROTATED_MS_BEFORE[name][0], stages=stages)
        print(f"  R1 {name}: {tuple(a.shape)} x {tuple(b.shape)} -> {tuple(got.shape)}: max |kernel - plain| {err:.2e} "
              f"(tol 1e-5; {int((~keep).sum())} pairs clipped by a box of no area left out); kernel {ms:.3f} ms "
              f"(before the redesign {ROTATED_MS_BEFORE[name][0]:.3f}), plain clip {plain_ms:.3f} ms; bound {bound:.4f} ms ({by}: "
              f"{ops:.3e} operations, {nbytes} bytes); stages: {rotated_ab.format_table(stages)}")
        if not err <= 1e-5:
            raise SystemExit(f"R1 disagrees with its plain version on {name}: {err}")
    for name, (boxes, scores, classes, thr, counts) in cases.items():
        rows = ROTATED_PLAIN_ROWS[name]
        sub = slice(None) if rows is None else slice(0, rows)
        bx, sc = boxes[sub].contiguous(), scores[sub].contiguous()
        cl = None if classes is None else classes[sub].contiguous()
        cn = counts if isinstance(counts, int) else counts[sub]
        rounds = nms_ops.rounds_taken()
        got = rot_ops.nms_rotated(bx, sc, thr, cn, cl)
        rounds = nms_ops.rounds_taken() - rounds
        want, plain_ms = timed_once(lambda: rot_ops.nms_rotated_fixed(bx, sc, thr, cn, cl))
        ties = rot_ops.nms_pick_ties(bx, sc, thr, got, want, cl)
        equal = ties["differing_rows"] == 0 and torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        ms = cuda_ms(lambda: rot_ops.nms_rotated(bx, sc, thr, cn, cl), iters=10)
        full_ms = cuda_ms(lambda: rot_ops.nms_rotated(boxes, scores, thr, counts, classes), iters=5)
        prefix, ops = rotated_nms_work(bx, sc, cl, *got)
        k = got[0].shape[1]
        nbytes = sc.numel() * 4 + prefix * (20 + (4 if cl is not None else 0)) + sc.shape[0] * k * 9
        bound, by = bound_of(ops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3)
        stages = rotated_ab.stage_table(lambda: rot_ops.nms_rotated(bx, sc, thr, cn, cl), calls=1)
        stages_all = rotated_ab.stage_table(lambda: rot_ops.nms_rotated(boxes, scores, thr, counts, classes), calls=1)
        before, before_all = ROTATED_MS_BEFORE[name]
        out[name] = dict(rows=sc.shape[0], all_rows=scores.shape[0], candidates=sc.shape[1], picks=ties["picks"],
                         equal=equal, ties=ties, rounds=rounds, ms=ms, plain_ms=plain_ms, ms_all_rows=full_ms,
                         bound_ms=bound, bound_by=by, sorted_prefix=prefix, ops=ops, classes=cl is not None,
                         ms_before=before, ms_all_rows_before=before_all, stages=stages, stages_all_rows=stages_all)
        print(f"  R2 {name}: {sc.shape[0]} of {scores.shape[0]} rows x {sc.shape[1]} candidates, picks "
              f"{counts if isinstance(counts, int) else sorted(set(counts))}, {ties['picks']} valid"
              f"{', per class' if cl is not None else ''}: {'equal' if equal else 'DIFFERENT'} to the loop "
              f"({ties['ties']} rows differ at a tie, {ties['not_ties']} otherwise); {rounds} chunks; kernel {ms:.3f} ms "
              f"({full_ms:.3f} ms on all {scores.shape[0]} rows; before the redesign {before:.3f}"
              f"{'' if before_all is None else f', {before_all:.3f}'}), plain loop {plain_ms:.3f} ms; bound {bound:.4f} ms "
              f"({by}: {ops:.3e} operations, {nbytes} bytes)")
        print(f"    stages, {sc.shape[0]} rows: {rotated_ab.format_table(stages)}")
        print(f"    stages, all {scores.shape[0]} rows: {rotated_ab.format_table(stages_all)}")
        if ties["not_ties"] or ties["ties"] > 0.001 * ties["picks"]:
            raise SystemExit(f"R2 disagrees with the plain loop on {name}: {ties}")
    res["kernels_vs_plain"] = out
    return out


def phase_trident(report, out_dir):
    """Phase 24: TridentNet R50-C4 (``TRIDENT_YAML``: three weight-shared
    branches at dilations 1/2/3 in res4, Res5ROIHeads, 128 rois, 500
    training proposals, no gt appended, 80 classes) at full width, bf16,
    seeded weights: (a) Fast mode (``TEST_BRANCH_IDX`` 1) and (b) full mode
    (-1: the batch tiled to 3N, each image's 3 x 100 detections merged by
    class-aware NMS on nms.cu): ``DefaultPredictor`` requests, ``predict_fn``
    at batch 1 and 16 (full mode at ``TRIDENT_FULL_BATCH``), peak memory;
    full mode's merge rows go to 10c; (c) ``tools/bench``'s train steps
    (``bench.bench_training``) at ``TRIDENT_TRAIN_BATCH`` (48 images at res4),
    busy share, peak memory, every loss finite; (d) ``tools/train_net`` ``TRIDENT_STEPS`` steps from
    the init, then ``--eval-only --resume`` on 16 synthetic coco_2017_val
    scenes. No DCN kernel, no rotated kernel. Returns (DCN launches, NMS
    launches by part, NMS cases for 10c)."""
    cfg = yaml_cfg(TRIDENT_YAML, "bfloat16")
    m = cfg.MODEL
    size = tuple(cfg.INPUT.TEST_SIZE)
    print(f"== 24a. {TRIDENT_YAML}: TridentRCNN, ResNet-{m.RESNETS.DEPTH} trident res4 (dilations "
          f"{list(m.TRIDENT.BRANCH_DILATIONS)}), {m.ROI_HEADS.BATCH_SIZE_PER_IMAGE} rois, proposals "
          f"{m.RPN.PRE_NMS_TOPK_TEST}/{m.RPN.POST_NMS_TOPK_TEST}, bf16; Fast (branch {m.TRIDENT.TEST_BRANCH_IDX}) and "
          f"full: DefaultPredictor, predict_fn at batch 1 and {RCNN_BATCH}")
    rng = np.random.RandomState(240)
    init, weights = rcnn_weights(yaml_cfg(TRIDENT_YAML, "float32"), letterboxed(rng, "cpu", 2, size), seed=0,
                                 device="cuda")
    res, nms_launches, nms_cases = {}, {}, {}
    reset_launches()
    reset_rotated_launches()
    for mode, branch in (("fast", int(m.TRIDENT.TEST_BRANCH_IDX)), ("full", -1)):
        mcfg = cfg.clone()
        mcfg.MODEL.TRIDENT.TEST_BRANCH_IDX = branch
        predictor = DefaultPredictor(mcfg)
        model = predictor.model
        model.model.load_state_dict(weights)
        nms_ops.greedy_nms.launches = 0
        for h, w in ((480, 640), (800, 800), (375, 500)):
            im = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            inst = predictor(im)["instances"]
            check_detections(f"trident {mode}", im, inst, model.score_threshold)
        latency = bench.request_ms(predictor, rng.randint(0, 256, (480, 640, 3)).astype(np.uint8))
        n = RCNN_BATCH if mode == "fast" else TRIDENT_FULL_BATCH
        b1, bn = letterboxed(rng, model.device, 1, size), letterboxed(rng, model.device, n, size)
        nms_inputs = []
        with capture_nms(nms_inputs):
            dn = model.predict_fn(bn)
        torch.cuda.synchronize()
        calls = 3 + bench.REQUEST_WARMUP + bench.REQUESTS + 1
        per_call = 2 if mode == "fast" else 3  # the RPN's rows, the box head's, full mode's merge
        nms_launches[f"trident_{mode}"] = {"serving": nms_ops.greedy_nms.launches}
        if nms_ops.greedy_nms.launches != per_call * calls:
            raise SystemExit(f"trident {mode}: expected {per_call * calls} NMS kernel launches, got "
                             f"{nms_ops.greedy_nms.launches}")
        names = ("rpn_test", "box_head") + (("merge",) if mode == "full" else ())
        nms_cases.update({f"{k}_trident_{mode}": c for k, c in zip(names, nms_inputs)})
        if not (tuple(dn["boxes"].shape) == (n, cfg.TEST.DETECTIONS_PER_IMAGE, 4)
                and bool(torch.isfinite(dn["boxes"]).all())):
            raise SystemExit(f"trident {mode}'s predict_fn gave {tuple(dn['boxes'].shape)}")
        del dn
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms_b1 = cuda_ms(lambda: model.predict_fn(b1), iters=5)
        ms_bn = cuda_ms(lambda: model.predict_fn(bn), iters=3, warmup=1)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        res[mode] = dict(request_ms=latency, request_median_ms=statistics.median(latency), predict_fn_b1_ms=ms_b1,
                         batch=n, predict_fn_batch_ms=ms_bn, img_s_b1=1e3 / ms_b1, img_s_batch=n * 1e3 / ms_bn,
                         peak_memory_gib_batch=peak)
        print(f"  {mode}: request (480x640) median {res[mode]['request_median_ms']:.3f} ms of {bench.REQUESTS}; "
              f"predict_fn batch 1 {ms_b1:.3f} ms = {1e3 / ms_b1:.2f} img/s; batch {n} {ms_bn:.3f} ms = "
              f"{n * 1e3 / ms_bn:.2f} img/s; peak memory {peak:.2f} GiB"
              + ("" if n == RCNN_BATCH else f" (batch {RCNN_BATCH} is {3 * RCNN_BATCH} images through res4 and "
                 f"{3 * RCNN_BATCH}k rois through res5: it does not fit in 80 GB)"))
        del predictor, model, b1, bn
        torch.cuda.empty_cache()

    print(f"== 24c. tools/bench's train steps (bench.bench_training) at the YAML's {TRIDENT_TRAIN_BATCH} x 800² (3 x "
          f"{TRIDENT_TRAIN_BATCH} at res4) on the synthetic {cfg.DATASETS.TRAIN[0]}, the model's own init")
    synthetic_stand_in(cfg.DATASETS.TRAIN[0])
    train_cfg = cfg.clone()
    train_cfg.SOLVER.IMS_PER_BATCH = TRIDENT_TRAIN_BATCH
    nms_ops.greedy_nms.launches = 0
    entries, trainer, clock = bench.bench_training(train_cfg)
    torch.cuda.synchronize()
    steps = bench.TRAIN_WARMUP + bench.TRAIN_STEPS + 1
    nms_launches["trident_fast"]["bench"] = nms_ops.greedy_nms.launches
    names = ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "total_loss")
    losses = {k: [v for v, _ in trainer.storage.history(k).values()] for k in names}
    if not (all(len(v) == steps and all(math.isfinite(a) for a in v) for v in losses.values())
            and nms_ops.greedy_nms.launches == steps):
        raise SystemExit(f"trident's train steps: losses {losses}, NMS launches {nms_ops.greedy_nms.launches}")
    print(f"  total loss {' '.join(f'{v:.4f}' for v in losses['total_loss'])}; step times (ms) "
          f"{' '.join(f'{t:.1f}' for t in clock.times)}, median of {bench.TRAIN_STEPS} {entries['train_step_ms']:.1f} ms "
          f"= {entries['train_img_s']:.1f} img/s; card busy {clock.device_ms:.1f} ms = "
          f"{entries['train_busy_share']:.0%} of the median step; peak memory {entries['peak_memory_gib']:.2f} GiB")
    print(clock.events.table(sort_by="cuda_time_total", row_limit=8, max_name_column_width=90))
    res.update(train=entries, train_losses=losses, train_step_ms_all=clock.times,
               train_profiled_device_ms=clock.device_ms)
    del trainer, clock

    init_path = os.path.join(out_dir, "init_weights.pth")
    torch.save(init, init_path)
    os.environ["DETECTRON2_SYNTH_DATA"] = "1"
    val = "coco_2017_val"
    for catalog in (DatasetCatalog, MetadataCatalog):
        if val in catalog:
            catalog.remove(val)
    register_synthetic_instances(val, num_images=ROTATED_EVAL_IMAGES, image_size=EVAL_SIZE)
    extra = ["MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.005", "TEST.BATCH_SIZE", str(RCNN_BATCH)]
    print(f"== 24d. tools/train_net on {TRIDENT_YAML}: {TRIDENT_STEPS} steps at batch {TRIDENT_TRAIN_BATCH} from the "
          f"init, then --eval-only --resume on {val} ({ROTATED_EVAL_IMAGES} synthetic images) {' '.join(extra)}")
    argv = ["--config-file", TRIDENT_YAML, "SOLVER.MAX_ITER", str(TRIDENT_STEPS), "SOLVER.IMS_PER_BATCH",
            str(TRIDENT_TRAIN_BATCH), "MODEL.WEIGHTS", init_path, "OUTPUT_DIR", out_dir, "SEED", "0"] + extra
    nms_ops.greedy_nms.launches = 0
    trained, evaluated, resumed, train_s, eval_s = run_train_net(argv, "output/chip_smoke_trident_train_net_log.txt")
    nms_launches["trident_fast"]["train_net"] = nms_ops.greedy_nms.launches
    want_nms = TRIDENT_STEPS + 2 * 2 * -(-ROTATED_EVAL_IMAGES // RCNN_BATCH)
    print(f"  train: {train_s:.1f} s; eval-only: {eval_s:.1f} s; iterations resumed at {resumed}; bbox AP "
          f"{trained['bbox']['AP']:.4f}, AP50 {trained['bbox']['AP50']:.4f}; NMS kernel launches "
          f"{nms_ops.greedy_nms.launches}")
    if not (resumed == [0, TRIDENT_STEPS] and same_results(trained, evaluated) and nms_ops.greedy_nms.launches == want_nms
            and all(math.isfinite(trained["bbox"][k]) for k in ("AP", "AP50"))):
        raise SystemExit(f"trident's train_net: resumed {resumed}, NMS launches {nms_ops.greedy_nms.launches} "
                         f"(expected {want_nms}), results {trained} vs {evaluated}")
    res.update(train_net=dict(train_s=train_s, eval_only_s=eval_s, resumed=resumed, results=trained))
    torch.cuda.synchronize()
    launches, rotated = read_launches(), read_rotated_launches()
    print(f"  DCN kernel launches on the trident paths: {launches}; rotated kernels {rotated}; NMS kernel launches "
          f"{nms_launches}")
    if any(launches.values()) or any(rotated.values()):
        raise SystemExit(f"the trident paths launched DCN or rotated kernels: {launches}, {rotated}")
    res.update(launches=launches, nms_kernel_launches=nms_launches)
    report["trident"] = res
    return launches, nms_launches, nms_cases


def roi_ops_inference(model, props, scores, deltas, n, p, size):
    """``fast_rcnn_inference`` of the box predictor's outputs on (N, P) proposals."""
    return roi_heads_ops.fast_rcnn_inference(props[0], props[2], scores.view(n, p, -1), deltas.view(n, p, -1),
                                             model.box2box, model.num_classes, size, model.score_threshold,
                                             model.nms_threshold, model.max_detections)


TTA_IMAGES = 8  # 25a's synthetic scenes
TTA_SIZES_CPU = (416, 512)  # 25a's card-against-CPU check: the config's two smallest sizes, with the flip
# 25a, f32 card against CPU on one image: the merged detections matched one for one (class, score, box); the
# scores are sigmoids of the f32 heads, held in phase 4 to HEAD_TOL of their scale. At most TTA_MAX_TIES of
# either side's 100 may stay unpaired, near-ties (merged_close)
TTA_SCORE_TOL, TTA_BOX_TOL, TTA_MAX_TIES = HEAD_TOL, 5e-2, 4
EXPORT_TOL = 1e-5  # 25b: a loaded program against eager predict_fn, relative to each output's max |value|
EXPORT_SIZE, EXPORT_BATCH = 512, 16  # 25b: ctdet DLA-34's programs (and batch 1); RetinaNet's at 800²
INT8_BOUND = 0.08  # 25c: the JAX package's bound on quantization_error (tests/test_export.py)
PROFILE_BATCH = 8  # 25e: the two profiled train steps' batch
# the kernels' names in a profiler trace: K5 is dcn_bwd_wq_kernel with both gradients (DQ, DW) on
TRACE_KERNELS = {"dcn_fwd": ("dcn_fwd_kernel",), "dcn_bwd_dx": ("dcn_bwd_dx_kernel",),
                 "dcn_bwd_dqdw": ("dcn_bwd_wq_kernel", "true, true")}
RUN_EXPORTED = r"""
import json, sys, time
import torch
from detectron2_centernet_tpu_torch.export import load_exported
from detectron2_centernet_tpu_torch.ops import dcn, nms

def no_plain(*args, **kwargs):
    raise RuntimeError("a plain version ran inside an exported program")

dcn.modulated_deform_conv_plain = no_plain
nms.nms_fixed = no_plain
torch.backends.cudnn.allow_tf32 = True  # PyTorch's default: the program must keep its f32 convolutions IEEE
spec = json.load(open(sys.argv[1]))
out = {}
for name, case in spec.items():
    t0 = time.perf_counter()
    model = load_exported(case["path"])
    load_s = time.perf_counter() - t0
    io = torch.load(case["io"])
    x = io["x"].cuda()
    dcn.modulated_deform_conv.launches = nms.greedy_nms.launches = 0
    got = model(x)
    torch.cuda.synchronize()
    launches = {"dcn_fwd": dcn.modulated_deform_conv.launches, "nms_fixed": nms.greedy_nms.launches}
    err = {k: ((got[k].float() - io[k].cuda().float()).abs().max() / io[k].float().abs().max().clamp(min=1e-30)).item()
           for k in ("boxes", "scores", "classes")}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(2):
        model(x)
    start.record()
    for _ in range(case["iters"]):
        model(x)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / case["iters"]
    total = {"dcn_fwd": dcn.modulated_deform_conv.launches, "nms_fixed": nms.greedy_nms.launches}
    out[name] = dict(load_s=load_s, launches=launches, total_launches=total, rel_err=err, ms=ms,
                     img_s=x.shape[0] * 1e3 / ms, calls=1 + 2 + case["iters"])
out["modules"] = sorted({m.split(".")[0] for m in sys.modules} & {"jax", "jaxlib", "flax", "detectron2_centernet_tpu"})
print(json.dumps(out))
"""


def merged_close(got, want):
    """Two TTA results matched one for one by class, score (within
    TTA_SCORE_TOL) and box (TTA_BOX_TOL px). Where the two sides' rounding
    decides a near-tie apart (a heatmap peak or a variant's cut at its top
    K, an IoU at the merge's NMS threshold), a detection stays unpaired on
    each side: at most TTA_MAX_TIES a side may (``tools/tta_check.py``
    traces them; a wrong K1 leaves nearly all unpaired). Returns
    {"detections", "paired", "unpaired" (each side's), "lone" (the unpaired
    detections' (side, rank, class, score)), the largest "score" and
    "box_px" differences of the pairs, "ok"}."""
    g, w = got["instances"], want["instances"]
    left, worst, paired, lone = list(range(len(w))), [0.0, 0.0], 0, []
    for i in range(len(g)):
        match = next((j for j in left if w.pred_classes[j] == g.pred_classes[i]
                      and abs(w.scores[j] - g.scores[i]) <= TTA_SCORE_TOL
                      and np.abs(w.pred_boxes.tensor[j] - g.pred_boxes.tensor[i]).max() <= TTA_BOX_TOL), None)
        if match is None:
            lone.append(("got", i, int(g.pred_classes[i]), float(g.scores[i])))
            continue
        paired += 1
        worst = [max(worst[0], abs(float(w.scores[match] - g.scores[i]))),
                 max(worst[1], float(np.abs(w.pred_boxes.tensor[match] - g.pred_boxes.tensor[i]).max()))]
        left.remove(match)
    lone += [("want", j, int(w.pred_classes[j]), float(w.scores[j])) for j in left]
    unpaired = (len(g) - paired, len(w) - paired)
    return dict(detections=(len(g), len(w)), paired=paired, unpaired=unpaired, lone=lone if len(lone) <= 8 else [],
                score=worst[0], box_px=worst[1], ok=max(unpaired) <= TTA_MAX_TIES)


def phase_deploy(report, weights, calib, out_dir):
    """Phase 25: test-time augmentation, export, int8 PTQ, the analysis and
    the profiler hook on ctdet DLA-34 (and RetinaNet, Faster R-CNN), on the
    seeded ``weights`` whose BatchNorm statistics ``calib`` (2 images)
    gave. Returns the launches of every kernel it made, the exported
    programs' included."""
    from detectron2_centernet_tpu_torch.export import (custom_op_nodes, dequantize_variables, export_program,
                                                       load_exported, quantization_error, quantize_variables)
    from detectron2_centernet_tpu_torch.models.test_time_augmentation import TTAPredictor
    from detectron2_centernet_tpu_torch.utils.analysis import flop_count, parameter_count

    res, launches = {}, collections.Counter()
    rng = np.random.RandomState(25)

    def part(name, t0):
        res.setdefault("part_s", {})[name] = time.perf_counter() - t0
        print(f"  ({name}: {res['part_s'][name]:.1f} s)")

    def counted():
        torch.cuda.synchronize()
        launches.update(read_launches())
        launches["nms_fixed"] += nms_ops.greedy_nms.launches
        reset_launches()
        nms_ops.greedy_nms.launches = 0

    reset_launches()
    nms_ops.greedy_nms.launches = 0
    # 25a: TTA through DefaultTrainer.test_with_TTA with the config's own sizes and flip
    t0 = time.perf_counter()
    cfg = ctdet_cfg(DLA, "bfloat16")
    name = "tta_scenes"
    for catalog in (DatasetCatalog, MetadataCatalog):
        if name in catalog:
            catalog.remove(name)
    register_synthetic_instances(name, num_images=TTA_IMAGES, image_size=EVAL_SIZE)
    cfg.merge_from_list(["DATASETS.TEST", (name,), "OUTPUT_DIR", os.path.join(out_dir, "tta")])
    model = build_model(cfg)
    model.model.load_state_dict(weights)
    tta = TTAPredictor(cfg, model)
    variants = len(tta.sizes) * (2 if tta.flip else 1)
    print(f"== 25a. TTA: DefaultTrainer.test_with_TTA on {TTA_IMAGES} synthetic {EVAL_SIZE} scenes, sizes "
          f"{tta.sizes} (TEST.AUG.MIN_SIZES rounded up to {model.size_divisibility}), flip {tta.flip}: "
          f"{variants} variants an image, bf16")
    reset_launches()
    t1 = time.perf_counter()
    results = DefaultTrainer.test_with_TTA(cfg, model)
    torch.cuda.synchronize()
    tta_s = time.perf_counter() - t1
    k1 = dcn.modulated_deform_conv.launches
    counted()
    bbox = results["bbox"]
    if k1 != 16 * variants * TTA_IMAGES or variants != 18:
        raise SystemExit(f"TTA: expected 16 K1 launches x 18 variants x {TTA_IMAGES} images, got {k1} "
                         f"({variants} variants)")
    if not all(math.isfinite(bbox[k]) for k in BBOX_KEYS):
        raise SystemExit(f"TTA: the bbox numbers are not finite: {bbox}")
    # warm: every size has run once; two more images through the predictor alone
    scenes = [d["image"] for d in DatasetCatalog.get(name)[:2]]
    t1 = time.perf_counter()
    for image in scenes:
        tta(image)
    warm_s = (time.perf_counter() - t1) / len(scenes)
    counted()
    print(f"  K1 {k1} = 16 x {variants} x {TTA_IMAGES}; bbox AP {bbox['AP']:.4f} (AP50 {bbox['AP50']:.4f}); "
          f"{TTA_IMAGES / tta_s:.3f} img/s ({tta_s:.2f} s, the evaluation and each size's first call included); "
          f"warm {1 / warm_s:.3f} img/s ({warm_s * 1e3:.1f} ms an image, {warm_s * 1e3 / variants:.2f} ms a variant)")
    res["tta"] = dict(sizes=tta.sizes, variants=variants, images=TTA_IMAGES, k1=k1, bbox=bbox, seconds=tta_s,
                      img_s=TTA_IMAGES / tta_s, warm_img_s=1 / warm_s)
    # f32, card against CPU, at two sizes and the flip, on one image
    cfg32 = ctdet_cfg(DLA, "float32")
    img = rng.randint(0, 256, EVAL_SIZE + (3,)).astype(np.uint8)
    merged = {}
    for dev in ("cuda", "cpu"):
        c = cfg32.clone()
        c.MODEL.DEVICE = dev
        m = build_model(c)
        m.model.load_state_dict(weights)
        merged[dev] = TTAPredictor(c, m, sizes=TTA_SIZES_CPU, flip=True)(img)
    counted()
    close = merged_close(merged["cuda"], merged["cpu"])
    if not close["ok"]:
        raise SystemExit(f"TTA f32: the card's merged detections are not the CPU's within scores {TTA_SCORE_TOL} "
                         f"and boxes {TTA_BOX_TOL} px but for at most {TTA_MAX_TIES} near-ties a side: {close}")
    print(f"  f32 card against CPU, sizes {TTA_SIZES_CPU} with the flip: {close['paired']} of {close['detections']} "
          f"merged detections paired, scores within {close['score']:.3e} (limit {TTA_SCORE_TOL}), boxes within "
          f"{close['box_px']:.3e} px (limit {TTA_BOX_TOL}); unpaired {close['unpaired']} (at most {TTA_MAX_TIES} a "
          f"side) {close['lone']}")
    res["tta"]["f32_card_vs_cpu"] = close
    part("25a", t0)

    # 25b: export, then each program loaded in a fresh process that imports the port only
    t0 = time.perf_counter()
    print(f"== 25b. torch.export: ctdet DLA-34 at {EXPORT_SIZE}² (batch 1 and {EXPORT_BATCH}, bf16), "
          f"RetinaNet R50-FPN at 800² (batch {RETINA_BATCH}), and Faster R-CNN R50-FPN (batch 1)")
    retina_cfg = retinanet_cfg("bfloat16")
    retina = build_model(retina_cfg)
    retina.model.load_state_dict(retinanet_weights(retina_cfg, letterboxed(rng, "cuda", 2, (800, 800)), seed=0,
                                                   device="cuda"))
    faster = build_model(rcnn_cfg(FASTER, "bfloat16"))
    cases, spec, exported = {}, {}, {}
    for name, m, batch, size in (("ctdet_b1", model, 1, EXPORT_SIZE), ("ctdet_b16", model, EXPORT_BATCH, EXPORT_SIZE),
                                 ("retinanet_b16", retina, RETINA_BATCH, 800)):
        x = letterboxed(rng, "cuda", batch, (size, size))
        path = os.path.join(out_dir, f"{name}.pt2")
        t1 = time.perf_counter()
        program = export_program(m, batch, (size, size), path)
        export_s = time.perf_counter() - t1
        counted()  # the export's one eager call first
        eager = m.predict_fn(x)
        torch.cuda.synchronize()
        eager_launches = {"dcn_fwd": dcn.modulated_deform_conv.launches, "nms_fixed": nms_ops.greedy_nms.launches}
        counted()
        torch.save({"x": x.cpu(), **{k: v.cpu() for k, v in eager.items()}}, path + ".io")
        spec[name] = {"path": path, "io": path + ".io", "iters": 10}
        exported[name] = load_exported(program)
        cases[name] = dict(export_s=export_s, bytes=os.path.getsize(path), nodes=custom_op_nodes(program),
                           eager_launches=eager_launches, batch=batch, size=size)
        print(f"  {name}: exported in {export_s:.2f} s, {cases[name]['bytes'] / 2**20:.1f} MiB, custom ops "
              f"{cases[name]['nodes']}; eager predict_fn launches {eager_launches}")
    t1 = time.perf_counter()
    program = export_program(faster, 1, (800, 800))
    cases["faster_rcnn_b1"] = dict(export_s=time.perf_counter() - t1, nodes=custom_op_nodes(program))
    if cases["faster_rcnn_b1"]["nodes"] != {"d2ct.greedy_nms.default": 2}:
        raise SystemExit(f"faster_rcnn_b1: expected two NMS nodes (the RPN's, the box head's), got "
                         f"{cases['faster_rcnn_b1']['nodes']}")
    print(f"  faster_rcnn_b1: exported in {cases['faster_rcnn_b1']['export_s']:.2f} s, custom ops "
          f"{cases['faster_rcnn_b1']['nodes']} (not loaded or run here)")
    counted()
    spec_path = os.path.join(out_dir, "exported.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    t1 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", RUN_EXPORTED, spec_path], capture_output=True, text=True,
                          timeout=600, env=dict(os.environ, PYTHONPATH=os.getcwd()))
    if proc.returncode != 0:
        raise SystemExit(f"the exported programs did not run in a fresh process:\n{proc.stderr[-4000:]}")
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    jax_modules = loaded.pop("modules")
    if jax_modules:
        raise SystemExit(f"the fresh process that ran the exported programs imported {jax_modules}")
    print(f"  the fresh process ({time.perf_counter() - t1:.1f} s) imported none of jax, jaxlib, flax and the JAX "
          f"package")
    for name, r in loaded.items():
        c = cases[name]
        per_forward = r["launches"]
        if per_forward != c["eager_launches"] or (name.startswith("ctdet") and per_forward["dcn_fwd"] != 16) \
                or (name.startswith("retinanet") and per_forward["nms_fixed"] != 1):
            raise SystemExit(f"{name}: the loaded program launched {per_forward}, eager {c['eager_launches']}")
        if max(r["rel_err"].values()) > EXPORT_TOL:
            raise SystemExit(f"{name}: the loaded program is not eager predict_fn's within {EXPORT_TOL}: {r['rel_err']}")
        if r["total_launches"] != {k: v * r["calls"] for k, v in per_forward.items()}:
            raise SystemExit(f"{name}: the loaded program's {r['calls']} calls launched {r['total_launches']}, not "
                             f"{r['calls']} x {per_forward}")
        for k in ("dcn_fwd", "nms_fixed"):
            launches[k] += r["total_launches"][k]
        c.update(loaded=r)
        print(f"  {name} loaded in {r['load_s']:.2f} s: launches a forward {per_forward}, in its {r['calls']} calls "
              f"{r['total_launches']}, err {r['rel_err']}, {r['img_s']:.2f} img/s ({r['ms']:.3f} ms a call)")
    # ieee_f32 is in force: at PyTorch's default TF32 flags the loaded program equals eager, the program bare does not
    x = letterboxed(rng, "cuda", 1, (EXPORT_SIZE, EXPORT_SIZE))
    eager = model.predict_fn(x)
    with pytorch_default_tf32():
        wrapped = exported["ctdet_b1"](x)
        bare = exported["ctdet_b1"].program.module()(x)
    counted()
    rel = lambda a: max(((a[k].float() - eager[k].float()).abs().max() / eager[k].float().abs().max()).item()
                        for k in ("boxes", "scores"))
    control = dict(with_ieee_f32=rel(wrapped), tf32_bare=rel(bare))
    if control["with_ieee_f32"] > EXPORT_TOL or control["tf32_bare"] <= EXPORT_TOL:
        raise SystemExit(f"the TF32 control: {control} (limit {EXPORT_TOL}: the first within, the second over)")
    print(f"  at PyTorch's TF32 defaults: ExportedModel {control['with_ieee_f32']:.3e} from eager, the bare program "
          f"{control['tf32_bare']:.3e} (the TF32 control, over {EXPORT_TOL})")
    # eager against the loaded program's img/s at batch 16; ctdet's calls profiled in this process (the program
    # runs the same kernels, its host time is longer)
    for name, m in (("ctdet_b16", model), ("retinanet_b16", retina)):
        x = letterboxed(rng, "cuda", cases[name]["batch"], (cases[name]["size"],) * 2)
        eager_ms = cuda_ms(lambda: m.predict_fn(x), iters=10)
        cases[name].update(eager_img_s=x.shape[0] * 1e3 / eager_ms)
        line = f"  {name}: eager {cases[name]['eager_img_s']:.2f} img/s, loaded program " \
               f"{cases[name]['loaded']['img_s']:.2f} img/s"
        if name.startswith("ctdet"):
            prof = {k: profiled(fn, calls=2) for k, fn in (("eager", lambda: m.predict_fn(x)),
                                                             ("exported", lambda: exported[name](x)))}
            k1_host = {k: sum(e.self_cpu_time_total for e in p["events"] if e.key == "d2ct::dcn_fwd") / 2 / 16e3
                       for k, p in prof.items()}
            cases[name].update(**{f"{k}_device_ms": p["device_ms"] for k, p in prof.items()},
                               **{f"{k}_kernel_launches": p["launches"] for k, p in prof.items()},
                               **{f"{k}_k1_host_ms": v for k, v in k1_host.items()})
            line += (f"; device ms a call eager {prof['eager']['device_ms']:.3f}, exported "
                     f"{prof['exported']['device_ms']:.3f}; kernel launches a call {prof['eager']['launches']:.0f}, "
                     f"{prof['exported']['launches']:.0f}; host ms a K1 call (d2ct::dcn_fwd's self CPU) eager "
                     f"{k1_host['eager']:.3f}, exported {k1_host['exported']:.3f}")
        counted()
        print(line)
    res["export"] = dict(cases=cases, tf32_control=control)
    part("25b", t0)

    # 25c: int8 weights, served through the same kernels
    t0 = time.perf_counter()
    print("== 25c. int8 PTQ of DLA-34's conv and dense kernels (per output channel, symmetric), served on the card")
    x = letterboxed(rng, "cuda", 2, (EXPORT_SIZE, EXPORT_SIZE))
    # the model's own init, as the JAX package's bound was set (tests/test_export.py). The seeded weights'
    # offset convs and statistics make a network that int8 rounding moves by ~100%: reported only
    init = build_model(cfg)
    packed = quantize_variables(init.model)
    quantized = sum(isinstance(v, dict) for v in packed["tree"].values())
    err = quantization_error(init, x)["output_max_rel_err"]
    err_seeded = quantization_error(model, calib.cuda())["output_max_rel_err"]
    served = build_model(cfg)
    served.model.load_state_dict(dequantize_variables(packed))
    dets = served.predict_fn(x)
    counted()
    if not err < INT8_BOUND or not bool((dets["scores"] > served.score_threshold).any()):
        raise SystemExit(f"int8: quantization_error {err} (bound {INT8_BOUND}) or no detection served")
    int8_bytes = sum(v["q"].numel() + 4 * v["scale"].numel() for v in packed["tree"].values() if isinstance(v, dict))
    f32_bytes = sum(4 * v["q"].numel() for v in packed["tree"].values() if isinstance(v, dict))
    print(f"  {quantized} kernels quantized ({f32_bytes / 2**20:.1f} MiB f32 → {int8_bytes / 2**20:.1f} MiB int8); "
          f"quantization_error (the init, bf16 serving model, 2 images) {err:.4e} < {INT8_BOUND} (the seeded "
          f"weights on their 2 calibration images, reported only: {err_seeded:.4e}); served "
          f"{int((dets['scores'] > served.score_threshold).sum())} detections")
    res["int8"] = dict(kernels=quantized, output_max_rel_err=err, output_max_rel_err_seeded=err_seeded,
                       bytes_f32=f32_bytes, bytes_int8=int8_bytes)
    part("25c", t0)

    # 25d: parameters and FLOPs per image
    t0 = time.perf_counter()
    print("== 25d. utils/analysis.py: parameters and FLOPs of one image (predict_fn at batch 1, FlopCounterMode)")
    analysis = {}
    for name, m, size in (("ctdet_dla34_512", model, EXPORT_SIZE), ("retinanet_r50_fpn_800", retina, 800),
                          ("faster_rcnn_r50_fpn_800", faster, 800)):
        flops = flop_count(m.predict_fn, torch.zeros(1, 3, size, size, device="cuda"))
        analysis[name] = dict(params=parameter_count(m.model)[""], flops=flops)
        print(f"  {name}: {analysis[name]['params'] / 1e6:.3f} M parameters, {flops / 1e9:.3f} GFLOP an image")
    counted()
    res["analysis"] = analysis
    part("25d", t0)

    # 25e: TorchProfiler over two train steps
    t0 = time.perf_counter()
    print(f"== 25e. hooks.TorchProfiler over two DLA-34 train steps at batch {PROFILE_BATCH}")
    tcfg = ctdet_cfg(DLA, "bfloat16")
    tcfg.merge_from_list(["SOLVER.MAX_ITER", 2, "SOLVER.IMS_PER_BATCH", PROFILE_BATCH, "TEST.EVAL_PERIOD", 0,
                          "DATASETS.TEST", (), "TEST.EXPECTED_RESULTS", [], "OUTPUT_DIR", os.path.join(out_dir, "prof")])
    ensure_synthetic_datasets(tuple(tcfg.DATASETS.TRAIN))
    trainer = DefaultTrainer(tcfg)
    trainer.model.model.load_state_dict(weights)
    trainer.resume_or_load(resume=False)
    profiler = hooks.TorchProfiler(lambda t: True, output_dir=os.path.join(out_dir, "prof"))
    trainer.register_hooks([profiler])
    trainer.train()
    step_launches = read_launches()
    counted()
    found = {}
    for path in profiler.traces:
        with open(path) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"}
        for k, marks in TRACE_KERNELS.items():
            found.setdefault(k, 0)
            found[k] += sum(all(mark in n for mark in marks) for n in names)
    if len(profiler.traces) != 2 or not all(found.values()) or step_launches["dcn_bwd_dqdw"] != 32:
        raise SystemExit(f"the profiler's traces {profiler.traces} name {found}; launches {step_launches}")
    print(f"  2 traces ({', '.join(os.path.basename(p) for p in profiler.traces)}); kernel names found {found}; "
          f"launches {step_launches}")
    res["profiler"] = dict(traces=len(profiler.traces), kernels_named=found, launches=step_launches)
    part("25e", t0)
    res["launches"] = dict(launches)
    report["deploy"] = res
    return dict(launches)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--json", help="also write every number of the run to this file")
    parser.add_argument("--rotated-cases", help="save 23e's R1 and R2 inputs to this file (tools/rotated_ab.py)")
    args = parser.parse_args()
    global ROTATED_CASES
    ROTATED_CASES = args.rotated_cases
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False  # f32 comparisons in true f32
    torch.backends.cuda.matmul.allow_tf32 = False
    # tools/bench's 20 timed requests, halved in this script's ~15 request timings, and its 4 timed train steps
    # halved in its ~14 step timings: the whole run fits its limit
    bench.REQUESTS = 10
    bench.TRAIN_STEPS = 2
    t_start = time.perf_counter()
    report = {}

    print("== 1. environment")
    smi = bench.card()
    print(f"  {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    report["card"] = smi

    laps, last_lap = {}, [time.perf_counter()]

    def lap(name):
        """Record and print the seconds since the last lap as ``name``'s."""
        now = time.perf_counter()
        laps[name] = now - last_lap[0]
        last_lap[0] = now
        print(f"  (phase {name}: {laps[name]:.1f} s)")

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
    lap("1-2")

    max_err, phase_launches = phase_kernels_vs_plain(report)
    lap("3")
    rng = np.random.RandomState(0)
    calib = letterboxed(rng, "cpu", 2, (512, 512))
    weights = seeded_weights(ctdet_cfg(DLA, "float32"), calib, seed=0)
    predictor, batch, inference = phase_inference(report, weights)
    phase_inference_timing(report, predictor, batch)
    lap("4-4c")
    os.makedirs("output", exist_ok=True)
    scratch = tempfile.mkdtemp(prefix="chip_smoke_", dir="output")
    try:
        evaluation = phase_evaluation(report, weights, os.path.join(scratch, "eval"))
        training = phase_training(report, weights)
        train_eval = phase_train_with_eval(report, weights, os.path.join(scratch, "train_eval"))
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    lap("4d-5b")
    phase_f32_step(report, weights)
    lap("6")
    phase_configs(report)
    phase_backbones(report)
    lap("8a-8b")
    scratch = tempfile.mkdtemp(prefix="chip_smoke_", dir="output")
    try:
        train_net_launches = phase_train_net(report, os.path.join(scratch, "train_net"))
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    bench_launches = phase_bench(report)
    lap("8c-8d")
    scratch = tempfile.mkdtemp(prefix="chip_smoke_", dir="output")
    try:
        retinanet_launches, retinanet_nms, retinanet_case = phase_retinanet(report, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    lap("9")
    scratch = tempfile.mkdtemp(prefix="chip_smoke_", dir="output")
    try:
        rcnn_launches, rcnn_nms, rcnn_cases = phase_faster_rcnn(report, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    lap("10")
    dconv_rows, dconv_ms = phase_dconv_kernels(report)
    lap("16k")
    head_launches, head_nms, head_cases = {}, {}, {}
    for kind in HEADS:
        scratch = tempfile.mkdtemp(prefix="chip_smoke_", dir="output")
        try:
            head_launches[kind], head_nms[kind], cases = phase_rcnn_head(report, scratch, kind)
            head_cases.update(cases)
        finally:
            shutil.rmtree(scratch, ignore_errors=True)
        lap(kind)
    for kind in VARIANTS:
        scratch = tempfile.mkdtemp(prefix="chip_smoke_", dir="output")
        try:
            head_launches[kind], head_nms[kind], cases = phase_rcnn_variant(report, scratch, kind)
            if not kind.startswith("dconv"):  # the dconv path's NMS rows are Mask R-CNN's (11)
                head_cases.update(cases)
        finally:
            shutil.rmtree(scratch, ignore_errors=True)
        lap(kind)
    scratch = tempfile.mkdtemp(prefix="chip_smoke_", dir="output")
    try:
        head_launches["fast"], head_nms["fast"] = phase_fast_rcnn(report, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    lap("17")
    for kind, phase in (("lvis", phase_lvis), ("voc_cityscapes", phase_voc_cityscapes),
                        ("segmentation", phase_segmentation), ("slice16", phase_slice16)):
        scratch = tempfile.mkdtemp(prefix="chip_smoke_", dir="output")
        try:
            head_launches[kind], head_nms[kind], cases = phase(report, scratch)
            head_cases.update(cases)
        finally:
            shutil.rmtree(scratch, ignore_errors=True)
        lap(kind)
    for kind in ("segmentation", "slice16"):  # by path: panoptic, semantic, panoptic_dconv; DeepLab, PointRend
        head_nms.update(head_nms.pop(kind))
    scratch = tempfile.mkdtemp(prefix="chip_smoke_", dir="output")
    try:
        head_launches["rotated"], rotated_launches, rotated_checks = phase_rotated(report, scratch)
        lap("23")
        head_launches["trident"], trident_nms, cases = phase_trident(report, scratch)
        head_cases.update(cases)
        head_nms.update(trident_nms)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    lap("24")
    scratch = tempfile.mkdtemp(prefix="chip_smoke_", dir="output")
    try:
        deploy_launches = phase_deploy(report, weights, calib, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    lap("25")
    nms_rows = phase_nms_kernel(report, dict(retinanet=retinanet_case, **rcnn_cases, **head_cases))
    lap("10c")
    totals = phase_kernel_timing(report)
    lap("7")
    report["phase_s"] = laps

    kernels = []
    for name, (_, source, replaces) in KERNELS.items():
        t = totals[name]
        dconv_path = head_launches["dconv"][name] + head_launches["dconv_s3"][name] \
            + head_launches["segmentation"][name]
        main_path = inference[name] + evaluation[name] + training[name] + train_eval[name] + bench_launches[name] \
            + dconv_path + deploy_launches.get(name, 0)
        shapes = [r for r in dconv_ms if r["kernel"] == name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": main_path or phase_launches[name],
            "launches_from": "main paths (DLA-34: inference, evaluation, training, training with PreciseBN and "
            "evaluation, the bench; the dconv Mask R-CNN, both STRIDE_IN_1X1: 16a-16d; the dconv Cascade GN "
            "Panoptic FPN R101: 20ga-20gc; phase 25: TTA, the exported programs (loaded in a fresh process too), "
            "int8 serving, the FLOP counts, the profiled train steps)" if main_path else
            "autograd phase (weight or offset/mask frozen); 0 on the main paths",
            "launches_dconv_rcnn": head_launches["dconv"][name],  # phase 16, 13 per forward, 13 per train step
            "launches_dconv_stride_in_3x3_rcnn": head_launches["dconv_s3"][name],  # phase 16s
            # phase 20g, 30 per forward, 30 per train step
            "launches_panoptic_dconv_cascade_gn": head_launches["segmentation"][name],
            "launches_fast_rcnn": head_launches["fast"][name],  # phase 17, asserted 0
            "launches_lvis_rcnn": head_launches["lvis"][name],  # phase 18, asserted 0
            "launches_voc_cityscapes_rcnn": head_launches["voc_cityscapes"][name],  # phase 19, asserted 0
            # phases 21, 21v, 22, 22s (DeepLab V3+ and V3, PointRend R-CNN and semantic), asserted 0
            "launches_deeplab_pointrend": head_launches["slice16"][name],
            "launches_rotated_rcnn": head_launches["rotated"][name],  # phase 23, asserted 0
            "launches_trident_rcnn": head_launches["trident"][name],  # phase 24, asserted 0
            # phase 25: TTA (16 x 18 x 8 K1), export and the loaded programs, int8, FLOPs, the profiled steps
            "launches_deploy": deploy_launches.get(name, 0),
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
            "launches_cascade_rcnn": head_launches["cascade"][name],  # phase 13, asserted 0
            "launches_c4_rcnn": head_launches["c4"][name],  # phase 14, asserted 0
            "launches_dc5_rcnn": head_launches["dc5"][name],  # phase 15, asserted 0
            "max_abs_err": max_err[name], "ms": t["ms_b1"], "plain_ms": t["plain_ms_b1"],
            "bound_ms": t["bound_ms_b1"], "bound_by": t["bound_by_b1"], "library_ms": None,
            "per": "16 launches, the DLA-34 shapes at batch 1, bf16"
            + (" (K1: with the eval epilogue at batches 1 and 16, without at 32)" if name == "dcn_fwd" else ""),
            **{f"ms_b{b}": t[f"ms_b{b}"] for b in t["big_batches"]},
            **{f"bound_ms_b{b}": t[f"bound_ms_b{b}"] for b in t["big_batches"]},
            **({"ms_by_regime": t["regimes"]} if "regimes" in t else {}),
            # the deformable trunk's shapes at batch 16, bf16, unmodulated (16k)
            **({"ms_dconv": {r["where"]: r["ms"] for r in shapes},
                "plain_ms_dconv": {r["where"]: r["plain_ms"] for r in shapes},
                "bound_ms_dconv": {r["where"]: r["bound_ms"] for r in shapes},
                "max_abs_err_dconv": max(r["max_abs_err"] for r in dconv_rows if r["kernel"] == name
                                         and r["dtype"] == "bfloat16")} if shapes else {}),
        })
    main_rpn = nms_rows["rpn_test"]
    kernels.append({
        "name": "nms_fixed", "route": "cuda", "source": CSRC + "nms.cu",
        "replaces": "detectron2_centernet_tpu/ops/nms.py:51",
        "launches": sum(retinanet_nms.values()) + sum(rcnn_nms.values())
        + sum(sum(v.values()) for v in head_nms.values()) + deploy_launches["nms_fixed"],
        "launches_from": "RetinaNet (phase 9: requests and batch 16, the bench, train_net), Faster R-CNN "
        "(phase 10: requests and batch 16, the training's proposals, the bench, train_net, the ProposalNetwork), "
        "Mask R-CNN and Keypoint R-CNN (phases 11 and 12: requests and batch 16, the training's proposals, the "
        "bench, train_net), Cascade Mask R-CNN, Mask R-CNN C4 with the C4 ProposalNetwork, Faster R-CNN DC5 "
        "and the dconv Mask R-CNN (phases 13-16: the same), Fast R-CNN (phase 17: the ProposalNetwork writing its "
        "proposal files, predict_fn, train_net's evaluations), LVIS Mask R-CNN (phase 18: requests, batch 1 and 16, "
        "the training's proposals, the bench's train steps, LVISEvaluator), Faster R-CNN on VOC and Mask R-CNN on "
        "Cityscapes (phase 19: their evaluations), Panoptic FPN R50 and the dconv Cascade GN Panoptic FPN R101 "
        "(phase 20: requests, batch 1 and 16, the training's proposals, the bench, train_net; none on Semantic FPN), "
        "PointRend R-CNN (phase 22: requests, batch 1 and 16, the training's proposals, its train steps, train_net; "
        "none on DeepLab or PointRend's semantic FPN), TridentNet Fast and full (phase 24: requests, batch 1 and 16, "
        "full mode's branch merge, the bench's train steps, train_net; none on the rotated R-CNN, whose NMS is "
        "nms_rotated's), and phase 25 (RetinaNet's and Faster R-CNN's exports, RetinaNet's programs loaded in a "
        "fresh process and in this one, the FLOP counts)",
        "launches_retinanet": retinanet_nms, "launches_faster_rcnn": rcnn_nms,
        "launches_mask_rcnn": head_nms["mask"], "launches_keypoint_rcnn": head_nms["keypoint"],
        "launches_cascade_rcnn": head_nms["cascade"], "launches_c4_rcnn": head_nms["c4"],
        "launches_dc5_rcnn": head_nms["dc5"], "launches_dconv_rcnn": head_nms["dconv"],
        "launches_dconv_stride_in_3x3_rcnn": head_nms["dconv_s3"], "launches_fast_rcnn": head_nms["fast"],
        "launches_lvis_rcnn": head_nms["lvis"], "launches_voc_cityscapes_rcnn": head_nms["voc_cityscapes"],
        "launches_panoptic_fpn": head_nms["panoptic"], "launches_semantic_fpn": head_nms["semantic"],
        "launches_panoptic_dconv_cascade_gn": head_nms["panoptic_dconv"],
        "launches_pointrend_rcnn": head_nms["pointrend_rcnn"],
        "launches_trident_fast_rcnn": head_nms["trident_fast"], "launches_trident_full_rcnn": head_nms["trident_full"],
        "launches_deploy": deploy_launches["nms_fixed"],
        "max_abs_err": 0.0 if all(r["equal"] for r in nms_rows.values()) else None,
        "ms": main_rpn["ms"], "plain_ms": main_rpn["plain_ms"], "bound_ms": main_rpn["bound_ms"],
        "bound_by": main_rpn["bound_by"], "library_ms": None,
        "per": f"one greedy_nms call for the RPN's {main_rpn['rows']} level rows of a batch-16 800² test forward; "
        "launches counts greedy_nms calls, each a pipeline of the 8 kernels of nms.cu (9-26 launches for a first "
        "round, up to 25 more that the card makes for each later one); indices and validity compared exactly, "
        "max_abs_err 0 means equal",
        **{f"{k}_{name}": r[k] for name, r in nms_rows.items()
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "old_bound_ms", "most_live_in_a_row", "rounds")},
    })
    rr = rotated_checks
    kernels.append({
        "name": "iou_rotated", "route": "cuda", "source": CSRC + "iou_rotated.cu",
        "replaces": "detectron2_centernet_tpu/ops/roi_align_rotated.py:140", "launches": rotated_launches["iou_rotated"],
        "launches_from": "the rotated Faster R-CNN (phase 23: the train steps' RRPN matching and proposal sampling; "
        "none in serving); none on any other path",
        "max_abs_err": max(rr[k]["max_abs_err"] for k in ("rrpn_matching", "proposal_sampling")),
        "ms": rr["rrpn_matching"]["ms"], "plain_ms": rr["rrpn_matching"]["plain_ms"],
        "bound_ms": rr["rrpn_matching"]["bound_ms"], "bound_by": rr["rrpn_matching"]["bound_by"], "library_ms": None,
        "per": "one call of a train step's RRPN matching: "
        f"{rr['rrpn_matching']['shape'][0]} gts x {rr['rrpn_matching']['shape'][1][0]} anchors",
        **{f"{k}_proposal_sampling": rr["proposal_sampling"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
    })
    head = rr["rpn_test_rotated"]
    kernels.append({
        "name": "nms_rotated", "route": "cuda", "source": CSRC + "nms.cu",
        "replaces": "detectron2_centernet_tpu/ops/roi_align_rotated.py:148", "launches": rotated_launches["nms_rotated"],
        "launches_from": "the rotated Faster R-CNN (phase 23: requests and batch 1 and 16, the RRPN's rows and the "
        "class-aware box-head rows, the training's proposals, the evaluation); none on any other path",
        "max_abs_err": 0.0 if all(r["equal"] for n, r in rr.items() if "ties" in r) else None,
        "ties": {n: r["ties"]["ties"] for n, r in rr.items() if "ties" in r},
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,
        "per": f"one nms_rotated call on {head['rows']} of the {head['all_rows']} RRPN level rows of a batch-16 800² "
        f"test forward ({head['candidates']} candidates, 1000 picks); kernel on all {head['all_rows']} rows "
        f"{head['ms_all_rows']:.3f} ms; indices and validity compared, max_abs_err 0 means equal",
        **{f"{k}_{n}": r[k] for n, r in rr.items() if "ties" in r
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "ms_all_rows", "rounds")},
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
