"""GeneralizedRCNN and ProposalNetwork, counterpart of the JAX package's
``models/meta_arch/rcnn.py`` (its ``standard`` ROI-head branch; reference
``modeling/meta_arch/rcnn.py``).

``RCNNModel`` is the network, NCHW: the ResNet-FPN backbone, the RPN head
(``proposal_generator.rpn_head``) and, for GeneralizedRCNN, the box head and
predictor (``roi_heads.box_head``, ``roi_heads.box_predictor``), under the
reference's module names. ``GeneralizedRCNN`` owns it on
``cfg.MODEL.DEVICE`` with the normalization, the anchors (numpy, moved to
the device once per input size), the training loss (``loss_fn``: RPN
matching and sampling over every anchor, the fixed-size proposals, ROI
sampling with the gt boxes appended, multi-level ROIAlign, the Fast R-CNN
losses), the fixed-size inference (``predict_fn``: proposals, ROIAlign, the
per-class decode and one class-aware fixed-K NMS) and the host boundary
(``postprocess``, RetinaNet's: boxes only).

The RPN head's NCHW outputs are permuted to (N, H, W, A·k) before any
flatten (``retinanet.nhwc_flat``), so anchors run in ``grid_anchors``'
(H·W, A) order as in the JAX package's NHWC.

Random draws: the RPN and ROI samplers draw uniforms, as the JAX package
draws them from ``batch["rng"]``. Here they come from ``batch["draws"]``
when given ({"rpn": (N, R), "roi_sub": (N, P'), "roi_tie": (N, P')}, as the
tests hand in JAX's own), else from ``batch["generator"]`` (the step's
``torch.Generator`` on the model's device, which ``SimpleTrainer`` seeds per
step), in that order: rpn, roi_sub, roi_tie. A batch with neither
raises.

Not ported (each raises naming its ROADMAP item): the mask and keypoint
heads, Cascade, Res5/C4 and DC5, PointRend, DensePose and other ROI-head
extensions, precomputed proposals, and rotated proposals.
"""

import logging
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from ...config import CfgNode
from ...ops.roi_align import multilevel_roi_align
from ..anchors import build_anchor_generator
from ..box_regression import Box2BoxTransform
from ..build import resolve_device
from ..layers import ieee_f32, init_weights
from ..matcher import Matcher
from ..proposal_generator.rpn import StandardRPNHead, find_top_rpn_proposals, rpn_losses
from ..registry import BACKBONE_REGISTRY, META_ARCH_REGISTRY
from ..roi_heads.box_head import FastRCNNConvFCHead, FastRCNNOutputLayers
from ..roi_heads.roi_heads import fast_rcnn_inference, fast_rcnn_losses, label_and_sample_proposals
from . import retinanet
from .retinanet import RetinaNet, nhwc_flat

__all__ = ["GeneralizedRCNN", "ProposalNetwork", "RCNNModel"]

logger = logging.getLogger(__name__)

STRIDES = {**retinanet.STRIDES, "res2": 4, "res3": 8, "res4": 16, "res5": 32}
# ROI_HEADS.NAME -> the ROADMAP item that ports it
QUEUED_ROI_HEADS = {"CascadeROIHeads": "A14", "Res5ROIHeads": "A14", "PointRendROIHeads": "A15",
                    "DensePoseROIHeads": "A18", "RROIHeads": "A16"}


class RPN(nn.Module):
    """Holds the RPN head under the reference's ``proposal_generator``."""

    def __init__(self, rpn_head: StandardRPNHead):
        super().__init__()
        self.rpn_head = rpn_head


class StandardROIHeads(nn.Module):
    """Holds the box head and predictor under the reference's ``roi_heads``."""

    def __init__(self, box_head: FastRCNNConvFCHead, box_predictor: FastRCNNOutputLayers):
        super().__init__()
        self.box_head = box_head
        self.box_predictor = box_predictor


class RCNNModel(nn.Module):
    """backbone (FPN) → RPN head on ``rpn_in_features``; the box head on
    pooled rois. Parameters stay f32; convolutions and the box head's fc
    layers run at ``dtype`` under autocast, every f32 convolution on the
    card in IEEE f32 (``ieee_f32``); the RPN's 1x1 predictors and the box
    predictor in f32."""

    def __init__(self, backbone: nn.Module, rpn_in_features: Tuple[str, ...], rpn_head: StandardRPNHead,
                 roi_heads: Optional[StandardROIHeads] = None):
        super().__init__()
        self.dtype = torch.float32
        self.backbone = backbone
        self.rpn_in_features = tuple(rpn_in_features)
        self.proposal_generator = RPN(rpn_head)
        if roi_heads is not None:
            self.roi_heads = roi_heads

    def cast(self, dtype: torch.dtype) -> "RCNNModel":
        """Compute width of everything but the f32 predictors."""
        self.dtype = dtype
        return self

    def _autocast(self, device: torch.device):
        return torch.autocast(device.type, dtype=self.dtype, enabled=self.dtype != torch.float32)

    def forward(self, images: torch.Tensor):
        """Normalized (N, 3, H, W) → (the FPN's {level: map}, per RPN level
        the f32 (N, A, H, W) logits and (N, A·4, H, W) deltas)."""
        with ieee_f32(), self._autocast(images.device):
            feats = self.backbone(images.to(self.dtype))
            logits, deltas = self.proposal_generator.rpn_head([feats[f] for f in self.rpn_in_features])
        return feats, logits, deltas

    def box_predict(self, pooled: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pooled (R, C, P, P) f32 → f32 (scores (R, C+1), deltas (R, 4C))."""
        with ieee_f32(), self._autocast(pooled.device):
            return self.roi_heads.box_predictor(self.roi_heads.box_head(pooled))


def _check_supported(cfg: CfgNode, with_roi_heads: bool) -> None:
    m = cfg.MODEL
    queued = []
    if m.MASK_ON:
        queued.append("MODEL.MASK_ON: the mask head (ROADMAP A14)")
    if m.KEYPOINT_ON:
        queued.append("MODEL.KEYPOINT_ON: the keypoint head (ROADMAP A14)")
    if m.LOAD_PROPOSALS or m.PROPOSAL_GENERATOR.NAME == "PrecomputedProposals":
        queued.append("MODEL.LOAD_PROPOSALS / PrecomputedProposals: precomputed proposals (ROADMAP A14)")
    elif m.PROPOSAL_GENERATOR.NAME != "RPN" or m.RPN.HEAD_NAME != "StandardRPNHead":
        queued.append(f"PROPOSAL_GENERATOR {m.PROPOSAL_GENERATOR.NAME} / RPN.HEAD_NAME {m.RPN.HEAD_NAME}: "
                      "rotated proposals (ROADMAP A16)")
    if m.RESNETS.RES5_DILATION != 1:
        queued.append("MODEL.RESNETS.RES5_DILATION: the DC5 trunk (ROADMAP A14)")
    if with_roi_heads:
        name = m.ROI_HEADS.NAME
        if name != "StandardROIHeads":
            queued.append(f"ROI_HEADS.NAME {name} (ROADMAP {QUEUED_ROI_HEADS.get(name, 'A14')})")
        if list(m.ROI_HEADS.EXTENSIONS):
            queued.append(f"ROI_HEADS.EXTENSIONS {list(m.ROI_HEADS.EXTENSIONS)}: ROI-head extensions "
                          "(ROADMAP A18)")
    if queued:
        raise NotImplementedError("not ported yet: " + "; ".join(queued))


@META_ARCH_REGISTRY.register()
class GeneralizedRCNN:
    """Faster R-CNN: the network on its device, the normalization, the
    anchors, the loss, the fixed-size inference and the host boundary."""

    with_roi_heads = True

    def __init__(self, cfg: CfgNode) -> None:
        _check_supported(cfg, self.with_roi_heads)
        self.device = resolve_device(cfg.MODEL.DEVICE)
        self.device_augment = None  # the step's batch augmentation; models/build.py attaches it
        self.dtype = torch.bfloat16 if cfg.TPU.DTYPE == "bfloat16" else torch.float32
        self.pixel_mean = torch.tensor(cfg.MODEL.PIXEL_MEAN, dtype=torch.float32,
                                       device=self.device).view(1, -1, 1, 1)
        self.pixel_std = torch.tensor(cfg.MODEL.PIXEL_STD, dtype=torch.float32,
                                      device=self.device).view(1, -1, 1, 1)
        backbone = BACKBONE_REGISTRY.get(cfg.MODEL.BACKBONE.NAME)(cfg)

        r = cfg.MODEL.RPN
        self.rpn_in_features = tuple(r.IN_FEATURES)
        self.strides = [STRIDES[f] for f in self.rpn_in_features]  # anchors_per_level reads them
        self.anchor_generator = build_anchor_generator(cfg, self.strides)
        num_anchors = self.anchor_generator.num_anchors[0]
        if any(a != num_anchors for a in self.anchor_generator.num_anchors):
            raise ValueError("the RPN's shared head needs the same number of anchors on every level")
        self.rpn_matcher = Matcher(list(r.IOU_THRESHOLDS), list(r.IOU_LABELS), allow_low_quality_matches=True)
        self.rpn_box2box = Box2BoxTransform(tuple(r.BBOX_REG_WEIGHTS))
        self.rpn_batch_size = int(r.BATCH_SIZE_PER_IMAGE)
        self.rpn_positive_fraction = float(r.POSITIVE_FRACTION)
        self.rpn_nms_thresh = float(r.NMS_THRESH)
        self.rpn_smooth_l1_beta = float(r.SMOOTH_L1_BETA)
        self.rpn_loss_weight = float(r.LOSS_WEIGHT)
        self.pre_nms_topk = {"train": int(r.PRE_NMS_TOPK_TRAIN), "test": int(r.PRE_NMS_TOPK_TEST)}
        self.post_nms_topk = {"train": int(r.POST_NMS_TOPK_TRAIN), "test": int(r.POST_NMS_TOPK_TEST)}
        self._anchors: Dict[Tuple[int, int], List[torch.Tensor]] = {}

        rh, bh = cfg.MODEL.ROI_HEADS, cfg.MODEL.ROI_BOX_HEAD
        self.num_classes = int(rh.NUM_CLASSES)
        self.roi_in_features = tuple(rh.IN_FEATURES)
        self.roi_strides = [STRIDES[f] for f in self.roi_in_features]
        self.roi_matcher = Matcher(list(rh.IOU_THRESHOLDS), list(rh.IOU_LABELS), allow_low_quality_matches=False)
        self.roi_batch_size = int(rh.BATCH_SIZE_PER_IMAGE)
        self.roi_positive_fraction = float(rh.POSITIVE_FRACTION)
        self.score_threshold = float(rh.SCORE_THRESH_TEST)
        self.nms_threshold = float(rh.NMS_THRESH_TEST)
        self.max_detections = int(cfg.TEST.DETECTIONS_PER_IMAGE)
        self.proposal_append_gt = bool(rh.PROPOSAL_APPEND_GT)
        self.box2box = Box2BoxTransform(tuple(bh.BBOX_REG_WEIGHTS))
        self.smooth_l1_beta = float(bh.SMOOTH_L1_BETA)
        self.pooler_resolution = int(bh.POOLER_RESOLUTION)
        # the reference's SAMPLING_RATIO 0 picks ceil(roi / bin) samples per
        # bin, a count per roi; the JAX package fixes it at 2, and so does the port
        self.pooler_sampling_ratio = int(bh.POOLER_SAMPLING_RATIO)
        if self.pooler_sampling_ratio == 0:
            logger.warning("ROI_BOX_HEAD.POOLER_SAMPLING_RATIO=0 (adaptive) is approximated with a fixed 2x2 "
                           "sample grid, as in the JAX package.")
            self.pooler_sampling_ratio = 2

        channels = backbone.out_channels
        rpn_head = StandardRPNHead(channels, num_anchors)
        roi_heads = None
        if self.with_roi_heads:
            num_conv, num_fc = int(bh.NUM_CONV), int(bh.NUM_FC)
            if num_conv == 0 and num_fc == 0:
                logger.warning("ROI_BOX_HEAD.NUM_CONV and NUM_FC are both 0; defaulting to the standard 2-fc "
                               "head (set either explicitly to silence).")
                num_fc = 2
            box_head = FastRCNNConvFCHead(channels, self.pooler_resolution, num_conv, int(bh.CONV_DIM), num_fc,
                                          int(bh.FC_DIM))
            roi_heads = StandardROIHeads(box_head, FastRCNNOutputLayers(box_head.out_dim, self.num_classes,
                                                                        bool(bh.CLS_AGNOSTIC_BBOX_REG)))
        self.model = RCNNModel(backbone, self.rpn_in_features, rpn_head, roi_heads)
        generator = torch.Generator().manual_seed(max(int(cfg.SEED), 0))
        init_weights(self.model, generator)
        rpn_head.init_parameters(generator)
        if roi_heads is not None:
            roi_heads.box_predictor.init_parameters(generator)
        self.model.to(self.device).cast(self.dtype).eval()

    def normalize(self, images: torch.Tensor) -> torch.Tensor:
        """(x - PIXEL_MEAN) / PIXEL_STD on 0..255 pixels."""
        return (images.to(self.device, torch.float32) - self.pixel_mean) / self.pixel_std

    anchors_per_level = RetinaNet.anchors_per_level
    postprocess = RetinaNet.postprocess

    def _flatten_rpn(self, logits, deltas):
        """Per level (N, H·W·A) logits and (N, H·W·A, 4) deltas."""
        return [nhwc_flat(t, 1)[..., 0] for t in logits], [nhwc_flat(t, 4) for t in deltas]

    def proposals(self, logits, deltas, image_hw: Tuple[int, int], mode: str):
        """``find_top_rpn_proposals`` of the RPN outputs at ``mode``'s top-ks."""
        lg, dl = self._flatten_rpn(logits, deltas)
        return find_top_rpn_proposals(lg, dl, self.anchors_per_level(image_hw), image_hw, self.rpn_box2box,
                                      nms_thresh=self.rpn_nms_thresh, pre_nms_topk=self.pre_nms_topk[mode],
                                      post_nms_topk=self.post_nms_topk[mode])

    def pool(self, feats: Dict[str, torch.Tensor], boxes: torch.Tensor, per_image: int) -> torch.Tensor:
        """(N·per_image, 4) boxes, image-major → pooled (R, C, P, P) f32."""
        batch_idx = torch.arange(boxes.shape[0] // per_image, device=boxes.device).repeat_interleave(per_image)
        return multilevel_roi_align([feats[f] for f in self.roi_in_features], self.roi_strides, boxes, batch_idx,
                                    self.pooler_resolution, self.pooler_sampling_ratio)

    def _uniform(self, batch: Dict, generator: torch.Generator, name: str, shape) -> torch.Tensor:
        draws = batch.get("draws")
        if draws is not None:
            return draws[name].to(self.device, torch.float32)
        return torch.rand(shape, generator=generator, device=self.device)

    def _generator(self, batch: Dict) -> Optional[torch.Generator]:
        """The step's generator (None when the batch carries its draws)."""
        generator = batch.get("generator")
        if generator is None and batch.get("draws") is None:
            raise ValueError("an R-CNN training batch needs its samplers' uniforms: give batch['draws'] or "
                             "batch['generator'] (SimpleTrainer seeds one per step)")
        return generator

    def _rpn_losses(self, batch, generator, logits, deltas, image_hw):
        anchors = torch.cat(self.anchors_per_level(image_hw))
        lg, dl = self._flatten_rpn(logits, deltas)
        lg, dl = torch.cat(lg, 1), torch.cat(dl, 1)
        return rpn_losses(anchors, lg, dl, batch["gt_boxes"].to(self.device, torch.float32),
                          batch["gt_valid"].to(self.device), self._uniform(batch, generator, "rpn", lg.shape),
                          self.rpn_matcher, self.rpn_box2box, self.rpn_batch_size, self.rpn_positive_fraction,
                          self.rpn_smooth_l1_beta)

    # -- training ------------------------------------------------------------------
    def loss_fn(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total, {"loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg"})
        of one train batch on the device: ``image`` (N, 3, H, W) 0..255,
        ``gt_boxes`` (N, M, 4) XYXY in input pixels, ``gt_classes`` (N, M),
        ``gt_valid`` (N, M), and the draws' source (module docstring)."""
        images = self.normalize(batch["image"])
        n, _, h, w = images.shape
        feats, logits, deltas = self.model(images)
        generator = self._generator(batch)
        losses = {k: v * self.rpn_loss_weight
                  for k, v in self._rpn_losses(batch, generator, logits, deltas, (h, w)).items()}
        with torch.no_grad():
            prop_boxes, _, prop_valid = self.proposals([t.detach() for t in logits], [t.detach() for t in deltas],
                                                       (h, w), "train")
        gt_boxes = batch["gt_boxes"].to(self.device, torch.float32)
        gt_valid = batch["gt_valid"].to(self.device)
        slots = max(prop_boxes.shape[1] + (gt_boxes.shape[1] if self.proposal_append_gt else 0),
                    self.roi_batch_size)
        rand_sub = self._uniform(batch, generator, "roi_sub", (n, slots))
        rand_tie = self._uniform(batch, generator, "roi_tie", (n, slots))
        sampled = label_and_sample_proposals(
            prop_boxes, prop_valid, gt_boxes, batch["gt_classes"].to(self.device), gt_valid, rand_sub, rand_tie,
            self.roi_matcher, self.roi_batch_size, self.roi_positive_fraction, self.num_classes,
            self.proposal_append_gt)
        s = sampled["boxes"].shape[1]
        flat = {k: v.reshape(n * s, *v.shape[2:]) for k, v in sampled.items()}
        scores, box_deltas = self.model.box_predict(self.pool(feats, flat["boxes"], s))
        losses.update(fast_rcnn_losses(scores, box_deltas, flat, self.box2box, self.num_classes,
                                       self.smooth_l1_beta))
        return sum(losses.values()), losses

    # -- inference -----------------------------------------------------------------
    @torch.inference_mode()
    def predict_fn(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Raw (N, 3, H, W) 0..255 images → fixed-size detections on the
        device: boxes (N, K, 4), scores (N, K) (0 in an invalid slot),
        classes (N, K)."""
        x = self.normalize(images)
        n, _, h, w = x.shape
        feats, logits, deltas = self.model(x)
        boxes, _, valid = self.proposals(logits, deltas, (h, w), "test")
        p = boxes.shape[1]
        scores, box_deltas = self.model.box_predict(self.pool(feats, boxes.reshape(n * p, 4), p))
        return fast_rcnn_inference(boxes, valid, scores.view(n, p, -1), box_deltas.view(n, p, -1), self.box2box,
                                   self.num_classes, (h, w), self.score_threshold, self.nms_threshold,
                                   self.max_detections)


@META_ARCH_REGISTRY.register()
class ProposalNetwork(GeneralizedRCNN):
    """The RPN alone (reference rcnn.py:261-321): ``predict_fn`` returns the
    proposals as class-0 detections with their sigmoid scores; the loss is
    the RPN's (without ``RPN.LOSS_WEIGHT``, as the JAX package's). The
    network has no ROI heads, as the reference's."""

    with_roi_heads = False

    def loss_fn(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        images = self.normalize(batch["image"])
        _, logits, deltas = self.model(images)
        losses = self._rpn_losses(batch, self._generator(batch), logits, deltas, images.shape[2:])
        return sum(losses.values()), losses

    @torch.inference_mode()
    def predict_fn(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.normalize(images)
        _, logits, deltas = self.model(x)
        boxes, scores, valid = self.proposals(logits, deltas, x.shape[2:], "test")
        return {"boxes": boxes, "scores": torch.where(valid, torch.sigmoid(scores), 0.0),
                "classes": torch.zeros(scores.shape, dtype=torch.int64, device=scores.device)}
