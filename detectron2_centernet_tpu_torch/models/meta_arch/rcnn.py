"""GeneralizedRCNN and ProposalNetwork, counterpart of the JAX package's
``models/meta_arch/rcnn.py`` (its ``standard``, ``cascade`` and ``res5``
ROI-head branches; reference ``modeling/meta_arch/rcnn.py``,
``roi_heads/roi_heads.py`` and ``roi_heads/cascade_rcnn.py``).

``RCNNModel`` is the network, NCHW: the backbone (ResNet-FPN, or the plain
ResNet trunk of C4 and DC5), the RPN head (``proposal_generator.rpn_head``)
and, for GeneralizedRCNN, the ROI heads under the reference's module names
(``roi_heads``): ``StandardROIHeads``' box head and predictor
(``box_head``, ``box_predictor``); ``CascadeROIHeads``' one class-agnostic
head and predictor per stage (``box_head.{t}``, ``box_predictor.{t}``);
``Res5ROIHeads``' res5 stage on 14² rois (``res5.{b}``, the trunk stopping
at res4) feeding the predictor through a global average; and, with
``MODEL.MASK_ON`` / ``MODEL.KEYPOINT_ON``, the mask head
(``roi_heads.mask_head``) and the keypoint head (``roi_heads.keypoint_head``).
``GeneralizedRCNN`` owns it on ``cfg.MODEL.DEVICE`` with the normalization,
the anchors (numpy, moved to the device once per input size, at the strides
the backbone reports: DC5's res5 is at 16, ROADMAP C20), the training loss
(``loss_fn``: RPN matching and sampling over every anchor, the fixed-size
proposals, ROI sampling with the gt boxes appended, ROIAlign, the Fast
R-CNN losses, per stage for Cascade; the mask loss on each foreground
roi's gt-class logits alone and the keypoint loss), the fixed-size inference (``predict_fn``: proposals,
ROIAlign, the box head (every Cascade stage, their softmaxes averaged), the
per-class decode and one class-aware fixed-K NMS; then the mask logits of
each detection's class alone (``mask_head``'s ``classes``; JAX computes all
classes' and gathers, the same values) and the keypoint heatmaps, pooled on
the detections' boxes) and the host boundary (``postprocess``: the detections above the
threshold in the original image, their masks pasted there and their
keypoints decoded, both on the model's device).

Cascade (JAX ``:572-611``, ``:774-797``): stage t > 0 takes the previous
stage's refined boxes, detached and clipped to the image, an empty box
weighing 0, relabelled against the gt at the stage's IoU
(``cascade_relabel``); each stage's pooled features pass through
``scale_gradient(1 / stages)``, so the summed stage losses send the
features the gradient of their mean. At inference the last stage's boxes
go unclipped to ``fast_rcnn_inference`` with zero deltas and the log of the
stages' mean softmax as scores.

The mask and keypoint losses: the JAX package runs both heads on all N·S
sampled rois (stage 0's for Cascade) and weights each by whether it is
foreground. The sampler puts its positives first and takes at most
``int(S · POSITIVE_FRACTION)`` of them (``rpn.py::subsample_labels``), so
every foreground roi lies in the first ``int(S · POSITIVE_FRACTION)`` slots
of its image: the port runs the heads on that fixed block only (128 of 512
rois per image at the configs' defaults), with no host sync; for C4 the
mask head takes that block of the res5 output the box predictor read. The
rois it leaves out weigh 0 in JAX's losses, so the losses and every
gradient are JAX's (``tests/test_torch_mask.py``,
``tests/test_torch_keypoint.py``, ``tests/test_torch_cascade.py``,
``tests/test_torch_c4.py``).

The RPN head's NCHW outputs are permuted to (N, H, W, A·k) before any
flatten (``retinanet.nhwc_flat``), so anchors run in ``grid_anchors``'
(H·W, A) order as in the JAX package's NHWC.

Random draws: the RPN and ROI samplers draw uniforms, as the JAX package
draws them from ``batch["rng"]``. Here they come from ``batch["draws"]``
when given ({"rpn": (N, R), "roi_sub": (N, P'), "roi_tie": (N, P')} and for
PointRend "point_cand" (N·S, k·P, 2) and "point_rand" (N·S, P - int(β·P),
2), every sampled roi's, as the tests hand in JAX's own), else from
``batch["generator"]`` (the step's ``torch.Generator`` on the model's
device, which ``SimpleTrainer`` seeds per step), in that order: rpn,
roi_sub, roi_tie, point_cand, point_rand (the foreground block's rois
only). A batch with neither raises.

Fast R-CNN (``MODEL.LOAD_PROPOSALS``, or ``PROPOSAL_GENERATOR.NAME``
``PrecomputedProposals``; JAX ``:534-541``, ``:752-770``): the proposals come
with the batch (``proposal_boxes`` (N, K, 4) in input pixels and
``proposal_valid`` (N, K), the mapper's top K of a proposal file), with no
RPN loss; ``predict_fn`` takes them as arguments and raises without them.
The RPN head stays in the model and the optimizer, as in the JAX package,
where it runs and gets a zero gradient: here its forward is skipped, and
``SimpleTrainer`` starts every gradient at 0, so weight decay and momentum
move it as under optax.

PointRend (JAX ``:184-205``, ``:333``, ``:361-371``, ``:661-701``,
``:838-853``): with ``MODEL.MASK_ON`` and ``ROI_HEADS.NAME``
``PointRendROIHeads`` (standard ROI heads), ``ROI_MASK_HEAD.POINT_HEAD_ON``
or ``ROI_MASK_HEAD.NAME`` ``PointRendMaskHead``, a class-agnostic
``PointHead`` (``roi_heads.mask_point_head``: one output, one coarse
channel) refines the mask head's logits (``CoarseMaskHead`` when
``ROI_MASK_HEAD.NAME`` names it, else the conv head). Its fine features are
the rois pooled over ``ROI_HEADS.IN_FEATURES`` at twice
``ROI_MASK_HEAD.POOLER_RESOLUTION``, as JAX's ``_pool`` does (the reference
reads p2 alone). Training (``loss_mask_point``): per foreground-block roi,
``sample_uncertain_points`` on its gt class's logits from its uniforms, the
point head at those points against the gt crop sampled there (> 0.5), the
mean BCE per roi over the foreground rois. Inference: ``refine_mask_with_
points`` from the detection's class logits (7² → 224² in the COCO config's 5
steps), whose sigmoid is ``masks``.

Not ported (each raises naming its ROADMAP item): DensePose and other
ROI-head extensions, rotated proposals, and any other ``ROI_HEADS.NAME`` or
``ROI_MASK_HEAD.NAME`` (the JAX package builds Res5ROIHeads and the conv
mask head for a name it does not know; the port raises).
"""

import logging
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from ...config import CfgNode
from ...ops.roi_align import multilevel_roi_align
from ...ops.nms import pairwise_iou_xyxy
from ..anchors import build_anchor_generator
from ..backbones.resnet import RESNET_SPECS, BottleneckBlock
from ..box_regression import Box2BoxTransform
from ..build import resolve_device
from ..layers import ieee_f32, init_weights
from ..matcher import Matcher
from ..proposal_generator.rpn import StandardRPNHead, find_top_rpn_proposals, rpn_losses
from ..registry import BACKBONE_REGISTRY, META_ARCH_REGISTRY
from ..roi_heads.box_head import FastRCNNConvFCHead, FastRCNNOutputLayers
from ..roi_heads.keypoint_head import KRCNNConvDeconvUpsampleHead, encode_keypoint_targets, keypoint_rcnn_loss
from ..roi_heads.mask_head import CoarseMaskHead, MaskRCNNConvUpsampleHead, crop_gt_masks, mask_rcnn_loss
from ..roi_heads.point_head import PointHead, point_sample, refine_mask_with_points, sample_uncertain_points
from ..roi_heads.roi_heads import fast_rcnn_inference, fast_rcnn_losses, label_and_sample_proposals
from .retinanet import RetinaNet, nhwc_flat

__all__ = ["GeneralizedRCNN", "ProposalNetwork", "RCNNModel", "cascade_relabel", "clip_boxes", "scale_gradient"]

logger = logging.getLogger(__name__)

ROI_TYPES = {"StandardROIHeads": "standard", "PointRendROIHeads": "standard", "CascadeROIHeads": "cascade",
             "Res5ROIHeads": "res5"}
# ROI_HEADS.NAME -> the ROADMAP item that ports it
QUEUED_ROI_HEADS = {"DensePoseROIHeads": "A18", "RROIHeads": "A16"}
MASK_HEADS = ("MaskRCNNConvUpsampleHead", "CoarseMaskHead", "PointRendMaskHead")


class RPN(nn.Module):
    """Holds the RPN head under the reference's ``proposal_generator``."""

    def __init__(self, rpn_head: StandardRPNHead):
        super().__init__()
        self.rpn_head = rpn_head


class ROIHeads(nn.Module):
    """Holds the ROI heads that are not None under the reference's names:
    ``box_head`` and ``box_predictor`` (``nn.ModuleList``s of one per stage
    for Cascade), ``res5`` (C4), ``mask_head``, ``keypoint_head``."""

    def __init__(self, **heads: Optional[nn.Module]):
        super().__init__()
        for name, head in heads.items():
            if head is not None:
                self.add_module(name, head)


class _ScaleGradient(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, scale: float) -> torch.Tensor:
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad * ctx.scale, None


def scale_gradient(x: torch.Tensor, scale: float) -> torch.Tensor:
    """The identity, whose backward multiplies the gradient by ``scale``
    (JAX ``_scale_gradient``; reference cascade ``_ScaleGradient``)."""
    return _ScaleGradient.apply(x, scale)


def clip_boxes(boxes: torch.Tensor, image_hw: Tuple[int, int]) -> torch.Tensor:
    """XYXY boxes clipped to [0, w] × [0, h] (JAX ``_clip_boxes``)."""
    h, w = image_hw
    return torch.stack([boxes[..., 0].clamp(0, w), boxes[..., 1].clamp(0, h),
                        boxes[..., 2].clamp(0, w), boxes[..., 3].clamp(0, h)], dim=-1)


def cascade_relabel(boxes: torch.Tensor, gt_boxes: torch.Tensor, gt_classes: torch.Tensor, gt_valid: torch.Tensor,
                    weights: torch.Tensor, iou_threshold: float, num_classes: int) -> Dict[str, torch.Tensor]:
    """A later Cascade stage's labels (JAX ``_cascade_relabel``; reference
    ``_match_and_label_boxes``): each of the (N, S) boxes matched to its
    highest-IoU valid gt (the first on ties; an invalid gt at IoU −1),
    foreground at IoU ≥ ``iou_threshold``. Returns the flat (N·S, ...)
    sampled dict ``fast_rcnn_losses`` takes, ``weights`` as given."""
    n, s = boxes.shape[:2]
    iou = torch.where(gt_valid[:, :, None].to(torch.bool), pairwise_iou_xyxy(gt_boxes, boxes), -1.0)  # (N, M, S)
    matched = torch.argmax(iou, dim=1)  # the first maximal gt
    is_pos = iou.amax(dim=1) >= iou_threshold
    img = torch.arange(n, device=boxes.device)[:, None].expand(n, s)
    out = {"boxes": boxes, "classes": torch.where(is_pos, gt_classes.to(torch.int64)[img, matched], num_classes),
           "weights": weights, "target_boxes": gt_boxes[img, matched], "matched_idx": matched, "is_pos": is_pos}
    return {k: v.reshape(n * s, *v.shape[2:]) for k, v in out.items()}


class RCNNModel(nn.Module):
    """backbone → RPN head on ``rpn_in_features``; the ROI heads on pooled
    rois. Parameters stay f32; convolutions and the box head's fc layers
    run at ``dtype`` under autocast, every f32 convolution on the card in
    IEEE f32 (``ieee_f32``); the RPN's 1x1 predictors and the box predictor
    in f32."""

    def __init__(self, backbone: nn.Module, rpn_in_features: Tuple[str, ...], rpn_head: StandardRPNHead,
                 roi_heads: Optional[ROIHeads] = None):
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

    def forward(self, images: torch.Tensor, rpn: bool = True):
        """Normalized (N, 3, H, W) → (the backbone's {name: map}, per RPN
        level the f32 (N, A, H, W) logits and (N, A·4, H, W) deltas; None
        and None without ``rpn``)."""
        with ieee_f32(), self._autocast(images.device):
            feats = self.backbone(images.to(self.dtype))
            if not rpn:
                return feats, None, None
            logits, deltas = self.proposal_generator.rpn_head([feats[f] for f in self.rpn_in_features])
        return feats, logits, deltas

    def box_predict(self, pooled: torch.Tensor, stage: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pooled (R, C, P, P) f32 → f32 (scores (R, C+1), deltas (R, 4C or
        4)): the box head and predictor (Cascade: ``stage``'s), or C4's res5
        head and the predictor."""
        heads = self.roi_heads
        with ieee_f32(), self._autocast(pooled.device):
            if hasattr(heads, "res5"):
                return heads.box_predictor(heads.res5(pooled))
            if isinstance(heads.box_head, nn.ModuleList):
                return heads.box_predictor[stage](heads.box_head[stage](pooled))
            return heads.box_predictor(heads.box_head(pooled))

    def res5_transform(self, pooled: torch.Tensor) -> torch.Tensor:
        """C4's shared per-roi transform: pooled (R, C, 14, 14) → the res5
        stage's (R, 8·RES2, 7, 7), at the model's width."""
        with ieee_f32(), self._autocast(pooled.device):
            return self.roi_heads.res5(pooled)

    def box_predict_shared(self, shared: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The predictor on ``res5_transform``'s output (its global average)."""
        return self.roi_heads.box_predictor(shared)

    def mask_predict(self, pooled: torch.Tensor, classes: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Pooled (R, C, P, P) → f32 mask logits (R, classes, 2P, 2P), or
        with ``classes`` (R,) each roi's class's only, (R, 2P, 2P)."""
        with ieee_f32(), self._autocast(pooled.device):
            return self.roi_heads.mask_head(pooled, classes)

    def keypoint_predict(self, pooled: torch.Tensor) -> torch.Tensor:
        """Pooled (R, C, P, P) f32 → f32 keypoint logits (R, K, 4P, 4P)."""
        with ieee_f32(), self._autocast(pooled.device):
            return self.roi_heads.keypoint_head(pooled)

    def point_predict(self, fine: torch.Tensor, coarse: torch.Tensor) -> torch.Tensor:
        """PointRend's point head: fine (R, P, C) and coarse (R, P, 1) → f32
        (R, P, 1) logits."""
        with ieee_f32(), self._autocast(fine.device):
            return self.roi_heads.mask_point_head(fine, coarse)


def _check_supported(cfg: CfgNode, with_roi_heads: bool) -> None:
    m = cfg.MODEL
    queued = []
    if with_roi_heads and m.MASK_ON and m.ROI_MASK_HEAD.NAME not in MASK_HEADS:
        raise ValueError(f"unknown ROI_MASK_HEAD.NAME {m.ROI_MASK_HEAD.NAME!r}: the port builds {list(MASK_HEADS)} "
                         "(the JAX package would build MaskRCNNConvUpsampleHead for it)")
    if m.PROPOSAL_GENERATOR.NAME not in ("RPN", "PrecomputedProposals") or m.RPN.HEAD_NAME != "StandardRPNHead":
        queued.append(f"PROPOSAL_GENERATOR {m.PROPOSAL_GENERATOR.NAME} / RPN.HEAD_NAME {m.RPN.HEAD_NAME}: "
                      "rotated proposals (ROADMAP A16)")
    if with_roi_heads:
        name = m.ROI_HEADS.NAME
        if name in QUEUED_ROI_HEADS:
            queued.append(f"ROI_HEADS.NAME {name} (ROADMAP {QUEUED_ROI_HEADS[name]})")
        elif name not in ROI_TYPES:
            raise ValueError(f"unknown ROI_HEADS.NAME {name!r}: the port builds {sorted(ROI_TYPES)} (the JAX "
                             "package would build Res5ROIHeads for it)")
        if list(m.ROI_HEADS.EXTENSIONS):
            queued.append(f"ROI_HEADS.EXTENSIONS {list(m.ROI_HEADS.EXTENSIONS)}: ROI-head extensions "
                          "(ROADMAP A18)")
    if queued:
        raise NotImplementedError("not ported yet: " + "; ".join(queued))


@META_ARCH_REGISTRY.register()
class GeneralizedRCNN:
    """Faster, Mask, Keypoint and Cascade R-CNN, FPN, C4 or DC5: the network
    on its device, the normalization, the anchors, the loss, the
    fixed-size inference and the host boundary."""

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
        strides, channels = backbone.out_feature_strides, backbone.out_feature_channels

        r = cfg.MODEL.RPN
        self.rpn_in_features = tuple(r.IN_FEATURES)
        self.strides = [strides[f] for f in self.rpn_in_features]  # anchors_per_level reads them
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
        self.roi_type = ROI_TYPES[rh.NAME] if self.with_roi_heads else None
        self.num_classes = int(rh.NUM_CLASSES)
        self.roi_in_features = tuple(rh.IN_FEATURES)
        self.roi_strides = [strides[f] for f in self.roi_in_features]
        self.roi_matcher = Matcher(list(rh.IOU_THRESHOLDS), list(rh.IOU_LABELS), allow_low_quality_matches=False)
        self.roi_batch_size = int(rh.BATCH_SIZE_PER_IMAGE)
        self.roi_positive_fraction = float(rh.POSITIVE_FRACTION)
        self.score_threshold = float(rh.SCORE_THRESH_TEST)
        self.nms_threshold = float(rh.NMS_THRESH_TEST)
        self.max_detections = int(cfg.TEST.DETECTIONS_PER_IMAGE)
        self.proposal_append_gt = bool(rh.PROPOSAL_APPEND_GT)
        # Fast R-CNN: the proposals come with the batch (JAX :350-356)
        self.precomputed_proposals = self.with_roi_heads and (
            cfg.MODEL.PROPOSAL_GENERATOR.NAME == "PrecomputedProposals" or bool(cfg.MODEL.LOAD_PROPOSALS))
        self.box2box = Box2BoxTransform(tuple(bh.BBOX_REG_WEIGHTS))
        ch = cfg.MODEL.ROI_BOX_CASCADE_HEAD
        self.cascade_ious = [float(t) for t in ch.IOUS]
        self.cascade_box2box = [Box2BoxTransform(tuple(w)) for w in ch.BBOX_REG_WEIGHTS]
        self.smooth_l1_beta = float(bh.SMOOTH_L1_BETA)
        self.pooler_resolution = int(bh.POOLER_RESOLUTION)
        # the reference's SAMPLING_RATIO 0 picks ceil(roi / bin) samples per
        # bin, a count per roi; the JAX package fixes it at 2, and so does the port
        self.pooler_sampling_ratio = int(bh.POOLER_SAMPLING_RATIO)
        if self.pooler_sampling_ratio == 0:
            logger.warning("ROI_BOX_HEAD.POOLER_SAMPLING_RATIO=0 (adaptive) is approximated with a fixed 2x2 "
                           "sample grid, as in the JAX package.")
            self.pooler_sampling_ratio = 2
        self.mask_on = self.with_roi_heads and bool(cfg.MODEL.MASK_ON)
        self.keypoint_on = self.with_roi_heads and bool(cfg.MODEL.KEYPOINT_ON)
        mh, kh, ph = cfg.MODEL.ROI_MASK_HEAD, cfg.MODEL.ROI_KEYPOINT_HEAD, cfg.MODEL.POINT_HEAD
        self.mask_pooler_resolution = int(mh.POOLER_RESOLUTION)
        # PointRend (JAX :361-371)
        self.point_rend_on = self.mask_on and (mh.NAME == "PointRendMaskHead" or bool(mh.POINT_HEAD_ON)
                                               or rh.NAME == "PointRendROIHeads")
        self.point_train_num = int(ph.TRAIN_NUM_POINTS)
        self.point_oversample = int(ph.OVERSAMPLE_RATIO)
        self.point_importance = float(ph.IMPORTANCE_SAMPLE_RATIO)
        self.point_steps = int(ph.SUBDIVISION_STEPS)
        self.point_subdiv_num = int(ph.SUBDIVISION_NUM_POINTS)
        self.num_keypoints = int(kh.NUM_KEYPOINTS)
        self.keypoint_pooler_resolution = int(kh.POOLER_RESOLUTION)
        self.keypoint_loss_weight = float(kh.LOSS_WEIGHT)

        rpn_head = StandardRPNHead(channels[self.rpn_in_features[0]], num_anchors)
        roi_heads = self._build_roi_heads(cfg, channels[self.roi_in_features[0]]) if self.with_roi_heads else None
        self.model = RCNNModel(backbone, self.rpn_in_features, rpn_head, roi_heads)
        generator = torch.Generator().manual_seed(max(int(cfg.SEED), 0))
        init_weights(self.model, generator)
        rpn_head.init_parameters(generator)
        if roi_heads is not None:
            predictors = roi_heads.box_predictor
            for predictor in predictors if isinstance(predictors, nn.ModuleList) else [predictors]:
                predictor.init_parameters(generator)
            for head in (roi_heads.get_submodule(h) for h in ("mask_head", "keypoint_head") if hasattr(roi_heads, h)):
                head.init_parameters(generator)
        self.model.to(self.device).cast(self.dtype).eval()

    def _build_roi_heads(self, cfg: CfgNode, channels: int) -> ROIHeads:
        """The ROI heads of ``ROI_HEADS.NAME`` on pooled maps of ``channels``
        (JAX ``RCNNNetwork.setup``)."""
        bh, mh, kh, res = cfg.MODEL.ROI_BOX_HEAD, cfg.MODEL.ROI_MASK_HEAD, cfg.MODEL.ROI_KEYPOINT_HEAD, cfg.MODEL.RESNETS
        heads = {}
        mask_channels = channels
        if self.roi_type == "res5":
            # the res5 stage of the trunk's recipe on 14² rois, FrozenBN untouched by FREEZE_AT (JAX :173-181,
            # :413-419: bottleneck blocks of one group, whatever the trunk's depth and groups)
            out, bottleneck = int(res.RES2_OUT_CHANNELS) * 8, int(res.NUM_GROUPS) * int(res.WIDTH_PER_GROUP) * 8
            blocks = RESNET_SPECS.get(int(res.DEPTH), ("bottleneck", (3, 4, 6, 3)))[1][3]
            heads["res5"] = nn.Sequential(*[
                BottleneckBlock(channels if b == 0 else out, out, bottleneck, stride=2 if b == 0 else 1,
                                stride_in_1x1=bool(res.STRIDE_IN_1X1), norm=res.NORM) for b in range(blocks)])
            heads["box_predictor"] = FastRCNNOutputLayers(out, self.num_classes, bool(bh.CLS_AGNOSTIC_BBOX_REG))
            mask_channels = out  # C4's mask head reads the res5 output
        else:
            num_conv, num_fc = int(bh.NUM_CONV), int(bh.NUM_FC)
            if num_conv == 0 and num_fc == 0:
                logger.warning("ROI_BOX_HEAD.NUM_CONV and NUM_FC are both 0; defaulting to the standard 2-fc "
                               "head (set either explicitly to silence).")
                num_fc = 2

            def box_head():
                return FastRCNNConvFCHead(channels, self.pooler_resolution, num_conv, int(bh.CONV_DIM), num_fc,
                                          int(bh.FC_DIM))

            if self.roi_type == "cascade":  # one head and one class-agnostic predictor per stage
                stages = [box_head() for _ in self.cascade_ious]
                heads["box_head"] = nn.ModuleList(stages)
                heads["box_predictor"] = nn.ModuleList(
                    [FastRCNNOutputLayers(h.out_dim, self.num_classes, True) for h in stages])
            else:
                heads["box_head"] = box_head()
                heads["box_predictor"] = FastRCNNOutputLayers(heads["box_head"].out_dim, self.num_classes,
                                                              bool(bh.CLS_AGNOSTIC_BBOX_REG))
        if self.mask_on and mh.NAME == "CoarseMaskHead":
            side = self.pooler_resolution // 2 if self.roi_type == "res5" else self.mask_pooler_resolution
            heads["mask_head"] = CoarseMaskHead(mask_channels, self.num_classes, side, int(mh.CONV_DIM),
                                                int(mh.FC_DIM), int(mh.NUM_FC), int(mh.OUTPUT_SIDE_RESOLUTION))
        elif self.mask_on:
            heads["mask_head"] = MaskRCNNConvUpsampleHead(mask_channels, self.num_classes, int(mh.NUM_CONV),
                                                          int(mh.CONV_DIM))
        if self.point_rend_on:  # class-agnostic: one output, the roi's class's coarse logit in (JAX :200-204)
            ph = cfg.MODEL.POINT_HEAD
            heads["mask_point_head"] = PointHead(channels, 1, 1, int(ph.FC_DIM), int(ph.NUM_FC))
        if self.keypoint_on:
            heads["keypoint_head"] = KRCNNConvDeconvUpsampleHead(channels, self.num_keypoints,
                                                                 [int(d) for d in kh.CONV_DIMS])
        return ROIHeads(**heads)

    def normalize(self, images: torch.Tensor) -> torch.Tensor:
        """(x - PIXEL_MEAN) / PIXEL_STD on 0..255 pixels."""
        return (images.to(self.device, torch.float32) - self.pixel_mean) / self.pixel_std

    anchors_per_level = RetinaNet.anchors_per_level

    def _flatten_rpn(self, logits, deltas):
        """Per level (N, H·W·A) logits and (N, H·W·A, 4) deltas."""
        return [nhwc_flat(t, 1)[..., 0] for t in logits], [nhwc_flat(t, 4) for t in deltas]

    def proposals(self, logits, deltas, image_hw: Tuple[int, int], mode: str):
        """``find_top_rpn_proposals`` of the RPN outputs at ``mode``'s top-ks."""
        lg, dl = self._flatten_rpn(logits, deltas)
        return find_top_rpn_proposals(lg, dl, self.anchors_per_level(image_hw), image_hw, self.rpn_box2box,
                                      nms_thresh=self.rpn_nms_thresh, pre_nms_topk=self.pre_nms_topk[mode],
                                      post_nms_topk=self.post_nms_topk[mode])

    def pool(self, feats: Dict[str, torch.Tensor], boxes: torch.Tensor, per_image: int,
             resolution: Optional[int] = None) -> torch.Tensor:
        """(N·per_image, 4) boxes, image-major → pooled (R, C, P, P) f32, P
        ``resolution`` (the box head's by default)."""
        batch_idx = torch.arange(boxes.shape[0] // per_image, device=boxes.device).repeat_interleave(per_image)
        return multilevel_roi_align([feats[f] for f in self.roi_in_features], self.roi_strides, boxes, batch_idx,
                                    resolution or self.pooler_resolution, self.pooler_sampling_ratio)

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
        """(total, {"loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg"}
        and, with their heads, "loss_mask" and "loss_keypoint") of one train
        batch on the device: ``image`` (N, 3, H, W) 0..255, ``gt_boxes`` (N,
        M, 4) XYXY in input pixels, ``gt_classes`` (N, M), ``gt_valid`` (N,
        M), ``gt_masks`` (N, M, R, R) gt-box-relative rasters, ``gt_keypoints``
        (N, M, K, 3), the draws' source (module docstring), and for Fast
        R-CNN ``proposal_boxes`` (N, K, 4) and ``proposal_valid`` (N, K)."""
        losses = self._losses(batch)[1]
        return sum(losses.values()), losses

    def _losses(self, batch: Dict[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(the backbone's maps, the loss terms) of ``loss_fn``: a subclass
        (``PanopticFPN``) feeds the same maps to its own head."""
        images = self.normalize(batch["image"])
        n, _, h, w = images.shape
        generator = self._generator(batch)
        if self.precomputed_proposals:  # no RPN loss (JAX :534-541)
            feats, _, _ = self.model(images, rpn=False)
            losses = {}
            prop_boxes = batch["proposal_boxes"].to(self.device, torch.float32)
            prop_valid = batch["proposal_valid"].to(self.device, torch.bool)
        else:
            feats, logits, deltas = self.model(images)
            losses = {k: v * self.rpn_loss_weight
                      for k, v in self._rpn_losses(batch, generator, logits, deltas, (h, w)).items()}
            with torch.no_grad():
                prop_boxes, _, prop_valid = self.proposals([t.detach() for t in logits],
                                                           [t.detach() for t in deltas], (h, w), "train")
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
        shared = None
        if self.roi_type == "cascade":
            losses.update(self._cascade_losses(batch, feats, sampled, flat, (h, w)))
        else:
            pooled = self.pool(feats, flat["boxes"], s)
            if self.roi_type == "res5":  # one res5 pass feeds the predictor and the mask head
                shared = self.model.res5_transform(pooled)
                scores, box_deltas = self.model.box_predict_shared(shared)
            else:
                scores, box_deltas = self.model.box_predict(pooled)
            losses.update(fast_rcnn_losses(scores, box_deltas, flat, self.box2box, self.num_classes,
                                           self.smooth_l1_beta))
        if (self.mask_on and "gt_masks" in batch) or (self.keypoint_on and "gt_keypoints" in batch):
            losses.update(self._roi_extra_losses(batch, feats, sampled, gt_boxes, shared))
        return feats, losses

    def _cascade_losses(self, batch, feats, sampled, flat, image_hw) -> Dict[str, torch.Tensor]:
        """``loss_cls_stage{t}`` and ``loss_box_reg_stage{t}`` of every stage
        (JAX ``:572-611``): stage 0 on the sampled rois, each later one on
        the previous refinements, detached, clipped, an empty box at weight
        0, relabelled at the stage's IoU; the pooled features' gradient
        scaled by 1 / stages."""
        n, s = sampled["boxes"].shape[:2]
        gt_boxes = batch["gt_boxes"].to(self.device, torch.float32)
        gt_classes, gt_valid = batch["gt_classes"].to(self.device), batch["gt_valid"].to(self.device)
        cur, cur_flat, weights = sampled["boxes"], flat, flat["weights"].view(n, s)
        losses = {}
        for t, (iou, b2b) in enumerate(zip(self.cascade_ious, self.cascade_box2box)):
            if t > 0:
                cur = clip_boxes(cur, image_hw)
                weights = weights * ((cur[..., 2] > cur[..., 0]) & (cur[..., 3] > cur[..., 1])).to(weights.dtype)
                cur_flat = cascade_relabel(cur, gt_boxes, gt_classes, gt_valid, weights, iou, self.num_classes)
            pooled = scale_gradient(self.pool(feats, cur.reshape(n * s, 4), s), 1.0 / len(self.cascade_ious))
            scores, deltas = self.model.box_predict(pooled, t)
            stage = fast_rcnn_losses(scores, deltas, cur_flat, b2b, self.num_classes, self.smooth_l1_beta)
            losses.update({f"{k}_stage{t}": v for k, v in stage.items()})
            cur = b2b.apply_deltas(deltas.detach(), cur.reshape(n * s, 4)).view(n, s, 4)
        return losses

    def _roi_extra_losses(self, batch, feats, sampled, gt_boxes, shared=None) -> Dict[str, torch.Tensor]:
        """The mask and keypoint losses on the first ``int(S · POSITIVE_FRACTION)``
        slots of each image, which hold all its foreground rois (module
        docstring); C4's mask head on that block of the res5 output ``shared``."""
        n, s = sampled["boxes"].shape[:2]
        k = min(int(self.roi_batch_size * self.roi_positive_fraction), s)
        boxes = sampled["boxes"][:, :k]
        matched = sampled["matched_idx"][:, :k]
        fg = (sampled["is_pos"][:, :k] & (sampled["weights"][:, :k] > 0)).reshape(-1).to(torch.float32)
        flat_boxes = boxes.reshape(n * k, 4)
        losses = {}
        if self.mask_on and "gt_masks" in batch:
            if shared is not None:
                mask_in = shared.view(n, s, *shared.shape[1:])[:, :k].reshape(n * k, *shared.shape[1:])
            else:
                mask_in = self.pool(feats, flat_boxes, k, self.mask_pooler_resolution)
            classes = torch.clamp(sampled["classes"][:, :k].reshape(-1), 0, self.num_classes - 1)
            logits = self.model.mask_predict(mask_in, classes)
            targets = crop_gt_masks(batch["gt_masks"].to(self.device), gt_boxes, matched, boxes, logits.shape[-1])
            losses["loss_mask"] = mask_rcnn_loss(logits, targets, fg)
            if self.point_rend_on:
                losses["loss_mask_point"] = self._point_loss(batch, feats, flat_boxes, s, k, logits, targets, fg)
        if self.keypoint_on and "gt_keypoints" in batch:
            logits = self.model.keypoint_predict(self.pool(feats, flat_boxes, k, self.keypoint_pooler_resolution))
            gt_kp = batch["gt_keypoints"].to(self.device, torch.float32)
            img = torch.arange(n, device=self.device)[:, None].expand(n, k)
            idx, valid = encode_keypoint_targets(gt_kp[img, matched].reshape(n * k, -1, 3), flat_boxes,
                                                 logits.shape[-2])
            losses["loss_keypoint"] = keypoint_rcnn_loss(logits, idx, valid, fg) * self.keypoint_loss_weight
        return losses

    def _point_uniforms(self, batch: Dict, n: int, s: int, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Each foreground-block roi's (k·P, 2) candidates and (P - int(β·P),
        2) uniform points: ``batch["draws"]``'s, given for all N·S sampled
        rois, or the step generator's for the N·k of the block."""
        p = self.point_train_num
        shapes = {"point_cand": (self.point_oversample * p, 2),
                  "point_rand": (p - int(self.point_importance * p), 2)}
        draws = batch.get("draws")
        if draws is not None:
            return tuple(draws[name].to(self.device, torch.float32).view(n, s, *shape)[:, :k].reshape(n * k, *shape)
                         for name, shape in shapes.items())
        return tuple(self._uniform(batch, batch["generator"], name, (n * k, *shape)) for name, shape in shapes.items())

    def _point_loss(self, batch, feats, boxes, s, k, logits, targets, fg) -> torch.Tensor:
        """``loss_mask_point`` (JAX :661-701) of the N·k foreground-block rois:
        their (N·k, M, M) gt-class mask logits and gt crops, foreground
        weights (N·k,)."""
        n = boxes.shape[0] // k
        fine = self.pool(feats, boxes, k, 2 * self.mask_pooler_resolution)
        cand, rand = self._point_uniforms(batch, n, s, k)
        with torch.no_grad():
            points = sample_uncertain_points(logits.detach(), cand, rand, self.point_train_num,
                                             self.point_importance)
        point_logits = self.model.point_predict(point_sample(fine, points), point_sample(logits[:, None], points))
        point_logits = point_logits[..., 0]
        t = (point_sample(targets[:, None], points)[..., 0] > 0.5).to(torch.float32)
        ce = torch.clamp(point_logits, min=0) - point_logits * t + torch.log1p(torch.exp(-torch.abs(point_logits)))
        return (ce.mean(1) * fg).sum() / torch.clamp(fg.sum(), min=1.0)

    # -- inference -----------------------------------------------------------------
    @torch.inference_mode()
    def predict_fn(self, images: torch.Tensor, proposal_boxes: Optional[torch.Tensor] = None,
                   proposal_valid: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Raw (N, 3, H, W) 0..255 images → fixed-size detections on the
        device: boxes (N, K, 4), scores (N, K) (0 in an invalid slot),
        classes (N, K); with the mask head ``masks`` (N, K, 2P, 2P), the
        sigmoid of the logits at each detection's class; with the keypoint
        head ``keypoint_heatmaps`` (N, K, keypoints, 4P, 4P) logits. Fast
        R-CNN takes its proposals, ``proposal_boxes`` (N, P, 4) in input
        pixels and ``proposal_valid`` (N, P), and raises without them."""
        return self._predict(images, proposal_boxes, proposal_valid)[0]

    def _predict(self, images: torch.Tensor, proposal_boxes: Optional[torch.Tensor] = None,
                 proposal_valid: Optional[torch.Tensor] = None) -> Tuple[Dict[str, torch.Tensor],
                                                                          Dict[str, torch.Tensor]]:
        """(``predict_fn``'s detections, the backbone's maps)."""
        x = self.normalize(images)
        n, _, h, w = x.shape
        if self.precomputed_proposals:  # JAX :752-770
            if proposal_boxes is None or proposal_valid is None:
                raise ValueError("MODEL.LOAD_PROPOSALS inference needs proposal_boxes and proposal_valid from the "
                                 "batch (the test mapper's, from DATASETS.PROPOSAL_FILES_TEST)")
            feats, _, _ = self.model(x, rpn=False)
            boxes = proposal_boxes.to(self.device, torch.float32)
            valid = proposal_valid.to(self.device, torch.bool)
        else:
            feats, logits, deltas = self.model(x)
            boxes, _, valid = self.proposals(logits, deltas, (h, w), "test")
        p = boxes.shape[1]
        if self.roi_type == "cascade":
            boxes, scores, box_deltas = self._cascade_inference(feats, boxes, (h, w))
        else:
            scores, box_deltas = self.model.box_predict(self.pool(feats, boxes.reshape(n * p, 4), p))
        dets = fast_rcnn_inference(boxes, valid, scores.view(n, p, -1), box_deltas.view(n, p, -1), self.box2box,
                                   self.num_classes, (h, w), self.score_threshold, self.nms_threshold,
                                   self.max_detections)
        k = dets["boxes"].shape[1]
        det_boxes = dets["boxes"].reshape(n * k, 4)
        if self.mask_on:
            if self.roi_type == "res5":  # C4: res5 again, on the detections' 14² pools (JAX :813-826)
                mask_in = self.model.res5_transform(self.pool(feats, det_boxes, k))
            else:
                mask_in = self.pool(feats, det_boxes, k, self.mask_pooler_resolution)
            cls = torch.clamp(dets["classes"].reshape(n * k), 0, self.num_classes - 1)
            sel = self.model.mask_predict(mask_in, cls)
            if self.point_rend_on:  # JAX :838-853
                fine = self.pool(feats, det_boxes, k, 2 * self.mask_pooler_resolution)
                sel = refine_mask_with_points(sel, fine, self.model.point_predict, self.point_subdiv_num,
                                              self.point_steps)
            dets["masks"] = torch.sigmoid(sel).view(n, k, *sel.shape[1:])
        if self.keypoint_on:
            kp = self.model.keypoint_predict(self.pool(feats, det_boxes, k, self.keypoint_pooler_resolution))
            dets["keypoint_heatmaps"] = kp.view(n, k, *kp.shape[1:])
        return dets, feats

    def _cascade_inference(self, feats, boxes: torch.Tensor, image_hw: Tuple[int, int]):
        """Every stage on the previous one's boxes, clipped (JAX ``:774-797``):
        (the last stage's boxes, unclipped; the log of the stages' mean
        softmax, at least 1e-12, as scores; zero deltas), for
        ``fast_rcnn_inference``."""
        n, p = boxes.shape[:2]
        probs = 0
        for t, b2b in enumerate(self.cascade_box2box):
            if t > 0:
                boxes = clip_boxes(boxes, image_hw)
            scores, deltas = self.model.box_predict(self.pool(feats, boxes.reshape(n * p, 4), p), t)
            probs = probs + torch.softmax(scores, dim=-1)
            boxes = b2b.apply_deltas(deltas, boxes.reshape(n * p, 4)).view(n, p, 4)
        scores = torch.log(torch.clamp(probs / len(self.cascade_box2box), min=1e-12))
        return boxes, scores, torch.zeros(n * p, 4, device=boxes.device)

    postprocess = RetinaNet.postprocess


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
