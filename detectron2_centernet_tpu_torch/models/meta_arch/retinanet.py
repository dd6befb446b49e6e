"""RetinaNet, counterpart of the JAX package's ``models/meta_arch/retinanet.py``
(reference ``modeling/meta_arch/retinanet.py``).

``RetinaNetModel`` is the network: a ResNet-FPN backbone (p3-p7) and the
shared 4-conv class and box towers (``RetinaNetHead``), NCHW. ``RetinaNet``
owns it on ``cfg.MODEL.DEVICE`` with the normalization (``(x - PIXEL_MEAN)
/ PIXEL_STD`` on 0..255 pixels, no /255), the anchors (numpy, moved to the
device once per input size), the training loss (``loss_fn``: anchors matched
to the gt slots, sigmoid focal loss over the valid anchors and smooth-L1
over the positives, both over the normalizer), the fixed-size inference
(``predict_fn``: per level top-k, decode and score threshold, then the
class-aware fixed-K NMS of ``ops/nms.py``) and the host boundary
(``postprocess``).

Anchor order is ``grid_anchors``' ``(H·W, A)``; the NCHW head outputs are
permuted to ``(N, H, W, A·C)`` before any reshape, so the flattened class
scores run class-fastest per anchor as in the JAX package's NHWC.

``MODEL.RETINANET.LOSS_NORMALIZER`` "ema" keeps the reference's running
foreground count in the ``loss_normalizer`` buffer (100 at the start; each
training ``loss_fn`` sets it to 0.9·prev + 0.1·num_pos before using it), so
it is saved and resumed with the checkpoint; "batch" uses the batch's own
count. ``BBOX_REG_LOSS_TYPE``, ``RETINANET.NORM`` and ``FPN.NORM`` are
accepted and ignored, as in the JAX package.
"""

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...config import CfgNode
from ...data.detection_utils import unwarp_boxes
from ...ops.nms import batched_nms_fixed, pairwise_iou_xyxy
from ...structures import Boxes, Instances
from ...structures.keypoints import heatmaps_to_keypoints
from ...structures.masks import paste_masks_in_image
from ..anchors import build_anchor_generator
from ..box_regression import Box2BoxTransform
from ..build import resolve_device
from ..layers import ieee_f32, init_weights
from ..matcher import Matcher
from ..registry import BACKBONE_REGISTRY, META_ARCH_REGISTRY
from .centernet import F32Conv2d

__all__ = ["RetinaNet", "RetinaNetHead", "RetinaNetModel", "nhwc_flat", "sigmoid_focal_loss", "smooth_l1"]

# anchors matched at once in label_anchors: about this many (gt slot, anchor) IoUs
MATCH_CHUNK = 2 ** 25


class RetinaNetHead(nn.Module):
    """The class and box towers (``num_convs`` × [3x3 conv + ReLU]; keys
    ``cls_subnet.{0,2,4,6}``, ``bbox_subnet.{0,2,4,6}``) and the f32
    predictors ``cls_score`` (A·C) and ``bbox_pred`` (A·4), shared by every
    level."""

    def __init__(self, channels: int, num_classes: int, num_anchors: int, num_convs: int = 4):
        super().__init__()
        for name in ("cls_subnet", "bbox_subnet"):
            layers = []
            for _ in range(num_convs):
                layers += [nn.Conv2d(channels, channels, 3, padding=1), nn.ReLU(inplace=True)]
            setattr(self, name, nn.Sequential(*layers))
        self.cls_score = F32Conv2d(channels, num_anchors * num_classes, 3, padding=1)
        self.bbox_pred = F32Conv2d(channels, num_anchors * 4, 3, padding=1)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator, prior_prob: float) -> None:
        """The JAX package's head init: every tower conv and both predictors
        N(0, 0.01) with zero bias, the ``cls_score`` bias at the prior-prob
        logit ``-log((1 - p) / p)``."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.normal_(0.0, 0.01, generator=generator)
                m.bias.zero_()
        self.cls_score.bias.fill_(-math.log((1 - prior_prob) / prior_prob))

    def forward(self, features: List[torch.Tensor]) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        return ([self.cls_score(self.cls_subnet(f)) for f in features],
                [self.bbox_pred(self.bbox_subnet(f)) for f in features])


class RetinaNetModel(nn.Module):
    """backbone (FPN) → head on the ``in_features`` levels. Input: normalized
    (N, 3, H, W) images; output: per level the f32 (N, A·C, H, W) logits and
    (N, A·4, H, W) deltas. Parameters and statistics stay f32; the
    convolutions run at ``dtype`` under autocast, and every f32 convolution
    on the card in IEEE f32 (``ieee_f32``), as ``CenterNetModel``'s."""

    def __init__(self, backbone: nn.Module, in_features: Tuple[str, ...], num_classes: int,
                 num_anchors: int, num_convs: int, ema_normalizer: bool = False):
        super().__init__()
        self.dtype = torch.float32
        self.backbone = backbone
        self.in_features = tuple(in_features)
        self.head = RetinaNetHead(backbone.out_channels, num_classes, num_anchors, num_convs)
        if ema_normalizer:
            self.register_buffer("loss_normalizer", torch.tensor(100.0))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # a checkpoint without the running count (the reference keeps it off
        # its state dict; a JAX tree has it only after a step) keeps the current one
        key = prefix + "loss_normalizer"
        if hasattr(self, "loss_normalizer") and key not in state_dict:
            state_dict[key] = self.loss_normalizer.detach().clone()
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def cast(self, dtype: torch.dtype) -> "RetinaNetModel":
        """Compute width of everything but the predictors (kept f32)."""
        self.dtype = dtype
        return self

    def forward(self, images: torch.Tensor) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        with ieee_f32(), torch.autocast(images.device.type, dtype=self.dtype,
                                        enabled=self.dtype != torch.float32):
            pyramid = self.backbone(images.to(self.dtype))
            return self.head([pyramid[f] for f in self.in_features])


def nhwc_flat(t: torch.Tensor, width: int) -> torch.Tensor:
    """A level's (N, A·width, H, W) head output → (N, H·W·A, width) in the
    anchor order of ``grid_anchors``: permuted to (N, H, W, A·width) first,
    as the JAX package's NHWC maps are."""
    return t.permute(0, 2, 3, 1).reshape(t.shape[0], -1, width)


def optax_sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Binary cross entropy from logits, in optax's stable form."""
    return torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, alpha: float, gamma: float) -> torch.Tensor:
    """Per-element focal loss (fvcore's, which the reference uses)."""
    p = torch.sigmoid(logits)
    ce = optax_sigmoid_ce(logits, targets)
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float) -> torch.Tensor:
    """Per-element smooth L1; plain L1 at ``beta`` ≤ 0."""
    diff = (pred - target).abs()
    if beta <= 0:
        return diff
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


@META_ARCH_REGISTRY.register()
class RetinaNet:
    """The RetinaNet meta-architecture: the network on its device, the
    normalization, the anchors, the loss, the fixed-size inference and the
    host boundary."""

    def __init__(self, cfg: CfgNode) -> None:
        r = cfg.MODEL.RETINANET
        self.device = resolve_device(cfg.MODEL.DEVICE)
        self.num_classes = int(r.NUM_CLASSES)
        self.in_features = tuple(r.IN_FEATURES)
        self.focal_alpha = float(r.FOCAL_LOSS_ALPHA)
        self.focal_gamma = float(r.FOCAL_LOSS_GAMMA)
        self.smooth_l1_beta = float(r.SMOOTH_L1_LOSS_BETA)
        self.score_threshold = float(r.SCORE_THRESH_TEST)
        self.topk_candidates = int(r.TOPK_CANDIDATES_TEST)
        self.nms_threshold = float(r.NMS_THRESH_TEST)
        self.max_detections = int(cfg.TEST.DETECTIONS_PER_IMAGE)
        self.loss_normalizer_mode = str(r.LOSS_NORMALIZER)
        if self.loss_normalizer_mode not in ("batch", "ema"):
            raise ValueError(f"MODEL.RETINANET.LOSS_NORMALIZER must be batch or ema, got {self.loss_normalizer_mode!r}")
        self.device_augment = None  # the step's batch augmentation; models/build.py attaches it
        self.dtype = torch.bfloat16 if cfg.TPU.DTYPE == "bfloat16" else torch.float32
        self.pixel_mean = torch.tensor(cfg.MODEL.PIXEL_MEAN, dtype=torch.float32,
                                       device=self.device).view(1, -1, 1, 1)
        self.pixel_std = torch.tensor(cfg.MODEL.PIXEL_STD, dtype=torch.float32,
                                      device=self.device).view(1, -1, 1, 1)

        backbone = BACKBONE_REGISTRY.get(cfg.MODEL.BACKBONE.NAME)(cfg)
        self.strides = [backbone.out_feature_strides[f] for f in self.in_features]
        self.anchor_generator = build_anchor_generator(cfg, self.strides)
        self.num_anchors_per_cell = self.anchor_generator.num_anchors[0]
        if any(a != self.num_anchors_per_cell for a in self.anchor_generator.num_anchors):
            raise ValueError("RetinaNet's shared head needs the same number of anchors on every level")
        self.box2box = Box2BoxTransform(tuple(r.BBOX_REG_WEIGHTS))
        self.matcher = Matcher(list(r.IOU_THRESHOLDS), list(r.IOU_LABELS), allow_low_quality_matches=True)
        self._anchors: Dict[Tuple[int, int], List[torch.Tensor]] = {}

        self.model = RetinaNetModel(backbone, self.in_features, self.num_classes, self.num_anchors_per_cell,
                                    int(r.NUM_CONVS), ema_normalizer=self.loss_normalizer_mode == "ema")
        generator = torch.Generator().manual_seed(max(int(cfg.SEED), 0))
        init_weights(self.model, generator)
        self.model.head.init_parameters(generator, float(r.PRIOR_PROB))
        self.model.to(self.device).cast(self.dtype).eval()

    def normalize(self, images: torch.Tensor) -> torch.Tensor:
        """(x - PIXEL_MEAN) / PIXEL_STD on 0..255 pixels (the RetinaNet
        configs carry 0..255 means)."""
        return (images.to(self.device, torch.float32) - self.pixel_mean) / self.pixel_std

    def anchors_per_level(self, image_hw: Tuple[int, int]) -> List[torch.Tensor]:
        """The (H_l·W_l·A, 4) anchors of each level for an input of
        ``image_hw`` (grids of ``ceil(size / stride)``), on the device, made
        once per size."""
        key = (int(image_hw[0]), int(image_hw[1]))
        if key not in self._anchors:
            grids = [(-(-key[0] // s), -(-key[1] // s)) for s in self.strides]
            self._anchors[key] = [torch.from_numpy(a).to(self.device)
                                  for a in self.anchor_generator.grid_anchors(grids)]
        return self._anchors[key]

    # -- training ------------------------------------------------------------------
    @torch.no_grad()
    def label_anchors(self, anchors: torch.Tensor, gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                      gt_valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(gt_labels (N, R) int64 in [0, C], C background and -1 ignored;
        matched_boxes (N, R, 4)) of the anchors (R, 4) against each image's
        gt slots, a few images at a time (the (N, M, R) IoU of a whole
        batch of 16 at 640² would take GBs)."""
        n, m = gt_valid.shape
        chunk = max(1, MATCH_CHUNK // max(m * anchors.shape[0], 1))
        labels_out, boxes_out = [], []
        for s in range(0, n, chunk):
            boxes, classes = gt_boxes[s:s + chunk], gt_classes[s:s + chunk]
            matches, labels = self.matcher(pairwise_iou_xyxy(boxes, anchors), gt_valid[s:s + chunk])
            boxes_out.append(torch.gather(boxes, 1, matches[..., None].expand(*matches.shape, 4)))
            matched_cls = torch.gather(classes.long(), 1, matches)
            labels_out.append(torch.where(labels == 1, matched_cls,
                                          torch.where(labels == 0, self.num_classes, -1)))
        return torch.cat(labels_out), torch.cat(boxes_out)

    def loss_fn(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total, {"loss_cls", "loss_box_reg"}) of one train batch on the
        device: ``image`` (N, 3, H, W) 0..255, ``gt_boxes`` (N, M, 4) XYXY in
        input pixels, ``gt_classes`` (N, M), ``gt_valid`` (N, M). The model
        runs in its current mode; in training mode the ema normalizer moves."""
        images = self.normalize(batch["image"])
        logits, bbox_reg = self.model(images)
        anchors = torch.cat(self.anchors_per_level(images.shape[2:]))
        cls_pred = torch.cat([nhwc_flat(t, self.num_classes) for t in logits], dim=1)
        box_pred = torch.cat([nhwc_flat(t, 4) for t in bbox_reg], dim=1)
        gt_labels, matched_boxes = self.label_anchors(
            anchors, batch["gt_boxes"].to(self.device, torch.float32), batch["gt_classes"].to(self.device),
            batch["gt_valid"].to(self.device))

        valid = gt_labels >= 0
        pos = valid & (gt_labels < self.num_classes)
        num_pos = torch.clamp(pos.sum().to(torch.float32), min=1.0)
        if self.loss_normalizer_mode == "ema":
            normalizer = 0.9 * self.model.loss_normalizer + 0.1 * num_pos
            if self.model.training:
                self.model.loss_normalizer.copy_(normalizer)
        else:
            normalizer = num_pos

        targets = F.one_hot(torch.where(pos, gt_labels, self.num_classes), self.num_classes + 1)
        targets = targets[..., :self.num_classes].to(torch.float32)  # background: all zero
        focal = sigmoid_focal_loss(cls_pred, targets, self.focal_alpha, self.focal_gamma)
        cls_loss = torch.where(valid[..., None], focal, 0.0).sum() / normalizer
        deltas_gt = self.box2box.get_deltas(anchors[None], matched_boxes)
        reg = smooth_l1(box_pred, deltas_gt, self.smooth_l1_beta)
        reg_loss = torch.where(pos[..., None], reg, 0.0).sum() / normalizer
        return cls_loss + reg_loss, {"loss_cls": cls_loss, "loss_box_reg": reg_loss}

    # -- inference -----------------------------------------------------------------
    def candidates(self, logits: List[torch.Tensor], bbox_reg: List[torch.Tensor],
                   image_hw: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The NMS candidates of the head outputs, every level's in turn:
        boxes (N, Σk, 4), scores (N, Σk) and classes (N, Σk). Per level:
        sigmoid of the f32 logits, the top ``min(TOPK_CANDIDATES_TEST,
        anchors of the level)`` (anchor, class) scores, their deltas decoded
        on their anchors, scores at or below ``SCORE_THRESH_TEST`` dead
        (``-inf``)."""
        n, c = logits[0].shape[0], self.num_classes
        cand_boxes, cand_scores, cand_classes = [], [], []
        for lg, bx, anc in zip(logits, bbox_reg, self.anchors_per_level(image_hw)):
            scores = torch.sigmoid(nhwc_flat(lg.float(), c).reshape(n, -1))  # (N, H·W·A·C), class fastest
            k = min(self.topk_candidates, anc.shape[0], scores.shape[1])
            top_scores, idx = torch.topk(scores, k, dim=1)
            anchor_idx = idx // c
            deltas = torch.gather(nhwc_flat(bx.float(), 4), 1, anchor_idx[..., None].expand(n, k, 4))
            cand_boxes.append(self.box2box.apply_deltas(deltas, anc[anchor_idx]))
            cand_scores.append(torch.where(top_scores > self.score_threshold, top_scores, float("-inf")))
            cand_classes.append(idx % c)
        return torch.cat(cand_boxes, 1), torch.cat(cand_scores, 1), torch.cat(cand_classes, 1)

    @torch.inference_mode()
    def predict_fn(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Raw (N, 3, H, W) 0..255 images → fixed-size detections on the
        device: boxes (N, K, 4), scores (N, K) (0 in an invalid slot),
        classes (N, K): the ``candidates`` of every level through the
        class-aware fixed-K NMS."""
        x = self.normalize(images)
        logits, bbox_reg = self.model(x)
        boxes, scores, classes = self.candidates(logits, bbox_reg, x.shape[2:])
        keep, valid = batched_nms_fixed(boxes, scores, classes, self.nms_threshold, self.max_detections)
        n, k = keep.shape
        return {"boxes": torch.gather(boxes, 1, keep[..., None].expand(n, k, 4)),
                "scores": torch.where(valid, torch.gather(scores, 1, keep), 0.0),
                "classes": torch.gather(classes, 1, keep)}

    # -- host boundary -------------------------------------------------------------
    def postprocess(
        self,
        dets: Dict[str, np.ndarray],
        warps: Optional[List[np.ndarray]],
        orig_sizes: List[Tuple[int, int]],
        device_masks: Optional[List[torch.Tensor]] = None,
    ) -> List[Dict[str, Instances]]:
        """Fixed-size detections (numpy) → per-image Instances in original
        image coordinates: every one of the K slots above the score
        threshold, un-warped, clipped, empty boxes dropped. Where ``dets``
        carries them (an R-CNN with its mask or keypoint head), the kept
        slots' ``pred_masks`` (D, H, W) bool, pasted at the original size,
        and ``pred_keypoints`` (D, keypoints, 3) (x, y, score), decoded in
        the original boxes, both computed on the model's device; the pasted
        masks are also appended to ``device_masks``, as they are there, when
        it is given (``PanopticFPN``'s merge reads them)."""
        boxes, scores, classes = (np.asarray(dets[k]) for k in ("boxes", "scores", "classes"))
        results = []
        for i, (oh, ow) in enumerate(orig_sizes):
            keep = scores[i] > self.score_threshold
            b = boxes[i][keep]
            if warps is not None:
                b = unwarp_boxes(warps[i], b)
            bx = Boxes(b.astype(np.float32))
            bx.clip((oh, ow))
            ne = bx.nonempty()
            slots = np.flatnonzero(keep)[ne]
            inst = Instances((oh, ow))
            inst.pred_boxes = bx[ne]
            inst.scores = scores[i][slots].astype(np.float32)
            inst.pred_classes = classes[i][slots].astype(np.int64)
            if "masks" in dets:
                masks = torch.from_numpy(np.asarray(dets["masks"][i][slots])).to(self.device)
                pasted = paste_masks_in_image(masks, inst.pred_boxes.tensor, (oh, ow))
                inst.pred_masks = pasted.cpu().numpy()
                if device_masks is not None:
                    device_masks.append(pasted)
            if "keypoint_heatmaps" in dets:
                maps = torch.from_numpy(np.asarray(dets["keypoint_heatmaps"][i][slots])).to(self.device)
                inst.pred_keypoints = heatmaps_to_keypoints(maps, inst.pred_boxes.tensor)[:, :, [0, 1, 3]].cpu().numpy()
            results.append({"instances": inst})
        return results
