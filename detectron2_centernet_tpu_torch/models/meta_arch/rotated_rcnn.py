"""The rotated Faster R-CNN, counterpart of the JAX package's
``models/meta_arch/rotated_rcnn.py`` (reference RRPN + RROIHeads:
``proposal_generator/rrpn.py`` and ``roi_heads/rotated_fast_rcnn.py``).

Built for a ``GeneralizedRCNN`` config that names ``PROPOSAL_GENERATOR.NAME``
``RRPN`` or ``ROI_HEADS.NAME`` ``RROIHeads`` (``models/build.py``), or for
``META_ARCHITECTURE`` ``RotatedRCNN``. Boxes are (cx, cy, w, h, angle in
degrees, counter-clockwise).

The network (``RCNNModel``): the backbone, the RPN head with 5-d deltas per
anchor (``proposal_generator.rpn_head``), and over ROIAlignRotated rois of
the first ``ROI_HEADS.IN_FEATURES`` map the box head of ``NUM_FC`` fc layers
(2 when 0, as JAX builds it; ``roi_heads.box_head``) and a class-agnostic
5-d predictor (``roi_heads.box_predictor``). A C4 config's res5 head is not
part of it, as in the JAX package.

Training (``loss_fn``), batch as ``GeneralizedRCNN``'s with ``gt_boxes`` (N,
M, 5): the RRPN's losses (``rrpn_losses``: anchors matched by the rotated
IoU, R1 on the card), the training proposals (``find_top_rrpn_proposals``,
R2), then per image the gt appended to the proposals, matched by the rotated
IoU, sampled, and the top ``min(S, P + M)`` slots by priority (positives,
then negatives, then the rest, each by a 1e-3 tie-breaker); softmax CE over
the sampled rois and L1 on the positives' deltas, both over the count of
sampled rois. The draws: ``batch["draws"]`` ({"rpn": (N, R), "roi": (N, P +
M)}; the tests hand in JAX's) or ``batch["generator"]``, in that order. JAX
draws the ROI sampler's uniforms and its tie-breaker from one key with the
same shape, so they are the same numbers: ``roi`` serves both.

Inference (``predict_fn``): proposals, ROIAlignRotated, the box head, the
class-agnostic deltas applied and clipped (near-horizontal boxes only)
before the (proposal × class) grid, whose top ``4 · DETECTIONS_PER_IMAGE``
candidates above the score threshold go to one class-aware ``nms_rotated``
call (R2) for the batch. ``postprocess`` un-warps the boxes on the host: the
warp must be isotropic, the centre maps back, w and h divide by the scale,
and a mirrored warp flips the angle.
"""

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ...config import CfgNode
from ...ops.roi_align_rotated import nms_rotated, pairwise_iou_rotated, roi_align_rotated
from ...structures import Instances, RotatedBoxes
from ..anchors import RotatedAnchorGenerator
from ..box_regression import Box2BoxTransformRotated
from ..build import resolve_device
from ..layers import init_weights
from ..matcher import Matcher
from ..proposal_generator.rpn import StandardRPNHead, subsample_labels, top_k_indices
from ..proposal_generator.rrpn import clip_rotated_boxes, find_top_rrpn_proposals, rrpn_losses
from ..registry import BACKBONE_REGISTRY, META_ARCH_REGISTRY
from ..roi_heads.box_head import FastRCNNConvFCHead, FastRCNNOutputLayers
from .rcnn import RCNNModel, ROIHeads
from .retinanet import RetinaNet, nhwc_flat

__all__ = ["RotatedRCNN"]


@META_ARCH_REGISTRY.register()
class RotatedRCNN:
    """RRPN + RROIHeads on their device: the normalization, the rotated
    anchors, the loss, the fixed-size inference and the host boundary."""

    def __init__(self, cfg: CfgNode) -> None:
        self.device = resolve_device(cfg.MODEL.DEVICE)
        self.device_augment = None  # the step's batch augmentation; models/build.py attaches it
        self.dtype = torch.bfloat16 if cfg.TPU.DTYPE == "bfloat16" else torch.float32
        self.pixel_mean = torch.tensor(cfg.MODEL.PIXEL_MEAN, dtype=torch.float32,
                                       device=self.device).view(1, -1, 1, 1)
        self.pixel_std = torch.tensor(cfg.MODEL.PIXEL_STD, dtype=torch.float32,
                                      device=self.device).view(1, -1, 1, 1)
        self.num_classes = int(cfg.MODEL.ROI_HEADS.NUM_CLASSES)
        backbone = BACKBONE_REGISTRY.get(cfg.MODEL.BACKBONE.NAME)(cfg)
        strides, channels = backbone.out_feature_strides, backbone.out_feature_channels

        r, a = cfg.MODEL.RPN, cfg.MODEL.ANCHOR_GENERATOR
        self.rpn_in_features = tuple(r.IN_FEATURES)
        self.strides = [strides[f] for f in self.rpn_in_features]  # anchors_per_level reads them
        self.anchor_generator = RotatedAnchorGenerator(a.SIZES, a.ASPECT_RATIOS, a.ANGLES, self.strides,
                                                       offset=float(a.OFFSET))
        num_anchors = self.anchor_generator.num_anchors[0]
        if any(k != num_anchors for k in self.anchor_generator.num_anchors):
            raise ValueError("the RPN's shared head needs the same number of anchors on every level")
        self._anchors: Dict[Tuple[int, int], List[torch.Tensor]] = {}
        self.rpn_matcher = Matcher(list(r.IOU_THRESHOLDS), list(r.IOU_LABELS), allow_low_quality_matches=True)
        self.rpn_box2box = Box2BoxTransformRotated((1.0, 1.0, 1.0, 1.0, 1.0))
        self.rpn_batch_size = int(r.BATCH_SIZE_PER_IMAGE)
        self.rpn_positive_fraction = float(r.POSITIVE_FRACTION)
        self.rpn_nms_thresh = float(r.NMS_THRESH)
        self.pre_nms_topk = {"train": int(r.PRE_NMS_TOPK_TRAIN), "test": int(r.PRE_NMS_TOPK_TEST)}
        self.post_nms_topk = {"train": int(r.POST_NMS_TOPK_TRAIN), "test": int(r.POST_NMS_TOPK_TEST)}

        rh, bh = cfg.MODEL.ROI_HEADS, cfg.MODEL.ROI_BOX_HEAD
        self.roi_in_feature = rh.IN_FEATURES[0]
        self.roi_stride = strides[self.roi_in_feature]
        self.roi_matcher = Matcher(list(rh.IOU_THRESHOLDS), list(rh.IOU_LABELS), allow_low_quality_matches=False)
        self.roi_batch_size = int(rh.BATCH_SIZE_PER_IMAGE)
        self.roi_positive_fraction = float(rh.POSITIVE_FRACTION)
        self.score_threshold = float(rh.SCORE_THRESH_TEST)
        self.nms_threshold = float(rh.NMS_THRESH_TEST)
        self.max_detections = int(cfg.TEST.DETECTIONS_PER_IMAGE)
        weights = tuple(bh.BBOX_REG_WEIGHTS)
        self.box2box = Box2BoxTransformRotated(weights + (1.0,) if len(weights) == 4 else weights)
        self.pooler_resolution = int(bh.POOLER_RESOLUTION)

        rpn_head = StandardRPNHead(channels[self.rpn_in_features[0]], num_anchors, box_dim=5)
        box_head = FastRCNNConvFCHead(channels[self.roi_in_feature], self.pooler_resolution, 0, 0,
                                      int(bh.NUM_FC) or 2, int(bh.FC_DIM))
        predictor = FastRCNNOutputLayers(box_head.out_dim, self.num_classes, True, box_dim=5)
        self.model = RCNNModel(backbone, self.rpn_in_features, rpn_head,
                               ROIHeads(box_head=box_head, box_predictor=predictor))
        generator = torch.Generator().manual_seed(max(int(cfg.SEED), 0))
        init_weights(self.model, generator)
        rpn_head.init_parameters(generator)
        predictor.init_parameters(generator)
        self.model.to(self.device).cast(self.dtype).eval()

    def normalize(self, images: torch.Tensor) -> torch.Tensor:
        """(x - PIXEL_MEAN) / PIXEL_STD on 0..255 pixels."""
        return (images.to(self.device, torch.float32) - self.pixel_mean) / self.pixel_std

    anchors_per_level = RetinaNet.anchors_per_level

    def _flatten_rpn(self, logits, deltas):
        """Per level (N, H·W·A) logits and (N, H·W·A, 5) deltas."""
        return [nhwc_flat(t, 1)[..., 0] for t in logits], [nhwc_flat(t, 5) for t in deltas]

    def proposals(self, logits, deltas, image_hw: Tuple[int, int], mode: str):
        """``find_top_rrpn_proposals`` of the RPN outputs at ``mode``'s top-ks."""
        lg, dl = self._flatten_rpn(logits, deltas)
        return find_top_rrpn_proposals(lg, dl, self.anchors_per_level(image_hw), image_hw, self.rpn_box2box,
                                       self.rpn_nms_thresh, self.pre_nms_topk[mode], self.post_nms_topk[mode])

    def pool(self, feats: Dict[str, torch.Tensor], boxes: torch.Tensor, per_image: int) -> torch.Tensor:
        """(N·per_image, 5) boxes, image-major → ROIAlignRotated (R, C, P, P) f32."""
        batch_idx = torch.arange(boxes.shape[0] // per_image, device=boxes.device).repeat_interleave(per_image)
        return roi_align_rotated(feats[self.roi_in_feature], boxes, batch_idx, 1.0 / self.roi_stride,
                                 self.pooler_resolution, 2)

    def _uniform(self, batch: Dict, name: str, shape) -> torch.Tensor:
        draws = batch.get("draws")
        if draws is not None:
            return draws[name].to(self.device, torch.float32)
        generator = batch.get("generator")
        if generator is None:
            raise ValueError("a RotatedRCNN training batch needs its samplers' uniforms: give batch['draws'] or "
                             "batch['generator'] (SimpleTrainer seeds one per step)")
        return torch.rand(shape, generator=generator, device=self.device)

    # -- training ------------------------------------------------------------------
    def loss_fn(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total, {"loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg"})
        of one train batch: ``image`` (N, 3, H, W) 0..255, ``gt_boxes`` (N,
        M, 5) rotated in input pixels, ``gt_classes`` (N, M), ``gt_valid``
        (N, M), the draws' source (module docstring). The train mapper's
        (N, M, 4) XYXY boxes raise: the JAX package reads them as rotated
        boxes (its index 4 clamps to 3), which trains on other targets."""
        gt_boxes = batch["gt_boxes"].to(self.device, torch.float32)
        if gt_boxes.shape[-1] != 5:
            raise ValueError(f"RotatedRCNN trains on (N, M, 5) rotated gt boxes (cx, cy, w, h, angle); the batch "
                             f"has {tuple(gt_boxes.shape)} (the train mapper's XYXY boxes, which the JAX package "
                             "misreads as rotated ones): build the batches with rotated boxes")
        images = self.normalize(batch["image"])
        n, _, h, w = images.shape
        gt_valid = batch["gt_valid"].to(self.device)
        gt_classes = batch["gt_classes"].to(self.device)
        feats, logits, deltas = self.model(images)
        lg, dl = self._flatten_rpn(logits, deltas)
        lg_all, dl_all = torch.cat(lg, 1), torch.cat(dl, 1)
        anchors = torch.cat(self.anchors_per_level((h, w)))
        losses = rrpn_losses(anchors, lg_all, dl_all, gt_boxes, gt_valid, self._uniform(batch, "rpn", lg_all.shape),
                             self.rpn_matcher, self.rpn_box2box, self.rpn_batch_size, self.rpn_positive_fraction)
        with torch.no_grad():
            prop_boxes, _, prop_valid = self.proposals([t.detach() for t in logits], [t.detach() for t in deltas],
                                                       (h, w), "train")
            sampled = self._sample(prop_boxes, prop_valid, gt_boxes, gt_classes, gt_valid,
                                   self._uniform(batch, "roi", (n, prop_boxes.shape[1] + gt_boxes.shape[1])))
        s = sampled["boxes"].shape[1]
        flat = {k: v.reshape(n * s, *v.shape[2:]) for k, v in sampled.items()}
        scores, deltas5 = self.model.box_predict(self.pool(feats, flat["boxes"], s))
        ce = -torch.gather(torch.log_softmax(scores, dim=-1), 1, flat["classes"][:, None])[:, 0]
        num_valid = torch.clamp(flat["weights"].sum(), min=1.0)
        losses["loss_cls"] = (ce * flat["weights"]).sum() / num_valid
        reg = (deltas5 - self.box2box.get_deltas(flat["boxes"], flat["target_boxes"])).abs().sum(-1)
        pos_w = (flat["is_pos"] & (flat["weights"] > 0)).to(torch.float32)
        losses["loss_box_reg"] = (reg * pos_w).sum() / num_valid
        return sum(losses.values()), losses

    def _sample(self, prop_boxes, prop_valid, gt_boxes, gt_classes, gt_valid, rand) -> Dict[str, torch.Tensor]:
        """JAX's ``sample_one`` for every image: the gt appended, the rotated
        IoU matcher (an invalid proposal at IoU -1 and label -1), the
        sampler on ``rand`` (N, P + M), the top min(S, P + M) by priority
        (tie-breaker ``rand`` · 1e-3)."""
        boxes = torch.cat([prop_boxes, gt_boxes], 1)
        valid = torch.cat([prop_valid, gt_valid.to(torch.bool)], 1)
        iou = torch.where(valid[:, None, :], pairwise_iou_rotated(gt_boxes, boxes), -1.0)
        matches, labels = self.roi_matcher(iou, gt_valid)
        labels = torch.where(valid, labels.to(torch.int32), -1)
        sel = subsample_labels(labels, self.roi_batch_size, self.roi_positive_fraction, rand)
        priority = torch.where(sel == 1, 2.0, torch.where(sel == 0, 1.0, 0.0)) + rand * 1e-3
        idx = top_k_indices(priority, min(self.roi_batch_size, priority.shape[1]))
        sel_s, matched = torch.gather(sel, 1, idx), torch.gather(matches, 1, idx)
        is_pos = sel_s == 1
        take = lambda t, i: torch.gather(t, 1, i[..., None].expand(*i.shape, 5))  # noqa: E731
        return {"boxes": take(boxes, idx),
                "classes": torch.where(is_pos, torch.gather(gt_classes.to(torch.int64), 1, matched),
                                       self.num_classes),
                "weights": (sel_s >= 0).to(torch.float32), "target_boxes": take(gt_boxes, matched), "is_pos": is_pos}

    # -- inference -----------------------------------------------------------------
    @torch.inference_mode()
    def predict_fn(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Raw (N, 3, H, W) 0..255 images → fixed-size detections on the
        device: boxes (N, K, 5), scores (N, K) (0 in an invalid slot),
        classes (N, K)."""
        x = self.normalize(images)
        n, _, h, w = x.shape
        feats, logits, deltas = self.model(x)
        prop_boxes, _, prop_valid = self.proposals(logits, deltas, (h, w), "test")
        p = prop_boxes.shape[1]
        scores, deltas5 = self.model.box_predict(self.pool(feats, prop_boxes.reshape(n * p, 5), p))
        return self.detect(prop_boxes, prop_valid, scores.view(n, p, -1), deltas5.view(n, p, 5), (h, w))

    def detect(self, prop_boxes: torch.Tensor, prop_valid: torch.Tensor, scores: torch.Tensor,
               deltas: torch.Tensor, image_hw: Tuple[int, int]) -> Dict[str, torch.Tensor]:
        """The rotated fast R-CNN inference (reference
        ``fast_rcnn_inference_single_image_rotated``) of the box predictor's
        (N, P, C+1) scores and (N, P, 5) deltas on (N, P) proposals."""
        n, p = prop_valid.shape
        probs = torch.softmax(scores, dim=-1)[..., : self.num_classes]
        boxes = clip_rotated_boxes(self.box2box.apply_deltas(deltas, prop_boxes), image_hw)
        nc = self.num_classes
        grid = torch.where(prop_valid[..., None] & (probs > self.score_threshold), probs, float("-inf"))
        m = min(4 * self.max_detections, p * nc)
        top = top_k_indices(grid.reshape(n, -1), m)  # (N, m)
        top_scores = torch.gather(grid.reshape(n, -1), 1, top)
        classes = top % nc
        cand = torch.gather(boxes, 1, (top // nc)[..., None].expand(n, m, 5))
        keep, valid = nms_rotated(cand, top_scores, self.nms_threshold, self.max_detections, classes)
        return {"boxes": torch.gather(cand, 1, keep[..., None].expand(*keep.shape, 5)),
                "scores": torch.where(valid, torch.gather(top_scores, 1, keep), 0.0),
                "classes": torch.gather(classes, 1, keep)}

    # -- host boundary -------------------------------------------------------------
    def postprocess(self, dets: Dict[str, np.ndarray], warps: Optional[List[np.ndarray]],
                    orig_sizes: List[Tuple[int, int]]) -> List[Dict[str, Instances]]:
        """Fixed-size detections (numpy) → per-image Instances in original
        image coordinates (JAX ``RotatedRCNN.postprocess``): the slots above
        the score threshold, un-warped (isotropic warps only), as
        ``RotatedBoxes`` clipped to the image."""
        boxes, scores, classes = (np.asarray(dets[k]) for k in ("boxes", "scores", "classes"))
        results = []
        for i, (oh, ow) in enumerate(orig_sizes):
            keep = scores[i] > self.score_threshold
            b, s, c = boxes[i][keep].astype(np.float32), scores[i][keep], classes[i][keep]  # f32, as JAX's
            if warps is not None and len(b):
                m = np.asarray(warps[i], np.float64)
                sx, sy = m[0, 0], m[1, 1]
                if abs(abs(sx) - abs(sy)) >= 1e-4:
                    raise ValueError(f"un-warping rotated boxes needs an isotropic warp, got {m}")
                b[:, :2] = (b[:, :2] - m[:, 2]) @ np.linalg.inv(m[:, :2]).T
                b[:, 2:4] /= abs(sx)
                if sx < 0:  # a mirrored warp flips the angle
                    b[:, 4] = -b[:, 4]
            inst = Instances((oh, ow))
            rb = RotatedBoxes(b.astype(np.float32))
            rb.clip((oh, ow))
            inst.pred_boxes = rb
            inst.scores = s.astype(np.float32)
            inst.pred_classes = c.astype(np.int64)
            results.append({"instances": inst})
        return results
