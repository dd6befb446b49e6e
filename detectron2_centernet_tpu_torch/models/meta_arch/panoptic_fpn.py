"""Panoptic FPN, counterpart of the JAX package's
``models/meta_arch/panoptic_fpn.py`` (reference
``modeling/meta_arch/panoptic_fpn.py``).

``PanopticFPN`` is the port's ``GeneralizedRCNN`` (Mask R-CNN, Cascade or
a deformable trunk as the config says) with ``SemSegFPNHead`` on the same
FPN, at the network's top level (``sem_seg_head.p2.0``, ...; JAX keeps its
variables apart, ``params["sem_seg_head"]``). The losses (JAX ``:61-89``):
the RPN's as they are, the ROI heads' × ``PANOPTIC_FPN.INSTANCE_LOSS_WEIGHT``
and ``loss_sem_seg`` × ``SEM_SEG_HEAD.LOSS_WEIGHT`` (0 for a batch without
``sem_seg``). JAX runs the backbone twice, once in ``GeneralizedRCNN``'s
loss or inference and once more for the sem-seg head; the port runs it
once and feeds both heads: with FrozenBN trunks (and GroupNorm) the value
and every gradient are the same (ROADMAP C23,
``tests/test_torch_panoptic.py``).

The host boundary (JAX ``:96-127``): the instances as Mask R-CNN's, the
sem-seg label map as ``SemanticSegmentor``'s (un-warped and argmaxed on the
device), and with ``PANOPTIC_FPN.COMBINE.ENABLED`` the panoptic merge,
``combine_semantic_and_instance_outputs``, on the device's pasted masks and
label map, which gives JAX's segment ids and ``segments_info``.
"""

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ...config import CfgNode
from ..layers import ieee_f32, init_weights
from ..registry import META_ARCH_REGISTRY
from .rcnn import GeneralizedRCNN
from .retinanet import RetinaNet
from .semantic_seg import SemanticSegmentor, SemSegFPNHead, host_label_maps, sem_seg_loss

__all__ = ["PanopticFPN", "combine_semantic_and_instance_outputs"]


@META_ARCH_REGISTRY.register()
class PanopticFPN(GeneralizedRCNN):
    def __init__(self, cfg: CfgNode) -> None:
        super().__init__(cfg)
        s, p = cfg.MODEL.SEM_SEG_HEAD, cfg.MODEL.PANOPTIC_FPN
        self.sem_seg_num_classes = int(s.NUM_CLASSES)
        self.sem_seg_ignore_value = int(s.IGNORE_VALUE)
        self.sem_seg_loss_weight = float(s.LOSS_WEIGHT)
        self.instance_loss_weight = float(p.INSTANCE_LOSS_WEIGHT)
        c = p.COMBINE
        self.combine_enabled = bool(c.ENABLED)
        self.combine_overlap_thresh = float(c.OVERLAP_THRESH)
        self.combine_stuff_area = int(c.STUFF_AREA_LIMIT)
        self.combine_conf_thresh = float(c.INSTANCES_CONFIDENCE_THRESH)
        # JAX's PanopticFPN builds SemSegFPNHead whatever SEM_SEG_HEAD.NAME says (panoptic_fpn.py:38)
        head = SemSegFPNHead(tuple(s.IN_FEATURES), self.model.backbone.out_feature_channels[s.IN_FEATURES[0]],
                             int(s.NUM_CLASSES), int(s.CONVS_DIM), int(s.COMMON_STRIDE))
        init_weights(head, torch.Generator().manual_seed(max(int(cfg.SEED), 0) + 1))  # JAX: fold_in(rng, 1)
        self.model.add_module("sem_seg_head", head.to(self.device).eval())

    def sem_seg_logits(self, feats: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The sem-seg head on the backbone's maps, at the model's width:
        (N, classes, H, W) f32 logits."""
        with ieee_f32(), self.model._autocast(self.device):
            return self.model.sem_seg_head(feats)

    def loss_fn(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``GeneralizedRCNN.loss_fn``'s terms, the ROI heads' weighted,
        and ``loss_sem_seg`` on the same backbone maps."""
        feats, losses = self._losses(batch)
        losses = {k: v if k.startswith("loss_rpn") else v * self.instance_loss_weight for k, v in losses.items()}
        if "sem_seg" in batch:
            loss = sem_seg_loss(self.sem_seg_logits(feats), batch["sem_seg"].to(self.device),
                                self.sem_seg_ignore_value)
        else:
            loss = torch.zeros((), device=self.device)
        losses["loss_sem_seg"] = loss * self.sem_seg_loss_weight
        return sum(losses.values()), losses

    @torch.inference_mode()
    def predict_fn(self, images: torch.Tensor, proposal_boxes=None, proposal_valid=None) -> Dict[str, torch.Tensor]:
        """``GeneralizedRCNN.predict_fn``'s detections and ``sem_seg`` (N,
        classes, H, W) f32 logits on the same backbone maps."""
        dets, feats = self._predict(images, proposal_boxes, proposal_valid)
        dets["sem_seg"] = self.sem_seg_logits(feats)
        return dets

    device_postprocess = SemanticSegmentor.device_postprocess  # the label maps, on the device

    def postprocess(self, dets: Dict[str, np.ndarray], warps, orig_sizes) -> List[Dict]:
        """Each image's {"instances", "sem_seg" (H, W) int64} and, with the
        merge on, "panoptic_seg": (the (H, W) int32 segment ids, the
        segments' info), as the JAX package's ``postprocess``, from the
        label maps of ``device_postprocess``."""
        labels = host_label_maps(dets, warps, orig_sizes)
        masks: List[torch.Tensor] = []
        results = RetinaNet.postprocess(self, {k: v for k, v in dets.items() if k != "sem_seg"}, warps, orig_sizes,
                                        device_masks=masks)
        for i, sem in enumerate(labels):
            results[i]["sem_seg"] = sem
            if self.combine_enabled:
                inst = results[i]["instances"]
                mask = masks[i] if masks else None
                results[i]["panoptic_seg"] = combine_semantic_and_instance_outputs(
                    inst.scores, inst.pred_classes, mask, torch.from_numpy(sem).to(self.device),
                    self.combine_overlap_thresh, self.combine_stuff_area, self.combine_conf_thresh,
                    self.sem_seg_num_classes)
        return results


def combine_semantic_and_instance_outputs(scores: np.ndarray, classes: np.ndarray, masks, semantic: torch.Tensor,
                                          overlap_threshold: float, stuff_area_limit: int,
                                          instances_confidence_threshold: float, num_labels: Optional[int] = None):
    """The panoptic merge (JAX ``panoptic_fpn.py:129-188``; reference
    ``:133-218``) on the device: the instances in the order of
    ``np.argsort(-scores)`` (numpy's, which is not stable at ties: it runs
    on the host, on the scores JAX would sort), down to the first under
    ``instances_confidence_threshold``, each pasting its (H, W) bool mask of
    ``masks`` where no earlier segment is, unless it is empty or more than
    ``overlap_threshold`` of it is taken (the ratio in float64, as numpy's);
    then each label of ``semantic`` but 0 (the things' placeholder) whose
    pixels left free number at least ``stuff_area_limit``, in label order.
    ``masks`` None: no instance segments (a model without masks).
    ``num_labels`` bounds the labels (the head's classes; read from
    ``semantic`` when None).

    Whether an instance is kept depends only on which earlier ones were, so
    the loop over instances becomes passes over all of them at once: each
    pass takes a guess of the kept set, finds every instance's overlap with
    the union of the guessed-kept ones before it (an exclusive running OR
    over the stacked masks) and decides them all; the first decision that
    differs from the guess is right (every earlier one was), so the next
    pass guesses the decisions and the guess settles in a few passes (one
    read-back each; more only when kept and dropped instances alternate).
    Each pixel then goes to the first kept mask over it. Returns (the (H, W)
    int32 segment ids as numpy, the segments' info)."""
    dev = semantic.device
    order = []
    if masks is not None:
        for idx in np.argsort(-np.asarray(scores)):
            if float(scores[idx]) < instances_confidence_threshold:
                break
            order.append(int(idx))
    pan = torch.zeros(semantic.shape, dtype=torch.int32, device=dev)
    kept = torch.zeros(len(order), dtype=torch.bool, device=dev)
    if order:
        stack = masks[torch.as_tensor(order, device=masks.device)].to(dev)  # (K, H, W) bool in pick order
        area = stack.sum((1, 2))
        kept = area > 0
        while True:
            taken = torch.cummax((stack & kept[:, None, None]).to(torch.uint8), 0).values
            before = torch.cat([torch.zeros_like(taken[:1]), taken[:-1]]).to(torch.bool)
            overlap = (stack & before).sum((1, 2)).double() / area.double()
            decided = (area > 0) & ~(overlap > overlap_threshold)
            if torch.equal(decided, kept):
                break
            kept = decided
        owned = stack & kept[:, None, None]
        ids = torch.cumsum(kept.to(torch.int32), 0, dtype=torch.int32)
        pan = torch.where(owned.any(0), ids[owned.to(torch.uint8).argmax(0)], pan)
    last = kept.sum().to(torch.int32)
    sem = semantic.long()
    if num_labels is None:
        num_labels = int(sem.max().item()) + 1 if sem.numel() else 1
    present = torch.bincount(sem.reshape(-1), minlength=num_labels) > 0
    free = torch.bincount(torch.where(pan == 0, sem, num_labels).reshape(-1), minlength=num_labels + 1)[:num_labels]
    stuff = present & (free >= stuff_area_limit)
    stuff[0] = False
    rank = last + torch.cumsum(stuff.to(torch.int32), 0, dtype=torch.int32)
    pan = torch.where((pan == 0) & stuff[sem], rank[sem], pan)
    kept_host, stuff_host, free_host = kept.cpu().numpy(), stuff.cpu().numpy(), free.cpu().numpy()
    segments_info = []
    for idx, keep in zip(order, kept_host):
        if keep:
            segments_info.append({"id": len(segments_info) + 1, "isthing": True, "score": float(scores[idx]),
                                  "category_id": int(classes[idx]), "instance_id": int(idx)})
    for label in np.flatnonzero(stuff_host):
        segments_info.append({"id": len(segments_info) + 1, "isthing": False, "category_id": int(label),
                              "area": int(free_host[label])})
    return pan.cpu().numpy(), segments_info
