"""CenterNet ("Objects as Points", ctdet), counterpart of the JAX package's
``models/meta_arch/centernet.py``.

``CenterNetModel`` is the network (backbone → hm/reg/wh heads, NCHW; a
ResNet or VoVNet trunk through the deconv neck);
``CenterNet`` owns it on ``cfg.MODEL.DEVICE`` with the normalization, the
training loss (``loss_fn``: targets rendered on the device, the CornerNet
focal loss and the masked L1), the fixed-size decode (``predict_fn``) and the
host boundary (``postprocess``).

The number of classes is that of the registered ``DATASETS.TRAIN[0]``'s
``thing_classes`` where there is one, else ``MODEL.CENTERNET.TASK.HM``, as in
the JAX package.
"""

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ...config import CfgNode
from ...data.catalog import DatasetCatalog, MetadataCatalog
from ...data.detection_utils import unwarp_boxes
from ...ops.decode import ctdet_decode
from ...ops.photometric import device_color_jitter
from ...ops.target_gen import gen_centernet_targets
from ...structures import Boxes, Instances
from ..build import resolve_device
from ..backbones import ResNet, VoVNet
from ..layers import BN_EPS, BN_MOMENTUM, BatchNorm2d, ieee_f32, init_weights
from ..registry import BACKBONE_REGISTRY, META_ARCH_REGISTRY

HM_BIAS = -2.19  # -log((1 - 0.1) / 0.1): the initial heatmap probability is ~0.1


class F32Conv2d(nn.Conv2d):
    """A conv that runs in f32 whatever the model's width, as the JAX heads'
    last convs do: head outputs stay f32 for the loss and the decode. Under
    ``CenterNetModel.forward`` that f32 is IEEE f32, not TF32."""

    def forward(self, x):
        with torch.autocast(x.device.type, enabled=False):
            return super().forward(x.float())


class CenterNetHead(nn.Sequential):
    """3x3 conv(head_conv) → ReLU → kxk f32 conv, the reference's head tower
    (keys ``.0`` and ``.2``)."""

    def __init__(self, cin: int, head_conv: int, nout: int, final_kernel: int):
        super().__init__(
            nn.Conv2d(cin, head_conv, 3, padding=1),
            nn.ReLU(inplace=True),
            F32Conv2d(head_conv, nout, final_kernel, padding=final_kernel // 2),
        )


def head_out(head: nn.Module) -> nn.Conv2d:
    """A head's last conv: the tower's ``.2``, or the head itself without a
    tower."""
    return head[-1] if isinstance(head, nn.Sequential) else head


class DeconvNeck(nn.Sequential):
    """The deconv upsampler of the dict-output trunks (JAX ``DeconvNeck``
    and ``ResNetDeconv``): the stride-16 map → 2 × [ConvTranspose 256 (k4,
    s2, pad 1; no bias) + BatchNorm + ReLU] → stride 4. The reference's
    ``deconv_layers`` (keys ``.0``, ``.1``, ``.3``, ``.4``). flax's
    ``ConvTranspose(k4, s2, "SAME")`` pads the dilated input by 2 on each
    side as this does, but correlates with its kernel unflipped: a JAX
    kernel crosses over flipped (``checkpoint/from_jax.py``)."""

    def __init__(self, cin: int, channels: int = 256, num_deconv: int = 2):
        mods = []
        for _ in range(num_deconv):
            mods += [nn.ConvTranspose2d(cin, channels, 4, stride=2, padding=1, bias=False),
                     BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM), nn.ReLU(inplace=True)]
            cin = channels
        super().__init__(*mods)
        self.out_channels = channels


class CenterNetModel(nn.Module):
    """backbone (→ deconv neck) → heads. Input: normalized (N, 3, H, W)
    images.

    The backbone returns the stride-``DOWN_RATIO`` map (DLA-34), or it is a
    dict-output trunk (ResNet, VoVNet) whose ``neck_feature`` map the
    ``deconv_layers`` bring to stride 4. Heads are a tower
    (``CenterNetHead``) at ``head_conv`` > 0, else one f32 conv each.

    Parameters and BatchNorm statistics are f32; the convolutions run at
    ``dtype`` (autocast), BatchNorm normalizes in f32 and rounds its output,
    as flax does with ``param_dtype`` f32 and ``dtype`` bf16. The forward
    runs under ``ieee_f32()``: every f32 convolution on the card (all of
    them at ``dtype`` f32, the heads' last convs at bf16) is IEEE f32, as
    the JAX package's f32 is, not the TF32 cuDNN takes by default."""

    def __init__(self, backbone: nn.Module, heads: Tuple[Tuple[str, int], ...],
                 head_conv: int = 256, final_kernel: int = 1, neck_feature: Optional[str] = None):
        super().__init__()
        self.dtype = torch.float32
        self.backbone = backbone
        self.neck_feature = neck_feature
        cin = getattr(backbone, "out_channels", None)
        if neck_feature is not None:
            self.deconv_layers = DeconvNeck(backbone.out_feature_channels[neck_feature])
            cin = self.deconv_layers.out_channels
        self.head_names = tuple(name for name, _ in heads)
        for name, nout in heads:
            setattr(self, name, CenterNetHead(cin, head_conv, nout, final_kernel) if head_conv > 0
                    else F32Conv2d(cin, nout, final_kernel, padding=final_kernel // 2))

    def cast(self, dtype: torch.dtype) -> "CenterNetModel":
        """Compute width of everything but the heads' last convs (kept f32).
        The parameters stay f32."""
        self.dtype = dtype
        return self

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        with ieee_f32(), torch.autocast(images.device.type, dtype=self.dtype,
                                        enabled=self.dtype != torch.float32):
            x = images.to(self.dtype)
            if self.neck_feature is None:
                y = self.backbone(x)
            else:
                y = self.deconv_layers(self.backbone(x, (self.neck_feature,))[self.neck_feature])
            return {name: getattr(self, name)(y) for name in self.head_names}


def focal_loss(hm_logits: torch.Tensor, gt_hm: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """CornerNet-style modified focal loss (reference ``_neg_loss``; JAX
    ``focal_loss``) on (N, C, H, W) logits and targets: the positive term
    weighted per class by ``alpha`` (C,), the negative term down-weighted by
    (1 - gt)^4, normalized by the number of positives."""
    pred = torch.clamp(torch.sigmoid(hm_logits.float()), 1e-4, 1 - 1e-4)
    gt = gt_hm.float()
    pos = (gt == 1.0).float()
    neg = (gt < 1.0).float()
    pos_loss = torch.log(pred) * (1.0 - pred) ** 2 * pos
    neg_loss = torch.log(1.0 - pred) * pred ** 2 * (1.0 - gt) ** 4 * neg
    num_pos = pos.sum()
    pos_total = (alpha.view(1, -1, 1, 1) * pos_loss).sum()
    neg_total = neg_loss.sum()
    return torch.where(num_pos == 0, -neg_total, -(pos_total + neg_total) / torch.clamp(num_pos, min=1.0))


def reg_l1_loss(out: torch.Tensor, mask: torch.Tensor, ind: torch.Tensor,
                target: torch.Tensor) -> torch.Tensor:
    """Masked L1 of an (N, 2, H, W) head gathered at the centers ``ind``
    (N, M) = y·W + x against ``target`` (N, M, 2) (reference ``RegL1Loss``;
    the normalizer counts the expanded (N, M, 2) mask)."""
    n, c, h, w = out.shape
    flat = out.float().reshape(n, c, h * w)
    pred = torch.gather(flat, 2, ind.long().view(n, 1, -1).expand(n, c, ind.shape[1])).transpose(1, 2)
    m = mask.float()[:, :, None].expand_as(pred)
    return (pred * m - target.float() * m).abs().sum() / (m.sum() + 1e-4)


def _resolve_alpha(alpha_cfg, num_classes: int) -> np.ndarray:
    """The reference's alpha list handling: one value for every class, or a
    list padded with 1.0."""
    alpha = list(alpha_cfg) if isinstance(alpha_cfg, (list, tuple)) else [alpha_cfg]
    if len(alpha) == 1:
        alpha = alpha * num_classes
    elif len(alpha) < num_classes:
        alpha = alpha + [1.0] * (num_classes - len(alpha))
    return np.asarray(alpha[:num_classes], np.float32)


def num_classes_of(cfg: CfgNode) -> int:
    """``len(thing_classes)`` of a registered ``DATASETS.TRAIN[0]``, else
    ``MODEL.CENTERNET.TASK.HM``."""
    train: Sequence[str] = tuple(cfg.DATASETS.TRAIN)
    if train and train[0] in DatasetCatalog:
        classes = MetadataCatalog.get(train[0]).get("thing_classes")
        if classes is not None:
            return len(classes)
    return int(cfg.MODEL.CENTERNET.TASK.HM)


@META_ARCH_REGISTRY.register()
class CenterNet:
    """The ctdet meta-architecture: the network on its device, the
    normalization, the decode and the host boundary."""

    def __init__(self, cfg: CfgNode) -> None:
        c = cfg.MODEL.CENTERNET
        self.device = resolve_device(cfg.MODEL.DEVICE)
        self.num_classes = num_classes_of(cfg)
        self.down_ratio = int(c.DOWN_RATIO)
        self.score_threshold = float(c.SCORE_THRESH_TEST)
        self.topk_candidates = int(c.TOPK_CANDIDATES_TEST)
        self.max_detections = int(cfg.TEST.DETECTIONS_PER_IMAGE)
        self.hm_weight = float(c.HM_WEIGHT)
        self.wh_weight = float(c.WH_WEIGHT)
        self.off_weight = float(c.OFF_WEIGHT)
        self.alpha = torch.from_numpy(_resolve_alpha(c.FOCAL_LOSS_ALPHA, self.num_classes)).to(self.device)
        # the batch-level train augmentation of the step (JAX models/build.py):
        # INPUT.COLOR_JITTER on the device unless DATALOADER.DEVICE_PHOTOMETRIC
        # is off (the port has no host jitter: then there is none)
        self.device_augment = (
            device_color_jitter
            if cfg.DATALOADER.DEVICE_PHOTOMETRIC and cfg.INPUT.COLOR_JITTER else None
        )
        # TEST.EXACT_MODE pins f32 decode scores; TPU.APPROX_TOPK has no
        # counterpart (top-k is always exact here)
        self.exact_mode = bool(cfg.TEST.EXACT_MODE)
        self.dtype = torch.bfloat16 if cfg.TPU.DTYPE == "bfloat16" else torch.float32
        self.pixel_mean = torch.tensor(cfg.MODEL.PIXEL_MEAN, dtype=torch.float32,
                                       device=self.device).view(1, -1, 1, 1)
        self.pixel_std = torch.tensor(cfg.MODEL.PIXEL_STD, dtype=torch.float32,
                                      device=self.device).view(1, -1, 1, 1)

        backbone = BACKBONE_REGISTRY.get(cfg.MODEL.BACKBONE.NAME)(cfg)
        # dict-output trunks get the deconv neck on their stride-16 map
        neck_feature = "res4" if isinstance(backbone, ResNet) else "stage4" if isinstance(backbone, VoVNet) else None
        heads = (("hm", self.num_classes), ("reg", 2), ("wh", 2))
        self.model = CenterNetModel(backbone, heads, int(c.HEAD_CONV), int(c.FINAL_KERNEL), neck_feature)
        init_weights(self.model, torch.Generator().manual_seed(max(int(cfg.SEED), 0)))
        with torch.no_grad():
            head_out(self.model.hm).bias.fill_(HM_BIAS)
        self.model.to(self.device).cast(self.dtype).eval()

    def normalize(self, images: torch.Tensor) -> torch.Tensor:
        """x/255, then (x - mean)/std (ctdet configs carry 0-1 scale mean/std)."""
        x = images.to(self.device, torch.float32) / 255.0
        return (x - self.pixel_mean) / self.pixel_std

    def loss_fn(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total, {"hm_loss", "wh_loss", "off_loss"}) of one train batch on
        the device: ``image`` (N, 3, H, W) 0..255, ``gt_boxes`` (N, M, 4) XYXY
        in input pixels, ``gt_classes`` (N, M), ``gt_valid`` (N, M). The
        model runs in its current mode (``train()`` for BatchNorm batch
        statistics); the loss terms come back already weighted."""
        images = self.normalize(batch["image"])
        z = self.model(images)
        n, _, h, w = images.shape
        t = gen_centernet_targets(
            batch["gt_boxes"].to(self.device), batch["gt_classes"].to(self.device),
            batch["gt_valid"].to(self.device), self.num_classes,
            h // self.down_ratio, w // self.down_ratio, self.down_ratio,
        )
        losses = {
            "hm_loss": focal_loss(z["hm"], t["hm"], self.alpha) * self.hm_weight,
            "wh_loss": reg_l1_loss(z["wh"], t["reg_mask"], t["ind"], t["wh"]) * self.wh_weight,
            "off_loss": reg_l1_loss(z["reg"], t["reg_mask"], t["ind"], t["reg"]) * self.off_weight,
        }
        return losses["hm_loss"] + losses["wh_loss"] + losses["off_loss"], losses

    @torch.inference_mode()
    def predict_fn(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Raw (N, 3, H, W) 0..255 images → fixed-size detections on the
        device: boxes (N, K, 4), scores (N, K), classes (N, K)."""
        z = self.model(self.normalize(images))
        hm = torch.clamp(torch.sigmoid(z["hm"].float()), 1e-4, 1 - 1e-4)
        boxes, scores, classes = ctdet_decode(
            hm, z["wh"], z["reg"], k=self.topk_candidates, down_ratio=self.down_ratio,
            score_dtype=(
                self.dtype if self.dtype != torch.float32 and not self.exact_mode else None
            ),
        )
        return {"boxes": boxes, "scores": scores, "classes": classes}

    def postprocess(
        self,
        dets: Dict[str, np.ndarray],
        warps: Optional[List[np.ndarray]],
        orig_sizes: List[Tuple[int, int]],
    ) -> List[Dict[str, Instances]]:
        """Fixed-size detections (numpy) → per-image Instances in original
        image coordinates: score threshold, un-warp, clip, drop empty boxes."""
        boxes = np.asarray(dets["boxes"])
        scores = np.asarray(dets["scores"])
        classes = np.asarray(dets["classes"])
        results = []
        k = min(self.max_detections, self.topk_candidates)
        for i, (oh, ow) in enumerate(orig_sizes):
            b, s, c = boxes[i, :k], scores[i, :k], classes[i, :k]
            keep = s > self.score_threshold
            b, s, c = b[keep], s[keep], c[keep]
            if warps is not None:
                b = unwarp_boxes(warps[i], b)
            inst = Instances((oh, ow))
            bx = Boxes(b.astype(np.float32))
            bx.clip((oh, ow))
            ne = bx.nonempty()
            inst.pred_boxes = bx[ne]
            inst.scores = s[ne].astype(np.float32)
            inst.pred_classes = c[ne].astype(np.int64)
            results.append({"instances": inst})
        return results
