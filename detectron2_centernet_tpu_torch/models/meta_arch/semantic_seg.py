"""Semantic segmentation, counterpart of the JAX package's
``models/meta_arch/semantic_seg.py`` (reference
``modeling/meta_arch/semantic_seg.py``).

``SemSegFPNHead`` (JAX ``:28-63``): per FPN level a tower of [3x3 conv
without bias + GroupNorm(min(32, dim)) (flax's epsilon) + ReLU (+ 2×
bilinear)] until the common stride, the towers summed, an f32 1x1
predictor, then a 4× bilinear upsample to the input size. Module names are
the reference's: ``sem_seg_head.p2.0`` (the conv, its norm at ``.norm``),
``sem_seg_head.p5.{0,2,4}`` with the ``nn.Upsample`` slots at the odd
indices, ``sem_seg_head.predictor``. The bilinear resizes are
``F.interpolate(align_corners=False)``, which equals
``jax.image.resize(method="bilinear")`` when it upsamples by an integer,
borders included (``tests/test_torch_semseg.py``).

``sem_seg_loss`` (JAX ``:255-278``): pixel cross-entropy over the pixels
that are not ``ignore_value``, or with ``top_k_percent`` < 1 the mean of the
largest fraction of the per-pixel losses (an ignored pixel counting 0).

``SemanticSegmentor`` (JAX ``:281-405``): the backbone and the head on
``cfg.MODEL.DEVICE``; ``loss_fn`` on ``batch["sem_seg"]`` (N, H, W);
``predict_fn`` returns the (N, C, H, W) f32 logits; ``device_postprocess``
un-warps them to each image's own size with the port's bilinear warp
(``data/detection_utils.py::warp_image``; JAX warps with cv2's fixed point,
ROADMAP C2) and takes the argmax on the device, so only a label map comes
back; ``postprocess`` gives each image's ``{"sem_seg": (H, W) int64}``, as
the JAX package's.

The DeepLab heads and PointRend's raise naming their ROADMAP items.
"""

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...config import CfgNode
from ...data.detection_utils import _axis_weights
from ..build import resolve_device
from ..layers import GN_EPS, ieee_f32, init_weights
from ..registry import BACKBONE_REGISTRY, META_ARCH_REGISTRY

__all__ = ["SemSegFPNHead", "SemanticSegmentor", "build_sem_seg_head", "host_label_maps", "sem_seg_labels",
           "sem_seg_loss"]

# SEM_SEG_HEAD.NAME -> the ROADMAP item that ports it
QUEUED_SEM_SEG_HEADS = {"DeepLabV3Head": "A15.2", "DeepLabV3PlusHead": "A15.2", "PointRendSemSegHead": "A15.3"}
FPN_STRIDES = {"p2": 4, "p3": 8, "p4": 16, "p5": 32, "p6": 64, "p7": 128}


class Conv2dGNReLU(nn.Conv2d):
    """A 3x3 conv without bias, its GroupNorm ``.norm`` and a ReLU: the
    reference's ``Conv2d(..., norm=GN, activation=relu)``."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 3, padding=1, bias=False)
        self.norm = nn.GroupNorm(min(32, cout), cout, eps=GN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.norm(super().forward(x)))


class SemSegFPNHead(nn.Module):
    """The FPN levels' towers summed at ``common_stride``, the f32 predictor
    and the upsample to the input: {level: (N, C_in, H, W)} → (N, classes,
    H·common_stride, W·common_stride) f32."""

    def __init__(self, in_features: Sequence[str], in_channels: int, num_classes: int, convs_dim: int = 128,
                 common_stride: int = 4):
        super().__init__()
        self.in_features = tuple(in_features)
        self.common_stride = common_stride
        for f in self.in_features:
            stride = FPN_STRIDES[f]
            reps = max(1, int(np.log2(stride) - np.log2(common_stride))) if stride > common_stride else 1
            ops: List[nn.Module] = []
            for k in range(reps):
                ops.append(Conv2dGNReLU(in_channels if k == 0 else convs_dim, convs_dim))
                if stride > common_stride:
                    ops.append(nn.Upsample(scale_factor=2, mode="bilinear", align_corners=False))
            self.add_module(f, nn.Sequential(*ops))
        self.predictor = nn.Conv2d(convs_dim, num_classes, 1)

    def forward(self, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        out = None
        for f in self.in_features:
            x = getattr(self, f)(features[f])
            out = x if out is None else out + x
        with torch.autocast(out.device.type, enabled=False):
            logits = self.predictor(out.float())
            return F.interpolate(logits, scale_factor=self.common_stride, mode="bilinear", align_corners=False)


def build_sem_seg_head(cfg: CfgNode, in_channels: int) -> SemSegFPNHead:
    """``SEM_SEG_HEAD``'s head on FPN maps of ``in_channels``; the DeepLab
    heads and PointRend raise naming their ROADMAP items."""
    s = cfg.MODEL.SEM_SEG_HEAD
    if s.NAME in QUEUED_SEM_SEG_HEADS:
        raise NotImplementedError(f"SEM_SEG_HEAD.NAME {s.NAME} is not ported yet (ROADMAP "
                                  f"{QUEUED_SEM_SEG_HEADS[s.NAME]})")
    if s.NAME != "SemSegFPNHead":
        raise ValueError(f"unknown SEM_SEG_HEAD.NAME {s.NAME!r}: the port builds SemSegFPNHead")
    unknown = [f for f in s.IN_FEATURES if f not in FPN_STRIDES]
    if unknown:
        raise ValueError(f"SemSegFPNHead reads FPN levels {sorted(FPN_STRIDES)}, not {unknown}")
    return SemSegFPNHead(tuple(s.IN_FEATURES), in_channels, int(s.NUM_CLASSES), int(s.CONVS_DIM),
                         int(s.COMMON_STRIDE))


def sem_seg_loss(logits: torch.Tensor, targets: torch.Tensor, ignore_value: int = 255,
                 top_k_percent: float = 1.0) -> torch.Tensor:
    """Cross-entropy of (N, C, H, W) logits against (N, H, W) labels, an
    ``ignore_value`` pixel weighing 0: the mean over the other pixels (0
    when there are none), or with ``top_k_percent`` < 1 the mean of the
    largest ``int(top_k_percent · N·H·W)`` per-pixel losses (at least one)."""
    valid = targets != ignore_value
    ce = F.cross_entropy(logits, torch.where(valid, targets, 0).long(), reduction="none")
    ce = torch.where(valid, ce, 0.0)
    if top_k_percent < 1.0:
        flat = ce.reshape(-1)
        return flat.topk(max(1, int(top_k_percent * flat.numel()))).values.mean()
    return ce.sum() / valid.sum().clamp(min=1)


def sem_seg_labels(logits: torch.Tensor, warps: Optional[List[np.ndarray]],
                   orig_sizes: List[Tuple[int, int]]) -> torch.Tensor:
    """(N, C, H, W) logits → each image's argmax label map at its own size,
    on their device: the logits un-warped bilinearly (output pixel (x, y)
    reads the logits at the image's warp of (x, y); a corner off the map
    reads 0, as cv2's constant border: ``warp_image``'s sampling, done
    channel-major here, rows then columns, for the images of one warp and
    size at once) or, without warps, as they are. The test-time warps are
    letterboxes; a warp that is not axis-aligned raises. Returns (N, H_max,
    W_max) labels, uint8 for at most 256 classes (else int32), image i's in
    its top-left (oh, ow) corner, 0 elsewhere."""
    n, c, hin, win = logits.shape
    dtype = torch.uint8 if c <= 256 else torch.int32
    dev = logits.device
    if warps is None:
        return logits.argmax(1).to(dtype)
    sizes = [(int(h), int(w)) for h, w in orig_sizes]
    out = torch.zeros((n, max(h for h, _ in sizes), max(w for _, w in sizes)), dtype=dtype, device=dev)
    groups: Dict[Tuple, List[int]] = {}
    for i, (warp, size) in enumerate(zip(warps, sizes)):
        groups.setdefault((tuple(np.asarray(warp, np.float64).reshape(-1)), size), []).append(i)
    for (flat, (h, w)), idx in groups.items():
        m = np.asarray(flat).reshape(2, 3)
        if m[0, 1] != 0 or m[1, 0] != 0:
            raise ValueError(f"the sem-seg logits are un-warped from axis-aligned test-time warps only, got {m}")
        lg = logits if len(idx) == n else logits[idx]  # (G, C, H, W); the whole batch without a copy
        ys = torch.arange(h, device=dev, dtype=torch.float32)
        xs = torch.arange(w, device=dev, dtype=torch.float32)
        y0, y1, wy0, wy1 = _axis_weights(float(m[1, 1]) * ys + float(m[1, 2]), hin)
        x0, x1, wx0, wx1 = _axis_weights(float(m[0, 0]) * xs + float(m[0, 2]), win)
        rows = lg[:, :, y0] * wy0[:, None] + lg[:, :, y1] * wy1[:, None]  # (G, C, h, W)
        out[idx, :h, :w] = (rows[..., x0] * wx0 + rows[..., x1] * wx1).argmax(1).to(dtype)
    return out


class SemSegModel(nn.Module):
    """The backbone and ``sem_seg_head``: normalized (N, 3, H, W) → f32
    logits (N, classes, H, W). Convolutions run at ``dtype`` under
    autocast (f32 ones in IEEE f32); the predictor in f32."""

    def __init__(self, backbone: nn.Module, sem_seg_head: SemSegFPNHead):
        super().__init__()
        self.dtype = torch.float32
        self.backbone = backbone
        self.sem_seg_head = sem_seg_head

    def cast(self, dtype: torch.dtype) -> "SemSegModel":
        self.dtype = dtype
        return self

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        with ieee_f32(), torch.autocast(images.device.type, dtype=self.dtype,
                                        enabled=self.dtype != torch.float32):
            return self.sem_seg_head(self.backbone(images.to(self.dtype)))


@META_ARCH_REGISTRY.register()
class SemanticSegmentor:
    """Semantic FPN: the network on its device, the normalization, the loss,
    the inference and the host boundary."""

    def __init__(self, cfg: CfgNode) -> None:
        s = cfg.MODEL.SEM_SEG_HEAD
        self.device = resolve_device(cfg.MODEL.DEVICE)
        self.device_augment = None  # the step's batch augmentation; models/build.py attaches it
        self.dtype = torch.bfloat16 if cfg.TPU.DTYPE == "bfloat16" else torch.float32
        self.num_classes = int(s.NUM_CLASSES)
        self.ignore_value = int(s.IGNORE_VALUE)
        self.loss_weight = float(s.LOSS_WEIGHT)
        # DeepLab's hard pixel mining (JAX :289-292)
        self.loss_top_k = float(s.LOSS_TOP_K) if s.LOSS_TYPE == "hard_pixel_mining" else 1.0
        self.pixel_mean = torch.tensor(cfg.MODEL.PIXEL_MEAN, dtype=torch.float32,
                                       device=self.device).view(1, -1, 1, 1)
        self.pixel_std = torch.tensor(cfg.MODEL.PIXEL_STD, dtype=torch.float32,
                                      device=self.device).view(1, -1, 1, 1)
        backbone = BACKBONE_REGISTRY.get(cfg.MODEL.BACKBONE.NAME)(cfg)
        head = build_sem_seg_head(cfg, backbone.out_feature_channels[s.IN_FEATURES[0]])
        self.model = SemSegModel(backbone, head)
        init_weights(self.model, torch.Generator().manual_seed(max(int(cfg.SEED), 0)))
        self.model.to(self.device).cast(self.dtype).eval()

    def normalize(self, images: torch.Tensor) -> torch.Tensor:
        """(x - PIXEL_MEAN) / PIXEL_STD on 0..255 pixels."""
        return (images.to(self.device, torch.float32) - self.pixel_mean) / self.pixel_std

    def loss_fn(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total, {"loss_sem_seg"}) of a batch with ``image`` (N, 3, H, W)
        0..255 and ``sem_seg`` (N, H, W) labels, × ``LOSS_WEIGHT``."""
        logits = self.model(self.normalize(batch["image"]))
        loss = sem_seg_loss(logits, batch["sem_seg"].to(self.device), self.ignore_value,
                            self.loss_top_k) * self.loss_weight
        return loss, {"loss_sem_seg": loss}

    @torch.inference_mode()
    def predict_fn(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Raw (N, 3, H, W) 0..255 images → {"sem_seg": (N, C, H, W) f32 logits}."""
        return {"sem_seg": self.model(self.normalize(images))}

    @torch.inference_mode()
    def device_postprocess(self, dets: Dict[str, torch.Tensor], warps, orig_sizes) -> Dict[str, torch.Tensor]:
        """``dets`` with the logits replaced by the label maps of
        ``sem_seg_labels``, on the device, before they go to the host."""
        return {**dets, "sem_seg": sem_seg_labels(dets["sem_seg"], warps, orig_sizes)}

    def postprocess(self, dets: Dict[str, np.ndarray], warps, orig_sizes) -> List[Dict]:
        """Each image's {"sem_seg": (H, W) int64} at its own size (JAX
        ``:391-405``), from the label maps of ``device_postprocess``."""
        return [{"sem_seg": labels} for labels in host_label_maps(dets, warps, orig_sizes)]


def host_label_maps(dets: Dict[str, np.ndarray], warps, orig_sizes) -> List[np.ndarray]:
    """Each image's (H, W) int64 label map from ``dets["sem_seg"]``, the
    (N, H_max, W_max) label maps of ``device_postprocess``, cropped to each
    image's size."""
    labels = np.asarray(dets["sem_seg"])
    sizes = orig_sizes if warps is not None else [labels.shape[1:]] * len(labels)
    return [labels[i, :h, :w].astype(np.int64) for i, (h, w) in enumerate(sizes)]
