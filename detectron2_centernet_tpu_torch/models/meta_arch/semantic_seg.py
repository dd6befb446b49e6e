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

``DeepLabV3Head`` (JAX ``:64-94``): ``ASPP`` (``models/layers.py``) on
the last of ``IN_FEATURES``, an f32 1x1 predictor, a ``COMMON_STRIDE``×
bilinear upsample. ``DeepLabV3PlusHead`` (JAX ``:97-140``): ASPP on the last
feature resized bilinearly to the first's size, concatenated with a 1x1
``low_level_proj`` of 48 channels + ReLU of the first, two 3x3
``decoder{i}`` + ReLU of ``CONVS_DIM``, the f32 predictor, then
``COMMON_STRIDE``×. As in JAX, every conv has a bias and no norm, and
``SEM_SEG_HEAD.NORM``, ``ASPP_CHANNELS`` (ASPP takes ``CONVS_DIM``),
``ASPP_DROPOUT``, ``PROJECT_FEATURES`` and ``PROJECT_CHANNELS`` (48) are not
read (ROADMAP C26). Keys: the reference's ``sem_seg_head.aspp.convs.{i}``,
``.aspp.project`` and ``.predictor``; JAX's ``low_level_proj`` and
``decoder{i}``.

``PointRendSemSegHead`` (JAX ``:151-233``) around the coarse head
(``POINT_HEAD.COARSE_SEM_SEG_HEAD_NAME``; key ``coarse_sem_seg_head``) with
a ``PointHead`` (``point_head``) over the ``POINT_HEAD.IN_FEATURES`` maps
and the coarse logits. Training, given each image's uniforms (``points``:
(N, k·P, 2) candidates and (N, P - int(β·P), 2) points): the int(β·P)
candidates of least top-2 logit gap, then the uniform ones, the point
logits there. Inference refines the input-resolution logits in place
``SUBDIVISION_STEPS`` times at the ``SUBDIVISION_NUM_POINTS`` pixels of
least top-2 gap (the first on ties), not the reference's 2× rounds.
``sem_seg_point_loss`` (JAX ``:236-252``): cross-entropy of the point
logits against the label at each point's pixel (coordinates × size,
truncated), the ignored ones left out.
"""

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...config import CfgNode
from ...data.detection_utils import _axis_weights
from ..build import resolve_device
from ..layers import ASPP, GN_EPS, ieee_f32, init_weights
from ..registry import BACKBONE_REGISTRY, META_ARCH_REGISTRY
from ..roi_heads.point_head import PointHead, point_sample
from ..proposal_generator.rpn import top_k_indices

__all__ = ["DeepLabV3Head", "DeepLabV3PlusHead", "PointRendSemSegHead", "SemSegFPNHead", "SemanticSegmentor",
           "build_sem_seg_head", "host_label_maps", "sem_seg_labels", "sem_seg_loss", "sem_seg_point_loss"]

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


class DeepLabV3Head(nn.Module):
    """ASPP on the last feature, the f32 predictor, ``common_stride``×
    bilinear: {name: (N, C, H, W)} → (N, classes, H·s, W·s) f32."""

    def __init__(self, in_features: Sequence[str], in_channels: int, num_classes: int, convs_dim: int = 256,
                 common_stride: int = 16, dilations: Sequence[int] = (6, 12, 18)):
        super().__init__()
        self.in_features = tuple(in_features)
        self.common_stride = common_stride
        self.aspp = ASPP(in_channels, convs_dim, tuple(dilations))
        self.predictor = nn.Conv2d(convs_dim, num_classes, 1)

    def forward(self, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = self.aspp(features[self.in_features[-1]])
        with torch.autocast(x.device.type, enabled=False):
            logits = self.predictor(x.float())
            return F.interpolate(logits, scale_factor=self.common_stride, mode="bilinear", align_corners=False)


class DeepLabV3PlusHead(nn.Module):
    """ASPP on the last feature at the first feature's size, fused with the
    first's 48-channel projection by two 3x3 convs, the f32 predictor,
    ``common_stride``× bilinear."""

    def __init__(self, in_features: Sequence[str], low_channels: int, in_channels: int, num_classes: int,
                 convs_dim: int = 256, common_stride: int = 4, dilations: Sequence[int] = (6, 12, 18)):
        super().__init__()
        self.in_features = tuple(in_features)
        self.common_stride = common_stride
        self.aspp = ASPP(in_channels, convs_dim, tuple(dilations))
        self.low_level_proj = nn.Conv2d(low_channels, 48, 1)
        self.decoder0 = nn.Conv2d(convs_dim + 48, convs_dim, 3, padding=1)
        self.decoder1 = nn.Conv2d(convs_dim, convs_dim, 3, padding=1)
        self.predictor = nn.Conv2d(convs_dim, num_classes, 1)

    def forward(self, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        low = features[self.in_features[0]]
        x = F.interpolate(self.aspp(features[self.in_features[-1]]), size=low.shape[2:], mode="bilinear",
                          align_corners=False)
        x = torch.cat([x, F.relu(self.low_level_proj(low)).to(x.dtype)], 1)
        x = F.relu(self.decoder1(F.relu(self.decoder0(x))))
        with torch.autocast(x.device.type, enabled=False):
            logits = self.predictor(x.float())
            return F.interpolate(logits, scale_factor=self.common_stride, mode="bilinear", align_corners=False)


def top2_uncertainty(logits: torch.Tensor) -> torch.Tensor:
    """(..., C) → the second largest minus the largest (JAX
    ``_top2_uncertainty``): higher is more uncertain."""
    top2 = torch.topk(logits, 2, dim=-1).values
    return top2[..., 1] - top2[..., 0]


class PointRendSemSegHead(nn.Module):
    """The coarse head's input-resolution logits, refined by the point head
    at uncertain pixels (module docstring). ``forward(features)`` →
    refined (N, classes, H, W) f32 logits; ``forward(features, points)`` →
    (coarse logits, point logits (N, P, classes), points (N, P, 2))."""

    def __init__(self, coarse: nn.Module, in_features: Sequence[str], fine_channels: int, num_classes: int,
                 train_num_points: int, importance: float, subdivision_steps: int, subdivision_num_points: int,
                 fc_dim: int = 256, num_fc: int = 3):
        super().__init__()
        self.coarse_sem_seg_head = coarse
        self.in_features = tuple(in_features)
        self.num_classes = num_classes
        self.train_num_points = train_num_points
        self.importance = importance
        self.subdivision_steps = subdivision_steps
        self.subdivision_num_points = subdivision_num_points
        self.point_head = PointHead(fine_channels, num_classes, num_classes, fc_dim, num_fc)

    def forward(self, features: Dict[str, torch.Tensor], points: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        logits = self.coarse_sem_seg_head(features)  # (N, C, H, W) f32
        fine = torch.cat([features[f] for f in self.in_features], 1).float()
        n, c, h, w = logits.shape
        if points is not None:
            cand, rand = points
            n_imp = int(self.importance * self.train_num_points)
            with torch.no_grad():
                u = top2_uncertainty(point_sample(logits.detach(), cand))
                idx = top_k_indices(u, n_imp)
                coords = torch.cat([torch.gather(cand, 1, idx[..., None].expand(n, n_imp, 2)), rand], 1)
            point_logits = self.point_head(point_sample(fine, coords), point_sample(logits, coords))
            return logits, point_logits, coords
        k = min(self.subdivision_num_points, h * w)
        flat = logits.permute(0, 2, 3, 1).reshape(n, h * w, c)
        for _ in range(self.subdivision_steps):
            idx = top_k_indices(top2_uncertainty(flat), k)  # (N, K)
            coords = torch.stack([((idx % w).to(torch.float32) + 0.5) / w,
                                  (torch.div(idx, w, rounding_mode="floor").to(torch.float32) + 0.5) / h], -1)
            coarse = torch.gather(flat, 1, idx[..., None].expand(n, k, c))
            new = self.point_head(point_sample(fine, coords), coarse)
            flat = flat.scatter(1, idx[..., None].expand(n, k, c), new.to(flat.dtype))
        return flat.view(n, h, w, c).permute(0, 3, 1, 2)


def build_sem_seg_head(cfg: CfgNode, channels: Dict[str, int]) -> nn.Module:
    """``SEM_SEG_HEAD.NAME``'s head on maps of ``channels`` (by feature
    name): ``SemSegFPNHead`` on FPN levels, the DeepLab heads, or
    ``PointRendSemSegHead`` around ``POINT_HEAD.COARSE_SEM_SEG_HEAD_NAME``'s
    (JAX ``SemanticSegmentor.__init__``)."""
    s = cfg.MODEL.SEM_SEG_HEAD
    point_rend = s.NAME == "PointRendSemSegHead"
    name = cfg.MODEL.POINT_HEAD.COARSE_SEM_SEG_HEAD_NAME if point_rend else s.NAME
    feats = tuple(s.IN_FEATURES)
    if name == "SemSegFPNHead":
        unknown = [f for f in feats if f not in FPN_STRIDES]
        if unknown:
            raise ValueError(f"SemSegFPNHead reads FPN levels {sorted(FPN_STRIDES)}, not {unknown}")
        head = SemSegFPNHead(feats, channels[feats[0]], int(s.NUM_CLASSES), int(s.CONVS_DIM), int(s.COMMON_STRIDE))
    elif name == "DeepLabV3Head":
        head = DeepLabV3Head(feats, channels[feats[-1]], int(s.NUM_CLASSES), int(s.CONVS_DIM), int(s.COMMON_STRIDE),
                             tuple(s.ASPP_DILATIONS))
    elif name == "DeepLabV3PlusHead":
        head = DeepLabV3PlusHead(feats, channels[feats[0]], channels[feats[-1]], int(s.NUM_CLASSES),
                                 int(s.CONVS_DIM), int(s.COMMON_STRIDE), tuple(s.ASPP_DILATIONS))
    else:
        raise ValueError(f"unknown sem-seg head {name!r}: SemSegFPNHead, DeepLabV3Head, DeepLabV3PlusHead or "
                         "PointRendSemSegHead around one of them")
    if not point_rend:
        return head
    ph = cfg.MODEL.POINT_HEAD
    return PointRendSemSegHead(head, tuple(ph.IN_FEATURES), sum(channels[f] for f in ph.IN_FEATURES),
                               int(s.NUM_CLASSES), int(ph.TRAIN_NUM_POINTS), float(ph.IMPORTANCE_SAMPLE_RATIO),
                               int(ph.SUBDIVISION_STEPS), int(ph.SUBDIVISION_NUM_POINTS), int(ph.FC_DIM),
                               int(ph.NUM_FC))


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


def sem_seg_point_loss(point_logits: torch.Tensor, point_coords: torch.Tensor, targets: torch.Tensor,
                       ignore_value: int = 255) -> torch.Tensor:
    """Cross-entropy of (N, P, C) point logits against the (N, H, W) labels
    at each point's pixel (x · W and y · H truncated, clamped), over the
    points whose label is not ``ignore_value`` (0 when there are none)."""
    n, h, w = targets.shape
    xs = torch.clamp((point_coords[..., 0] * w).to(torch.int64), 0, w - 1)
    ys = torch.clamp((point_coords[..., 1] * h).to(torch.int64), 0, h - 1)
    t = torch.gather(targets.reshape(n, h * w), 1, ys * w + xs)
    valid = t != ignore_value
    ce = F.cross_entropy(point_logits.transpose(1, 2), torch.where(valid, t, 0).long(), reduction="none")
    return torch.where(valid, ce, 0.0).sum() / valid.sum().clamp(min=1)


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
    logits (N, classes, H, W); with ``points`` PointRend's training outputs.
    Convolutions run at ``dtype`` under autocast (f32 ones in IEEE f32); the
    predictor in f32."""

    def __init__(self, backbone: nn.Module, sem_seg_head: nn.Module):
        super().__init__()
        self.dtype = torch.float32
        self.backbone = backbone
        self.sem_seg_head = sem_seg_head

    def cast(self, dtype: torch.dtype) -> "SemSegModel":
        self.dtype = dtype
        return self

    def forward(self, images: torch.Tensor, points=None):
        with ieee_f32(), torch.autocast(images.device.type, dtype=self.dtype,
                                        enabled=self.dtype != torch.float32):
            feats = self.backbone(images.to(self.dtype))
            return self.sem_seg_head(feats) if points is None else self.sem_seg_head(feats, points)


@META_ARCH_REGISTRY.register()
class SemanticSegmentor:
    """Semantic FPN, DeepLab and PointRend's semantic head: the network on
    its device, the normalization, the loss, the inference and the host
    boundary."""

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
        self.point_rend = s.NAME == "PointRendSemSegHead"
        ph = cfg.MODEL.POINT_HEAD
        self.point_draws = (int(ph.OVERSAMPLE_RATIO) * int(ph.TRAIN_NUM_POINTS),
                            int(ph.TRAIN_NUM_POINTS) - int(float(ph.IMPORTANCE_SAMPLE_RATIO) * int(ph.TRAIN_NUM_POINTS)))
        backbone = BACKBONE_REGISTRY.get(cfg.MODEL.BACKBONE.NAME)(cfg)
        head = build_sem_seg_head(cfg, backbone.out_feature_channels)
        self.model = SemSegModel(backbone, head)
        init_weights(self.model, torch.Generator().manual_seed(max(int(cfg.SEED), 0)))
        self.model.to(self.device).cast(self.dtype).eval()

    def normalize(self, images: torch.Tensor) -> torch.Tensor:
        """(x - PIXEL_MEAN) / PIXEL_STD on 0..255 pixels."""
        return (images.to(self.device, torch.float32) - self.pixel_mean) / self.pixel_std

    def point_uniforms(self, batch: Dict, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """PointRend's training uniforms: ``batch["draws"]``'s "point_cand"
        (N, k·P, 2) and "point_rand" (N, P - int(β·P), 2) (the tests hand in
        JAX's), else drawn in that order from ``batch["generator"]``."""
        draws = batch.get("draws")
        if draws is not None:
            return tuple(draws[k].to(self.device, torch.float32) for k in ("point_cand", "point_rand"))
        generator = batch.get("generator")
        if generator is None:
            raise ValueError("a PointRend training batch needs its uniforms: give batch['draws'] or "
                             "batch['generator'] (SimpleTrainer seeds one per step)")
        return tuple(torch.rand((n, m, 2), generator=generator, device=self.device) for m in self.point_draws)

    def loss_fn(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total, {"loss_sem_seg"}) of a batch with ``image`` (N, 3, H, W)
        0..255 and ``sem_seg`` (N, H, W) labels, × ``LOSS_WEIGHT``; PointRend
        adds "loss_sem_seg_point" (unweighted, as in JAX)."""
        images = self.normalize(batch["image"])
        targets = batch["sem_seg"].to(self.device)
        if not self.point_rend:
            logits = self.model(images)
            loss = sem_seg_loss(logits, targets, self.ignore_value, self.loss_top_k) * self.loss_weight
            return loss, {"loss_sem_seg": loss}
        logits, point_logits, coords = self.model(images, self.point_uniforms(batch, images.shape[0]))
        loss = sem_seg_loss(logits, targets, self.ignore_value, self.loss_top_k) * self.loss_weight
        point_loss = sem_seg_point_loss(point_logits, coords, targets, self.ignore_value)
        return loss + point_loss, {"loss_sem_seg": loss, "loss_sem_seg_point": point_loss}

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
