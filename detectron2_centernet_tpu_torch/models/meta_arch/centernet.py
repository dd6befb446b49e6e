"""CenterNet ("Objects as Points", ctdet) inference, counterpart of the JAX
package's ``models/meta_arch/centernet.py``.

``CenterNetModel`` is the network (backbone → hm/reg/wh heads, NCHW);
``CenterNet`` owns it on ``cfg.MODEL.DEVICE`` with the normalization, the
fixed-size decode (``predict_fn``) and the host boundary (``postprocess``).
Training (targets, losses) is not ported yet.

The number of classes is ``MODEL.CENTERNET.TASK.HM``: the port has no dataset
catalog, where the JAX package takes the class count of a registered
``DATASETS.TRAIN`` (80 for COCO, the default of ``TASK.HM``).
"""

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ...config import CfgNode
from ...data.detection_utils import unwarp_boxes
from ...ops.decode import ctdet_decode
from ...structures import Boxes, Instances
from ..build import resolve_device
from ..layers import init_weights
from ..registry import BACKBONE_REGISTRY, META_ARCH_REGISTRY

HM_BIAS = -2.19  # -log((1 - 0.1) / 0.1): the initial heatmap probability is ~0.1


class CenterNetHead(nn.Sequential):
    """3x3 conv(head_conv) → ReLU → kxk conv, the reference's head tower
    (keys ``.0`` and ``.2``). The last conv runs in f32 whatever the model's
    width, as the JAX head does: head outputs stay f32 for the decode."""

    def __init__(self, cin: int, head_conv: int, nout: int, final_kernel: int):
        super().__init__(
            nn.Conv2d(cin, head_conv, 3, padding=1),
            nn.ReLU(inplace=True),
            nn.Conv2d(head_conv, nout, final_kernel, padding=final_kernel // 2),
        )

    def forward(self, y):
        return self[2](self[1](self[0](y)).float())


class CenterNetModel(nn.Module):
    """backbone → heads. Input: normalized (N, 3, H, W) images."""

    def __init__(self, backbone: nn.Module, heads: Tuple[Tuple[str, int], ...],
                 head_conv: int = 256, final_kernel: int = 1):
        super().__init__()
        if head_conv <= 0:
            raise ValueError("the port's CenterNet heads need MODEL.CENTERNET.HEAD_CONV > 0")
        self.backbone = backbone
        self.head_names = tuple(name for name, _ in heads)
        for name, nout in heads:
            setattr(self, name, CenterNetHead(backbone.out_channels, head_conv, nout, final_kernel))

    def cast(self, dtype: torch.dtype) -> "CenterNetModel":
        """Compute width of everything but the heads' last convs (kept f32)."""
        self.to(dtype)
        for name in self.head_names:
            getattr(self, name)[2].float()
        return self

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        y = self.backbone(images.to(self.hm[0].weight.dtype))
        return {name: getattr(self, name)(y) for name in self.head_names}


@META_ARCH_REGISTRY.register()
class CenterNet:
    """The ctdet meta-architecture: the network on its device, the
    normalization, the decode and the host boundary."""

    def __init__(self, cfg: CfgNode) -> None:
        c = cfg.MODEL.CENTERNET
        self.device = resolve_device(cfg.MODEL.DEVICE)
        self.num_classes = int(c.TASK.HM)
        self.down_ratio = int(c.DOWN_RATIO)
        self.score_threshold = float(c.SCORE_THRESH_TEST)
        self.topk_candidates = int(c.TOPK_CANDIDATES_TEST)
        self.max_detections = int(cfg.TEST.DETECTIONS_PER_IMAGE)
        # TEST.EXACT_MODE pins f32 decode scores; TPU.APPROX_TOPK has no
        # counterpart (top-k is always exact here)
        self.exact_mode = bool(cfg.TEST.EXACT_MODE)
        self.dtype = torch.bfloat16 if cfg.TPU.DTYPE == "bfloat16" else torch.float32
        self.pixel_mean = torch.tensor(cfg.MODEL.PIXEL_MEAN, dtype=torch.float32,
                                       device=self.device).view(1, -1, 1, 1)
        self.pixel_std = torch.tensor(cfg.MODEL.PIXEL_STD, dtype=torch.float32,
                                      device=self.device).view(1, -1, 1, 1)

        backbone = BACKBONE_REGISTRY.get(cfg.MODEL.BACKBONE.NAME)(cfg)
        heads = (("hm", self.num_classes), ("reg", 2), ("wh", 2))
        self.model = CenterNetModel(backbone, heads, int(c.HEAD_CONV), int(c.FINAL_KERNEL))
        init_weights(self.model, torch.Generator().manual_seed(max(int(cfg.SEED), 0)))
        with torch.no_grad():
            self.model.hm[2].bias.fill_(HM_BIAS)
        self.model.to(self.device).cast(self.dtype).eval()

    def normalize(self, images: torch.Tensor) -> torch.Tensor:
        """x/255, then (x - mean)/std (ctdet configs carry 0-1 scale mean/std)."""
        x = images.to(self.device, torch.float32) / 255.0
        return (x - self.pixel_mean) / self.pixel_std

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
