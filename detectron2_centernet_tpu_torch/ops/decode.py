"""CenterNet NMS-free detection decode (counterpart of the JAX package's
``ops/decode.py``), NCHW.

3x3 max-pool peak suppression, then one exact top-K over the
(class, y, x)-flattened heatmap, the sub-pixel offset add, the wh gather and
the box assembly scaled by the down ratio. The TPU's approximate top-k
(``approx_max_k``) has no counterpart: selection is always exact.

``torch.topk`` does not promise the order of equal scores, where
``jax.lax.top_k`` takes the lower index first; suppressed pixels (exactly 0)
and clipped ones (exactly 1e-4) tie, so callers compare detections above a
score threshold.
"""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def heat_nms(hm: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """Keep only the local maxima of an (N, C, H, W) heatmap; ``max_pool2d``
    pads with -inf, as the JAX ``reduce_window`` does."""
    hmax = F.max_pool2d(hm, kernel, stride=1, padding=(kernel - 1) // 2)
    return torch.where(hmax == hm, hm, torch.zeros_like(hm))


def ctdet_decode(
    hm: torch.Tensor,  # (N, C, H, W) sigmoided and clamped heatmap
    wh: torch.Tensor,  # (N, 2, H, W)
    reg: torch.Tensor,  # (N, 2, H, W)
    k: int = 100,
    down_ratio: int = 4,
    score_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k detections per image: (boxes (N, K, 4) XYXY in input pixels,
    scores (N, K) f32, classes (N, K) int32), by descending score.

    ``score_dtype`` runs the suppression and the top-k at that width (the
    bf16 model's default, as in the JAX package); boxes are always gathered
    and computed in f32."""
    n, c, h, w = hm.shape
    if score_dtype is not None:
        hm = hm.to(score_dtype)
    flat = heat_nms(hm).reshape(n, c * h * w)  # NCHW flattening = (class, y, x)
    scores, inds = torch.topk(flat, k, dim=1)
    scores = scores.to(torch.float32)
    classes = (inds // (h * w)).to(torch.int32)
    pix = inds % (h * w)
    ys = (pix // w).to(torch.float32)
    xs = (pix % w).to(torch.float32)
    idx = pix[:, None, :].expand(n, 2, k)
    reg_k = reg.reshape(n, 2, h * w).to(torch.float32).gather(2, idx)  # (N, 2, K)
    wh_k = wh.reshape(n, 2, h * w).to(torch.float32).gather(2, idx)
    xs = xs + reg_k[:, 0]
    ys = ys + reg_k[:, 1]
    half_w = wh_k[:, 0] / 2
    half_h = wh_k[:, 1] / 2
    boxes = torch.stack([xs - half_w, ys - half_h, xs + half_w, ys + half_h], dim=2)
    return boxes * float(down_ratio), scores, classes
