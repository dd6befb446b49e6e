"""Keypoint structures (counterpart of the JAX package's
``structures/keypoints.py``; reference ``detectron2/structures/keypoints.py``).

``Keypoints``: (N, K, 3) x, y, visibility. ``keypoints_to_heatmap_targets``
(reference ``_keypoints_to_heatmap`` :85-142): each keypoint's cell of a
roi's heatmap, in numpy f64 as the JAX package's. ``heatmaps_to_keypoints``
(reference :145-212): each roi's maps upsampled to the roi's size by bicubic
interpolation (``F.interpolate``, a = -0.75, half-pixel centres, the border
replicated: cv2's ``INTER_CUBIC``, which the JAX package calls), the argmax,
and the score normalised by the softmax sum at the pool's resolution. It
upsamples on the device of the maps (the card at serving), in f64, so the
card and the CPU pick the same cells but at ties; against cv2's f32 a cell
can move only where two upsampled values tie to its rounding
(``tests/test_torch_keypoint.py`` bounds how often, ROADMAP C17).
"""

import math
from typing import List, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["Keypoints", "heatmaps_to_keypoints", "keypoints_to_heatmap_targets"]


class Keypoints:
    """(N, K, 3) keypoints: (x, y, visibility)."""

    def __init__(self, keypoints: Union[np.ndarray, List]) -> None:
        keypoints = np.asarray(keypoints, np.float32)
        assert keypoints.ndim == 3 and keypoints.shape[2] == 3, keypoints.shape
        self.tensor = keypoints

    def __len__(self) -> int:
        return self.tensor.shape[0]

    def __getitem__(self, item) -> "Keypoints":
        if isinstance(item, int):
            return Keypoints(self.tensor[item: item + 1])
        return Keypoints(self.tensor[item])

    def to_heatmap(self, boxes: np.ndarray, heatmap_size: int) -> Tuple[np.ndarray, np.ndarray]:
        return keypoints_to_heatmap_targets(self.tensor, boxes, heatmap_size)

    def __repr__(self) -> str:
        return f"Keypoints(num_instances={len(self)})"


def keypoints_to_heatmap_targets(keypoints: np.ndarray, rois: np.ndarray,
                                 heatmap_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(N, K, 3) keypoints in (N, 4) XYXY rois → (flat cell index (N, K)
    int64, 0 where invalid; validity (N, K) int64): visible and inside the
    roi, a keypoint on the roi's far edge in its last cell."""
    kp = np.asarray(keypoints, np.float64)
    rois = np.asarray(rois, np.float64)
    offset_x = rois[:, 0][:, None]
    offset_y = rois[:, 1][:, None]
    scale_x = heatmap_size / np.maximum(rois[:, 2] - rois[:, 0], 1e-6)[:, None]
    scale_y = heatmap_size / np.maximum(rois[:, 3] - rois[:, 1], 1e-6)[:, None]
    x = (kp[..., 0] - offset_x) * scale_x
    y = (kp[..., 1] - offset_y) * scale_y
    x_boundary = x == heatmap_size
    y_boundary = y == heatmap_size
    x = np.floor(x)
    y = np.floor(y)
    x[x_boundary] = heatmap_size - 1
    y[y_boundary] = heatmap_size - 1
    valid_loc = (x >= 0) & (y >= 0) & (x < heatmap_size) & (y < heatmap_size)
    valid = (valid_loc & (kp[..., 2] > 0)).astype(np.int64)
    heatmaps = (y * heatmap_size + x).astype(np.int64)
    heatmaps[valid == 0] = 0
    return heatmaps, valid


def heatmaps_to_keypoints(maps: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
    """(N, K, H, W) heatmap logits of (N, 4) XYXY rois → (N, K, 4) f64
    (x, y, logit, score) in the rois' coordinates, on the host. Each roi's
    maps go up to (ceil(roi h), ceil(roi w)) (at least 1 × 1; the roi at
    least 1 px a side) on the maps' device, the argmax (the first maximum)
    is the cell, its centre the position; the score is 1 / Σ exp(maps - the
    upsampled max) over the pool-resolution maps. The positions are
    computed on the host, as the JAX package's numpy computes them (a card
    divides by a host scalar through its reciprocal)."""
    n, k = maps.shape[:2]
    r32 = torch.as_tensor(rois).detach().to("cpu", torch.float32)
    sides = torch.stack([r32[:, 2] - r32[:, 0], r32[:, 3] - r32[:, 1]], 1).tolist()  # in f32, as the JAX package's
    maps = maps.detach().to(torch.float64)
    cells = torch.zeros((n, k), dtype=torch.int64, device=maps.device)
    values = torch.zeros((n, 2, k), dtype=torch.float64, device=maps.device)  # the max logit, the score
    grids = []
    for i, (w, h) in enumerate(sides):
        roi_w, roi_h = max(w, 1.0), max(h, 1.0)
        up_w, up_h = max(math.ceil(roi_w), 1), max(math.ceil(roi_h), 1)
        up = F.interpolate(maps[i: i + 1], size=(up_h, up_w), mode="bicubic", align_corners=False)[0]
        mx, cells[i] = up.reshape(k, -1).max(1)
        values[i, 0] = mx
        values[i, 1] = 1.0 / torch.exp(maps[i] - mx[:, None, None]).sum((1, 2))
        grids.append((roi_w, roi_h, up_w, up_h))
    cells, values = cells.cpu(), values.cpu()
    out = torch.zeros((n, k, 4), dtype=torch.float64)
    for i, ((x0, y0), (roi_w, roi_h, up_w, up_h)) in enumerate(zip(r32[:, :2].tolist(), grids)):
        out[i, :, 0] = x0 + ((cells[i] % up_w).to(torch.float64) + 0.5) * roi_w / up_w
        out[i, :, 1] = y0 + ((cells[i] // up_w).to(torch.float64) + 0.5) * roi_h / up_h
    out[:, :, 2:] = values.transpose(1, 2)
    return out
