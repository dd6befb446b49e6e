"""Rotated boxes on the host (a copy of the JAX package's
``structures/rotated_boxes.py``; reference ``structures/rotated_boxes.py``
and the C++ polygon-clip IoU of ``layers/csrc/box_iou_rotated/
box_iou_rotated_utils.h``).

Boxes are (cx, cy, w, h, angle in degrees) with the angle counter-clockwise.
``RotatedBoxes`` is the host boundary of the rotated detections
(``RotatedRCNN.postprocess``); ``pairwise_iou_rotated`` (exact convex
intersection: Sutherland-Hodgman clip and shoelace area, in float64) and
``nms_rotated`` serve the rotated COCO evaluation (``evaluation/
cocoeval_np.py``). The model's rotated IoU and NMS run on its device
(``ops/roi_align_rotated.py``).
"""

from typing import Tuple

import numpy as np

__all__ = ["RotatedBoxes", "pairwise_iou_rotated", "nms_rotated", "rotated_box_vertices"]


def rotated_box_vertices(boxes: np.ndarray) -> np.ndarray:
    """(N, 5) -> (N, 4, 2) corner points (counter-clockwise)."""
    boxes = np.asarray(boxes, np.float64)
    cx, cy, w, h, a = boxes.T
    theta = np.deg2rad(a)
    c, s = np.cos(theta), np.sin(theta)
    dx = np.stack([w / 2, -w / 2, -w / 2, w / 2], 1)  # (N, 4)
    dy = np.stack([h / 2, h / 2, -h / 2, -h / 2], 1)
    x = cx[:, None] + dx * c[:, None] - dy * s[:, None]
    y = cy[:, None] + dx * s[:, None] + dy * c[:, None]
    return np.stack([x, y], axis=2)


def _polygon_area(poly) -> float:
    if len(poly) < 3:
        return 0.0
    p = np.asarray(poly)
    x, y = p[:, 0], p[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def _clip_polygon(subject, cx1, cy1, cx2, cy2):
    """Sutherland–Hodgman: clip ``subject`` by the half-plane left of the
    directed edge (cx1,cy1)->(cx2,cy2)."""
    out = []
    n = len(subject)
    ex, ey = cx2 - cx1, cy2 - cy1

    def inside(p):
        # vertices are ordered so the interior is on the positive-cross side
        return ex * (p[1] - cy1) - ey * (p[0] - cx1) >= -1e-12

    for i in range(n):
        cur, prev = subject[i], subject[i - 1]
        cur_in, prev_in = inside(cur), inside(prev)
        if cur_in != prev_in:
            # edge intersection
            dx, dy = cur[0] - prev[0], cur[1] - prev[1]
            denom = ex * dy - ey * dx
            if abs(denom) > 1e-12:
                t = (ex * (prev[1] - cy1) - ey * (prev[0] - cx1)) / -denom
                t = min(max(t, 0.0), 1.0)
                out.append((prev[0] + t * dx, prev[1] + t * dy))
        if cur_in:
            out.append(tuple(cur))
    return out


def _intersection_area(p1: np.ndarray, p2: np.ndarray) -> float:
    """Area of intersection of two convex quads (N=4 vertex arrays)."""
    poly = [tuple(v) for v in p1]
    for i in range(len(p2)):
        a = p2[i]
        b = p2[(i + 1) % len(p2)]
        poly = _clip_polygon(poly, a[0], a[1], b[0], b[1])
        if not poly:
            return 0.0
    return _polygon_area(poly)


def pairwise_iou_rotated(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """(N, 5) x (M, 5) -> (N, M) IoU (reference box_iou_rotated_utils.h)."""
    boxes1 = np.asarray(boxes1, np.float64).reshape(-1, 5)
    boxes2 = np.asarray(boxes2, np.float64).reshape(-1, 5)
    v1 = rotated_box_vertices(boxes1)
    v2 = rotated_box_vertices(boxes2)
    a1 = boxes1[:, 2] * boxes1[:, 3]
    a2 = boxes2[:, 2] * boxes2[:, 3]
    out = np.zeros((len(boxes1), len(boxes2)))
    for i in range(len(boxes1)):
        for j in range(len(boxes2)):
            inter = _intersection_area(v1[i], v2[j])
            union = a1[i] + a2[j] - inter
            out[i, j] = inter / union if union > 0 else 0.0
    return out


def nms_rotated(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float) -> np.ndarray:
    """Greedy rotated NMS; returns kept indices by descending score
    (reference csrc/nms_rotated)."""
    order = np.argsort(-np.asarray(scores))
    keep = []
    suppressed = np.zeros(len(order), bool)
    iou = pairwise_iou_rotated(boxes, boxes)
    for oi, i in enumerate(order):
        if suppressed[oi]:
            continue
        keep.append(int(i))
        for oj in range(oi + 1, len(order)):
            if iou[i, order[oj]] > iou_threshold:
                suppressed[oj] = True
    return np.asarray(keep, np.int64)


class RotatedBoxes:
    """(N, 5) rotated boxes (reference rotated_boxes.py:11)."""

    def __init__(self, tensor: np.ndarray) -> None:
        tensor = np.asarray(tensor, np.float32).reshape(-1, 5)
        self.tensor = tensor

    def clone(self) -> "RotatedBoxes":
        return RotatedBoxes(self.tensor.copy())

    def area(self) -> np.ndarray:
        return self.tensor[:, 2] * self.tensor[:, 3]

    def normalize_angles(self) -> None:
        self.tensor[:, 4] = (self.tensor[:, 4] + 180.0) % 360.0 - 180.0

    def clip(self, box_size: Tuple[int, int], clip_angle_threshold: float = 1.0) -> None:
        """Clip nearly-axis-aligned boxes to the image (reference
        rotated_boxes.py:240-297 only clips |angle| <= threshold)."""
        h, w = box_size
        self.normalize_angles()
        idx = np.where(np.abs(self.tensor[:, 4]) <= clip_angle_threshold)[0]
        if len(idx) == 0:
            return
        x1 = self.tensor[idx, 0] - self.tensor[idx, 2] / 2
        y1 = self.tensor[idx, 1] - self.tensor[idx, 3] / 2
        x2 = self.tensor[idx, 0] + self.tensor[idx, 2] / 2
        y2 = self.tensor[idx, 1] + self.tensor[idx, 3] / 2
        x1 = np.clip(x1, 0, w)
        y1 = np.clip(y1, 0, h)
        x2 = np.clip(x2, 0, w)
        y2 = np.clip(y2, 0, h)
        self.tensor[idx, 0] = (x1 + x2) / 2
        self.tensor[idx, 1] = (y1 + y2) / 2
        self.tensor[idx, 2] = x2 - x1
        self.tensor[idx, 3] = y2 - y1

    def nonempty(self, threshold: float = 0.0) -> np.ndarray:
        return (self.tensor[:, 2] > threshold) & (self.tensor[:, 3] > threshold)

    def inside_box(self, box_size: Tuple[int, int], boundary_threshold: int = 0) -> np.ndarray:
        h, w = box_size
        cx, cy = self.tensor[:, 0], self.tensor[:, 1]
        return (
            (cx >= -boundary_threshold)
            & (cy >= -boundary_threshold)
            & (cx < w + boundary_threshold)
            & (cy < h + boundary_threshold)
        )

    def __getitem__(self, item) -> "RotatedBoxes":
        if isinstance(item, int):
            return RotatedBoxes(self.tensor[item : item + 1])
        return RotatedBoxes(self.tensor[item])

    def __len__(self) -> int:
        return self.tensor.shape[0]

    def __repr__(self) -> str:
        return f"RotatedBoxes({self.tensor})"
