"""Anchor generation (counterpart of the JAX package's ``models/anchors.py``;
reference ``modeling/anchor_generator.py``).

``DefaultAnchorGenerator``: per level, the cell anchors of sizes ×
aspect ratios centered at ``(offset + i) · stride``, broadcast over the
feature grid in ``(H·W, A)`` order. numpy, as in the JAX package: anchors
depend only on the grid sizes, so the meta-architecture moves them to its
device once per input size and keeps them. ``RotatedAnchorGenerator``:
sizes × aspect ratios × angles → (cx, cy, w, h, angle) cell anchors, sizes
outer, angles inner, the same grid (the RRPN's, cached by the
meta-architecture the same way).
"""

import math
from typing import List, Sequence, Tuple

import numpy as np

from ..config import CfgNode

__all__ = ["DefaultAnchorGenerator", "RotatedAnchorGenerator", "build_anchor_generator"]


def _cell_anchors(sizes: Sequence[float], aspect_ratios: Sequence[float]) -> np.ndarray:
    """(A, 4) XYXY anchors centered at the origin, sizes outer, ratios inner."""
    anchors = []
    for size in sizes:
        area = size ** 2.0
        for ar in aspect_ratios:
            w = math.sqrt(area / ar)
            h = ar * w
            anchors.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.asarray(anchors, np.float32)


class DefaultAnchorGenerator:
    def __init__(self, sizes: Sequence[Sequence[float]], aspect_ratios: Sequence[Sequence[float]],
                 strides: Sequence[int], offset: float = 0.0) -> None:
        num_levels = len(strides)
        # a single size or ratio list serves every level
        if len(sizes) == 1:
            sizes = list(sizes) * num_levels
        if len(aspect_ratios) == 1:
            aspect_ratios = list(aspect_ratios) * num_levels
        if len(sizes) != num_levels or len(aspect_ratios) != num_levels:
            raise ValueError(f"anchor sizes ({len(sizes)} lists) and aspect ratios ({len(aspect_ratios)}) must "
                             f"give one list or one per level ({num_levels})")
        self.strides = list(strides)
        self.cell_anchors = [_cell_anchors(s, a) for s, a in zip(sizes, aspect_ratios)]
        self.offset = offset

    @property
    def num_anchors(self) -> List[int]:
        return [len(c) for c in self.cell_anchors]

    def grid_anchors(self, grid_sizes: Sequence[Tuple[int, int]]) -> List[np.ndarray]:
        """Per level: (H·W·A, 4) XYXY anchors for the given feature grids."""
        out = []
        for (h, w), stride, cells in zip(grid_sizes, self.strides, self.cell_anchors):
            shift_x = (np.arange(w, dtype=np.float32) + self.offset) * stride
            shift_y = (np.arange(h, dtype=np.float32) + self.offset) * stride
            sx, sy = np.meshgrid(shift_x, shift_y)
            shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)  # (HW, 1, 4)
            out.append((shifts + cells[None]).reshape(-1, 4))
        return out

    def __call__(self, grid_sizes: Sequence[Tuple[int, int]]) -> np.ndarray:
        """All levels concatenated: (Σ H·W·A, 4)."""
        return np.concatenate(self.grid_anchors(grid_sizes), axis=0)


def build_anchor_generator(cfg: CfgNode, strides: Sequence[int]) -> DefaultAnchorGenerator:
    a = cfg.MODEL.ANCHOR_GENERATOR
    return DefaultAnchorGenerator(sizes=a.SIZES, aspect_ratios=a.ASPECT_RATIOS, strides=strides,
                                  offset=a.OFFSET)


class RotatedAnchorGenerator:
    """Rotated cell anchors (JAX ``RotatedAnchorGenerator``; reference
    anchor_generator.py:232): per level (A, 5) = sizes × ratios × angles."""

    def __init__(self, sizes: Sequence[Sequence[float]], aspect_ratios: Sequence[Sequence[float]],
                 angles: Sequence[Sequence[float]], strides: Sequence[int], offset: float = 0.5) -> None:
        num_levels = len(strides)
        sizes, aspect_ratios, angles = (list(v) * num_levels if len(v) == 1 else list(v)
                                        for v in (sizes, aspect_ratios, angles))
        if not len(sizes) == len(aspect_ratios) == len(angles) == num_levels:
            raise ValueError(f"anchor sizes ({len(sizes)} lists), aspect ratios ({len(aspect_ratios)}) and angles "
                             f"({len(angles)}) must give one list or one per level ({num_levels})")
        self.strides = list(strides)
        self.offset = offset
        self.cell_anchors = []
        for s_l, a_l, an_l in zip(sizes, aspect_ratios, angles):
            cells = []
            for size in s_l:
                area = size ** 2.0
                for ar in a_l:
                    w = math.sqrt(area / ar)
                    cells += [[0.0, 0.0, w, ar * w, float(ang)] for ang in an_l]
            self.cell_anchors.append(np.asarray(cells, np.float32))

    @property
    def num_anchors(self) -> List[int]:
        return [len(c) for c in self.cell_anchors]

    def grid_anchors(self, grid_sizes: Sequence[Tuple[int, int]]) -> List[np.ndarray]:
        """Per level: (H·W·A, 5) anchors for the given feature grids."""
        out = []
        for (h, w), stride, cells in zip(grid_sizes, self.strides, self.cell_anchors):
            shift_x = (np.arange(w, dtype=np.float32) + self.offset) * stride
            shift_y = (np.arange(h, dtype=np.float32) + self.offset) * stride
            sx, sy = np.meshgrid(shift_x, shift_y)
            zero = np.zeros_like(sx)
            shifts = np.stack([sx, sy, zero, zero, zero], axis=-1).reshape(-1, 1, 5)
            out.append((shifts + cells[None]).reshape(-1, 5))
        return out

    def __call__(self, grid_sizes: Sequence[Tuple[int, int]]) -> np.ndarray:
        return np.concatenate(self.grid_anchors(grid_sizes), axis=0)
