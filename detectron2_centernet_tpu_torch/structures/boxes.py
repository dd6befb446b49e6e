"""Boxes (a copy of the JAX package's ``structures/boxes.py::Boxes``).

Host-side and numpy-backed: the decode's fixed-size device output becomes
``Boxes`` at the host boundary (``CenterNet.postprocess``). ``BoxMode``
converts between the two absolute axis-aligned modes the train mapper reads;
the relative and rotated modes and the pairwise overlaps are not copied yet.
"""

from enum import IntEnum
from typing import List, Tuple

import numpy as np


class BoxMode(IntEnum):
    """Coordinate conventions for a box, the reference enum's values."""

    XYXY_ABS = 0
    XYWH_ABS = 1
    XYXY_REL = 2
    XYWH_REL = 3
    XYWHA_ABS = 4

    @staticmethod
    def convert(box, from_mode: "BoxMode", to_mode: "BoxMode") -> np.ndarray:
        """XYXY_ABS <-> XYWH_ABS of a (4,) box or (N, 4) boxes, as float64."""
        arr = np.array(box, dtype=np.float64)
        modes = {BoxMode.XYXY_ABS, BoxMode.XYWH_ABS}
        if from_mode not in modes or to_mode not in modes:
            raise NotImplementedError(f"BoxMode {from_mode} -> {to_mode} is not ported")
        if from_mode == to_mode:
            return arr
        flat = arr.reshape(-1, 4)
        sign = 1.0 if from_mode == BoxMode.XYWH_ABS else -1.0
        flat[:, 2:] += sign * flat[:, :2]
        return flat.reshape(arr.shape)


class Boxes:
    """A list of boxes stored as an ``(N, 4)`` float array in XYXY_ABS order."""

    def __init__(self, tensor: np.ndarray) -> None:
        tensor = np.asarray(tensor, dtype=np.float32)
        if tensor.size == 0:
            tensor = tensor.reshape((0, 4))
        assert tensor.ndim == 2 and tensor.shape[-1] == 4, tensor.shape
        self.tensor = tensor

    def clone(self) -> "Boxes":
        return Boxes(self.tensor.copy())

    def area(self) -> np.ndarray:
        box = self.tensor
        return (box[:, 2] - box[:, 0]) * (box[:, 3] - box[:, 1])

    def clip(self, box_size: Tuple[int, int]) -> None:
        """Clip coordinates in-place to ``[0, w] x [0, h]``; size is (h, w)."""
        assert np.isfinite(self.tensor).all(), "Box tensor contains infinite or NaN!"
        h, w = box_size
        self.tensor[:, 0] = self.tensor[:, 0].clip(0, w)
        self.tensor[:, 1] = self.tensor[:, 1].clip(0, h)
        self.tensor[:, 2] = self.tensor[:, 2].clip(0, w)
        self.tensor[:, 3] = self.tensor[:, 3].clip(0, h)

    def nonempty(self, threshold: float = 0.0) -> np.ndarray:
        box = self.tensor
        widths = box[:, 2] - box[:, 0]
        heights = box[:, 3] - box[:, 1]
        return (widths > threshold) & (heights > threshold)

    def scale(self, scale_x: float, scale_y: float) -> None:
        self.tensor[:, 0::2] *= scale_x
        self.tensor[:, 1::2] *= scale_y

    def get_centers(self) -> np.ndarray:
        return (self.tensor[:, :2] + self.tensor[:, 2:]) / 2

    def inside_box(self, box_size: Tuple[int, int], boundary_threshold: int = 0) -> np.ndarray:
        h, w = box_size
        return (
            (self.tensor[:, 0] >= -boundary_threshold)
            & (self.tensor[:, 1] >= -boundary_threshold)
            & (self.tensor[:, 2] < w + boundary_threshold)
            & (self.tensor[:, 3] < h + boundary_threshold)
        )

    def __getitem__(self, item) -> "Boxes":
        if isinstance(item, int):
            return Boxes(self.tensor[item : item + 1])
        b = self.tensor[item]
        assert b.ndim == 2, f"Indexing on Boxes with {item} failed!"
        return Boxes(b)

    def __len__(self) -> int:
        return self.tensor.shape[0]

    def __iter__(self):
        yield from self.tensor

    def __repr__(self) -> str:
        return "Boxes(" + str(self.tensor) + ")"

    @classmethod
    def cat(cls, boxes_list: List["Boxes"]) -> "Boxes":
        if len(boxes_list) == 0:
            return cls(np.zeros((0, 4), dtype=np.float32))
        return cls(np.concatenate([b.tensor for b in boxes_list], axis=0))
