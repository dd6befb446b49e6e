"""Eval-time geometry: the ctdet letterbox as one affine matrix.

Counterpart of the JAX package's ``data/transforms.py::letterbox_transform``
(the train-time augmentations belong to the training slice).
"""

from typing import Tuple

import numpy as np

from .detection_utils import get_affine_transform


def letterbox_transform(height: int, width: int, out_size: Tuple[int, int]) -> np.ndarray:
    """Deterministic eval-time warp: centered, aspect-preserving
    (the ctdet test-time mapping)."""
    center = np.array([width / 2.0, height / 2.0], np.float64)
    return get_affine_transform(center, float(max(height, width)), out_size)
