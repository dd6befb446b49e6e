"""Geometry as one affine matrix: the ctdet letterbox (eval) and the
scale/shift/flip augmentation (train).

Counterpart of the JAX package's ``data/transforms.py::letterbox_transform``
and ``CenterAffineAug``. The host photometric jitter, crop, extent and
rotation are not ported: the port jitters colors on the device
(``ops/photometric.py``), and nothing on its path crops or rotates.
"""

from typing import Optional, Tuple

import numpy as np

from .detection_utils import get_affine_transform


def letterbox_transform(height: int, width: int, out_size: Tuple[int, int]) -> np.ndarray:
    """Deterministic eval-time warp: centered, aspect-preserving
    (the ctdet test-time mapping)."""
    center = np.array([width / 2.0, height / 2.0], np.float64)
    return get_affine_transform(center, float(max(height, width)), out_size)


class CenterAffineAug:
    """Train-time geometric augmentation as one affine matrix: a random scale
    in ``scale_range`` times the letterbox scale, a random center shift up to
    ``shift_range`` of the image extent, an optional horizontal flip, all
    composed into the source → network 2x3 matrix, so boxes and image share
    one mapping. The draws and their order are the JAX package's."""

    def __init__(
        self,
        out_size: Tuple[int, int],
        scale_range: Tuple[float, float] = (0.6, 1.4),
        shift_range: float = 0.1,
        flip_prob: float = 0.5,
    ) -> None:
        self.out_size = tuple(out_size)
        self.scale_range = scale_range
        self.shift_range = shift_range
        self.flip_prob = flip_prob

    def __call__(self, height: int, width: int, rng: Optional[np.random.RandomState]) -> np.ndarray:
        center = np.array([width / 2.0, height / 2.0], np.float64)
        scale = float(max(height, width))
        if rng is not None:
            scale *= rng.uniform(*self.scale_range)
            center[0] += rng.uniform(-self.shift_range, self.shift_range) * width
            center[1] += rng.uniform(-self.shift_range, self.shift_range) * height
        m = get_affine_transform(center, scale, self.out_size)
        if rng is not None and rng.rand() < self.flip_prob:
            # flip x: x' = out_w - 1 - x, composed after the warp
            flip = np.array([[-1, 0, self.out_size[1] - 1], [0, 1, 0]], np.float64)
            m = np.concatenate([flip[:, :2] @ m[:, :2], (flip[:, :2] @ m[:, 2] + flip[:, 2])[:, None]], axis=1)
        return m
