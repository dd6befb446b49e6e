"""Host augmentation in numpy, counterpart of the JAX package's
``data/transforms.py``: the geometry as one affine matrix (the ctdet
letterbox at eval; at training the scale/shift/flip, rotation, crop and
extent, each a piece the mapper composes into one source → network 2x3
matrix, so an image is resampled once) and the host photometric jitter
(``PhotometricAug``, run when ``DATALOADER.DEVICE_PHOTOMETRIC`` is off;
else the jitter runs on the device, ``ops/photometric.py``).

Every class draws from the ``RandomState`` it is given with the JAX
package's calls in the JAX package's order, so one seed gives the JAX
matrix and the JAX jitter (``tests/test_torch_transforms.py``).
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


class PhotometricAug:
    """Contrast, brightness, saturation and PCA-lighting jitter of an (H, W,
    3) image, each applied with probability ``prob`` (the JAX package's
    ``PhotometricAug``; reference ``augmentation_impl.py:420-515``).
    Returns float32."""

    _EIGVAL = np.array([0.2141788, 0.01817699, 0.00341571], np.float32)
    _EIGVEC = np.array(
        [
            [-0.58752847, -0.69563484, 0.41340352],
            [-0.5832747, 0.00994535, -0.81221408],
            [-0.56089297, 0.71832671, 0.41158938],
        ],
        np.float32,
    )

    def __init__(self, prob: float = 0.4, contrast: Tuple[float, float] = (0.8, 1.2),
                 brightness: Tuple[float, float] = (0.8, 1.2), saturation: Tuple[float, float] = (0.8, 1.2),
                 lighting_scale: float = 0.1) -> None:
        self.prob = prob
        self.contrast = contrast
        self.brightness = brightness
        self.saturation = saturation
        self.lighting_scale = lighting_scale

    def __call__(self, image: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
        img = image.astype(np.float32)
        if rng.rand() < self.prob:  # contrast
            w = rng.uniform(*self.contrast)
            img = img.mean() * (1 - w) + img * w
        if rng.rand() < self.prob:  # brightness
            img = img * rng.uniform(*self.brightness)
        if rng.rand() < self.prob:  # saturation
            w = rng.uniform(*self.saturation)
            gray = img @ np.array([0.299, 0.587, 0.114], np.float32)
            img = gray[:, :, None] * (1 - w) + img * w
        if rng.rand() < self.prob:  # PCA lighting
            weights = rng.normal(scale=self.lighting_scale, size=3).astype(np.float32)
            img = img + self._EIGVEC @ (weights * self._EIGVAL) * 255.0
        return img


def compose_affine(outer: np.ndarray, inner: np.ndarray) -> np.ndarray:
    """2x3 matrices: apply ``inner`` first, then ``outer``."""
    return np.concatenate([outer[:, :2] @ inner[:, :2], (outer[:, :2] @ inner[:, 2] + outer[:, 2])[:, None]], axis=1)


class RandomRotationAug:
    """A rotation by a sampled angle as a source-frame affine (reference
    ``RandomRotation``, ``augmentation_impl.py:211-263``). Returns
    ``(matrix, (new_h, new_w))``: with ``expand`` the canvas grows to the
    rotated image's bound and the rotation is recentred on it."""

    def __init__(self, angle=(-10.0, 10.0), expand: bool = True, center=None, sample_style: str = "range") -> None:
        assert sample_style in ("range", "choice"), sample_style
        self.angle = tuple(angle) if not np.isscalar(angle) else (angle, angle)
        self.expand = expand
        self.center = center  # relative [[min x, min y], [max x, max y]], or None for the image centre
        self.is_range = sample_style == "range"

    def __call__(self, height: int, width: int, rng: np.random.RandomState):
        if self.is_range:
            angle = rng.uniform(self.angle[0], self.angle[1])
        else:
            angle = float(rng.choice(list(self.angle)))
        if angle % 360 == 0:
            return np.array([[1, 0, 0], [0, 1, 0]], np.float64), (height, width)
        if self.center is None:
            cx, cy = width / 2.0, height / 2.0
        else:
            (lox, loy), (hix, hiy) = self.center
            cx = width * rng.uniform(lox, hix)
            cy = height * rng.uniform(loy, hiy)
        rad = np.deg2rad(angle)
        cos, sin = np.cos(rad), np.sin(rad)
        # counter-clockwise in image coordinates (y down), cv2's convention
        m = np.array([[cos, sin, (1 - cos) * cx - sin * cy], [-sin, cos, sin * cx + (1 - cos) * cy]], np.float64)
        if not self.expand:
            return m, (height, width)
        bw = int(np.round(height * abs(sin) + width * abs(cos)))
        bh = int(np.round(height * abs(cos) + width * abs(sin)))
        m[0, 2] += bw / 2.0 - cx
        m[1, 2] += bh / 2.0 - cy
        return m, (bh, bw)


class RandomCropAug:
    """A random crop window (reference ``RandomCrop``,
    ``augmentation_impl.py:265-314``): returns an XYWH window in source
    pixels, which the mapper composes into its one matrix."""

    def __init__(self, crop_type: str, crop_size) -> None:
        assert crop_type in ("relative_range", "relative", "absolute", "absolute_range"), crop_type
        self.crop_type = crop_type
        self.crop_size = tuple(crop_size)

    def get_crop_size(self, h: int, w: int, rng: np.random.RandomState):
        if self.crop_type == "relative":
            ch, cw = self.crop_size
            return int(h * ch + 0.5), int(w * cw + 0.5)
        if self.crop_type == "relative_range":
            cs = np.asarray(self.crop_size, np.float32)
            ch, cw = cs + rng.rand(2) * (1 - cs)
            return int(h * ch + 0.5), int(w * cw + 0.5)
        if self.crop_type == "absolute":
            return min(self.crop_size[0], h), min(self.crop_size[1], w)
        assert self.crop_size[0] <= self.crop_size[1]  # absolute_range
        ch = rng.randint(min(h, self.crop_size[0]), min(h, self.crop_size[1]) + 1)
        cw = rng.randint(min(w, self.crop_size[0]), min(w, self.crop_size[1]) + 1)
        return ch, cw

    def __call__(self, height: int, width: int, rng: np.random.RandomState):
        ch, cw = self.get_crop_size(height, width, rng)
        assert height >= ch and width >= cw, (height, width, ch, cw)
        y0 = rng.randint(height - ch + 1)
        x0 = rng.randint(width - cw + 1)
        return x0, y0, cw, ch


class RandomCropCategoryAreaConstraint(RandomCropAug):
    """``RandomCropAug`` that draws again (at most 10 times) until no single
    sem-seg category fills more than ``single_category_max_area`` of the
    window (reference ``RandomCrop_CategoryAreaConstraint``,
    ``augmentation_impl.py:318-365``)."""

    def __init__(self, crop_type: str, crop_size, single_category_max_area: float = 1.0,
                 ignored_category=None) -> None:
        super().__init__(crop_type, crop_size)
        self.max_area = float(single_category_max_area)
        self.ignored = ignored_category

    def __call__(self, height: int, width: int, rng: np.random.RandomState, sem_seg: Optional[np.ndarray] = None):
        if self.max_area >= 1.0 or sem_seg is None:
            return super().__call__(height, width, rng)
        for _ in range(10):
            x0, y0, cw, ch = super().__call__(height, width, rng)
            labels, counts = np.unique(sem_seg[y0: y0 + ch, x0: x0 + cw], return_counts=True)
            if self.ignored is not None:
                counts = counts[labels != self.ignored]
            if len(counts) > 1 and counts.max() < counts.sum() * self.max_area:
                return x0, y0, cw, ch
        return x0, y0, cw, ch


class RandomExtentAug:
    """A random sub- or super-image extent around the centre (reference
    ``RandomExtent``, ``augmentation_impl.py:368-417``): the XYWH source
    rectangle, possibly beyond the image (the warp fills 0 there)."""

    def __init__(self, scale_range, shift_range) -> None:
        self.scale_range = tuple(scale_range)
        self.shift_range = tuple(shift_range)

    def __call__(self, height: int, width: int, rng: np.random.RandomState):
        rect = np.array([-0.5 * width, -0.5 * height, 0.5 * width, 0.5 * height])
        rect *= rng.uniform(self.scale_range[0], self.scale_range[1])
        rect[0::2] += self.shift_range[0] * width * (rng.rand() - 0.5)
        rect[1::2] += self.shift_range[1] * height * (rng.rand() - 0.5)
        rect[0::2] += 0.5 * width
        rect[1::2] += 0.5 * height
        x0, y0 = rect[0], rect[1]
        return x0, y0, rect[2] - x0, rect[3] - y0


def window_to_output_transform(window, out_size: Tuple[int, int]) -> np.ndarray:
    """The 2x3 matrix that maps an XYWH source window onto the output canvas."""
    x0, y0, cw, ch = window
    sx = out_size[1] / float(cw)
    sy = out_size[0] / float(ch)
    return np.array([[sx, 0, -x0 * sx], [0, sy, -y0 * sy]], np.float64)
