"""Affine warp geometry, the image warp and the box annotations (host numpy
+ PyTorch).

Counterpart of the JAX package's ``data/detection_utils.py`` for the ctdet
paths: one 2x3 matrix M maps original-image pixels to network-input pixels,
boxes warp with the same M, and its inverse un-maps predicted boxes at the
host boundary (``CenterNet.postprocess``). At training, the annotations
become a fixed number of box slots (``pad_to_capacity``).

``warp_image`` and ``fast_letterbox`` differ in mechanism, not in meaning:
the JAX package calls ``cv2.warpAffine`` and ``cv2.resize``; the port
samples bilinearly in PyTorch (the card's machine has no cv2). cv2
quantizes sample positions to 1/32 px and, for uint8, its resize weights to
11 bits, so the two agree to that quantization, not bit for bit.
"""

from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..structures import BoxMode


def read_image(file_name: str, format: Optional[str] = None) -> np.ndarray:
    """(H, W, 3) uint8 in ``format`` ("BGR" or "RGB") from an image file.
    PIL is imported here, not with the module: the card's machine may lack
    it, and the synthetic datasets carry their pixels."""
    from PIL import Image

    with Image.open(file_name) as im:
        arr = np.asarray(im.convert("RGB"))
    return arr[:, :, ::-1].copy() if format == "BGR" else arr


def read_sem_seg(file_name: str) -> np.ndarray:
    """(H, W) labels of a sem-seg PNG, as PIL gives them (the JAX mapper's
    ``np.asarray(Image.open(...))``); PIL is imported here, as in
    ``read_image``."""
    from PIL import Image

    with Image.open(file_name) as im:
        return np.asarray(im)


def check_image_size(dataset_dict: dict, image: np.ndarray) -> None:
    """Raise when the image disagrees with the record's height and width;
    fill them in when the record has none."""
    h, w = image.shape[:2]
    if "width" in dataset_dict or "height" in dataset_dict:
        if (dataset_dict.get("width"), dataset_dict.get("height")) != (w, h):
            raise ValueError(
                f"Mismatched image shape for {dataset_dict.get('file_name', '')}: "
                f"file is {w}x{h}, annotation says "
                f"{dataset_dict.get('width')}x{dataset_dict.get('height')}."
            )
    dataset_dict.setdefault("width", w)
    dataset_dict.setdefault("height", h)


def annotations_to_boxes(annos: List[dict]) -> Tuple[np.ndarray, np.ndarray]:
    """Annotation dicts → (XYXY boxes (N, 4) f32, classes (N,) int64)."""
    boxes = np.array(
        [BoxMode.convert(a["bbox"], a["bbox_mode"], BoxMode.XYXY_ABS) for a in annos],
        np.float32,
    ).reshape(-1, 4)
    classes = np.array([a["category_id"] for a in annos], np.int64)
    return boxes, classes


def pad_to_capacity(boxes: np.ndarray, classes: np.ndarray, capacity: int) -> Dict[str, np.ndarray]:
    """Fixed slots: gt_boxes (M, 4) f32, gt_classes (M,) int32, gt_valid (M,)
    bool. Objects beyond ``capacity`` are dropped (the reference caps at 128
    objects too)."""
    n = min(len(boxes), capacity)
    out_boxes = np.zeros((capacity, 4), np.float32)
    out_classes = np.zeros((capacity,), np.int32)
    out_valid = np.zeros((capacity,), bool)
    out_boxes[:n] = boxes[:n]
    out_classes[:n] = classes[:n]
    out_valid[:n] = True
    return {"gt_boxes": out_boxes, "gt_classes": out_classes, "gt_valid": out_valid}


def get_affine_transform(
    center: np.ndarray,  # (2,) crop center in source pixels
    scale: float,  # source crop extent (max side, pixels)
    out_size: Tuple[int, int],  # (out_h, out_w)
) -> np.ndarray:
    """2x3 matrix mapping source pixels -> output pixels.

    Axis-aligned scale+translate (CenterNet uses no rotation): the square
    region of side ``scale`` centred at ``center`` maps onto the output so
    that the longer normalization matches the ctdet letterbox.
    """
    out_h, out_w = out_size
    s = np.float64(scale)
    sx = out_w / s
    sy = out_h / s
    tx = out_w / 2 - sx * center[0]
    ty = out_h / 2 - sy * center[1]
    return np.array([[sx, 0, tx], [0, sy, ty]], np.float64)


def invert_affine(m: np.ndarray) -> np.ndarray:
    """Invert a 2x3 affine matrix."""
    a = m[:, :2]
    t = m[:, 2]
    ainv = np.linalg.inv(a)
    return np.concatenate([ainv, (-ainv @ t)[:, None]], axis=1)


def apply_affine_to_points(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """pts (..., 2) through a 2x3 matrix."""
    return pts @ m[:, :2].T + m[:, 2]


def apply_affine_to_boxes(m: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """XYXY boxes (N, 4) -> axis-aligned envelope of all four warped corners."""
    if len(boxes) == 0:
        return boxes
    corners = np.stack(
        [
            boxes[:, [0, 1]], boxes[:, [2, 1]],
            boxes[:, [0, 3]], boxes[:, [2, 3]],
        ],
        axis=1,
    )  # (N, 4, 2)
    warped = apply_affine_to_points(m, corners)
    lo = warped.min(axis=1)
    hi = warped.max(axis=1)
    return np.concatenate([lo, hi], axis=1)


def unwarp_boxes(m: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """Map XYXY boxes from warped (network-input) space back to source space
    through the inverse of a 2x3 warp, reordering corners (mirrored warps
    swap them)."""
    if len(boxes) == 0:
        return boxes
    return apply_affine_to_boxes(invert_affine(np.asarray(m, np.float64)), boxes)


def _axis_weights(coord: torch.Tensor, n: int):
    """Floor corners of 1-D sample positions: (i0, i1) clamped into [0, n) and
    their bilinear weights, 0 where the corner is outside."""
    c0 = torch.floor(coord)
    frac = coord - c0
    w0 = (1 - frac) * ((c0 >= 0) & (c0 < n))
    w1 = frac * ((c0 + 1 >= 0) & (c0 + 1 < n))
    return c0.clamp(0, n - 1).long(), (c0 + 1).clamp(0, n - 1).long(), w0, w1


def warp_image(
    image: Union[np.ndarray, torch.Tensor],
    m: np.ndarray,
    out_size: Tuple[int, int],
    device: Optional[Union[str, torch.device]] = None,
) -> torch.Tensor:
    """Apply the 2x3 affine ``m`` to an (H, W, C) image with bilinear sampling.

    Output pixel (x, y) reads the source at ``invert_affine(m) @ (x, y, 1)``;
    each of the four bilinear corners that falls outside the source reads 0
    (cv2's ``BORDER_CONSTANT``). Returns an (out_h, out_w, C) float32 tensor
    on ``device`` (default: the image's own device, the CPU for numpy).

    An axis-aligned ``m`` (the letterbox, and the train augmentation's scale,
    shift and flip) is separable: the rows are interpolated first, then the
    columns, two 1-D gathers in place of four 2-D ones, the same sum."""
    src = torch.as_tensor(np.ascontiguousarray(image) if isinstance(image, np.ndarray) else image)
    if device is not None:
        src = src.to(device, non_blocking=True)
    h, w, c = src.shape
    out_h, out_w = out_size
    inv = invert_affine(np.asarray(m, np.float64))
    dev = src.device
    # source coordinates in float64 on the host grid would be exact; f32 on the
    # device keeps the error far below cv2's own 1/32 px position quantization
    ys = torch.arange(out_h, device=dev, dtype=torch.float32)[:, None]
    xs = torch.arange(out_w, device=dev, dtype=torch.float32)[None, :]
    if inv[0, 1] == 0 and inv[1, 0] == 0:
        y0, y1, wy0, wy1 = _axis_weights(float(inv[1, 1]) * ys[:, 0] + float(inv[1, 2]), h)
        x0, x1, wx0, wx1 = _axis_weights(float(inv[0, 0]) * xs[0] + float(inv[0, 2]), w)
        srcf = src.to(torch.float32)
        rows = srcf[y0] * wy0[:, None, None] + srcf[y1] * wy1[:, None, None]  # (out_h, W, C)
        return rows[:, x0] * wx0[None, :, None] + rows[:, x1] * wx1[None, :, None]
    sx = float(inv[0, 0]) * xs + float(inv[0, 1]) * ys + float(inv[0, 2])
    sy = float(inv[1, 0]) * xs + float(inv[1, 1]) * ys + float(inv[1, 2])
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    lx = sx - x0
    ly = sy - y0
    flat = src.reshape(h * w, c).to(torch.float32)
    out = torch.zeros(out_h, out_w, c, device=dev, dtype=torch.float32)
    for dy, dx, wgt in (
        (0, 0, (1 - ly) * (1 - lx)),
        (0, 1, (1 - ly) * lx),
        (1, 0, ly * (1 - lx)),
        (1, 1, ly * lx),
    ):
        yy = y0 + dy
        xx = x0 + dx
        valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()
        out += flat[idx] * (wgt * valid)[..., None]
    return out


_AB_BITS = 10  # cv2 warpAffine's fixed-point fraction bits for the source coordinates (AB_BITS)


def warp_labels_nearest(labels: np.ndarray, m: np.ndarray, out_size: Tuple[int, int],
                        border: int = 255) -> np.ndarray:
    """An (H, W) label map through the 2x3 ``m`` by nearest neighbour, an
    output pixel off the source ``border``: ``cv2.warpAffine(labels, m,
    INTER_NEAREST, borderValue=border)`` pixel for pixel, which the JAX
    mapper calls. cv2 inverts ``m`` in float64, then takes each output
    pixel's source position in fixed point with 10 fraction bits, rounding
    the row's term and the column's term separately (``cvRound``, half to
    even) and adding half a unit before the shift; rounding the exact
    position instead moves labels on the regions' borders. An axis-aligned
    ``m`` (every warp but a rotation's) is separable: each output column
    reads one source column and each row one source row, gathered once.
    Returns (out_h, out_w) int32."""
    h, w = labels.shape[:2]
    out_h, out_w = out_size
    mm = np.asarray(m, np.float64).reshape(6)
    d = mm[0] * mm[4] - mm[1] * mm[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a12, a21, a22 = mm[4] * d, -mm[1] * d, -mm[3] * d, mm[0] * d
    b1 = -a11 * mm[2] - a12 * mm[5]
    b2 = -a21 * mm[2] - a22 * mm[5]
    scale = float(1 << _AB_BITS)
    xs, ys = np.arange(out_w, dtype=np.float64), np.arange(out_h, dtype=np.float64)
    adelta, bdelta = np.rint(a11 * xs * scale).astype(np.int64), np.rint(a21 * xs * scale).astype(np.int64)
    x0 = np.rint((a12 * ys + b1) * scale).astype(np.int64) + (1 << (_AB_BITS - 1))
    y0 = np.rint((a22 * ys + b2) * scale).astype(np.int64) + (1 << (_AB_BITS - 1))
    out = np.full((out_h, out_w), border, np.int32)
    if a12 == 0 and a21 == 0:  # x0 the same on every row, bdelta 0
        sx = np.clip((x0[0] + adelta) >> _AB_BITS, -32768, 32767)
        sy = np.clip(y0 >> _AB_BITS, -32768, 32767)
        cols, rows = (sx >= 0) & (sx < w), (sy >= 0) & (sy < h)
        out[np.ix_(rows, cols)] = labels[np.ix_(sy[rows], sx[cols])]
        return out
    sx = np.clip((x0[:, None] + adelta[None, :]) >> _AB_BITS, -32768, 32767)  # cv2 keeps them as shorts
    sy = np.clip((y0[:, None] + bdelta[None, :]) >> _AB_BITS, -32768, 32767)
    inside = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    out[inside] = labels[sy[inside], sx[inside]]
    return out


def fast_letterbox(image: np.ndarray, out_size: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """Centered, aspect-preserving letterbox by resize and paste (the JAX
    package's ``fast_letterbox``, there ``cv2.resize`` + paste): the source
    is resized bilinearly with the half-pixel-center convention, no
    antialiasing, to the integer paste rectangle of the source extent under
    ``letterbox_transform``, and pasted on a zero canvas.

    Returns ``(canvas, m_eff)``: the canvas in the image's dtype (uint8 is
    rounded), and the EXACT source -> canvas affine the operation applied,
    ``x_dst = s·(x_src + 0.5) - 0.5 + x0`` per axis, which differs from
    ``letterbox_transform``'s by under a pixel. Boxes un-map through
    ``m_eff``."""
    from .transforms import letterbox_transform

    h, w = image.shape[:2]
    out_h, out_w = out_size
    m = letterbox_transform(h, w, out_size)
    # paste rectangle of the source extent under the requested warp
    x0, y0 = m[0, 2], m[1, 2]
    x1, y1 = m[0, 0] * w + x0, m[1, 1] * h + y0
    xi0, yi0 = max(int(round(x0)), 0), max(int(round(y0)), 0)
    xi1, yi1 = min(int(round(x1)), out_w), min(int(round(y1)), out_h)
    rw, rh = max(xi1 - xi0, 1), max(yi1 - yi0, 1)
    src = torch.from_numpy(np.ascontiguousarray(image)).reshape(h, w, -1)
    resized = F.interpolate(src.permute(2, 0, 1)[None].to(torch.float32), size=(rh, rw),
                            mode="bilinear", align_corners=False, antialias=False)[0].permute(1, 2, 0)
    if image.dtype == np.uint8:
        resized = resized.round_().clamp_(0, 255)
    canvas = np.zeros((out_h, out_w) + image.shape[2:], image.dtype)
    canvas[yi0:yi0 + rh, xi0:xi0 + rw] = resized.numpy().astype(image.dtype).reshape((rh, rw) + image.shape[2:])
    sx, sy = rw / w, rh / h
    m_eff = np.array(
        [[sx, 0.0, xi0 + 0.5 * sx - 0.5], [0.0, sy, yi0 + 0.5 * sy - 0.5]],
        np.float64,
    )
    return canvas, m_eff


def letterbox_and_flip_variants(image: np.ndarray, sizes, flip: bool,
                                device: Optional[Union[str, torch.device]] = None):
    """Yield (warped (size, size, C) f32 tensor on ``device``, warp matrix,
    flipped?, size) for each TTA variant, as the JAX package's
    ``letterbox_and_flip_variants``: one square letterbox per size, plus the
    horizontal flip of each (``models/test_time_augmentation.py``). The flip
    is composed into the warp matrix, so inverting the matrix un-maps flipped
    detections too. The matrices are the JAX package's; the image goes
    through ``warp_image`` (bilinear in PyTorch, where JAX calls
    ``cv2.warpAffine``: ROADMAP C2)."""
    h, w = image.shape[:2]
    img_f32 = image.astype(np.float32)
    for size in sizes:
        m = get_affine_transform(np.array([w / 2.0, h / 2.0]), float(max(h, w)), (size, size))
        yield warp_image(img_f32, m, (size, size), device=device), m, False, size
        if flip:
            f = np.array([[-1.0, 0.0, size - 1.0], [0.0, 1.0, 0.0]])
            mf = np.concatenate([f[:, :2] @ m[:, :2], (f[:, :2] @ m[:, 2] + f[:, 2])[:, None]], axis=1)
            yield warp_image(img_f32, mf, (size, size), device=device), mf, True, size
