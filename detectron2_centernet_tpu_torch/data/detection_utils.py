"""Affine warp geometry, the image warp and the box annotations (host numpy
+ PyTorch).

Counterpart of the JAX package's ``data/detection_utils.py`` for the ctdet
paths: one 2x3 matrix M maps original-image pixels to network-input pixels,
boxes warp with the same M, and its inverse un-maps predicted boxes at the
host boundary (``CenterNet.postprocess``). At training, the annotations
become a fixed number of box slots (``pad_to_capacity``).

``warp_image`` differs in mechanism, not in meaning: the JAX package calls
``cv2.warpAffine``; the port samples bilinearly in PyTorch (on whatever
device the caller names), with zero fill outside the source. cv2 quantizes
sample positions to 1/32 px, so the two agree to that quantization, not
bit for bit.
"""

from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..structures import BoxMode


def read_image(file_name: str, format: Optional[str] = None) -> np.ndarray:
    """(H, W, 3) uint8 in ``format`` ("BGR" or "RGB") from an image file.
    PIL is imported here, not with the module: the card's machine may lack
    it, and the synthetic datasets carry their pixels."""
    from PIL import Image

    with Image.open(file_name) as im:
        arr = np.asarray(im.convert("RGB"))
    return arr[:, :, ::-1].copy() if format == "BGR" else arr


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
