"""Mask structures (counterpart of the JAX package's ``structures/masks.py``;
reference ``detectron2/structures/masks.py``), with no cv2.

``polygons_to_bitmask`` is OpenCV's ``fillPoly`` (8-connected, integer
vertices, no shift) written out: every edge drawn as an 8-connected
Bresenham line (``LineIterator``, left to right, clipped to the image by
``clipLine``), then the even-odd scanline fill of ``FillEdgeCollection``
in OpenCV's 16.16 fixed point. The JAX package calls cv2 there and so the
port's mask is cv2's, pixel for pixel (``tests/test_torch_mask.py``).
``resize_bilinear`` is cv2's ``INTER_LINEAR`` resize of a float map
(half-pixel centres, the border replicated), for ``BitMasks.crop_and_resize``.

``rasterize_in_box``: the training targets' gt-box-relative raster, made
once in the mapper (the device crops each sampled proposal's window out of
it, ``models/roi_heads/mask_head.py::crop_gt_masks``).

``paste_masks_in_image``: the reference's ``_do_paste_mask`` semantics
(``grid_sample(align_corners=False)`` over the sub-pixel box, zero
outside), in f64 like the JAX package's numpy, on whatever device the masks
are (the card at serving): every operation a separate IEEE f64 op, so the
thresholded masks equal the JAX package's bit for bit on the CPU and on the
card.
"""

from typing import Iterator, List, Tuple, Union

import numpy as np
import torch

from .boxes import Boxes

__all__ = [
    "BitMasks",
    "PolygonMasks",
    "paste_masks_in_image",
    "polygons_to_bitmask",
    "rasterize_in_box",
    "resize_bilinear",
]

_SHIFT = 16  # OpenCV's XY_SHIFT: polygon edges step in 16.16 fixed point
_ONE = 1 << _SHIFT


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's ``clipLine`` (int64 form): (whether any of the segment lies in
    [0, w-1] × [0, h-1], the end points as clipLine leaves them)."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    def shift(a: int, num: int, den: int) -> int:
        return int(float(a) * num / den)  # C's (int64)((double)a * num / den): truncation towards 0

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += shift(a - y1, x2 - x1, y2 - y1)
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += shift(a - y2, x2 - x1, y2 - y1)
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += shift(a - x1, y2 - y1, x2 - x1)
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += shift(a - x2, y2 - y1, x2 - x1)
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _inside(w: int, h: int, *xy: int) -> bool:
    return all(0 <= x < w for x in xy[0::2]) and all(0 <= y < h for y in xy[1::2])


def _draw_line(mask: np.ndarray, x1: int, y1: int, x2: int, y2: int) -> None:
    """OpenCV's 8-connected ``Line`` (``LineIterator``, left to right)."""
    h, w = mask.shape
    if not _inside(w, h, x1, y1, x2, y2):
        ok, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not ok:
            return
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:  # left to right
        dx, dy = -dx, -dy
        x1, y1 = x2, y2
    step_y = 1
    if dy < 0:
        dy, step_y = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x1, y1
    for _ in range(dx + 1):
        mask[y, x] = True
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if vert:
            y += step_y
            x += 1 if minor else 0
        else:
            x += 1
            y += step_y if minor else 0


def _c_div(num: int, den: int) -> int:
    """C's integer division: truncation towards 0."""
    q = abs(num) // abs(den)
    return q if (num >= 0) == (den > 0) else -q


def _collect_edges(mask: np.ndarray, pts: np.ndarray, edges: list) -> None:
    """OpenCV's ``CollectPolyEdges`` for one polygon of integer vertices:
    draws its edges and appends (y0, y1, x at y0, dx) of every non-horizontal
    one, x and dx in 16.16 fixed point. An edge that leaves the image steps
    from the end points ``clipLine`` makes of it (their rows only when they
    differ), as OpenCV does."""
    h, w = mask.shape
    p0 = pts[-1]
    for p1 in pts:
        x0, y0, x1, y1 = int(p0[0]), int(p0[1]), int(p1[0]), int(p1[1])
        p0 = p1
        _draw_line(mask, x0, y0, x1, y1)
        t0x, t0y, t1x, t1y = x0, y0, x1, y1
        c0y, c1y = y0, y1
        if not _inside(w, h, x0, y0, x1, y1):
            _, t0x, t0y, t1x, t1y = _clip_line(w, h, x0, y0, x1, y1)
            if t0y != t1y:
                c0y, c1y = t0y, t1y
        c0x, c1x = t0x << _SHIFT, t1x << _SHIFT
        if y0 == y1:
            continue
        dx = _c_div(c1x - c0x, c1y - c0y)
        if y0 < y1:
            edges.append((y0, y1, c0x + (y0 - c0y) * dx, dx))
        else:
            edges.append((y1, y0, c1x + (y1 - c1y) * dx, dx))


def _fill_edges(mask: np.ndarray, edges: list) -> None:
    """OpenCV's ``FillEdgeCollection`` (even-odd, no anti-aliasing): on each
    row the active edges' x, sorted, pair up into spans [ceil(x_a), floor(x_b)]
    (in 16.16 fixed point), clipped to the row."""
    h, w = mask.shape
    if len(edges) < 2:
        return
    y_min = min(e[0] for e in edges)
    y_max = max(e[1] for e in edges)
    xs = [e[2] for e in edges] + [e[2] + (e[1] - e[0]) * e[3] for e in edges]
    if y_max < 0 or y_min >= h or max(xs) < 0 or min(xs) >= (w << _SHIFT):
        return
    for y in range(max(y_min, 0), min(y_max, h)):
        row = sorted(e[2] + (y - e[0]) * e[3] for e in edges if e[0] <= y < e[1])
        for a, b in zip(row[0::2], row[1::2]):
            x1, x2 = (a + _ONE - 1) >> _SHIFT, b >> _SHIFT
            if x1 < w and x2 >= 0:
                mask[y, max(x1, 0): min(x2, w - 1) + 1] = True


def polygons_to_bitmask(polygons: List[np.ndarray], height: int, width: int) -> np.ndarray:
    """XY-interleaved polygons → (H, W) bool mask, as ``cv2.fillPoly`` of
    their vertices rounded to int (polygons of fewer than 3 points dropped)."""
    mask = np.zeros((height, width), bool)
    pts = [np.round(np.asarray(p, np.float64).reshape(-1, 2)).astype(np.int64) for p in polygons]
    pts = [p for p in pts if len(p) >= 3]
    edges: list = []
    for p in pts:
        _collect_edges(mask, p, edges)
    _fill_edges(mask, edges)
    return mask


def rasterize_in_box(polygons: List[np.ndarray], box: np.ndarray, mask_size: int) -> np.ndarray:
    """Polygons within ``box`` (XYXY) on a (mask_size, mask_size) f32 0/1
    grid: translated to the box's origin, scaled to the grid, filled."""
    w = max(box[2] - box[0], 1e-2)
    h = max(box[3] - box[1], 1e-2)
    scaled = []
    for p in polygons:
        p = np.asarray(p, np.float64).reshape(-1, 2).copy()
        p[:, 0] = (p[:, 0] - box[0]) * (mask_size / w)
        p[:, 1] = (p[:, 1] - box[1]) * (mask_size / h)
        scaled.append(p.reshape(-1))
    return polygons_to_bitmask(scaled, mask_size, mask_size).astype(np.float32)


def _linear_taps(src: int, dst: int):
    """cv2's INTER_LINEAR taps along one axis: (lower index, upper index,
    weight of the lower, weight of the upper), half-pixel centres, the
    position rounded to f32 before its floor, clamped at the border."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    i0 = np.floor(f)
    a = (f - i0).astype(np.float32)
    i0 = i0.astype(np.int64)
    a = np.where((i0 < 0) | (i0 >= src - 1), np.float32(0), a)
    i0 = np.clip(i0, 0, src - 1)
    return i0, np.minimum(i0 + 1, src - 1), np.float32(1) - a, a


def resize_bilinear(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """(H, W) f32 map → (out_h, out_w) f32, cv2's ``INTER_LINEAR`` resize
    (rows, then columns, in f32)."""
    out_h, out_w = size
    x0, x1, ax0, ax1 = _linear_taps(image.shape[1], out_w)
    y0, y1, ay0, ay1 = _linear_taps(image.shape[0], out_h)
    img = np.asarray(image, np.float32)
    rows = img[:, x0] * ax0 + img[:, x1] * ax1
    return rows[y0] * ay0[:, None] + rows[y1] * ay1[:, None]


class BitMasks:
    """(N, H, W) bool masks (reference masks.py:84)."""

    def __init__(self, tensor: np.ndarray) -> None:
        tensor = np.asarray(tensor, bool)
        assert tensor.ndim == 3, tensor.shape
        self.tensor = tensor
        self.image_size: Tuple[int, int] = tensor.shape[1:]

    def __getitem__(self, item) -> "BitMasks":
        if isinstance(item, int):
            return BitMasks(self.tensor[item: item + 1])
        return BitMasks(self.tensor[item])

    def __len__(self) -> int:
        return self.tensor.shape[0]

    def __iter__(self):
        return iter(self.tensor)

    def nonempty(self) -> np.ndarray:
        return self.tensor.reshape(len(self), -1).any(axis=1)

    def get_bounding_boxes(self) -> Boxes:
        boxes = np.zeros((len(self), 4), np.float32)
        for i, m in enumerate(self.tensor):
            ys, xs = np.nonzero(m)
            if len(ys):
                boxes[i] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
        return Boxes(boxes)

    @staticmethod
    def from_polygon_masks(polygon_masks: "PolygonMasks", height: int, width: int) -> "BitMasks":
        if not len(polygon_masks):
            return BitMasks(np.zeros((0, height, width), bool))
        return BitMasks(np.stack([polygons_to_bitmask(p, height, width) for p in polygon_masks.polygons]))

    def crop_and_resize(self, boxes: np.ndarray, mask_size: int) -> np.ndarray:
        """(N, mask_size, mask_size) bool crops of each mask's box, resized
        linearly as cv2 does (reference masks.py:170-204)."""
        out = np.zeros((len(self), mask_size, mask_size), np.float32)
        for i, (m, b) in enumerate(zip(self.tensor, boxes)):
            x0, y0, x1, y1 = [int(round(v)) for v in b]
            x0, y0 = max(x0, 0), max(y0, 0)
            x1 = min(max(x1, x0 + 1), m.shape[1])
            y1 = min(max(y1, y0 + 1), m.shape[0])
            out[i] = resize_bilinear(m[y0:y1, x0:x1].astype(np.float32), (mask_size, mask_size))
        return out >= 0.5

    def __repr__(self) -> str:
        return f"BitMasks(num_instances={len(self)})"


class PolygonMasks:
    """Per-instance polygon lists (reference masks.py:239)."""

    def __init__(self, polygons: List[List[Union[np.ndarray, List[float]]]]) -> None:
        self.polygons: List[List[np.ndarray]] = [[np.asarray(p, np.float64) for p in inst] for inst in polygons]

    def __len__(self) -> int:
        return len(self.polygons)

    def __getitem__(self, item) -> "PolygonMasks":
        if isinstance(item, int):
            return PolygonMasks([self.polygons[item]])
        if isinstance(item, slice):
            return PolygonMasks(self.polygons[item])
        if isinstance(item, (list, tuple)):
            return PolygonMasks([self.polygons[i] for i in item])
        item = np.asarray(item)
        if item.dtype == bool:
            item = np.nonzero(item)[0]
        return PolygonMasks([self.polygons[int(i)] for i in item])

    def __iter__(self) -> Iterator[List[np.ndarray]]:
        return iter(self.polygons)

    def nonempty(self) -> np.ndarray:
        return np.asarray([len(p) > 0 for p in self.polygons], bool)

    def get_bounding_boxes(self) -> Boxes:
        boxes = np.zeros((len(self), 4), np.float32)
        for i, inst in enumerate(self.polygons):
            if not inst:
                continue
            pts = np.concatenate([p.reshape(-1, 2) for p in inst], axis=0)
            boxes[i] = [pts[:, 0].min(), pts[:, 1].min(), pts[:, 0].max(), pts[:, 1].max()]
        return Boxes(boxes)

    def area(self) -> np.ndarray:
        out = []
        for inst in self.polygons:
            a = 0.0
            for p in inst:
                pts = p.reshape(-1, 2)
                x, y = pts[:, 0], pts[:, 1]
                a += 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))
            out.append(a)
        return np.asarray(out)

    def crop_and_resize(self, boxes: np.ndarray, mask_size: int) -> np.ndarray:
        if not len(self):
            return np.zeros((0, mask_size, mask_size), bool)
        return np.stack([rasterize_in_box(p, b, mask_size) >= 0.5 for p, b in zip(self.polygons, boxes)])

    def __repr__(self) -> str:
        return f"PolygonMasks(num_instances={len(self)})"


PASTE_CHUNK = 1 << 24  # window pixels pasted at once: ~1 GB of f64 temporaries


def paste_masks_in_image(masks: Union[np.ndarray, torch.Tensor], boxes: Union[np.ndarray, torch.Tensor],
                         image_shape: Tuple[int, int], threshold: float = 0.5) -> torch.Tensor:
    """(N, M, M) mask probabilities pasted into (N, H, W) bool image masks at
    their (N, 4) XYXY boxes, on the device of ``masks``: each output pixel
    centre (x + 0.5, y + 0.5) inside the box grown by a pixel and floored /
    ceiled samples the mask bilinearly (``grid_sample(align_corners=False)``
    over the sub-pixel box, zero outside), in f64, then ``>= threshold``.
    The detections go in chunks of at most ``PASTE_CHUNK`` window pixels (or
    one detection), each detection's window padded to the chunk's largest."""
    masks = torch.as_tensor(masks)
    dev = masks.device
    boxes = torch.as_tensor(boxes).to(dev, torch.float64)
    h, w = image_shape
    n, mh, mw = masks.shape
    out = torch.zeros((n, h, w), dtype=torch.bool, device=dev)
    if n == 0:
        return out
    bx = boxes.cpu().numpy()  # the windows' bounds, as Python ints on the host
    x0i = np.maximum(np.floor(bx[:, 0]).astype(np.int64) - 1, 0)
    y0i = np.maximum(np.floor(bx[:, 1]).astype(np.int64) - 1, 0)
    x1i = np.minimum(np.ceil(bx[:, 2]).astype(np.int64) + 1, w)
    y1i = np.minimum(np.ceil(bx[:, 3]).astype(np.int64) + 1, h)
    live = np.flatnonzero((x1i > x0i) & (y1i > y0i))
    m64 = masks.to(torch.float32).to(torch.float64)
    start = 0
    while start < len(live):
        stop = start + 1
        wh = int(y1i[live[start]] - y0i[live[start]]), int(x1i[live[start]] - x0i[live[start]])
        while stop < len(live):
            cand = max(wh[0], int(y1i[live[stop]] - y0i[live[stop]])), max(wh[1], int(x1i[live[stop]] - x0i[live[stop]]))
            if (stop - start + 1) * cand[0] * cand[1] > PASTE_CHUNK:
                break
            wh, stop = cand, stop + 1
        idx = live[start:stop]
        _paste_chunk(out, m64, boxes, idx, x0i, y0i, x1i, y1i, wh, threshold)
        start = stop
    return out


def _axis(lo: torch.Tensor, b0: torch.Tensor, b1: torch.Tensor, length: int, m: int):
    """Per window row (or column) the mask coordinate's two taps and
    weights, the JAX package's f64 formula op for op."""
    dev = lo.device
    pix = lo[:, None].to(torch.float64) + torch.arange(length, device=dev, dtype=torch.float64)[None]
    g = pix + 0.5
    g = g - b0[:, None]
    g = g / torch.clamp(b1 - b0, min=1e-6)[:, None]
    g = g * 2
    g = g - 1
    p = g + 1
    p = p * m
    p = p - 1
    p = p / 2
    f = torch.floor(p)
    frac = p - f
    taps = []
    for d in (0, 1):
        i = f + d
        valid = (i >= 0) & (i < m)
        wgt = (frac if d else 1.0 - frac) * valid
        taps.append((torch.clamp(i, 0, m - 1).to(torch.int64), wgt))
    return taps


def _paste_chunk(out, m64, boxes, idx, x0i, y0i, x1i, y1i, wh, threshold) -> None:
    dev = out.device
    k = len(idx)
    hh, ww = wh
    sel = torch.as_tensor(idx, device=dev)
    b = boxes[sel]
    ylo, xlo = torch.as_tensor(y0i[idx], device=dev), torch.as_tensor(x0i[idx], device=dev)
    yhi, xhi = torch.as_tensor(y1i[idx], device=dev), torch.as_tensor(x1i[idx], device=dev)
    mh, mw = m64.shape[1:]
    ytaps = _axis(ylo, b[:, 1], b[:, 3], hh, mh)
    xtaps = _axis(xlo, b[:, 0], b[:, 2], ww, mw)
    flat = m64[sel].reshape(k, mh * mw)
    acc = torch.zeros((k, hh, ww), dtype=torch.float64, device=dev)
    for yc, wy in ytaps:
        for xc, wx in xtaps:
            at = (yc[:, :, None] * mw + xc[:, None, :]).reshape(k, -1)
            vals = torch.gather(flat, 1, at).reshape(k, hh, ww)
            term = vals * wy[:, :, None]
            term = term * wx[:, None, :]
            acc = acc + term
    keep = acc >= threshold
    rows = ylo[:, None] + torch.arange(hh, device=dev)[None]
    cols = xlo[:, None] + torch.arange(ww, device=dev)[None]
    inside = (rows < yhi[:, None])[:, :, None] & (cols < xhi[:, None])[:, None, :]
    keep &= inside
    r = torch.clamp(rows, max=out.shape[1] - 1)[:, :, None].expand(k, hh, ww)
    c = torch.clamp(cols, max=out.shape[2] - 1)[:, None, :].expand(k, hh, ww)
    det = sel[:, None, None].expand(k, hh, ww)
    out.index_put_((det[keep], r[keep], c[keep]), torch.ones((), dtype=torch.bool, device=dev))
