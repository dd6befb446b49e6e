"""Run-length encoding of binary masks (a copy of the JAX package's
``structures/rle.py``): pycocotools' ``RLE`` format, column-major, counts
starting with the zero run, uncompressed as lists or compressed as the
ASCII string of ``rleToString``; and the mask IoU of segm evaluation
(``maskUtils.iou``, crowd included). Plain numpy and Python on the host,
with no pycocotools.
"""

from typing import Dict, List, Sequence

import numpy as np

__all__ = [
    "mask_to_rle",
    "rle_to_mask",
    "rle_area",
    "rle_iou",
    "decode_counts",
    "encode_counts",
    "ensure_uncompressed",
]


def decode_counts(s) -> List[int]:
    """Decode a compressed COCO counts string (pycocotools ``rleFrString``:
    delta-coded LEB128 variant, 5 data bits per char, chars offset by 48).

    Real COCO ground truth stores crowd segmentations this way
    (``{"size": [h, w], "counts": "<ascii>"}``).
    """
    if isinstance(s, bytes):
        s = s.decode("ascii")
    counts: List[int] = []
    pos = 0
    n = len(s)
    while pos < n:
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[pos]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            pos += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def encode_counts(counts: Sequence[int]) -> str:
    """Inverse of :func:`decode_counts` (pycocotools ``rleToString``)."""
    out = []
    for i, c in enumerate(counts):
        x = int(c)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            ch = x & 0x1F
            x >>= 5
            more = (x != -1) if (ch & 0x10) else (x != 0)
            if more:
                ch |= 0x20
            out.append(chr(ch + 48))
    return "".join(out)


def ensure_uncompressed(rle: Dict) -> Dict:
    """Return an RLE dict whose ``counts`` is a list[int]; decodes the
    compressed-string form in place-compatible copy if needed."""
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        return {"size": rle["size"], "counts": decode_counts(counts)}
    return rle


def mask_to_rle(mask: np.ndarray) -> Dict:
    """(H, W) bool -> uncompressed COCO RLE (column-major counts starting
    with the zero run)."""
    h, w = mask.shape
    flat = np.asarray(mask, bool).reshape(h * w, order="F")
    # positions where value changes
    diff = np.nonzero(flat[1:] != flat[:-1])[0] + 1
    runs = np.diff(np.concatenate([[0], diff, [flat.size]]))
    counts = runs.tolist()
    if flat.size and flat[0]:  # counts must start with a zero run
        counts = [0] + counts
    return {"size": [int(h), int(w)], "counts": counts}


def rle_to_mask(rle: Dict) -> np.ndarray:
    rle = ensure_uncompressed(rle)
    h, w = rle["size"]
    counts = rle["counts"]
    flat = np.zeros(h * w, bool)
    pos = 0
    val = False
    for c in counts:
        if val:
            flat[pos : pos + c] = True
        pos += c
        val = not val
    return flat.reshape((h, w), order="F")


def rle_area(rle: Dict) -> int:
    return int(sum(ensure_uncompressed(rle)["counts"][1::2]))


def _run_starts(counts: Sequence[int]):
    """[(start, end)) intervals of the foreground runs."""
    out = []
    pos = 0
    val = False
    for c in counts:
        if val and c:
            out.append((pos, pos + c))
        pos += c
        val = not val
    return out


def rle_iou(dets: List[Dict], gts: List[Dict], iscrowd: Sequence[int]) -> np.ndarray:
    """Pairwise mask IoU (crowd gt -> intersection / det area), matching
    pycocotools ``maskUtils.iou`` semantics."""
    out = np.zeros((len(dets), len(gts)), np.float64)
    dets = [ensure_uncompressed(d) for d in dets]
    gts = [ensure_uncompressed(g) for g in gts]
    det_runs = [_run_starts(d["counts"]) for d in dets]
    gt_runs = [_run_starts(g["counts"]) for g in gts]
    det_areas = [rle_area(d) for d in dets]
    gt_areas = [rle_area(g) for g in gts]
    for i, dr in enumerate(det_runs):
        for j, gr in enumerate(gt_runs):
            inter = _interval_intersection(dr, gr)
            if iscrowd[j]:
                denom = det_areas[i]
            else:
                denom = det_areas[i] + gt_areas[j] - inter
            out[i, j] = inter / denom if denom > 0 else 0.0
    return out


def _interval_intersection(a, b) -> int:
    total = 0
    i = j = 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
