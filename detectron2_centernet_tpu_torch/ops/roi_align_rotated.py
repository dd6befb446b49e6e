"""Rotated boxes on the device (counterpart of the JAX package's
``ops/roi_align_rotated.py``; reference ``layers/roi_align_rotated.py``,
``layers/csrc/box_iou_rotated`` and ``csrc/nms_rotated``): ROIAlignRotated,
the pairwise rotated IoU and the fixed-K rotated NMS. A box is (cx, cy, w,
h, angle in degrees, counter-clockwise).

* ``roi_align_rotated``: ROIAlign (``aligned=True``) on a sampling grid
  rotated by each box's angle (the reference samples at −angle), in plain
  PyTorch with autograd, as JAX computes it with XLA: the table /
  ``embedding_bag`` design of ``ops/roi_align.py`` with rotated sample
  positions. Each output bin is one bag of S² × 4 (sample, corner) rows and
  their bilinear weights (0 outside the map, 1/S² for the mean).
* ``pairwise_iou_rotated``: (B, N, 5) × (B, M, 5) → (B, N, M) f32 (or (N,
  5) × (M, 5) → (N, M)). On a CUDA tensor it launches ``csrc/iou_rotated.cu``
  (R1; ``pairwise_iou_rotated.launches`` counts it), on a CPU tensor it runs
  ``pairwise_iou_rotated_plain``: JAX's Sutherland-Hodgman clip vectorised
  over pairs, a chunk of pairs at a time, with ``MAX_VERTICES`` slots per
  polygon (JAX keeps 64; the kernel and this keep 16, the count cut there as
  JAX cuts it at 64: a convex quadrilateral clipped four times has at most
  8 vertices). Same inside test (``>= -1e-9``), same ``t`` guard, same area
  formula, the shoelace terms summed in vertex order as the kernel sums
  them; the first box of a pair is the clipped subject.
* ``nms_rotated``: greedy NMS of (R, C, 5) boxes by (R, C) scores (``-inf``
  dead), with optional (R, C) classes (suppression within a class only: a
  same-class mask, not the offset trick). On a CUDA tensor it launches
  ``csrc/nms.cu``'s pipeline for rotated boxes (R2; ``nms_rotated.launches``),
  on a CPU tensor it runs ``nms_rotated_fixed``, JAX's argmax loop for every
  row at once. Each row has its own pick count, as ``ops/nms.py::greedy_nms``.
* ``nms_pick_ties``: where two runs of the same NMS give other picks, whether
  each row's first difference is decided by an IoU within ``TIE_EPS`` of the
  threshold (the kernel and the plain clip may round an IoU ~1e-6 apart).
"""

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import cuda_lib
from .nms import MaxOut, _row_counts, sorted_nms_on_card

__all__ = ["MAX_VERTICES", "TIE_EPS", "nms_pick_ties", "nms_rotated", "nms_rotated_fixed", "pairwise_iou_rotated",
           "pairwise_iou_rotated_plain", "roi_align_rotated"]

MAX_VERTICES = 16  # polygon slots of the clip (``kMaxVertices`` in csrc/iou_rotated.cuh)
PAIR_CHUNK = 2 ** 19  # pairs the plain clip takes at once: ~40 (chunk, 16) f32 temporaries
TIE_EPS = 1e-5
_SIGNATURES = {"iou_rotated": [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                               ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_void_p],
               "iou_rotated_scratch_bytes": [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                             ctypes.c_int, ctypes.c_void_p]}


# -- ROIAlignRotated ----------------------------------------------------------------------------


def roi_align_rotated(features: torch.Tensor, boxes: torch.Tensor, batch_idx: torch.Tensor, spatial_scale: float,
                      output_size: int = 7, sampling_ratio: int = 2) -> torch.Tensor:
    """(R, C, P, P) f32 pooled features of (R, 5) rotated boxes (input
    coordinates, ``spatial_scale`` times the map's) on the (N, C, H, W) map,
    roi r on image ``batch_idx[r]`` (JAX ``roi_align_rotated``): the box's
    P·S × P·S samples at ``(i + 0.5) / (P·S) - 0.5`` of its width and height
    from its centre, rotated by −angle, each bilinear (zero outside (-1, H)
    × (-1, W), clamped inside), averaged S² to a bin."""
    p, s = output_size, sampling_ratio
    n, c, h, w = features.shape
    dev = boxes.device
    table = features.permute(0, 2, 3, 1).reshape(-1, c).float()  # (N·H·W, C) f32
    b = boxes.to(torch.float32)
    cx = b[:, 0] * spatial_scale - 0.5
    cy = b[:, 1] * spatial_scale - 0.5
    roi_w = torch.clamp(b[:, 2] * spatial_scale, min=1e-6)
    roi_h = torch.clamp(b[:, 3] * spatial_scale, min=1e-6)
    theta = -b[:, 4] * math.pi / 180.0
    cos, sin = torch.cos(theta), torch.sin(theta)
    grid = (torch.arange(p * s, device=dev, dtype=torch.float32) + 0.5) / (p * s)
    ux = (grid - 0.5)[None, :] * roi_w[:, None]  # (R, PS): along x
    uy = (grid - 0.5)[None, :] * roi_h[:, None]  # (R, PS): along y
    xs = cx[:, None, None] + ux[:, None, :] * cos[:, None, None] - uy[:, :, None] * sin[:, None, None]
    ys = cy[:, None, None] + ux[:, None, :] * sin[:, None, None] + uy[:, :, None] * cos[:, None, None]
    # (R, PS, PS), rows y, columns x → (R, P, P, S·S): each bin's samples
    ys = ys.view(-1, p, s, p, s).permute(0, 1, 3, 2, 4).reshape(-1, p, p, s * s)
    xs = xs.view(-1, p, s, p, s).permute(0, 1, 3, 2, 4).reshape(-1, p, p, s * s)
    valid = ((ys > -1.0) & (ys < h) & (xs > -1.0) & (xs < w)).to(torch.float32) / (s * s)
    yc = torch.clamp(ys, 0.0, h - 1)
    xc = torch.clamp(xs, 0.0, w - 1)
    y0, x0 = torch.floor(yc), torch.floor(xc)
    y1, x1 = torch.clamp(y0 + 1, max=h - 1), torch.clamp(x0 + 1, max=w - 1)
    ly, lx = yc - y0, xc - x0
    base = (batch_idx.to(torch.int64) * h * w)[:, None, None, None]
    rows = torch.stack([base + y0.long() * w + x0.long(), base + y0.long() * w + x1.long(),
                        base + y1.long() * w + x0.long(), base + y1.long() * w + x1.long()], -1)
    weights = torch.stack([(1 - ly) * (1 - lx), (1 - ly) * lx, ly * (1 - lx), ly * lx], -1) * valid[..., None]
    out = F.embedding_bag(rows.reshape(-1, 4 * s * s), table, per_sample_weights=weights.reshape(-1, 4 * s * s),
                          mode="sum")  # (R·P·P, C)
    return out.reshape(-1, p, p, c).permute(0, 3, 1, 2)


# -- the pairwise rotated IoU -------------------------------------------------------------------


def _corners(b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., 5) → x, y (..., 4): the corners of JAX's ``_box_vertices_jnp``."""
    t = b[..., 4] * (math.pi / 180.0)
    c, s = torch.cos(t)[..., None], torch.sin(t)[..., None]
    hw, hh = b[..., 2] / 2, b[..., 3] / 2
    dx = torch.stack([hw, -hw, -hw, hw], -1)
    dy = torch.stack([hh, hh, -hh, -hh], -1)
    return b[..., 0, None] + dx * c - dy * s, b[..., 1, None] + dx * s + dy * c


def _nxt(n: torch.Tensor, slots: int) -> torch.Tensor:
    """Each slot's successor in a polygon of ``n`` live slots (the last's is 0)."""
    idx = torch.arange(slots, device=n.device)
    return torch.where(idx[None] + 1 >= n[:, None], 0, idx[None] + 1)


def _pair_iou(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """IoU of (P, 5) subjects ``p`` with (P, 5) boxes ``q``, pair by pair."""
    v = MAX_VERTICES
    pairs = p.shape[0]
    sx, sy = _corners(p)
    qx, qy = _corners(q)
    px = torch.cat([sx, sx.new_zeros(pairs, v - 4)], 1)
    py = torch.cat([sy, sy.new_zeros(pairs, v - 4)], 1)
    n = torch.full((pairs,), 4, dtype=torch.int64, device=p.device)
    idx = torch.arange(v, device=p.device)
    for e in range(4):
        ax, ay = qx[:, e, None], qy[:, e, None]
        ex, ey = qx[:, (e + 1) % 4, None] - ax, qy[:, (e + 1) % 4, None] - ay
        nxt = _nxt(n, v)
        nx, ny = torch.gather(px, 1, nxt), torch.gather(py, 1, nxt)
        s_cur = ex * (py - ay) - ey * (px - ax)
        s_nxt = torch.gather(s_cur, 1, nxt)
        cur_in, nxt_in = s_cur >= -1e-9, s_nxt >= -1e-9
        denom = s_cur - s_nxt
        t = torch.where(denom.abs() > 1e-12, s_cur / torch.where(denom == 0, torch.ones_like(denom), denom),
                        torch.zeros_like(denom))
        ix, iy = px + t * (nx - px), py + t * (ny - py)
        live = idx[None] < n[:, None]
        flags = torch.stack([cur_in & live, (cur_in != nxt_in) & live], -1).reshape(pairs, 2 * v)
        pos = torch.cumsum(flags, 1) - 1
        dest = torch.where(flags & (pos < v), pos, v)  # slot v takes what is dropped
        px = px.new_zeros(pairs, v + 1).scatter_(1, dest, torch.stack([px, ix], -1).reshape(pairs, 2 * v))[:, :v]
        py = py.new_zeros(pairs, v + 1).scatter_(1, dest, torch.stack([py, iy], -1).reshape(pairs, 2 * v))[:, :v]
        n = torch.clamp(flags.sum(1), max=v)
    nxt = _nxt(n, v)
    terms = (px * torch.gather(py, 1, nxt) - torch.gather(px, 1, nxt) * py) * (idx[None] < n[:, None])
    acc = terms[:, 0]
    for i in range(1, v):  # in vertex order, as the kernel adds them
        acc = acc + terms[:, i]
    inter = 0.5 * acc.abs()
    union = p[:, 2] * p[:, 3] + q[:, 2] * q[:, 3] - inter
    return torch.where(union > 0, inter / torch.where(union > 0, union, torch.ones_like(union)),
                       torch.zeros_like(union))


def pairwise_iou_rotated_plain(boxes1: torch.Tensor, boxes2: torch.Tensor, chunk: int = PAIR_CHUNK) -> torch.Tensor:
    """``pairwise_iou_rotated`` in plain PyTorch (module docstring), on any
    device, ``chunk`` pairs at a time."""
    a, b, squeeze = _batched(boxes1, boxes2)
    bsz, n, m = a.shape[0], a.shape[1], b.shape[1]
    out = torch.empty(bsz * n * m, dtype=torch.float32, device=a.device)
    flat = torch.arange(bsz * n * m, device=a.device)
    for start in range(0, bsz * n * m, chunk):
        k = flat[start:start + chunk]
        img, i, j = k // (n * m), (k // m) % n, k % m
        out[start:start + chunk] = _pair_iou(a[img, i], b[img, j])
    out = out.view(bsz, n, m)
    return out[0] if squeeze else out


def _batched(boxes1: torch.Tensor, boxes2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """Both sets as (B, ·, 5) f32 (a 2-d set broadcast over the other's
    batch), and whether both came 2-d."""
    if boxes1.shape[-1] != 5 or boxes2.shape[-1] != 5 or boxes1.dim() not in (2, 3) or boxes2.dim() not in (2, 3):
        raise ValueError(f"rotated boxes must be (N, 5) or (B, N, 5), got {tuple(boxes1.shape)} and "
                         f"{tuple(boxes2.shape)}")
    squeeze = boxes1.dim() == boxes2.dim() == 2
    a, b = boxes1.to(torch.float32), boxes2.to(torch.float32)
    bsz = max(a.shape[0] if a.dim() == 3 else 1, b.shape[0] if b.dim() == 3 else 1)
    a = a.expand(bsz, *a.shape) if a.dim() == 2 else a
    b = b.expand(bsz, *b.shape) if b.dim() == 2 else b
    return a, b, squeeze


def pairwise_iou_rotated(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(N, 5) × (M, 5) → (N, M), or batched (B, N, 5) × (B, M, 5) → (B, N,
    M) (a 2-d set broadcast over the batch): the IoU of every pair, the
    first box clipped. On CUDA tensors through ``csrc/iou_rotated.cu``
    (``pairwise_iou_rotated.launches`` counts the launches), on CPU tensors
    through ``pairwise_iou_rotated_plain``."""
    if boxes1.device != boxes2.device:
        raise ValueError(f"the boxes lie on {boxes1.device} and {boxes2.device}")
    if boxes1.device.type == "cpu":
        return pairwise_iou_rotated_plain(boxes1, boxes2)
    if boxes1.device.type != "cuda":
        raise ValueError(f"no rotated IoU kernel for device {boxes1.device}")
    a, b, squeeze = _batched(boxes1, boxes2)
    bsz, n, m = a.shape[0], a.shape[1], b.shape[1]
    out = torch.empty(bsz, n, m, dtype=torch.float32, device=a.device)
    if out.numel():
        # a broadcast set keeps its stride 0 over the batch; each box's 5 floats contiguous
        a = a if a.stride(0) == 0 and a[0].is_contiguous() else a.contiguous()
        b = b if b.stride(0) == 0 and b[0].is_contiguous() else b.contiguous()
        lib = cuda_lib.library("iou_rotated", _SIGNATURES)
        size = ctypes.c_longlong(0)
        lib.iou_rotated_scratch_bytes(a.stride(0), b.stride(0), bsz, n, m, ctypes.addressof(size))
        scratch = torch.empty(size.value, dtype=torch.uint8, device=a.device)  # each box's record
        cuda_lib.launch(lib, "iou_rotated", a.device, a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0),
                        out.data_ptr(), bsz, n, m, scratch.data_ptr())
        pairwise_iou_rotated.launches += 1
    return out[0] if squeeze else out


pairwise_iou_rotated.launches = 0


# -- the rotated NMS ----------------------------------------------------------------------------


def nms_rotated_fixed(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float, max_out: MaxOut = 100,
                      classes: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's ``nms_rotated_fixed`` for every row at once, in plain PyTorch:
    (R, C, 5) boxes, (R, C) scores (``-inf`` dead), ``max_out`` picks per
    row (an int or one count per row), optional (R, C) classes. Each pick
    takes the first maximal live score and kills every live candidate of
    its class whose IoU with it (the pick clipped) is > ``iou_threshold``.
    Returns (keep_idx (R, K) int64, keep_valid (R, K) bool); an invalid
    slot's index is 0."""
    rows, cands = scores.shape
    dev = scores.device
    counts, k = _row_counts(max_out, rows, dev)
    live = scores.clone()
    keep = torch.zeros(rows, k, dtype=torch.int64, device=dev)
    valid = torch.zeros(rows, k, dtype=torch.bool, device=dev)
    boxes = boxes.to(torch.float32)
    for i in range(k):
        j = torch.argmax(live, dim=1, keepdim=True)  # (R, 1): the first maximal entry
        ok = (torch.gather(live, 1, j) > float("-inf")) & (i < counts[:, None])
        keep[:, i:i + 1] = torch.where(ok, j, 0)
        valid[:, i:i + 1] = ok
        if cands == 0:
            continue
        pick = torch.gather(boxes, 1, j[:, :, None].expand(rows, 1, 5)).expand(rows, cands, 5)
        iou = _pair_iou(pick.reshape(-1, 5), boxes.reshape(-1, 5)).view(rows, cands)
        suppress = (iou > iou_threshold) & ok
        if classes is not None:
            suppress &= classes == torch.gather(classes, 1, j)
        live = torch.where(suppress, float("-inf"), live).scatter_(1, j, float("-inf"))
    return keep, valid


def nms_rotated(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float, max_out: MaxOut = 100,
                classes: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``nms_rotated_fixed``'s function: on CUDA tensors through
    ``csrc/nms.cu``'s pipeline for rotated boxes (``nms_rotated.launches``
    counts the calls; ``ops/nms.py::rounds_taken`` the chunks), on CPU
    tensors through ``nms_rotated_fixed``. boxes (R, C, 5) and scores (R, C)
    f32, classes (R, C) integers or None, on one device."""
    if boxes.dim() != 3 or boxes.shape[-1] != 5 or scores.shape != boxes.shape[:2]:
        raise ValueError(f"boxes must be (R, C, 5) and scores (R, C), got {tuple(boxes.shape)} and "
                         f"{tuple(scores.shape)}")
    if classes is not None and (classes.shape != scores.shape or classes.device != scores.device):
        raise ValueError(f"classes must be (R, C) beside the scores, got {tuple(classes.shape)} on {classes.device}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32 or boxes.device != scores.device:
        raise TypeError(f"boxes and scores must be float32 on one device, got {boxes.dtype} on {boxes.device} "
                        f"and {scores.dtype} on {scores.device}")
    if boxes.device.type == "cpu":
        return nms_rotated_fixed(boxes, scores, iou_threshold, max_out, classes)
    if boxes.device.type != "cuda":
        raise ValueError(f"no rotated NMS kernel for device {boxes.device}")
    return sorted_nms_on_card(boxes, scores, iou_threshold, max_out, nms_rotated, classes)


nms_rotated.launches = 0


def nms_pick_ties(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float, got, want,
                  classes: Optional[torch.Tensor] = None, eps: float = TIE_EPS) -> Dict[str, int]:
    """Compare two results (keep, valid) of the same rotated NMS row by row.
    A row agrees, or its first differing slot is a tie: of the two
    candidates picked there, the one earlier in pick order (score
    descending, index ascending) was suppressed on one side only, so some
    earlier pick of its class lies at an IoU within ``eps`` of the
    threshold (by the plain clip). Returns {"rows", "differing_rows",
    "ties", "not_ties", "picks"}: ``ties`` counts the rows whose first
    difference is such a tie (the picks after it follow from it and are not
    compared), ``not_ties`` the others; ``picks`` the valid picks of
    ``want``."""
    gk, gv = (t.cpu() for t in got)
    wk, wv = (t.cpu() for t in want)
    boxes, scores = boxes.cpu().float(), scores.cpu()
    classes = None if classes is None else classes.cpu()
    out = {"rows": int(scores.shape[0]), "differing_rows": 0, "ties": 0, "not_ties": 0, "picks": int(wv.sum())}
    differ = ((gk != wk) | (gv != wv)).any(1)
    for r in torch.nonzero(differ).flatten().tolist():
        out["differing_rows"] += 1
        slot = int(torch.nonzero((gk[r] != wk[r]) | (gv[r] != wv[r]))[0])
        cands = [int(x[r, slot]) for x, v in ((gk, gv), (wk, wv)) if v[r, slot]]
        if not cands:
            out["not_ties"] += 1
            continue
        first = min(cands, key=lambda i: (-float(scores[r, i]), i))
        earlier = wk[r, :slot][wv[r, :slot]]
        if classes is not None:
            earlier = earlier[classes[r, earlier] == classes[r, first]]
        ious = _pair_iou(boxes[r, earlier], boxes[r, first].expand(len(earlier), 5)) if len(earlier) else \
            torch.zeros(0)
        tie = bool(((ious - iou_threshold).abs() <= eps).any())
        out["ties" if tie else "not_ties"] += 1
    return out
