"""Fixed-size greedy non-maximum suppression, batched over rows of
candidates (counterpart of the JAX package's ``ops/nms.py``).

The JAX package writes NMS as a ``lax.fori_loop`` of K greedy picks per
image (vmapped over the batch): each pick takes the highest live score,
then kills every candidate whose IoU with it is above the threshold.
``-inf`` marks a dead candidate; a pick whose score is ``-inf`` is invalid,
and its index is that of the first maximal (``-inf``) entry, 0, as JAX's
``argmax`` gives it.

* ``greedy_nms`` is the port's NMS: on a CUDA tensor it launches the
  hand-written kernel ``csrc/nms.cu`` (the whole K-pick loop in one launch,
  one CTA per row, the row's live candidates compacted into shared memory
  where they fit; built by ``ops/cuda_lib.py``), or raises; on a CPU tensor
  it runs ``nms_fixed``. ``greedy_nms.launches`` counts the kernel's launches.
* ``nms_fixed`` is the plain PyTorch version: one loop of K iterations for
  every row at once, a handful of (rows, C) tensor ops per pick, so its
  launches do not grow with the rows (but are ~25 per pick).
* ``batched_nms_fixed`` adds each image's class offsets in front of
  ``greedy_nms``.

Each row has its own pick count (``max_out`` a sequence, or a tensor on
the host): the RPN's level rows keep ``min(POST_NMS_TOPK, k_level)``. Slots
at or past a row's count are (0, invalid). K, the largest count, is taken
on the host, and the counts go to the device once per distinct sequence, so
a call does not wait for the card.

There is no torchvision in the port: this is its own NMS.
"""

import ctypes
import functools
from typing import Sequence, Tuple, Union

import torch

from . import cuda_lib

__all__ = ["batched_nms_fixed", "greedy_nms", "nms_fixed", "pairwise_iou_xyxy"]

MaxOut = Union[int, Sequence[int], torch.Tensor]
_P, _I = ctypes.c_void_p, ctypes.c_int
# pointers, then rows, cands, k, the threshold, then the stream
_SIGNATURES = {"nms_fixed": [_P] * 6 + [_I] * 3 + [ctypes.c_float, _P], "nms_fixed_shared_cap": []}


def _areas(boxes: torch.Tensor) -> torch.Tensor:
    return torch.clamp(boxes[..., 2] - boxes[..., 0], min=0) * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0)


def _iou(inter: torch.Tensor, union: torch.Tensor) -> torch.Tensor:
    """``where(union > 0, inter / max(union, 1e-12), 0)``, the JAX package's
    guard for empty boxes."""
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-12), torch.zeros((), dtype=inter.dtype,
                                                                                        device=inter.device))


def pairwise_iou_xyxy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU between (..., N, 4) and (..., M, 4) XYXY boxes → (..., N, M)."""
    area_a, area_b = _areas(a), _areas(b)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return _iou(inter, union)


@functools.lru_cache(maxsize=64)
def _counts_on(counts: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    return torch.tensor(counts, dtype=torch.int32, device=device)


def _row_counts(max_out: MaxOut, rows: int, device) -> Tuple[torch.Tensor, int]:
    """(the (rows,) int32 pick counts on ``device``, K = the largest)."""
    if isinstance(max_out, int):
        return torch.full((rows,), max_out, dtype=torch.int32, device=device), max_out
    # a tensor on the card is read back here, once: the counts are the host's to give
    counts = tuple(int(c) for c in (max_out.tolist() if isinstance(max_out, torch.Tensor) else max_out))
    if len(counts) != rows:
        raise ValueError(f"max_out must be an int or one count per row ({rows}), got {len(counts)} counts")
    return _counts_on(counts, torch.device(device)), max(counts, default=0)


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
              max_out: MaxOut = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS of (R, C, 4) XYXY boxes by (R, C) scores (``-inf`` for an
    invalid candidate), in plain PyTorch: ``max_out`` picks per row (an int,
    or one count per row). Returns (keep_idx (R, K) int64, keep_valid (R, K)
    bool), K the largest count; suppression is ``iou > iou_threshold``."""
    n = scores.shape[0]
    dev = scores.device
    counts, k = _row_counts(max_out, n, dev)
    live = scores.clone()
    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype, device=dev)
    areas = _areas(boxes)  # (N, C)
    keep = torch.zeros(n, k, dtype=torch.int64, device=dev)
    valid = torch.zeros(n, k, dtype=torch.bool, device=dev)
    for i in range(k):
        j = torch.argmax(live, dim=1, keepdim=True)  # (N, 1): the first maximal entry
        ok = (torch.gather(live, 1, j) > neg_inf) & (i < counts[:, None])  # (N, 1)
        keep[:, i:i + 1] = torch.where(ok, j, 0)
        valid[:, i:i + 1] = ok
        box = torch.gather(boxes, 1, j[:, :, None].expand(n, 1, 4))  # (N, 1, 4)
        lt = torch.maximum(box[..., :2], boxes[..., :2])
        rb = torch.minimum(box[..., 2:], boxes[..., 2:])
        wh = torch.clamp(rb - lt, min=0)
        inter = wh[..., 0] * wh[..., 1]
        union = torch.gather(areas, 1, j) + areas - inter
        suppress = (_iou(inter, union) > iou_threshold) & ok
        live = torch.where(suppress, neg_inf, live).scatter_(1, j, float("-inf"))
    return keep, valid


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
               max_out: MaxOut = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """``nms_fixed``'s function: on CUDA tensors through the kernel of
    ``csrc/nms.cu`` (one launch for every row; ``greedy_nms.launches`` counts
    them), on CPU tensors through ``nms_fixed``. boxes (R, C, 4) and scores
    (R, C) f32 on one device."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or scores.shape != boxes.shape[:2]:
        raise ValueError(f"boxes must be (R, C, 4) and scores (R, C), got {tuple(boxes.shape)} and "
                         f"{tuple(scores.shape)}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32 or boxes.device != scores.device:
        raise TypeError(f"boxes and scores must be float32 on one device, got {boxes.dtype} on {boxes.device} "
                        f"and {scores.dtype} on {scores.device}")
    if boxes.device.type == "cpu":
        return nms_fixed(boxes, scores, iou_threshold, max_out)
    if boxes.device.type != "cuda":
        raise ValueError(f"no NMS kernel for device {boxes.device}")
    rows, cands = scores.shape
    counts, k = (None, max_out) if isinstance(max_out, int) else _row_counts(max_out, rows, boxes.device)
    keep = torch.empty(rows, k, dtype=torch.int64, device=boxes.device)
    valid = torch.empty(rows, k, dtype=torch.bool, device=boxes.device)
    if rows == 0 or k == 0:
        return keep, valid
    boxes = boxes.contiguous()
    if boxes.data_ptr() % 16:  # the kernel reads a box as one float4
        boxes = boxes.clone()
    scores = scores.contiguous()
    lib = cuda_lib.library("nms", _SIGNATURES)
    # scratch for a row with more live candidates than shared memory holds
    live = None if cands <= lib.nms_fixed_shared_cap() else torch.empty(rows, cands, dtype=torch.float32,
                                                                         device=boxes.device)
    cuda_lib.launch(lib, "nms_fixed", boxes.device, boxes.data_ptr(), scores.data_ptr(),
                    None if counts is None else counts.data_ptr(),
                    None if live is None else live.data_ptr(), keep.data_ptr(), valid.data_ptr(),
                    rows, cands, k, float(iou_threshold))
    greedy_nms.launches += 1
    return keep, valid


greedy_nms.launches = 0


def batched_nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
                      iou_threshold: float, max_out: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-aware NMS by the coordinate-offset trick (reference
    ``layers/nms.py:10-31``): each image's boxes shifted by class × (its own
    largest finite coordinate + 1), as the JAX package's vmap computes it
    per image, in PyTorch in front of ``greedy_nms``; (N, C, 4), (N, C),
    (N, C) → ``greedy_nms``'s pair."""
    finite = torch.where(torch.isfinite(boxes), boxes, torch.zeros((), dtype=boxes.dtype, device=boxes.device))
    max_coord = finite.flatten(1).amax(dim=1) + 1.0  # (N,)
    offsets = classes.to(boxes.dtype)[:, :, None] * max_coord[:, None, None]
    return greedy_nms(boxes + offsets, scores, iou_threshold, max_out)
