"""Fixed-size greedy non-maximum suppression, batched over rows of
candidates (counterpart of the JAX package's ``ops/nms.py``).

The JAX package writes NMS as a ``lax.fori_loop`` of K greedy picks per
image (vmapped over the batch): each pick takes the highest live score,
then kills every candidate whose IoU with it is above the threshold.
``-inf`` marks a dead candidate; a pick whose score is ``-inf`` is invalid,
and its index is that of the first maximal (``-inf``) entry, 0, as JAX's
``argmax`` gives it.

* ``greedy_nms`` is the port's NMS: on a CUDA tensor it runs the
  hand-written pipeline of ``csrc/nms.cu`` (built by ``ops/cuda_lib.py``):
  the live candidates in pick order, a chunk of ``CHUNK`` at a time, a
  suppression bitmask over each chunk and a scan; or raises. On a CPU
  tensor it runs ``nms_fixed``. ``greedy_nms.launches`` counts its calls
  on the card; ``rounds_taken()`` reads the chunks their rows took, which
  the card counts. It goes through the custom op ``torch.ops.d2ct.greedy_nms``
  (``greedy_nms_op``: the pipeline its CUDA implementation, ``nms_fixed`` its
  CPU one, a fake for the (R, K) outputs), so that ``torch.export`` records
  one node and an exported program launches the same pipeline.
* ``nms_fixed`` is the plain PyTorch version: one loop of K iterations for
  every row at once, a handful of (rows, C) tensor ops per pick, so its
  launches do not grow with the rows (but are ~25 per pick).
* ``nms_sorted_reference`` mirrors the kernel's algorithm in plain PyTorch
  (for the tests and ``chip_smoke.py``): the same function as
  ``nms_fixed``, reached by sorting.
* ``batched_nms_fixed`` adds each image's class offsets
  (``class_offset_boxes``) in front of ``greedy_nms``.
* ``sorted_nms_on_card`` launches the pipeline for either kind of box:
  ``greedy_nms``'s, and the rotated boxes of
  ``ops/roi_align_rotated.py::nms_rotated``.

Each row has its own pick count (``max_out`` a sequence, or a tensor on
the host): the RPN's level rows keep ``min(POST_NMS_TOPK, k_level)``. Slots
at or past a row's count are (0, invalid). K, the largest count, is taken
on the host, and the counts go to the device once per distinct sequence.
A call on the card never waits for it: whether a row takes another chunk
is decided on the card, which launches the next round itself.

There is no torchvision in the port: this is its own NMS.
"""

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple, Union

import torch

from . import cuda_lib

__all__ = ["CHUNK", "batched_nms_fixed", "class_offset_boxes", "greedy_nms", "greedy_nms_op", "nms_fixed",
           "nms_sorted_reference", "pairwise_iou_xyxy", "rounds_taken", "sorted_nms_on_card"]

MaxOut = Union[int, Sequence[int], torch.Tensor]
_P, _I = ctypes.c_void_p, ctypes.c_int
# nms_sorted: six pointers, rows, cands, k, the threshold, the card's chunk counter, the stream;
# nms_rotated_sorted: the same with the classes' pointer after the boxes'
_SIGNATURES = {"nms_sorted": [_P] * 6 + [_I] * 3 + [ctypes.c_float, _P, _P], "nms_scratch_bytes": [_I] * 3 + [_P],
               "nms_rotated_sorted": [_P] * 7 + [_I] * 3 + [ctypes.c_float, _P, _P],
               "nms_rotated_scratch_bytes": [_I] * 3 + [_P]}
CHUNK = 8192  # T: the sorted candidates a round takes from a row (``kChunk`` in csrc/nms.cu)
_CHUNKS = {}  # device → the chunks the rows of its calls took, a counter on that card


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


def _host_counts(max_out: MaxOut, rows: int) -> Tuple[int, ...]:
    """One pick count per row from a sequence or a tensor, on the host."""
    # a tensor on the card is read back here, once: the counts are the host's to give
    counts = tuple(int(c) for c in (max_out.tolist() if isinstance(max_out, torch.Tensor) else max_out))
    if len(counts) != rows:
        raise ValueError(f"max_out must be an int or one count per row ({rows}), got {len(counts)} counts")
    return counts


def _row_counts(max_out: MaxOut, rows: int, device) -> Tuple[torch.Tensor, int]:
    """(the (rows,) int32 pick counts on ``device``, K = the largest)."""
    if isinstance(max_out, int):
        return torch.full((rows,), max_out, dtype=torch.int32, device=device), max_out
    counts = _host_counts(max_out, rows)
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


def _sort_words(scores: torch.Tensor) -> torch.Tensor:
    """The kernel's 64-bit word of every candidate, as int64 (meaningful
    where the score is live): ascending words are descending scores, ties
    by ascending index, ``-0.0`` folded into ``+0.0``."""
    cands = scores.shape[1]
    idx_bits = max(1, (cands - 1).bit_length())
    bits = torch.where(scores == 0, torch.zeros_like(scores), scores).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = torch.where(bits >= 0x80000000, bits ^ 0xFFFFFFFF, bits | 0x80000000)  # order-preserving
    index = torch.arange(cands, dtype=torch.int64, device=scores.device)
    return ((key ^ 0xFFFFFFFF) << idx_bits) | index


def _overlaps(a: torch.Tensor, b: torch.Tensor, iou_threshold: float, block: int = 1024) -> torch.Tensor:
    """``pairwise_iou_xyxy(a, b) > iou_threshold`` for (R, N, 4) and (R, M, 4),
    ``block`` of a's boxes at a time (bounded memory)."""
    return torch.cat([pairwise_iou_xyxy(a[:, i:i + block], b) > iou_threshold for i in range(0, a.shape[1], block)]
                     + [torch.zeros(a.shape[0], 0, b.shape[1], dtype=torch.bool, device=a.device)], 1)


def nms_sorted_reference(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float, max_out: MaxOut = 100,
                         chunk: int = CHUNK) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``nms_fixed``'s function by the kernel's algorithm, in plain PyTorch:
    each round takes from every row still at work the next ``chunk`` live
    candidates in pick order (the words after the last chunk's), marks
    those that a pick kept so far suppresses, builds the chunk's
    suppression bitmask (bit (i, j), i < j in pick order, ``iou(box_i,
    box_j) > iou_threshold``) and scans it in order. A row stops at its
    count, or once a chunk held all its live candidates. Returns (keep_idx,
    keep_valid, the chunks each row took); only tests and ``chip_smoke.py``
    call it."""
    rows, cands = scores.shape
    dev = scores.device
    counts, k = _row_counts(max_out, rows, dev)
    keep = torch.zeros(rows, k, dtype=torch.int64, device=dev)
    valid = torch.zeros(rows, k, dtype=torch.bool, device=dev)
    chunks = torch.zeros(rows, dtype=torch.int64, device=dev)
    if rows == 0 or k == 0 or cands == 0:
        return keep, valid, chunks + (counts > 0)
    words, live = _sort_words(scores), scores > float("-inf")
    picks = counts.to(torch.int64)
    kept = torch.zeros(rows, dtype=torch.int64, device=dev)
    active = picks > 0
    bound = torch.full((rows,), -1, dtype=torch.int64, device=dev)  # every word is >= 0
    row = torch.arange(rows, device=dev)
    width = min(chunk, cands)
    last_word = torch.iinfo(torch.int64).max
    while bool(active.any()):
        chunks += active
        in_round = live & (words > bound[:, None]) & active[:, None]
        total = in_round.sum(1)
        n = torch.clamp(total, max=chunk)
        ordered, order = torch.sort(torch.where(in_round, words, last_word), dim=1)
        ordered, order = ordered[:, :width], order[:, :width]
        cbox = torch.gather(boxes, 1, order[:, :, None].expand(rows, width, 4))
        removed = torch.zeros(rows, width, dtype=torch.bool, device=dev)
        most = int(kept.max())
        if most:  # the picks of earlier chunks, first in the IoU
            pbox = torch.gather(boxes, 1, keep[:, :most, None].expand(rows, most, 4))
            by_pick = _overlaps(pbox, cbox, iou_threshold) & (
                torch.arange(most, device=dev)[None, :, None] < kept[:, None, None])
            removed |= by_pick.any(1)
        later = torch.ones(width, width, dtype=torch.bool, device=dev).triu(1)
        mask = _overlaps(cbox, cbox, iou_threshold) & later
        for p in range(width):
            take = active & (p < n) & ~removed[:, p] & (kept < picks)
            if p % 64 == 0 and not bool((active & (p < n) & (kept < picks)).any()):
                break
            keep[row[take], kept[take]] = order[take, p]
            valid[row[take], kept[take]] = True
            kept += take
            removed |= take[:, None] & mask[:, p]
        bound = torch.where(n > 0, ordered[row, torch.clamp(n - 1, min=0)], bound)
        active &= (kept < picks) & (total > n)
    return keep, valid, chunks


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
               max_out: MaxOut = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """``nms_fixed``'s function: on CUDA tensors through the kernels of
    ``csrc/nms.cu`` (``greedy_nms.launches`` counts the calls,
    ``rounds_taken()`` the chunks their rows took), on CPU tensors
    through ``nms_fixed``. boxes (R, C, 4) and scores (R, C) f32 on one
    device. The call goes through the custom op ``torch.ops.d2ct.greedy_nms``
    (``greedy_nms_op``), which takes the pick counts as host ints, so that
    ``torch.export`` records it as one node."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or scores.shape != boxes.shape[:2]:
        raise ValueError(f"boxes must be (R, C, 4) and scores (R, C), got {tuple(boxes.shape)} and "
                         f"{tuple(scores.shape)}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32 or boxes.device != scores.device:
        raise TypeError(f"boxes and scores must be float32 on one device, got {boxes.dtype} on {boxes.device} "
                        f"and {scores.dtype} on {scores.device}")
    if boxes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no NMS kernel for device {boxes.device}")
    if isinstance(max_out, int):
        k, counts = max_out, None
    else:
        counts = list(_host_counts(max_out, scores.shape[0]))
        k = max(counts, default=0)
    return greedy_nms_op(boxes, scores, float(iou_threshold), k, counts)


@torch.library.custom_op("d2ct::greedy_nms", mutates_args=(), device_types="cpu")
def greedy_nms_op(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float, k: int,
                  counts: Optional[List[int]]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The NMS as a custom op: ``k`` picks a row, or ``counts[r]`` for row r
    (k their largest). On the CPU: ``nms_fixed``."""
    return nms_fixed(boxes, scores, iou_threshold, k if counts is None else tuple(counts))


@greedy_nms_op.register_kernel("cuda")
def _greedy_nms_cuda(boxes, scores, iou_threshold, k, counts):
    """On the card: the pipeline of ``csrc/nms.cu``."""
    return sorted_nms_on_card(boxes, scores, iou_threshold, k if counts is None else tuple(counts), greedy_nms)


@greedy_nms_op.register_fake
def _greedy_nms_fake(boxes, scores, iou_threshold, k, counts):
    rows = scores.shape[0]
    return scores.new_empty((rows, k), dtype=torch.int64), scores.new_empty((rows, k), dtype=torch.bool)


greedy_nms.launches = 0


def sorted_nms_on_card(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float, max_out: MaxOut,
                       counter, classes: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One call of ``csrc/nms.cu``'s pipeline on the card: (R, C, 4) XYXY
    boxes (``nms_sorted``) or (R, C, 5) rotated boxes with, optionally, (R,
    C) classes (``nms_rotated_sorted``), f32, checked by the callers. Adds
    one to ``counter.launches`` where it launches the kernels (a call with
    no rows or no picks launches nothing). Returns (keep_idx, keep_valid),
    never waiting for the card."""
    rotated = boxes.shape[-1] == 5
    rows, cands = scores.shape
    host = None if isinstance(max_out, int) else _host_counts(max_out, rows)
    counts, k = (None, max_out) if host is None else (_counts_on(host, boxes.device), max(host, default=0))
    keep = torch.empty(rows, k, dtype=torch.int64, device=boxes.device)
    valid = torch.empty(rows, k, dtype=torch.bool, device=boxes.device)
    if rows == 0 or k == 0:
        return keep, valid
    boxes = boxes.contiguous()
    if boxes.data_ptr() % 16 and not rotated:  # the kernel reads an XYXY box as one float4
        boxes = boxes.clone()
    scores = scores.contiguous()
    lib = cuda_lib.library("nms", _SIGNATURES)
    size = ctypes.c_longlong(0)
    (lib.nms_rotated_scratch_bytes if rotated else lib.nms_scratch_bytes)(rows, cands, k, ctypes.addressof(size))
    scratch = torch.empty(size.value, dtype=torch.uint8, device=boxes.device)
    if boxes.device not in _CHUNKS:
        _CHUNKS[boxes.device] = torch.zeros((), dtype=torch.int64, device=boxes.device)
    rest = (scores.data_ptr(), None if counts is None else counts.data_ptr(), scratch.data_ptr(), keep.data_ptr(),
            valid.data_ptr(), rows, cands, k, float(iou_threshold), _CHUNKS[boxes.device].data_ptr())
    if rotated:
        classes = None if classes is None else classes.to(torch.int32).contiguous()
        cuda_lib.launch(lib, "nms_rotated_sorted", boxes.device, boxes.data_ptr(),
                        None if classes is None else classes.data_ptr(), *rest)
    else:
        cuda_lib.launch(lib, "nms_sorted", boxes.device, boxes.data_ptr(), *rest)
    counter.launches += 1
    return keep, valid


def rounds_taken() -> int:
    """The chunks the rows of every ``greedy_nms`` call on a card took so
    far (one a row with picks to make, one more each time a row went on).
    The card counts them, so this waits for its work."""
    return sum(int(count) for count in _CHUNKS.values())


def class_offset_boxes(boxes: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    """(N, C, 4) boxes shifted by class × (their image's largest finite
    coordinate + 1), as the JAX package's vmap computes it per image: boxes
    of different classes never overlap."""
    finite = torch.where(torch.isfinite(boxes), boxes, torch.zeros((), dtype=boxes.dtype, device=boxes.device))
    max_coord = finite.flatten(1).amax(dim=1) + 1.0  # (N,)
    return boxes + classes.to(boxes.dtype)[:, :, None] * max_coord[:, None, None]


def batched_nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
                      iou_threshold: float, max_out: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-aware NMS by the coordinate-offset trick (reference
    ``layers/nms.py:10-31``): ``class_offset_boxes`` in front of
    ``greedy_nms``; (N, C, 4), (N, C), (N, C) → ``greedy_nms``'s pair."""
    return greedy_nms(class_offset_boxes(boxes, classes), scores, iou_threshold, max_out)
