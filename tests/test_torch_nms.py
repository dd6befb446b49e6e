"""The NMS kernel's algorithm, ``ops/nms.py::nms_sorted_reference`` (the
plain PyTorch mirror of ``csrc/nms.cu``: the live candidates in pick order,
a chunk of T at a time, a suppression bitmask per chunk, a scan), against
the JAX package's ``nms_fixed`` (vmapped over rows, and per row at its own
count) and ``batched_nms_fixed`` (class offsets), and against the port's
plain loop ``nms_fixed``, index for index and validity for validity, on the
CPU. T is 16 or 64 here, so rows take two chunks or more, and the kernel's
own T where a case fits it. The inputs are made with numpy from a seed.

The cases: overlapping rows; ties on a few score values; ``-0.0`` beside
``0.0`` (the argmax loop takes them as equal, ties to the lower index);
boxes of no area (a union of 0 is an IoU of 0); an IoU exactly at the
threshold (kept: suppression is ``iou > thr``); all-dead rows and rows that
run dry before their count; a pick count per row; disjoint boxes that need
many chunks; an LVIS-shaped row (proposals × classes through the class
offsets) at a reduced size. The kernel itself is held to the plain loop and
to this mirror on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``
10c)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from detectron2_centernet_tpu.ops import nms as jax_nms
from detectron2_centernet_tpu_torch.ops import nms


def _boxes(rng, rows, c, spread, size):
    xy = rng.uniform(0, spread, (rows, c, 2))
    return np.concatenate([xy, xy + rng.uniform(*size, (rows, c, 2))], -1).astype(np.float32)


def _jax_rows(boxes, scores, thr, counts):
    """JAX's ``nms_fixed`` on each row at its count, padded to the largest
    count with (0, False): (keep, valid) as numpy."""
    k = max(counts)
    keep, valid = np.zeros((len(counts), k), np.int64), np.zeros((len(counts), k), bool)
    for r, c in enumerate(counts):
        if c > 0:
            got = jax_nms.nms_fixed(jnp.asarray(boxes[r]), jnp.asarray(scores[r]), thr, max_out=c)
            keep[r, :c], valid[r, :c] = np.asarray(got[0]), np.asarray(got[1])
    return keep, valid


def _jax_vmapped(boxes, scores, thr, k):
    run = jax.vmap(functools.partial(jax_nms.nms_fixed, iou_threshold=thr, max_out=k))
    keep, valid = run(jnp.asarray(boxes), jnp.asarray(scores))
    return np.asarray(keep).astype(np.int64), np.asarray(valid)


def _check(boxes, scores, thr, max_out, chunk, want):
    """The mirror and the port's plain loop both equal ``want`` (numpy
    keep, valid); returns the chunks each row took."""
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    keep, valid, chunks = nms.nms_sorted_reference(b, s, thr, max_out, chunk)
    np.testing.assert_array_equal(valid.numpy(), want[1])
    np.testing.assert_array_equal(keep.numpy(), want[0])
    plain = nms.nms_fixed(b, s, thr, max_out)
    np.testing.assert_array_equal(plain[1].numpy(), want[1])
    np.testing.assert_array_equal(plain[0].numpy(), want[0])
    return chunks


@pytest.mark.parametrize("chunk", [16, 64, nms.CHUNK])
@pytest.mark.parametrize("seed", [0, 1])
def test_mirror_equals_jax_on_overlapping_rows(seed, chunk):
    """Four rows of 300 overlapping candidates, a fifth dead, 100 picks."""
    rng = np.random.RandomState(seed)
    boxes = _boxes(rng, 4, 300, 80, (10, 60))
    scores = rng.uniform(0, 1, (4, 300)).astype(np.float32)
    scores[rng.uniform(size=(4, 300)) < 0.2] = -np.inf
    want = _jax_vmapped(boxes, scores, 0.5, 100)
    chunks = _check(boxes, scores, 0.5, 100, chunk, want)
    assert want[1].sum() > 100
    if chunk == 16:
        assert (chunks > 1).all()
    if chunk == nms.CHUNK:
        assert (chunks == 1).all()


@pytest.mark.parametrize("chunk", [16, 64])
def test_mirror_ties_on_a_few_score_values(chunk):
    """Scores on four values: most picks break a tie, by the lower index."""
    rng = np.random.RandomState(2)
    boxes = _boxes(rng, 3, 400, 100, (10, 50))
    scores = (np.floor(rng.uniform(0, 1, (3, 400)) * 4) / 4).astype(np.float32)
    want = _jax_vmapped(boxes, scores, 0.6, 150)
    _check(boxes, scores, 0.6, 150, chunk, want)
    assert want[1].sum() > 150


@pytest.mark.parametrize("chunk", [16, 64])
def test_mirror_takes_negative_zero_as_zero(chunk):
    """``-0.0`` and ``0.0`` interleaved with negative scores: equal keys,
    so the lower index goes first, as JAX's argmax has it."""
    rng = np.random.RandomState(3)
    boxes = _boxes(rng, 2, 200, 60, (10, 40))
    scores = np.where(rng.uniform(size=(2, 200)) < 0.5, np.float32(0.0), np.float32(-0.0)).astype(np.float32)
    scores[:, ::3] = -rng.uniform(0, 1, (2, 67)).astype(np.float32)
    assert np.signbit(scores).any() and (scores == 0).sum() > 200
    want = _jax_vmapped(boxes, scores, 0.5, 200)
    _check(boxes, scores, 0.5, 200, chunk, want)
    words = nms._sort_words(torch.tensor([[0.0, -0.0, 1.0, -1.0]]))
    assert words[0, 0] >> 2 == words[0, 1] >> 2 and words[0, 2] < words[0, 0] < words[0, 3]


@pytest.mark.parametrize("chunk", [16, 64])
def test_mirror_boxes_of_no_area(chunk):
    """A third of the boxes have no width, a third no height, some repeat:
    a union of 0 gives an IoU of 0, so none of them suppresses its twin."""
    rng = np.random.RandomState(4)
    boxes = _boxes(rng, 2, 240, 40, (5, 30))
    boxes[:, ::3, 2] = boxes[:, ::3, 0]
    boxes[:, 1::3, 3] = boxes[:, 1::3, 1]
    boxes[:, 100:140] = boxes[:, 0:40]
    scores = rng.uniform(0, 1, (2, 240)).astype(np.float32)
    want = _jax_vmapped(boxes, scores, 0.3, 240)
    _check(boxes, scores, 0.3, 240, chunk, want)
    assert want[1].sum() > 160


@pytest.mark.parametrize("chunk", [16, 64])
def test_mirror_iou_exactly_at_the_threshold(chunk):
    """Pairs whose IoU is exactly 0.5 (inter 1, union 2) stay, pairs just
    above it are suppressed: ``iou > thr``, in the loop's rounding."""
    pairs = []
    for i in range(40):
        x = 10.0 * i
        pairs.append([[x, 0, x + 2, 1], [x, 0, x + 1, 1]])  # IoU 0.5
        pairs.append([[x, 5, x + 2, 6], [x, 5, x + 1.25, 6]])  # IoU 0.625
    boxes = np.asarray(pairs, np.float32).reshape(1, -1, 4)
    scores = np.linspace(1, 0.1, boxes.shape[1], dtype=np.float32)[None]
    want = _jax_vmapped(boxes, scores, 0.5, 160)
    _check(boxes, scores, 0.5, 160, chunk, want)
    assert want[1].sum() == 120  # both of each 0.5 pair, one of each 0.625 pair


@pytest.mark.parametrize("chunk", [16, 64])
def test_mirror_dead_rows_and_rows_that_run_dry(chunk):
    """An all-dead row (every slot (0, False)), rows with fewer survivors
    than their count (the slots after the last pick (0, False))."""
    rng = np.random.RandomState(5)
    boxes = _boxes(rng, 4, 150, 30, (10, 30))
    scores = rng.uniform(0, 1, (4, 150)).astype(np.float32)
    scores[0] = -np.inf
    scores[1, 5:] = -np.inf
    scores[2, rng.uniform(size=150) < 0.7] = -np.inf
    want = _jax_vmapped(boxes, scores, 0.5, 120)
    _check(boxes, scores, 0.5, 120, chunk, want)
    assert not want[1][0].any() and 0 < want[1][1].sum() <= 5 and not want[1][:, -1].any()


@pytest.mark.parametrize("chunk", [16, 64])
def test_mirror_pick_count_per_row(chunk):
    """Five rows, each with its own count (one of them 0): each row equals
    JAX's ``nms_fixed`` at that count; slots past it are (0, False)."""
    rng = np.random.RandomState(6)
    counts = [120, 7, 300, 0, 60]
    boxes = _boxes(rng, 5, 300, 60, (10, 50))
    scores = rng.uniform(0, 1, (5, 300)).astype(np.float32)
    scores[rng.uniform(size=(5, 300)) < 0.2] = -np.inf
    want = _jax_rows(boxes, scores, 0.6, counts)
    chunks = _check(boxes, scores, 0.6, counts, chunk, want)
    assert chunks[3] == 0 and (chunks[[0, 1, 2, 4]] >= 1).all()
    assert torch.equal(_check(boxes, scores, 0.6, torch.tensor(counts), chunk, want), chunks)


@pytest.mark.parametrize("chunk", [16, 64])
def test_mirror_disjoint_boxes_take_many_chunks(chunk):
    """Disjoint boxes, so every live candidate is a pick: a row of count c
    takes ceil(c / T) chunks, and picks in score order."""
    rng = np.random.RandomState(7)
    xy = np.arange(500, dtype=np.float32)[None, :, None].repeat(2, 0).repeat(2, 2) * 10
    boxes = np.concatenate([xy, xy + 5], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (2, 500)).astype(np.float32)
    counts = [300, 450]
    want = _jax_rows(boxes, scores, 0.5, counts)
    chunks = _check(boxes, scores, 0.5, counts, chunk, want)
    assert chunks.tolist() == [-(-c // chunk) for c in counts]
    np.testing.assert_array_equal(want[0][0, :300], np.argsort(-scores[0], kind="stable")[:300])


@pytest.mark.parametrize("chunk", [64, nms.CHUNK])
def test_mirror_lvis_shaped_rows_through_class_offsets(chunk):
    """Two images of 100 proposals × 50 classes (LVIS's box-head row at a
    reduced size: 1000 × 1203 there), about 54% live, 300 picks, through
    the class offsets: the mirror on ``class_offset_boxes`` equals JAX's
    vmapped ``batched_nms_fixed`` and the port's (CPU) one."""
    rng = np.random.RandomState(8)
    props, classes = 100, 50
    boxes = np.repeat(_boxes(rng, 2, props, 700, (20, 300)), classes, axis=1)
    boxes += rng.uniform(-3, 3, boxes.shape).astype(np.float32)  # per-class box deltas
    cls = np.tile(np.arange(classes), (2, props))
    scores = rng.uniform(0, 1, (2, props * classes)).astype(np.float32) ** 3
    scores[scores < 0.1] = -np.inf  # about 54% live
    run = jax.vmap(functools.partial(jax_nms.batched_nms_fixed, iou_threshold=0.5, max_out=300))
    jk, jv = run(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(cls))
    want = (np.asarray(jk).astype(np.int64), np.asarray(jv))
    assert 0.5 < np.isfinite(scores).mean() < 0.6 and want[1].all()
    offset = nms.class_offset_boxes(torch.from_numpy(boxes), torch.from_numpy(cls))
    keep, valid, _ = nms.nms_sorted_reference(offset, torch.from_numpy(scores), 0.5, 300, chunk)
    np.testing.assert_array_equal(valid.numpy(), want[1])
    np.testing.assert_array_equal(keep.numpy(), want[0])
    port = nms.batched_nms_fixed(torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(cls), 0.5, 300)
    np.testing.assert_array_equal(port[0].numpy(), want[0])
    np.testing.assert_array_equal(port[1].numpy(), want[1])


def test_greedy_nms_on_the_cpu_is_the_plain_loop():
    """On CPU tensors ``greedy_nms`` is ``nms_fixed``, launches no kernel
    and takes no chunk."""
    rng = np.random.RandomState(9)
    boxes = torch.from_numpy(_boxes(rng, 2, 100, 50, (10, 30)))
    scores = torch.from_numpy(rng.uniform(0, 1, (2, 100)).astype(np.float32))
    launches, rounds = nms.greedy_nms.launches, nms.rounds_taken()
    got = nms.greedy_nms(boxes, scores, 0.5, [40, 10])
    want = nms.nms_fixed(boxes, scores, 0.5, [40, 10])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (nms.greedy_nms.launches, nms.rounds_taken()) == (launches, rounds)
