"""The port's Faster R-CNN slice against the JAX package on the CPU, in f32,
at a small size (ResNet-18 with RES2 16 and a stem of 8, FPN 32, p2-p6 RPN
with one anchor size per level and 3 ratios, FC_DIM 64, 5 classes,
proposals 200/100 at training and 100/50 at test, 64 rois per image, 64²
inputs): the plain NMS with a pick count per row, ROIAlign on one map and
over the pyramid (values, levels, feature gradients), the RPN and ROI
samplers on JAX's own draws, ``find_top_rpn_proposals`` slot for slot, the
RPN and Fast R-CNN losses, ``fast_rcnn_inference``, ``state_dict_from_jax``
with ``fc1``'s permute, the whole model's loss and every gradient,
``predict_fn``, ``DefaultPredictor``, ``ProposalNetwork``, one
``DefaultTrainer`` run with its evaluation, the options that raise, and
``chip_smoke.py``'s config.

One random variables tree, made with numpy from a seed, goes to both: as it
is to the JAX model, through ``state_dict_from_jax`` to the port. JAX runs
with ``TPU.DTYPE=float32`` and ``TEST.EXACT_MODE``; the port with
``MODEL.DEVICE=cpu``. The R-CNN path of the JAX package is plain XLA (its
NMS a ``lax.fori_loop``, its ROIAlign a gather): no interpret mode.

Where the samplers draw, the port is handed the uniforms JAX draws from the
same key (``_jax_draws``), so the sampled slots must be equal, not alike.
"""

import importlib
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from detectron2_centernet_tpu.config import get_cfg as jax_get_cfg
from detectron2_centernet_tpu.engine import DefaultPredictor as JaxPredictor
from detectron2_centernet_tpu.models.box_regression import Box2BoxTransform as JaxBox2Box
from detectron2_centernet_tpu.models.build import build_model as jax_build_model
from detectron2_centernet_tpu.models.matcher import Matcher as JaxMatcher
from detectron2_centernet_tpu_torch.checkpoint import canonical_key, state_dict_from_jax, torch_key
from detectron2_centernet_tpu_torch.config import get_cfg
from detectron2_centernet_tpu_torch.data import warp_image
from detectron2_centernet_tpu_torch.data.datasets import ensure_synthetic_datasets
from detectron2_centernet_tpu_torch.engine import DefaultPredictor, DefaultTrainer
from detectron2_centernet_tpu_torch.models import build_model
from detectron2_centernet_tpu_torch.models.box_regression import Box2BoxTransform
from detectron2_centernet_tpu_torch.models.matcher import Matcher
from detectron2_centernet_tpu_torch.models.proposal_generator import rpn
from detectron2_centernet_tpu_torch.models.roi_heads import roi_heads
from detectron2_centernet_tpu_torch.ops import nms, roi_align

jax_nms = importlib.import_module("detectron2_centernet_tpu.ops.nms")
jax_roi = importlib.import_module("detectron2_centernet_tpu.ops.roi_align")
jax_rpn = importlib.import_module("detectron2_centernet_tpu.models.proposal_generator.rpn")
jax_roi_heads = importlib.import_module("detectron2_centernet_tpu.models.roi_heads.roi_heads")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64
SMALL = ["MODEL.META_ARCHITECTURE", "GeneralizedRCNN", "MODEL.BACKBONE.NAME", "build_resnet_fpn_backbone",
         "MODEL.RESNETS.DEPTH", 18, "MODEL.RESNETS.RES2_OUT_CHANNELS", 16, "MODEL.RESNETS.STEM_OUT_CHANNELS", 8,
         "MODEL.RESNETS.OUT_FEATURES", ["res2", "res3", "res4", "res5"],
         "MODEL.FPN.IN_FEATURES", ["res2", "res3", "res4", "res5"], "MODEL.FPN.OUT_CHANNELS", 32,
         "MODEL.RPN.IN_FEATURES", ["p2", "p3", "p4", "p5", "p6"], "MODEL.RPN.PRE_NMS_TOPK_TRAIN", 200,
         "MODEL.RPN.POST_NMS_TOPK_TRAIN", 100, "MODEL.RPN.PRE_NMS_TOPK_TEST", 100, "MODEL.RPN.POST_NMS_TOPK_TEST", 50,
         "MODEL.ANCHOR_GENERATOR.SIZES", [[32], [64], [128], [256], [512]],
         "MODEL.ROI_HEADS.NAME", "StandardROIHeads", "MODEL.ROI_HEADS.NUM_CLASSES", 5,
         "MODEL.ROI_HEADS.IN_FEATURES", ["p2", "p3", "p4", "p5"], "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 64,
         "MODEL.ROI_BOX_HEAD.NUM_FC", 2, "MODEL.ROI_BOX_HEAD.FC_DIM", 64,
         "INPUT.TRAIN_SIZE", (SIZE, SIZE), "INPUT.TEST_SIZE", (SIZE, SIZE), "TPU.DTYPE", "float32",
         "TEST.EXACT_MODE", True, "INPUT.COLOR_JITTER", False, "DATASETS.TRAIN", ()]
RPN_ONLY = ["MODEL.META_ARCHITECTURE", "ProposalNetwork"]


def _cfgs(extra=()):
    jcfg, pcfg = jax_get_cfg(), get_cfg()
    jcfg.merge_from_list(SMALL + list(extra))
    pcfg.merge_from_list(SMALL + list(extra) + ["MODEL.DEVICE", "cpu"])
    return jcfg, pcfg


# the predictors' kernels at a fraction of N(0, 1/fan_in): the FPN maps are
# ~100 (R-CNN's PIXEL_STD is 1), so at full scale every class score would be
# 0 or 1 and every box far from its anchor or proposal
PREDICTOR_SCALE = {"cls_score": 0.02, "bbox_pred": 0.005, "objectness_logits": 0.05, "anchor_deltas": 0.1}


def _random_variables(shapes, seed):
    """Every leaf random: kernels N(0, 1/fan_in) (the predictors' scaled by
    ``PREDICTOR_SCALE``), norm scales and variances in [0.5, 1.5], biases
    and means N(0, 0.1²)."""
    rng = np.random.RandomState(seed)
    out = {}
    for path, v in flatten_dict(shapes).items():
        leaf = path[-1]
        if leaf == "kernel":
            a = rng.randn(*v.shape) / np.sqrt(np.prod(v.shape[:-1])) * PREDICTOR_SCALE.get(path[-2], 1.0)
        elif leaf in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, v.shape)
        else:
            a = rng.randn(*v.shape) * 0.1
        out[path] = a.astype(np.float32)
    return unflatten_dict(out)


def _pair(extra=(), seed=0):
    """(JAX model, its random variables, the port's model with them). A
    ProposalNetwork's JAX tree carries box-head leaves its network never
    uses; the port's, like the reference's, has no ROI heads, so they stay
    behind."""
    jcfg, pcfg = _cfgs(extra)
    jm = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), (SIZE, SIZE)))
    variables = _random_variables(shapes, seed)
    pm = build_model(pcfg)
    pm.model.load_state_dict(state_dict_from_jax(_port_leaves(variables, pm)))
    return jm, variables, pm


def _port_leaves(variables, pm):
    if hasattr(pm.model, "roi_heads"):
        return variables
    flat = {k: v for k, v in flatten_dict(variables).items() if k[1] not in ("box_head", "box_predictor")}
    return unflatten_dict(flat)


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.fixture(scope="module")
def jax_predict(pair):
    """JAX's ``predict_fn`` jitted once for the tests below (each calls it
    on two 64² images)."""
    return jax.jit(pair[0].predict_fn)


@pytest.fixture(scope="module")
def rpn_pair():
    return _pair(RPN_ONLY)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _images(n, seed, size=SIZE):
    return np.random.RandomState(seed).uniform(0, 255, (n, size, size, 3)).astype(np.float32)


def _close(got, want, rel, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-6), err_msg=what)


def _boxes(rng, n, lo=0.0, hi=SIZE, size=(4.0, 40.0)):
    xy = rng.uniform(lo, hi, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(*size, (n, 2))], -1).astype(np.float32)


# -- the plain NMS: a pick count per row --------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_fixed_with_a_pick_count_per_row_equals_jax(seed):
    """Five rows of 300 overlapping candidates (a fifth dead, the last row
    all dead), each with its own pick count (the RPN's ``min(post, k_l)``):
    each row's picks equal JAX's ``nms_fixed`` at that count, index for
    index and validity for validity, the invalid picks included (index 0);
    the slots past a row's count are (0, invalid). ``greedy_nms`` on CPU
    tensors is this plain version."""
    rng = np.random.RandomState(seed)
    rows, c, counts = 5, 300, [120, 7, 300, 40, 60]
    boxes = np.stack([_boxes(rng, c, 0, 60, (10, 50)) for _ in range(rows)])
    scores = rng.uniform(0, 1, (rows, c)).astype(np.float32)
    scores[rng.uniform(size=(rows, c)) < 0.2] = -np.inf
    scores[-1] = -np.inf
    keep, valid = nms.nms_fixed(torch.from_numpy(boxes), torch.from_numpy(scores), 0.6, counts)
    assert keep.shape == valid.shape == (rows, max(counts))
    for r, k in enumerate(counts):
        want_keep, want_valid = jax_nms.nms_fixed(jnp.asarray(boxes[r]), jnp.asarray(scores[r]), 0.6, max_out=k)
        np.testing.assert_array_equal(keep[r, :k].numpy(), np.asarray(want_keep))
        np.testing.assert_array_equal(valid[r, :k].numpy(), np.asarray(want_valid))
        assert not keep[r, k:].any() and not valid[r, k:].any()
    assert valid[2].sum() > 20 and valid[1, :7].all() and not valid[-1].any()
    again = nms.greedy_nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.6, torch.tensor(counts))
    assert torch.equal(again[0], keep) and torch.equal(again[1], valid)


def test_greedy_nms_checks_its_inputs():
    boxes, scores = torch.zeros(2, 5, 4), torch.zeros(2, 5)
    with pytest.raises(ValueError, match="one count per row"):
        nms.greedy_nms(boxes, scores, 0.5, [3, 4, 5])
    with pytest.raises(ValueError, match=r"\(R, C, 4\)"):
        nms.greedy_nms(boxes[..., :3], scores, 0.5, 3)
    with pytest.raises(TypeError, match="float32"):
        nms.greedy_nms(boxes.double(), scores, 0.5, 3)


def test_row_counts_are_taken_on_the_host_and_built_once():
    """Per-row pick counts: K is the largest, taken from the host's values
    (a list or a host tensor alike), and the same counts give the same
    device tensor again, not a new copy per call."""
    a, k = nms._row_counts([1000] * 4 + [507], 5, "cpu")
    b, k2 = nms._row_counts(torch.tensor([1000] * 4 + [507]), 5, torch.device("cpu"))
    assert k == k2 == 1000 and a is b
    assert a.dtype == torch.int32 and a.tolist() == [1000] * 4 + [507]
    assert nms._row_counts([], 0, "cpu")[1] == 0


# -- ROIAlign ---------------------------------------------------------------------------------


def _roi_case(seed, r=40):
    """Boxes partly outside the image, tiny (under a bin), large, and ones
    whose sqrt(area) sits exactly on an FPN level boundary (112, 224, 448:
    levels 3, 4, 5)."""
    rng = np.random.RandomState(seed)
    boxes = [_boxes(rng, r - 12, -30, 120, (0.5, 150))]
    for side in (112.0, 224.0, 448.0, 56.0):
        xy = rng.uniform(-10, 60, (3, 2)).astype(np.float32)
        boxes.append(np.concatenate([xy, xy + side], 1))
    boxes = np.concatenate(boxes).astype(np.float32)
    return boxes, rng.randint(0, 2, len(boxes)).astype(np.int32)


@pytest.mark.parametrize("sampling_ratio", [2, 3])
def test_roi_align_matches_jax_values_and_feature_gradient(sampling_ratio):
    """One (2, 24, 20, 8) map at scale 1/4, 2 or 3 samples per bin side
    (``aligned=True``): pooled values within 1e-5 of the largest, and the
    gradient of a random projection of them with respect to the features
    within 1e-5 of ``jax.grad``'s."""
    rng = np.random.RandomState(3)
    feat = rng.randn(2, 24, 20, 8).astype(np.float32)
    boxes, bidx = _roi_case(4)
    cot = rng.randn(len(boxes), 7, 7, 8).astype(np.float32)

    def jax_fn(f):
        return jax_roi.roi_align(f, jnp.asarray(boxes), jnp.asarray(bidx), 0.25, 7, sampling_ratio)

    want, want_grad = jax.value_and_grad(lambda f: (jax_fn(f) * cot).sum())(jnp.asarray(feat))
    x = _nchw(feat).requires_grad_(True)
    got = roi_align.roi_align(x, torch.from_numpy(boxes), torch.from_numpy(bidx), 0.25, 7, sampling_ratio)
    assert got.shape == (len(boxes), 8, 7, 7) and got.dtype == torch.float32
    _close(got.detach().permute(0, 2, 3, 1).numpy(), jax_fn(jnp.asarray(feat)), 1e-5, "pooled")
    (got * _nchw(cot)).sum().backward()
    _close(x.grad.permute(0, 2, 3, 1).numpy(), want_grad, 1e-5, "d features")


def test_multilevel_roi_align_matches_jax_levels_values_and_gradients():
    """Four levels (strides 4-32) of a 2-image pyramid: every box's level
    equals JAX's ``assign_boxes_to_levels`` exactly (boxes on the 112, 224,
    448 boundaries included), the pooled values and the gradient with
    respect to every level within 1e-5 of JAX's."""
    rng = np.random.RandomState(5)
    feats = [rng.randn(2, s, s, 8).astype(np.float32) for s in (32, 16, 8, 4)]
    boxes, bidx = _roi_case(6)
    cot = rng.randn(len(boxes), 7, 7, 8).astype(np.float32)
    levels = roi_align.assign_boxes_to_levels(torch.from_numpy(boxes), 2, 5)
    np.testing.assert_array_equal(levels.numpy(), np.asarray(jax_roi.assign_boxes_to_levels(jnp.asarray(boxes), 2, 5)))
    assert {3, 4, 5} <= set(levels[-12:-3].tolist()) and set(levels.tolist()) == {2, 3, 4, 5}

    def jax_fn(fs):
        return jax_roi.multilevel_roi_align(fs, [4, 8, 16, 32], jnp.asarray(boxes), jnp.asarray(bidx), 7, 2)

    want_grads = jax.grad(lambda fs: (jax_fn(fs) * cot).sum())([jnp.asarray(f) for f in feats])
    xs = [_nchw(f).requires_grad_(True) for f in feats]
    got = roi_align.multilevel_roi_align(xs, [4, 8, 16, 32], torch.from_numpy(boxes), torch.from_numpy(bidx), 7, 2)
    _close(got.detach().permute(0, 2, 3, 1).numpy(), jax_fn([jnp.asarray(f) for f in feats]), 1e-5, "pooled")
    (got * _nchw(cot)).sum().backward()
    for level, (x, want) in enumerate(zip(xs, want_grads)):
        _close(x.grad.permute(0, 2, 3, 1).numpy(), want, 1e-5, f"d level {level}")


# -- the samplers on JAX's draws --------------------------------------------------------------


def _quantized_uniform(monkeypatch, steps=4):
    """JAX's uniforms rounded down to ``steps`` values, for both sides: many
    exact ties, which only the lower-index order breaks as JAX does."""
    uniform = jax.random.uniform
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape=(), *a, **k: jnp.floor(uniform(key, shape, *a, **k) * steps) / steps)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("case", range(3))
def test_subsample_labels_on_jax_draws_equals_jax(case, ties, monkeypatch):
    """Labels with more and with fewer positives than the cap, and with
    ignored entries: the port's mask on JAX's own draws equals JAX's,
    element for element. With the draws quantized to 4 values (``ties``),
    ``torch.topk`` in place of the stable sort picks other samples, which
    the port's order prevents."""
    if ties:
        _quantized_uniform(monkeypatch)
    rng = np.random.RandomState(case)
    labels = rng.choice([-1, 0, 1], size=2000, p=[(0.2, 0.7, 0.1), (0.1, 0.88, 0.02), (0.5, 0.3, 0.2)][case])
    key = jax.random.PRNGKey(case)
    want = np.asarray(jax_rpn.subsample_labels(jnp.asarray(labels, jnp.int32), 256, 0.5, key))
    rand = torch.from_numpy(np.asarray(jax.random.uniform(key, (2000,))))
    got = rpn.subsample_labels(torch.from_numpy(labels), 256, 0.5, rand)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 1).sum() == min(128, (labels == 1).sum()) and (want >= 0).sum() == 256
    if ties:
        monkeypatch.setattr(rpn, "top_k_indices", lambda x, k: torch.topk(x, k)[1])
        assert not np.array_equal(rpn.subsample_labels(torch.from_numpy(labels), 256, 0.5, rand).numpy(), want)


def _jax_roi_draws(key, slots):
    """The two uniforms JAX's ``label_and_sample_proposals`` draws from ``key``."""
    k_sub, k_tie = jax.random.split(key)
    return np.asarray(jax.random.uniform(k_sub, (slots,))), np.asarray(jax.random.uniform(k_tie, (slots,)))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("append_gt", [True, False])
def test_label_and_sample_proposals_on_jax_draws_equals_jax(append_gt, ties, monkeypatch):
    """Two images of 300 proposals (a tenth invalid) around 6 gt boxes (two
    slots empty in the second image), 64 samples at a quarter positive:
    every sampled slot (box, class, weight, target, matched index, positive)
    equals JAX's on the same draws. With quantized draws the priorities
    tie often (the 1e-3 tie-breaker too), and ``torch.topk`` in place of
    the stable sort gives other slots."""
    if ties:
        _quantized_uniform(monkeypatch)
    rng = np.random.RandomState(7)
    n, p, m = 2, 300, 6
    gt = np.stack([_boxes(rng, m, 0, 40, (8, 24)) for _ in range(n)])
    props = np.stack([np.concatenate([gt[i] + rng.uniform(-4, 4, (m, 4)), _boxes(rng, p - m, 0, 50, (4, 30))])
                      for i in range(n)]).astype(np.float32)
    pvalid = rng.uniform(size=(n, p)) > 0.1
    gvalid = np.ones((n, m), bool)
    gvalid[1, 4:] = False
    classes = rng.randint(0, 5, (n, m)).astype(np.int32)
    matcher, jmatcher = Matcher([0.5], [0, 1]), JaxMatcher([0.5], [0, 1], allow_low_quality_matches=False)
    slots = p + m if append_gt else p
    keys = jax.random.split(jax.random.PRNGKey(11), n)
    draws = [_jax_roi_draws(k, slots) for k in keys]
    want = [jax_roi_heads.label_and_sample_proposals(
        jnp.asarray(props[i]), jnp.asarray(pvalid[i]), jnp.asarray(gt[i]), jnp.asarray(classes[i]),
        jnp.asarray(gvalid[i]), keys[i], jmatcher, 64, 0.25, 5, append_gt) for i in range(n)]

    def port():
        return roi_heads.label_and_sample_proposals(
            torch.from_numpy(props), torch.from_numpy(pvalid), torch.from_numpy(gt), torch.from_numpy(classes),
            torch.from_numpy(gvalid), torch.from_numpy(np.stack([d[0] for d in draws])),
            torch.from_numpy(np.stack([d[1] for d in draws])), matcher, 64, 0.25, 5, append_gt)

    got = port()
    for key in ("boxes", "classes", "weights", "target_boxes", "matched_idx", "is_pos"):
        np.testing.assert_array_equal(got[key].numpy(), np.stack([np.asarray(w[key]) for w in want]), err_msg=key)
    assert 4 <= got["is_pos"][0].sum() <= 16 and (got["classes"] == 5).any()
    if ties:
        monkeypatch.setattr(roi_heads, "top_k_indices", lambda x, k: torch.topk(x, k)[1])
        assert not np.array_equal(port()["boxes"].numpy(), got["boxes"].numpy())


# -- proposals and losses -----------------------------------------------------------------------


def _rpn_outputs(seed, n=2, quantize=False):
    """Per level (N, R_l) logits and (N, R_l, 4) deltas on the small model's
    anchors at 64² (768, 192, 48, 12 and 3)."""
    _, pcfg = _cfgs()
    from detectron2_centernet_tpu_torch.models.anchors import build_anchor_generator

    gen = build_anchor_generator(pcfg, [4, 8, 16, 32, 64])
    anchors = gen.grid_anchors([(SIZE // s, SIZE // s) for s in (4, 8, 16, 32)] + [(1, 1)])
    rng = np.random.RandomState(seed)
    logits = [rng.randn(n, len(a)).astype(np.float32) for a in anchors]
    if quantize:  # ties in the pre-NMS top-k
        logits = [np.round(lg * 2) / 2 for lg in logits]
    deltas = [(rng.randn(n, len(a), 4) * 0.2).astype(np.float32) for a in anchors]
    return anchors, logits, deltas


@pytest.mark.parametrize("mode", ["test", "train", "ties"])
def test_find_top_rpn_proposals_equals_jax_every_slot(mode):
    """Random RPN outputs over the five levels, JAX's layout and sizes
    (test: pre 100 / post 50; train: 200 / 100; ties: test's with logits on
    a half-integer grid): every one of the P slots, valid or not, has
    JAX's box (within 1e-4 px), score and validity; the five level NMS rows
    are one call."""
    anchors, logits, deltas = _rpn_outputs(1, quantize=mode == "ties")
    pre, post = (200, 100) if mode == "train" else (100, 50)
    b2b, jb2b = Box2BoxTransform((1.0, 1.0, 1.0, 1.0)), JaxBox2Box((1.0, 1.0, 1.0, 1.0))
    want = jax_rpn.find_top_rpn_proposals([jnp.asarray(x) for x in logits], [jnp.asarray(x) for x in deltas],
                                          [jnp.asarray(a) for a in anchors], (SIZE, SIZE), jb2b, 0.7, pre, post)
    calls = []
    greedy = rpn.greedy_nms
    rpn.greedy_nms = lambda *a, **k: calls.append(a[0].shape) or greedy(*a, **k)
    try:
        got = rpn.find_top_rpn_proposals([torch.from_numpy(x) for x in logits], [torch.from_numpy(x) for x in deltas],
                                         [torch.from_numpy(a) for a in anchors], (SIZE, SIZE), b2b, 0.7, pre, post)
    finally:
        rpn.greedy_nms = greedy
    assert calls == [(2 * 5, min(pre, 768), 4)]
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-4)
    assert got[0].shape == (2, post, 4) and got[2].sum() > post // 2


def _gt(seed, n=2, m=6):
    rng = np.random.RandomState(seed)
    boxes = np.stack([_boxes(rng, m, 0, 40, (8, 24)) for _ in range(n)])
    valid = np.ones((n, m), bool)
    valid[1, 4:] = False
    return boxes, valid, rng.randint(0, 5, (n, m)).astype(np.int32)


@pytest.mark.parametrize("beta", [0.0, 0.1])
def test_rpn_losses_on_jax_draws_match_jax(beta):
    """Both RPN losses (BCE over the 256 sampled anchors, L1 or smooth L1 on
    the positives) on JAX's draws, within 1e-5 relative."""
    anchors, logits, deltas = _rpn_outputs(2)
    anc = np.concatenate(anchors)
    lg, dl = np.concatenate(logits, 1), np.concatenate(deltas, 1)
    gt, gvalid, _ = _gt(3)
    key = jax.random.PRNGKey(2)
    rpn_matcher = ([0.3, 0.7], [0, -1, 1])
    want = jax_rpn.rpn_losses(jnp.asarray(anc), jnp.asarray(lg), jnp.asarray(dl), jnp.asarray(gt),
                              jnp.asarray(gvalid), key, JaxMatcher(*rpn_matcher, allow_low_quality_matches=True),
                              JaxBox2Box((1.0, 1.0, 1.0, 1.0)), 256, 0.5, beta)
    rand = np.stack([np.asarray(jax.random.uniform(k, (len(anc),))) for k in jax.random.split(key, 2)])
    got = rpn.rpn_losses(torch.from_numpy(anc), torch.from_numpy(lg), torch.from_numpy(dl), torch.from_numpy(gt),
                         torch.from_numpy(gvalid), torch.from_numpy(rand),
                         Matcher(*rpn_matcher, allow_low_quality_matches=True), Box2BoxTransform(), 256, 0.5, beta)
    for k in ("loss_rpn_cls", "loss_rpn_loc"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, err_msg=k)


def test_fast_rcnn_losses_and_inference_match_jax():
    """``fast_rcnn_losses`` on JAX's sampled slots (class-specific deltas,
    smooth L1 at β 0 and 0.5) within 1e-5 relative; ``fast_rcnn_inference``
    on 2 images × 80 proposals (some invalid) × 5 classes: JAX's classes and
    validity, scores within 1e-6, boxes within 1e-4 px."""
    rng = np.random.RandomState(9)
    s, c = 64, 5
    sampled = {"boxes": _boxes(rng, s, 0, 40, (6, 30)), "target_boxes": _boxes(rng, s, 0, 40, (6, 30)),
               "classes": rng.randint(0, c + 1, s).astype(np.int32), "weights": (rng.uniform(size=s) > 0.2)
               .astype(np.float32)}
    sampled["is_pos"] = sampled["classes"] < c
    scores = rng.randn(s, c + 1).astype(np.float32)
    deltas = (rng.randn(s, 4 * c) * 0.3).astype(np.float32)
    b2b, jb2b = Box2BoxTransform((10.0, 10.0, 5.0, 5.0)), JaxBox2Box((10.0, 10.0, 5.0, 5.0))
    for beta in (0.0, 0.5):
        want = jax_roi_heads.fast_rcnn_losses(jnp.asarray(scores), jnp.asarray(deltas),
                                              {k: jnp.asarray(v) for k, v in sampled.items()}, jb2b, c, beta)
        got = roi_heads.fast_rcnn_losses(torch.from_numpy(scores), torch.from_numpy(deltas),
                                         {k: torch.from_numpy(v) for k, v in sampled.items()}, b2b, c, beta)
        for k in ("loss_cls", "loss_box_reg"):
            np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, err_msg=f"{k} beta {beta}")

    n, p = 2, 80
    props = np.stack([_boxes(rng, p, 0, 50, (4, 30)) for _ in range(n)])
    pvalid = rng.uniform(size=(n, p)) > 0.15
    sc = (rng.randn(n, p, c + 1) * 2).astype(np.float32)
    dl = (rng.randn(n, p, 4 * c) * 0.3).astype(np.float32)
    want = [jax_roi_heads.fast_rcnn_inference(jnp.asarray(props[i]), jnp.asarray(pvalid[i]), jnp.asarray(sc[i]),
                                              jnp.asarray(dl[i]), jb2b, c, (SIZE, SIZE), 0.05, 0.5, 100)
            for i in range(n)]
    got = roi_heads.fast_rcnn_inference(torch.from_numpy(props), torch.from_numpy(pvalid), torch.from_numpy(sc),
                                        torch.from_numpy(dl), b2b, c, (SIZE, SIZE), 0.05, 0.5, 100)
    stack = lambda k: np.stack([np.asarray(w[k]) for w in want])
    np.testing.assert_array_equal(got["classes"].numpy(), stack("classes"))
    np.testing.assert_array_equal(got["scores"].numpy() > 0, stack("scores") > 0)
    np.testing.assert_allclose(got["scores"].numpy(), stack("scores"), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["boxes"].numpy(), stack("boxes"), rtol=0, atol=1e-4)
    assert (stack("scores") > 0).sum(1).min() >= 30


# -- weights ------------------------------------------------------------------------------------


@pytest.mark.parametrize("extra", [[], ["MODEL.ROI_BOX_HEAD.NUM_CONV", 2, "MODEL.ROI_BOX_HEAD.CONV_DIM", 16],
                                   RPN_ONLY], ids=["fc_head", "conv_fc_head", "proposal_network"])
def test_state_dict_from_jax_covers_every_leaf_once_both_ways(extra):
    """Every JAX leaf of the R-CNN tree (the ResNet under
    ``backbone/bottom_up``, the FPN, ``rpn_head``, ``box_head``,
    ``box_predictor``) maps to one port key of its shape and back; the port
    has no key beyond them. A ProposalNetwork's port has no ROI heads (as
    the reference's): its JAX tree's box-head leaves are the only ones left
    over."""
    jm, variables, pm = _pair(extra)
    sd = state_dict_from_jax(_port_leaves(variables, pm))
    own = pm.model.state_dict()
    assert set(own) == set(sd) - {k for k in sd if k.endswith("num_batches_tracked")} | \
        {k for k in own if k.endswith("num_batches_tracked")}
    leaves = {"/".join(p) for p in flatten_dict(_port_leaves(variables, pm))}
    mapped = [canonical_key(k) for k in own if not k.endswith("num_batches_tracked")]
    assert sorted(mapped) == sorted(leaves)
    assert {torch_key(p) for p in leaves} == {k for k in own if not k.endswith("num_batches_tracked")}
    for key, t in own.items():
        assert t.shape == sd[key].shape, key
    assert canonical_key("proposal_generator.rpn_head.objectness_logits.weight") == \
        "params/rpn_head/objectness_logits/kernel"
    if extra == RPN_ONLY:
        left = {"/".join(p) for p in flatten_dict(variables)} - leaves
        assert left and all(p.split("/")[1] in ("box_head", "box_predictor") for p in left)
    else:
        assert canonical_key("roi_heads.box_head.fc2.bias") == "params/box_head/fc2/bias"
        assert torch_key("params/box_predictor/cls_score/kernel") == "roi_heads.box_predictor.cls_score.weight"


def test_fc1_crosses_permuted_and_the_plain_reshape_gives_other_scores(pair, jax_predict):
    """JAX's box head flattens pooled rois NHWC, the port (like the
    reference) NCHW: ``state_dict_from_jax`` re-orders ``fc1``'s input dim
    from (H, W, C) to (C, H, W). With that permute the port's scores are
    JAX's; with ``fc1`` crossed as a plain transpose they are not."""
    jm, variables, pm = pair
    x = _images(2, seed=8)
    want = jax_predict(variables, jnp.asarray(x))
    kernel = np.asarray(variables["params"]["box_head"]["fc1"]["kernel"])
    permuted = pm.model.roi_heads.box_head.fc1.weight.detach().clone()
    assert not torch.equal(permuted, torch.from_numpy(kernel.T.copy()))
    np.testing.assert_allclose(pm.predict_fn(_nchw(x))["scores"].numpy(), np.asarray(want["scores"]), atol=1e-4)
    try:
        with torch.no_grad():
            pm.model.roi_heads.box_head.fc1.weight.copy_(torch.from_numpy(kernel.T.copy()))
        got = pm.predict_fn(_nchw(x))
    finally:
        with torch.no_grad():
            pm.model.roi_heads.box_head.fc1.weight.copy_(permuted)
    assert np.abs(got["scores"].numpy() - np.asarray(want["scores"])).max() > 1e-2


# -- the whole model ------------------------------------------------------------------------------


def _batch(seed, n=2, m=6):
    gt, valid, classes = _gt(seed, n, m)
    image = np.random.RandomState(seed + 100).uniform(0, 255, (n, SIZE, SIZE, 3)).astype(np.float32)
    return {"image": image, "gt_boxes": gt, "gt_classes": classes, "gt_valid": valid}


def _port_batch(b, draws=None):
    out = {"image": _nchw(b["image"]), "gt_boxes": torch.from_numpy(b["gt_boxes"]),
           "gt_classes": torch.from_numpy(b["gt_classes"]), "gt_valid": torch.from_numpy(b["gt_valid"])}
    if draws is not None:
        out["draws"] = draws
    return out


def _jax_draws(key, n, anchors, slots):
    """The uniforms JAX's ``GeneralizedRCNN.loss_fn`` draws from
    ``batch["rng"]`` (split in three: RPN, ROI, point), by image: the RPN
    sampler's (N, R) and the ROI sampler's two (N, slots)."""
    k_rpn, k_roi, _ = jax.random.split(key, 3)
    rpn_draws = np.stack([np.asarray(jax.random.uniform(k, (anchors,))) for k in jax.random.split(k_rpn, n)])
    roi = [_jax_roi_draws(k, slots) for k in jax.random.split(k_roi, n)]
    return {"rpn": torch.from_numpy(rpn_draws), "roi_sub": torch.from_numpy(np.stack([r[0] for r in roi])),
            "roi_tie": torch.from_numpy(np.stack([r[1] for r in roi]))}


def _anchor_count(pm):
    return sum(a.shape[0] for a in pm.anchors_per_level((SIZE, SIZE)))


@pytest.mark.parametrize("beta", [0.0, 0.5])
def test_loss_and_every_gradient_match_jax(beta):
    """The four losses on JAX's draws (the RPN's BCE and L1 over 256
    sampled anchors, the ROI head's softmax CE and L1 over 64 sampled rois
    with the gt appended) within 1e-5 relative, and every parameter's
    gradient within 1e-4 of its own max |value| (FrozenBN; the frozen stem
    and res2 get 0 on both sides)."""
    jm, variables, pm = _pair(["MODEL.ROI_BOX_HEAD.SMOOTH_L1_BETA", beta, "MODEL.RPN.SMOOTH_L1_BETA", beta])
    batch, key = _batch(1), jax.random.PRNGKey(5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch["rng"] = key
    stats = variables["batch_stats"]
    (_, (jloss, _)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, stats, jbatch), has_aux=True))(variables["params"])
    slots = max(100 + 6, 64)  # POST_NMS_TOPK_TRAIN proposals + the gt slots, at least the 64 samples
    pb = _port_batch(batch, _jax_draws(key, 2, _anchor_count(pm), slots))
    for p in pm.model.parameters():
        p.grad = torch.zeros_like(p)
    pm.model.train()
    total, losses = pm.loss_fn(pb)
    total.backward()
    assert set(losses) == set(jloss) == {"loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg"}
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), float(jloss[k]), rtol=1e-5, err_msg=k)
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    grads = {k: p.grad for k, p in pm.model.named_parameters()}
    assert set(want) == set(grads)
    for k, g in grads.items():
        w = want[k].numpy()
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max(), k
    assert not grads["backbone.bottom_up.stem.conv1.weight"].any()
    assert grads["roi_heads.box_head.fc1.weight"].abs().max() > 0


def test_loss_draws_come_from_the_step_generator(pair):
    """Without injected draws the samplers draw from ``batch["generator"]``:
    the same seed gives the same loss, another seed another; a batch with
    neither draws nor a generator raises."""
    _, _, pm = pair
    pm.model.eval()
    batch = _batch(2)

    def loss(seed):
        b = _port_batch(batch)
        if seed is not None:
            b["generator"] = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return pm.loss_fn(b)[1]["loss_cls"].item()

    assert loss(3) == loss(3) != loss(4)
    with pytest.raises(ValueError, match="draws"):
        loss(None)


def _valid_count(scores, threshold=0.05):
    return (np.asarray(scores) > threshold).sum(axis=1)


def test_predict_fn_matches_jax(pair, jax_predict):
    """Two 64² images: the K = 100 slots of JAX's and the port's
    ``predict_fn``: the same validity and classes, scores within 1e-4 and
    boxes within 1e-2 px (the two convolution libraries' RPN deltas round
    apart by ~1e-6; decoded by exp on anchors of up to 512 px, a proposal
    moves by ~1e-3 px, which moves its pooled features and its scores by
    up to ~3e-5), at least 20 valid detections, the scores unsaturated
    (some valid ones under 0.9)."""
    jm, variables, pm = pair
    x = _images(2, seed=8)
    want = jax_predict(variables, jnp.asarray(x))
    got = pm.predict_fn(_nchw(x))
    assert got["boxes"].shape == (2, 100, 4)
    valid = _valid_count(want["scores"])
    assert (valid >= 20).all() and (valid > _valid_count(want["scores"], 0.9)).all()
    np.testing.assert_array_equal(_valid_count(got["scores"]), _valid_count(want["scores"]))
    np.testing.assert_array_equal(got["classes"].numpy(), np.asarray(want["classes"]))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), rtol=0, atol=1e-2)


def test_default_predictor_matches_jax(pair, monkeypatch):
    """One BGR uint8 image of 50×70 through both DefaultPredictors,
    letterboxed to 64² (the JAX one fed the port's warp): the same
    detections (3 here: most proposals of the random model are the clipped
    image, and the NMS keeps one of each class), classes, scores within
    1e-4, boxes within 1e-2 px of the image (``predict_fn``'s
    tolerances)."""
    jm, variables, pm = pair
    jcfg, pcfg = _cfgs()
    port = DefaultPredictor(pcfg)
    port.model.model.load_state_dict(state_dict_from_jax(variables))
    monkeypatch.setattr(type(jm), "init", lambda self, rng, size: variables)
    ref = JaxPredictor(jcfg)
    ref._warp_image = lambda img, m, size: warp_image(img, m, size).numpy()
    img = np.random.RandomState(7).randint(0, 256, (50, 70, 3)).astype(np.uint8)
    got = port(img)["instances"]
    want = ref(img)["instances"]
    assert len(got) == len(want) >= 3
    np.testing.assert_array_equal(got.pred_classes, want.pred_classes)
    np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.pred_boxes.tensor, np.asarray(want.pred_boxes.tensor), rtol=0, atol=1e-2)


def test_proposal_network_predict_and_loss_match_jax(rpn_pair):
    """``ProposalNetwork``: its 50 proposal slots (sigmoid scores, class 0)
    equal JAX's (validity exactly, scores within 1e-5, boxes within 1e-2
    px: the two convolution libraries' deltas differ by ~1e-6, which exp
    and anchors of up to 512 px scale up), and its two RPN losses on JAX's draws within 1e-5 relative, the
    RPN's gradients within 1e-4 of their max."""
    jm, variables, pm = rpn_pair
    x = _images(2, seed=9)
    want = jax.jit(jm.predict_fn)(variables, jnp.asarray(x))
    got = pm.predict_fn(_nchw(x))
    assert got["boxes"].shape == (2, 50, 4) and not got["classes"].any()
    np.testing.assert_array_equal(got["scores"].numpy() > 0, np.asarray(want["scores"]) > 0)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), rtol=0, atol=1e-2)

    batch, key = _batch(4), jax.random.PRNGKey(6)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch["rng"] = key
    (_, (jloss, _)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, variables["batch_stats"], jbatch), has_aux=True))(variables["params"])
    draws = {"rpn": torch.from_numpy(np.stack([np.asarray(jax.random.uniform(k, (_anchor_count(pm),)))
                                               for k in jax.random.split(key, 2)]))}
    for p in pm.model.parameters():
        p.grad = torch.zeros_like(p)
    pm.model.train()
    total, losses = pm.loss_fn(_port_batch(batch, draws))
    total.backward()
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), float(jloss[k]), rtol=1e-5, err_msg=k)
    want = state_dict_from_jax(_port_leaves({"params": jax.tree_util.tree_map(np.asarray, jgrads)}, pm))
    for k, p in pm.model.named_parameters():
        w = want[k].numpy()
        assert np.abs(p.grad.numpy() - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-12), k


# -- entry points ---------------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["GeneralizedRCNN", "ProposalNetwork"])
def test_default_trainer_trains_two_steps_then_evaluates(arch, tmp_path):
    """``faster_rcnn_R_50_FPN_1x.yaml`` (or ``rpn_R_50_FPN_1x.yaml``) cut
    in width (ResNet-18, RES2 16, FPN 32, FC_DIM 64) and size (64², top-ks
    200/100 and 100/50, 64 rois), on the synthetic stand-ins: 2 SGD steps at
    batch 2, the samplers drawing from the step's generator, then the
    evaluation that ends ``train()``: finite losses, a finite bbox AP
    dict, and the final checkpoint."""
    name = "faster_rcnn_R_50_FPN_1x.yaml" if arch == "GeneralizedRCNN" else "rpn_R_50_FPN_1x.yaml"
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "COCO-Detection", name))
    cfg.merge_from_list([
        "MODEL.DEVICE", "cpu", "MODEL.WEIGHTS", "", "MODEL.RESNETS.DEPTH", 18,
        "MODEL.RESNETS.RES2_OUT_CHANNELS", 16, "MODEL.RESNETS.STEM_OUT_CHANNELS", 8, "MODEL.FPN.OUT_CHANNELS", 32,
        "MODEL.ROI_BOX_HEAD.FC_DIM", 64, "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 64,
        "MODEL.RPN.PRE_NMS_TOPK_TRAIN", 200, "MODEL.RPN.POST_NMS_TOPK_TRAIN", 100,
        "MODEL.RPN.PRE_NMS_TOPK_TEST", 100, "MODEL.RPN.POST_NMS_TOPK_TEST", 50,
        "INPUT.TRAIN_SIZE", (SIZE, SIZE), "INPUT.TEST_SIZE", (SIZE, SIZE), "SOLVER.BASE_LR", 0.002,
        "SOLVER.IMS_PER_BATCH", 2, "SOLVER.MAX_ITER", 2, "TEST.BATCH_SIZE", 2, "DATALOADER.NUM_WORKERS", 1,
        "DATASETS.TRAIN", ("test_torch_rcnn_train",), "DATASETS.TEST", ("test_torch_rcnn_val",),
        "OUTPUT_DIR", str(tmp_path), "TPU.DTYPE", "float32"])
    ensure_synthetic_datasets(list(cfg.DATASETS.TRAIN) + list(cfg.DATASETS.TEST))
    trainer = DefaultTrainer(cfg)
    assert type(trainer.model).__name__ == arch
    trainer.resume_or_load(resume=False)
    results = trainer.train()
    losses = [v for v, _ in trainer.storage.history("total_loss").values()]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    bbox = results["bbox"]
    assert {"AP", "AP50", "AP75"} <= set(bbox) and all(math.isfinite(bbox[k]) for k in ("AP", "AP50", "AP75"))
    assert (tmp_path / "model_final.pth").exists()


@pytest.mark.parametrize("name", ["faster_rcnn_R_50_FPN_1x.yaml", "rpn_R_50_FPN_1x.yaml"])
def test_rcnn_raises_without_a_card(name):
    """MODEL.DEVICE is cuda by default: no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "COCO-Detection", name))
    with pytest.raises(RuntimeError, match="MODEL.DEVICE=cpu"):
        build_model(cfg)


@pytest.mark.parametrize("extra, item", [
    # Cascade, Res5/C4 and DC5 build now (tests/test_torch_cascade.py, tests/test_torch_c4.py), and so do
    # precomputed proposals, deformable trunks and PointRend (test_formerly_queued_rcnn_options_build below);
    # the ids are the ones these cases had among PointRend's
    pytest.param(["MODEL.PROPOSAL_GENERATOR.NAME", "RRPN"], "ROADMAP A16", id="extra1-ROADMAP A16"),
    pytest.param(["MODEL.ROI_HEADS.EXTENSIONS", ["DensePoseExtension"]], "ROADMAP A18", id="extra2-ROADMAP A18"),
    pytest.param(["MODEL.ROI_HEADS.NAME", "MyROIHeads"], "unknown ROI_HEADS.NAME 'MyROIHeads'",
                 id="extra4-unknown ROI_HEADS.NAME 'MyROIHeads'"),
])
def test_unported_rcnn_options_raise_naming_their_roadmap_item(extra, item):
    """Each option the port has not ported raises naming its ROADMAP item;
    a ``ROI_HEADS.NAME`` that names no ROI head raises too (the JAX package
    builds Res5ROIHeads for it)."""
    _, pcfg = _cfgs(extra)
    with pytest.raises(NotImplementedError if item.startswith("ROADMAP") else ValueError, match=item):
        build_model(pcfg)


POINTREND_C4 = ["MODEL.ROI_HEADS.NAME", "Res5ROIHeads", "MODEL.BACKBONE.NAME", "build_resnet_backbone",
                "MODEL.RESNETS.OUT_FEATURES", ["res4"], "MODEL.RPN.IN_FEATURES", ["res4"],
                "MODEL.ROI_HEADS.IN_FEATURES", ["res4"], "MODEL.ANCHOR_GENERATOR.SIZES", [[32, 64]],
                "MODEL.MASK_ON", True, "MODEL.ROI_MASK_HEAD.POINT_HEAD_ON", True]


@pytest.mark.parametrize("extra, precomputed, deform, heads", [
    (["MODEL.LOAD_PROPOSALS", True], True, 0, ("box_head", "box_predictor")),
    (["MODEL.PROPOSAL_GENERATOR.NAME", "PrecomputedProposals"], True, 0, ("box_head", "box_predictor")),
    (["MODEL.RESNETS.DEFORM_ON_PER_STAGE", [False, True, True, True], "MODEL.RESNETS.DEPTH", 50,
      "MODEL.RESNETS.WIDTH_PER_GROUP", 4], False, 4 + 6 + 3, ("box_head", "box_predictor")),
    (["MODEL.ROI_HEADS.NAME", "CascadeROIHeads", "MODEL.LOAD_PROPOSALS", True], True, 0,
     ("box_head", "box_predictor")),
    # PointRend (A15.3): its ROI heads name without MASK_ON (the box path alone, as JAX), its coarse mask
    # head, and C4 with a point head, which JAX builds too
    (["MODEL.ROI_HEADS.NAME", "PointRendROIHeads"], False, 0, ("box_head", "box_predictor")),
    (["MODEL.MASK_ON", True, "MODEL.ROI_MASK_HEAD.NAME", "CoarseMaskHead"], False, 0,
     ("box_head", "box_predictor", "mask_head")),
    (POINTREND_C4, False, 0, ("res5", "box_predictor", "mask_head", "mask_point_head")),
], ids=["load_proposals", "precomputed_proposals", "deform_trunk", "cascade_precomputed", "pointrend_roi_heads",
        "coarse_mask_head", "res5_point_head"])
def test_formerly_queued_rcnn_options_build(extra, precomputed, deform, heads):
    """Precomputed proposals (ROADMAP A14.6; Cascade with them too), the
    deformable trunk (A14.5) and PointRend's ROI options (A15.3), which
    raised before they were ported, build as the JAX package builds them
    (every leaf of JAX's tree crosses, strictly): Fast R-CNN keeps its RPN
    head (JAX builds and runs it), the trunk holds a
    ``DeformBottleneckBlock`` per block of its deformable stages, the ROI
    heads are the ones named (tests/test_torch_fast_rcnn.py,
    tests/test_torch_dconv.py and tests/test_torch_pointrend.py hold them
    to the JAX package)."""
    jcfg, pcfg = _cfgs(extra)
    model = build_model(pcfg)
    assert model.precomputed_proposals == precomputed
    assert hasattr(model.model.proposal_generator, "rpn_head")
    blocks = [m for m in model.model.backbone.modules() if type(m).__name__ == "DeformBottleneckBlock"]
    assert len(blocks) == deform
    assert tuple(n for n, _ in model.model.roi_heads.named_children()) == heads
    jm = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), (SIZE, SIZE)))
    model.model.load_state_dict(state_dict_from_jax(_random_variables(shapes, 0)))


def _flat(node, prefix=""):
    out = {}
    for key, val in node.items():
        if isinstance(val, dict):
            out.update(_flat(val, prefix + key + "."))
        else:
            out[prefix + key] = val
    return out


@pytest.mark.parametrize("name", ["faster_rcnn_R_50_FPN_1x", "rpn_R_50_FPN_1x"])
def test_chip_smoke_reads_rcnn_as_the_jax_package_does(name):
    """``chip_smoke.py``'s R-CNN configs are the YAML files read by the
    port's reader, the run's dtype, output directory and seed over them and
    no weights file: key for key the JAX package's config of the same file
    and overrides, at full width."""
    import sys

    sys.path.insert(0, REPO)
    import chip_smoke

    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        got = chip_smoke.rcnn_cfg(name, "bfloat16")
    finally:
        os.chdir(cwd)
    want = jax_get_cfg()
    want.merge_from_file(os.path.join(REPO, "configs", "COCO-Detection", name + ".yaml"))
    want.merge_from_list(["TPU.DTYPE", "bfloat16", "OUTPUT_DIR", "output/chip_smoke", "SEED", 0,
                          "MODEL.WEIGHTS", ""])
    assert _flat(got) == _flat(want)
    assert got.MODEL.RESNETS.DEPTH == 50 and got.MODEL.FPN.OUT_CHANNELS == 256
    assert got.MODEL.ROI_HEADS.NUM_CLASSES == 80 and tuple(got.INPUT.TEST_SIZE) == (800, 800)
