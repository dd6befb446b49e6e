"""The port's RetinaNet slice against the JAX package on the CPU, in f32, at
a small width (ResNet-18 with RES2 16, FPN 32, 5 classes, 2 tower convs,
64² inputs): the batch augmentation ``build_model`` attaches (ROADMAP C14)
and the SSD distortion, anchors, the matcher, the box transform, the
fixed-K NMS, the FPN, the head, ``state_dict_from_jax``, ``loss_fn`` with
its gradients (batch and ema normalizers) and three SGD steps, ``predict_fn``,
``DefaultPredictor``, the NHWC layout of the flattened heads, the optimizer's
parameter groups, and one ``DefaultTrainer`` run with its evaluation.

One random variables tree, made with numpy from a seed, goes to both: as it
is to the JAX model, through ``state_dict_from_jax`` to the port. JAX runs
with ``TPU.DTYPE=float32`` and ``TEST.EXACT_MODE``; the port with
``MODEL.DEVICE=cpu``.
"""

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
from detectron2_centernet_tpu.engine.train_state import TrainState, make_train_step
from detectron2_centernet_tpu.models import anchors as jax_anchors
from detectron2_centernet_tpu.models.box_regression import Box2BoxTransform as JaxBox2Box
from detectron2_centernet_tpu.models.build import build_model as jax_build_model
from detectron2_centernet_tpu.models.matcher import Matcher as JaxMatcher
from detectron2_centernet_tpu.models.registry import BACKBONE_REGISTRY as JAX_BACKBONES
from detectron2_centernet_tpu.ops import nms as jax_nms
from detectron2_centernet_tpu.ops.photometric import device_color_aug_ssd as jax_aug_ssd
from detectron2_centernet_tpu.parallel import get_mesh
from detectron2_centernet_tpu.solver import build_optimizer as jax_build_optimizer
from detectron2_centernet_tpu.solver.build import param_group_labels as jax_labels
from detectron2_centernet_tpu_torch.checkpoint import canonical_key, state_dict_from_jax, torch_key
from detectron2_centernet_tpu_torch.config import get_cfg
from detectron2_centernet_tpu_torch.data import warp_image
from detectron2_centernet_tpu_torch.data.datasets import ensure_synthetic_datasets
from detectron2_centernet_tpu_torch.engine import DefaultPredictor, DefaultTrainer
from detectron2_centernet_tpu_torch.models import BACKBONE_REGISTRY, build_model
from detectron2_centernet_tpu_torch.models.anchors import DefaultAnchorGenerator, build_anchor_generator
from detectron2_centernet_tpu_torch.models.box_regression import Box2BoxTransform
from detectron2_centernet_tpu_torch.models.matcher import Matcher
from detectron2_centernet_tpu_torch.models.meta_arch import retinanet
from detectron2_centernet_tpu_torch.models.meta_arch.centernet import F32Conv2d
from detectron2_centernet_tpu_torch.ops import nms
from detectron2_centernet_tpu_torch.ops.photometric import color_aug_ssd, device_color_aug_ssd
from detectron2_centernet_tpu_torch.solver import build_optimizer, param_group_labels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64
SMALL = ["MODEL.META_ARCHITECTURE", "RetinaNet", "MODEL.BACKBONE.NAME", "build_retinanet_resnet_fpn_backbone",
         "MODEL.RESNETS.DEPTH", 18, "MODEL.RESNETS.RES2_OUT_CHANNELS", 16, "MODEL.RESNETS.STEM_OUT_CHANNELS", 8,
         "MODEL.RESNETS.OUT_FEATURES", ["res3", "res4", "res5"], "MODEL.FPN.IN_FEATURES", ["res3", "res4", "res5"],
         "MODEL.FPN.OUT_CHANNELS", 32, "MODEL.RETINANET.NUM_CLASSES", 5, "MODEL.RETINANET.NUM_CONVS", 2,
         "MODEL.PIXEL_MEAN", [103.53, 116.28, 123.675], "MODEL.PIXEL_STD", [57.375, 57.12, 58.395],
         "INPUT.TRAIN_SIZE", (SIZE, SIZE), "INPUT.TEST_SIZE", (SIZE, SIZE), "TPU.DTYPE", "float32",
         "TEST.EXACT_MODE", True, "INPUT.COLOR_JITTER", False, "DATASETS.TRAIN", (),
         "MODEL.ANCHOR_GENERATOR.SIZES", [[x, x * 2 ** (1.0 / 3), x * 2 ** (2.0 / 3)] for x in [32, 64, 128, 256, 512]]]
EMA = ["MODEL.RETINANET.LOSS_NORMALIZER", "ema"]


def _cfgs(extra=()):
    jcfg, pcfg = jax_get_cfg(), get_cfg()
    jcfg.merge_from_list(SMALL + list(extra))
    pcfg.merge_from_list(SMALL + list(extra) + ["MODEL.DEVICE", "cpu"])
    return jcfg, pcfg


def _random_variables(shapes, seed):
    """Every leaf random: kernels N(0, 1/fan_in), norm scales and variances
    in [0.5, 1.5], biases and means N(0, 0.1²), the ``cls_score`` bias about
    -2.5 (scores near 0.08, so at least 20 per image clear 0.05), the
    ``bbox_pred`` kernel at a tenth of the scale (boxes stay near their
    anchors)."""
    rng = np.random.RandomState(seed)
    out = {}
    for path, v in flatten_dict(shapes).items():
        leaf = path[-1]
        if leaf == "kernel":
            a = rng.randn(*v.shape) / np.sqrt(np.prod(v.shape[:-1])) * (0.1 if path[-2] == "bbox_pred" else 1.0)
        elif leaf in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, v.shape)
        elif path[-2] == "cls_score":
            a = -2.5 + rng.randn(*v.shape) * 0.5
        else:
            a = rng.randn(*v.shape) * 0.1
        out[path] = a.astype(np.float32)
    return unflatten_dict(out)


def _pair(extra=(), seed=0):
    """(JAX RetinaNet, its random variables, the port's RetinaNet with
    them). Under the ema normalizer the JAX tree carries its running count
    at 100, where both start."""
    jcfg, pcfg = _cfgs(extra)
    jm = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), (SIZE, SIZE)))
    variables = _random_variables(shapes, seed)
    if jm.loss_normalizer_mode == "ema":
        variables["batch_stats"]["loss_normalizer"] = np.float32(100.0)
    pm = build_model(pcfg)
    pm.model.load_state_dict(state_dict_from_jax(variables))
    return jm, variables, pm


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _images(n, seed, size=SIZE):
    return np.random.RandomState(seed).uniform(0, 255, (n, size, size, 3)).astype(np.float32)


def _close(got, want, rel, what):
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-6), err_msg=what)


# -- C14: the batch augmentation build_model attaches, and the SSD distortion -----------


R18_CTDET = ["MODEL.META_ARCHITECTURE", "CenterNet", "MODEL.BACKBONE.NAME", "build_resnet_deconv_backbone",
             "MODEL.RESNETS.DEPTH", 18, "MODEL.RESNETS.RES2_OUT_CHANNELS", 16,
             "MODEL.RESNETS.STEM_OUT_CHANNELS", 8, "MODEL.CENTERNET.HEAD_CONV", 8, "DATASETS.TRAIN", ()]


@pytest.mark.parametrize("arch", ["CenterNet", "RetinaNet"])
@pytest.mark.parametrize("ssd, jitter, on_device", [
    (True, True, True), (False, True, True), (True, False, True), (False, False, True), (True, True, False)])
def test_build_model_attaches_the_augmentation_jax_attaches(arch, ssd, jitter, on_device):
    """ROADMAP C14: the JAX package's ``build_model`` attaches the step's
    batch augmentation for every meta-architecture, ``INPUT.COLOR_AUG_SSD``
    first, then ``INPUT.COLOR_JITTER``, none without
    ``DATALOADER.DEVICE_PHOTOMETRIC``. The port's does the same, by name:
    with ``COLOR_AUG_SSD`` the SSD distortion (the parent port jittered),
    and a RetinaNet gets one at all (the parent had none)."""
    base = R18_CTDET if arch == "CenterNet" else SMALL
    flags = ["INPUT.COLOR_AUG_SSD", ssd, "INPUT.COLOR_JITTER", jitter, "DATALOADER.DEVICE_PHOTOMETRIC", on_device]
    jcfg, pcfg = jax_get_cfg(), get_cfg()
    jcfg.merge_from_list(base + flags)
    pcfg.merge_from_list(base + flags + ["MODEL.DEVICE", "cpu"])
    want = getattr(getattr(jax_build_model(jcfg), "device_augment", None), "__name__", None)
    got = getattr(build_model(pcfg).device_augment, "__name__", None)
    assert got == want
    assert want == (None if not on_device else "device_color_aug_ssd" if ssd
                    else "device_color_jitter" if jitter else None)


def _jax_ssd_draws(key, n):
    """The draws JAX's ``device_color_aug_ssd`` makes from ``key``, gated as
    it gates them: (brightness delta, contrast factor, saturation factor,
    hue angle in radians)."""
    ks = jax.random.split(key, 8)
    u = lambda k, lo, hi: np.asarray(jax.random.uniform(k, (n, 1, 1, 1), minval=lo, maxval=hi))[:, 0, 0, 0]
    gate = lambda k: (np.asarray(jax.random.uniform(k, (n, 1, 1, 1)))[:, 0, 0, 0] < 0.5).astype(np.float32)
    theta = np.asarray(jax.random.uniform(ks[6], (n,), minval=-18.0, maxval=18.0)) * (2.0 * np.pi / 180.0)
    return (gate(ks[1]) * u(ks[0], -32.0, 32.0), 1.0 + gate(ks[3]) * (u(ks[2], 0.5, 1.5) - 1.0),
            1.0 + gate(ks[5]) * (u(ks[4], 0.5, 1.5) - 1.0), theta * gate(ks[7]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_color_aug_ssd_core_on_jax_draws_matches_jax(seed):
    """16 BGR images of 0..255 noise, some of them near 0 and 255 so the
    clips bite: the port's core fed JAX's gated draws agrees with JAX's
    ``device_color_aug_ssd`` within 1e-4 of 255 (f32 sums in another
    order); the op order, the BGR→RGB reversals around the luma and the YIQ
    rotation, and the exact inverse all show at the 1e-1 level when wrong."""
    n = 16
    rng = np.random.RandomState(seed)
    images = rng.uniform(0, 255, (n, 12, 10, 3)).astype(np.float32)
    images[: n // 4] = np.clip(images[: n // 4] * 0.1 + 240, 0, 255)
    images[n // 4: n // 2] *= 0.05
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_aug_ssd(jnp.asarray(images), key))
    draws = [torch.from_numpy(np.asarray(d, np.float32)) for d in _jax_ssd_draws(key, n)]
    assert all(0 < float((d != (1.0 if i in (1, 2) else 0.0)).float().mean()) < 1 for i, d in enumerate(draws))
    got = color_aug_ssd(torch.from_numpy(images.transpose(0, 3, 1, 2).copy()), *draws)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-4 * 255)


def test_color_aug_ssd_identity_draws_and_the_seeded_wrapper():
    """Identity draws return the image; the wrapper's same seed gives the
    same batch, and over 400 flat gray images of 100 (which saturation and
    hue leave gray) about 3/4 move by brightness or contrast (each gated at
    0.5), into [(100 - 32) · 0.5, (100 + 32) · 1.5]."""
    images = torch.rand(2, 3, 5, 4) * 255
    zero, one = torch.zeros(2), torch.ones(2)
    torch.testing.assert_close(color_aug_ssd(images, zero, one, one, zero), images, atol=1e-3, rtol=0)
    flat = torch.full((400, 3, 2, 2), 100.0)
    out1 = device_color_aug_ssd(flat, torch.Generator().manual_seed(3))
    torch.testing.assert_close(out1, device_color_aug_ssd(flat, torch.Generator().manual_seed(3)))
    assert (out1 - out1[:, :1]).abs().max() < 1e-3  # still gray
    assert (out1 >= 34 - 1e-3).all() and (out1 <= 198 + 1e-3).all()
    assert 0.65 < ((out1 - flat).abs().amax((1, 2, 3)) > 1e-3).float().mean().item() < 0.85


# -- anchors, matcher, box transform, NMS --------------------------------------------------


def test_anchors_equal_jax_exactly():
    """Base-RetinaNet's anchors (3 sizes × 3 ratios per level, strides 8-128)
    on several grids, and the model's per-level anchors at 64², 640² and
    800² (76 725 and 120 087 anchors at the last two): equal to JAX's, bit
    for bit."""
    jcfg, pcfg = _cfgs()
    for c in (jcfg, pcfg):
        c.merge_from_file(os.path.join(REPO, "configs", "Base-RetinaNet.yaml"))
    strides = [8, 16, 32, 64, 128]
    port, ref = build_anchor_generator(pcfg, strides), jax_anchors.build_anchor_generator(jcfg, strides)
    assert port.num_anchors == ref.num_anchors == [9] * 5
    for grids in ([(8, 8), (4, 4), (2, 2), (1, 1), (1, 1)], [(13, 7), (7, 4), (4, 2), (2, 1), (1, 1)]):
        for a, b in zip(port.grid_anchors(grids), ref.grid_anchors(grids)):
            np.testing.assert_array_equal(a, b)
    gen = DefaultAnchorGenerator([[32.0]], [[0.5, 1.0, 2.0]], [8, 16], offset=0.5)
    ref = jax_anchors.DefaultAnchorGenerator([[32.0]], [[0.5, 1.0, 2.0]], [8, 16], offset=0.5)
    np.testing.assert_array_equal(gen([(3, 5), (2, 3)]), ref([(3, 5), (2, 3)]))
    _, pcfg = _cfgs()
    pcfg.merge_from_list(["MODEL.ANCHOR_GENERATOR.SIZES", jcfg.MODEL.ANCHOR_GENERATOR.SIZES])
    model = build_model(pcfg)
    jm = jax_build_model(jcfg)
    for size, count in ((64, None), (640, 76725), (800, 120087)):
        got = torch.cat(model.anchors_per_level((size, size))).numpy()
        np.testing.assert_array_equal(got, np.asarray(jm._anchors_for((size, size))))
        assert count is None or got.shape == (count, 4)
    assert model.anchors_per_level((800, 800))[0] is model.anchors_per_level((800, 800))[0]  # made once


def _matcher_cases():
    """(IoU (M, N), gt_valid (M,)): random, with ties between gts, ties of a
    gt's best across anchors, an invalid gt holding the largest IoU, and an
    image with no valid gt."""
    rng = np.random.RandomState(0)
    iou = rng.uniform(0, 0.7, (6, 40)).astype(np.float32)
    iou[1, 3] = iou[4, 3] = 0.9  # two gts tie as the best of anchor 3: the first wins
    iou[2] *= 0.3
    iou[2, 7] = iou[2, 8] = 0.35  # gt 2's best, twice, below the low threshold: both rescued
    iou[5, 10] = 0.99  # an invalid gt's IoU never matches
    iou[0, 20] = iou[3, 20] = 0.45  # a tie in the ignore band
    valid = np.array([True, True, True, True, True, False])
    return [(iou, valid), (iou, np.zeros(6, bool)), (iou[:, :5] * 0, valid)]


@pytest.mark.parametrize("case", range(3))
def test_matcher_equals_jax(case):
    """Matches and labels equal JAX's, one image at a time and batched."""
    iou, valid = _matcher_cases()[case]
    m = Matcher([0.4, 0.5], [0, -1, 1], allow_low_quality_matches=True)
    jm_matches, jm_labels = JaxMatcher([0.4, 0.5], [0, -1, 1], allow_low_quality_matches=True)(
        jnp.asarray(iou), jnp.asarray(valid))
    matches, labels = m(torch.from_numpy(iou), torch.from_numpy(valid))
    np.testing.assert_array_equal(matches.numpy(), np.asarray(jm_matches))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jm_labels))
    bm, bl = m(torch.from_numpy(np.stack([iou, iou])), torch.from_numpy(np.stack([valid, valid])))
    assert torch.equal(bm[1], matches) and torch.equal(bl[1], labels)
    if case == 0:
        assert matches[3] == 1 and labels[7] == labels[8] == 1 and matches[10] != 5 and labels[20] == -1
    else:
        assert not labels.any()


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)])
def test_box2box_transform_matches_jax(weights):
    """``get_deltas`` (with a degenerate target box: the 1e-8 floor) and
    ``apply_deltas`` (with dw, dh past the log(1000/16) clamp, and k = 2
    boxes of deltas per row) within 1e-5 of each output's scale."""
    rng = np.random.RandomState(1)
    xy = rng.uniform(0, 100, (50, 2))
    src = np.concatenate([xy, xy + rng.uniform(1, 60, (50, 2))], 1).astype(np.float32)
    xy = rng.uniform(0, 100, (50, 2))
    tgt = np.concatenate([xy, xy + rng.uniform(1, 60, (50, 2))], 1).astype(np.float32)
    tgt[0, 2] = tgt[0, 0]
    deltas = (rng.randn(50, 8) * 2).astype(np.float32)
    deltas[:5, 2] = 10.0
    port, ref = Box2BoxTransform(weights), JaxBox2Box(weights)
    _close(port.get_deltas(torch.from_numpy(src), torch.from_numpy(tgt)).numpy(),
           np.asarray(ref.get_deltas(jnp.asarray(src), jnp.asarray(tgt))), 1e-5, "get_deltas")
    _close(port.apply_deltas(torch.from_numpy(deltas), torch.from_numpy(src)).numpy(),
           np.asarray(ref.apply_deltas(jnp.asarray(deltas), jnp.asarray(src))), 1e-5, "apply_deltas")


def _nms_case(seed, n=3, c=200, dead=0.2):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 20, (n, c, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(20, 40, (n, c, 2))], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (n, c)).astype(np.float32)
    scores[rng.uniform(size=(n, c)) < dead] = -np.inf
    scores[-1] = -np.inf  # an image with no live candidate
    return boxes, scores, rng.randint(0, 4, (n, c))


def _jax_batched_nms(boxes, scores, classes, thresh, k):
    out = [jax_nms.batched_nms_fixed(jnp.asarray(b), jnp.asarray(s), jnp.asarray(c), thresh, max_out=k)
           for b, s, c in zip(boxes, scores, classes)]
    return np.stack([np.asarray(i) for i, _ in out]), np.stack([np.asarray(v) for _, v in out])


@pytest.mark.parametrize("seed, k", [(0, 100), (1, 50), (2, 150)])
def test_batched_nms_equals_jax(seed, k):
    """Three images of 200 overlapping candidates (4 classes, 20% dead, the
    last image all dead; 30-45 survive), K picks per image: the kept indices
    and their validity equal JAX's, the invalid picks included (the first
    dead index), and
    ``pairwise_iou_xyxy`` within 1e-6."""
    boxes, scores, classes = _nms_case(seed)
    want_idx, want_valid = _jax_batched_nms(boxes, scores, classes, 0.5, k)
    idx, valid = nms.batched_nms_fixed(torch.from_numpy(boxes), torch.from_numpy(scores),
                                       torch.from_numpy(classes), 0.5, k)
    np.testing.assert_array_equal(valid.numpy(), want_valid)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    assert 10 < want_valid[0].sum() < k and not want_valid[-1].any()
    np.testing.assert_allclose(nms.pairwise_iou_xyxy(torch.from_numpy(boxes[0]), torch.from_numpy(boxes[1])).numpy(),
                               np.asarray(jax_nms.pairwise_iou_xyxy(jnp.asarray(boxes[0]), jnp.asarray(boxes[1]))),
                               rtol=0, atol=1e-6)


def test_batched_nms_offsets_each_image_by_its_own_extent():
    """An image of small boxes beside one whose coordinates reach 1e5, with
    pairs of boxes at IoU within 1e-4 of the threshold: the class offset of
    each image is its own max + 1, as JAX computes it per image. Offsetting
    by the batch's max rounds the small image's boxes to 1/32 px, and its
    picks change (the test can tell the two apart)."""
    rng = np.random.RandomState(3)
    c = 120
    xy = rng.uniform(0, 50, (c // 2, 2))
    wh = rng.uniform(8, 20, (c // 2, 2))
    a = np.concatenate([xy, xy + wh], -1)
    # b: a shifted right by s, IoU (w - s) / (w + s) = 0.5 + 1e-4 · u
    target = 0.5 + 1e-4 * rng.uniform(-1, 1, c // 2)
    s = wh[:, 0] * (1 - target) / (1 + target)
    b = a + np.stack([s, np.zeros_like(s), s, np.zeros_like(s)], -1)
    small = np.concatenate([a, b]).astype(np.float32)
    big = small * 2000.0
    boxes = np.stack([small, big])
    scores = np.stack([rng.uniform(0, 1, c), rng.uniform(0, 1, c)]).astype(np.float32)
    classes = np.stack([np.full(c, 3), np.full(c, 3)])
    want_idx, want_valid = _jax_batched_nms(boxes, scores, classes, 0.5, 100)
    idx, valid = nms.batched_nms_fixed(*(torch.from_numpy(x) for x in (boxes, scores, classes)), 0.5, 100)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(valid.numpy(), want_valid)
    t = torch.from_numpy(boxes)
    batch_max = t.amax() + 1.0
    idx2, valid2 = nms.nms_fixed(t + 3 * batch_max, torch.from_numpy(scores), 0.5, 100)
    assert not (np.array_equal(idx2[0].numpy(), want_idx[0]) and np.array_equal(valid2[0].numpy(), want_valid[0]))


# -- the FPN and the head --------------------------------------------------------------------


FPN_CASES = {  # name: (overrides, the backbone build function of both packages)
    "retinanet_p6p7": ([], "build_retinanet_resnet_fpn_backbone"),
    "retinanet_p6p7_avg_bn": (["MODEL.FPN.FUSE_TYPE", "avg", "MODEL.RESNETS.NORM", "BN"],
                              "build_retinanet_resnet_fpn_backbone"),
    "rcnn_maxpool": (["MODEL.RESNETS.OUT_FEATURES", ["res2", "res3", "res4", "res5"],
                      "MODEL.FPN.IN_FEATURES", ["res2", "res3", "res4", "res5"]], "build_resnet_fpn_backbone"),
}


@pytest.mark.parametrize("case", list(FPN_CASES))
def test_fpn_pyramid_matches_jax(case):
    """Both build functions (RetinaNet's P6/P7 from res5; R-CNN's max-pool P6 over
    res2-res5) and ``fuse_type`` avg: every level within 1e-4 of its max, in
    eval mode; the port's keys are the reference's (``bottom_up``,
    ``fpn_lateral3``, ``top_block.p6``), and its P6 conv reads res5's
    channels."""
    extra, name = FPN_CASES[case]
    jcfg, pcfg = _cfgs(extra + ["MODEL.BACKBONE.NAME", name])
    jb = JAX_BACKBONES.get(name)(jcfg, dtype=jnp.float32)
    x = _images(2, seed=5) / 50.0
    shapes = jax.eval_shape(lambda: jb.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = _random_variables(shapes, seed=1)
    want = jb.apply(variables, jnp.asarray(x))
    port = BACKBONE_REGISTRY.get(name)(pcfg).eval()
    sd = state_dict_from_jax({k: {"backbone": v} for k, v in variables.items()})
    port.load_state_dict({k.removeprefix("backbone."): v for k, v in sd.items()})
    with torch.no_grad():
        got = port(_nchw(x))
    assert list(got) == port.out_features and set(got) == set(want)
    for k in want:
        _close(_nhwc(got[k]), np.asarray(want[k]), 1e-4, k)
    keys = set(port.state_dict())
    assert "fpn_lateral4.weight" in keys and "bottom_up.res4.0.conv1.weight" in keys
    if "p7" in got:
        assert port.top_block.p6.weight.shape[1] == port.bottom_up.out_feature_channels["res5"] == 128


def test_fpn_size_not_a_multiple_of_the_coarsest_stride_fails_as_in_jax(pair):
    """80²: res4 is 5×5 and res5 3×3, whose 2× upsample is 6×6. JAX's sum
    fails to broadcast; the port raises rather than interpolating to 5×5."""
    jm, variables, pm = pair
    x = _images(1, seed=0, size=80)
    with pytest.raises(Exception):
        jm.module.apply(variables, jnp.asarray(x))
    with pytest.raises(ValueError, match="multiple of 32"):
        pm.model(_nchw(x))


def test_head_logits_and_deltas_match_jax(pair):
    """The whole network in eval mode: each level's ``cls_score`` (9 anchors
    × 5 classes) and ``bbox_pred`` outputs within 1e-4 of their max; both
    predictors are f32 convs."""
    jm, variables, pm = pair
    x = _images(2, seed=6)
    want_logits, want_boxes = jm.module.apply(variables, jnp.asarray(jm.normalize(jnp.asarray(x))))
    with torch.no_grad():
        logits, boxes = pm.model.eval()(pm.normalize(_nchw(x)))
    assert len(logits) == len(want_logits) == 5
    for lvl, (g, w) in enumerate(zip(logits, want_logits)):
        assert g.shape[1] == 9 * 5
        _close(_nhwc(g), np.asarray(w), 1e-4, f"cls_score p{lvl + 3}")
    for lvl, (g, w) in enumerate(zip(boxes, want_boxes)):
        _close(_nhwc(g), np.asarray(w), 1e-4, f"bbox_pred p{lvl + 3}")
    assert isinstance(pm.model.head.cls_score, F32Conv2d) and isinstance(pm.model.head.bbox_pred, F32Conv2d)


def test_head_init_is_the_jax_packages():
    """The port's own init: tower convs and predictors N(0, 0.01) with zero
    bias but ``cls_score``'s, at -log(99) for PRIOR_PROB 0.01; the FPN convs
    lecun-normal (flax's default)."""
    _, pcfg = _cfgs(["MODEL.RETINANET.NUM_CONVS", 4, "MODEL.FPN.OUT_CHANNELS", 64])
    head = build_model(pcfg).model.head
    assert [k for k in head.state_dict() if k.endswith("weight")] == [
        f"{t}.{i}.weight" for t in ("cls_subnet", "bbox_subnet") for i in (0, 2, 4, 6)] + [
        "cls_score.weight", "bbox_pred.weight"]
    for name, p in head.named_parameters():
        if name.endswith("weight"):
            assert abs(p.std().item() - 0.01) < 2e-3 and abs(p.mean().item()) < 2e-3, name
        elif name == "cls_score.bias":
            assert torch.allclose(p, torch.full_like(p, -math.log(99.0)))
        else:
            assert not p.any(), name


# -- weights, parameter groups -----------------------------------------------------------


@pytest.mark.parametrize("extra", [[], EMA + ["MODEL.RESNETS.NORM", "BN"]], ids=["frozen_bn", "ema_bn"])
def test_state_dict_from_jax_covers_every_leaf_once_both_ways(extra):
    """Every JAX leaf of the RetinaNet tree (the ResNet under
    ``backbone/bottom_up``, laterals and outputs, ``top_block_p6``/``p7``,
    ``cls_tower{i}``/``box_tower{i}``, the predictors, the ema
    ``loss_normalizer``) maps to one port key of its shape and back; the
    port has no key beyond them but the BatchNorm counters. A state dict
    without the running count (a reference ``.pth``) loads and keeps 100."""
    jm, variables, pm = _pair(extra)
    sd = state_dict_from_jax(variables)
    own = pm.model.state_dict()
    assert set(own) - set(sd) == set() and set(own) == {k for k in sd if k in own}
    leaves = {"/".join(p) for p in flatten_dict(variables)}
    mapped = [canonical_key(k) for k in own if not k.endswith("num_batches_tracked")]
    assert sorted(mapped) == sorted(leaves)
    assert {torch_key(p) for p in leaves} == {k for k in own if not k.endswith("num_batches_tracked")}
    for key, t in own.items():
        assert t.shape == sd[key].shape, key
    for key in ("backbone.top_block.p6.weight", "head.cls_subnet.2.bias", "head.bbox_subnet.0.weight"):
        assert key in own
    assert canonical_key("head.cls_subnet.2.weight") == "params/head/cls_tower1/kernel"
    assert canonical_key("backbone.bottom_up.stem.conv1.norm.running_var") == \
        "batch_stats/backbone/bottom_up/stem/conv1_norm/bn/var"
    if extra:
        assert ("loss_normalizer" in own) and own["loss_normalizer"].item() == 100.0
        pm.model.loss_normalizer.fill_(7.0)
        pm.model.load_state_dict({k: v for k, v in own.items() if k != "loss_normalizer"})
        assert pm.model.loss_normalizer.item() == 7.0


def test_param_group_labels_match_jax_leaf_for_leaf():
    """FrozenBN and BN trunks: every JAX params leaf's optimizer group
    equals the group of the port's parameter it maps to: FrozenBN and BN
    affines "norm", the FPN and head biases "bias", kernels "default"."""
    for extra in ([], ["MODEL.RESNETS.NORM", "BN"]):
        jcfg, pcfg = _cfgs(extra)
        jm = jax_build_model(jcfg)
        params = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), (SIZE, SIZE)))["params"]
        want = {"/".join(("params",) + k): v for k, v in flatten_dict(jax_labels(params)).items()}
        got = param_group_labels(build_model(pcfg).model)
        assert {torch_key(p): label for p, label in want.items()} == got
        assert got["backbone.fpn_output3.bias"] == got["head.cls_score.bias"] == "bias"
        assert got["backbone.bottom_up.res3.0.conv1.norm.weight"] == "norm"


# -- the loss and its gradients ----------------------------------------------------------


def _batch(seed, n=2, m=6):
    """Two images with gt boxes of 8-40 px, the second with two empty
    slots."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 40, (n, m, 2))
    boxes = np.concatenate([xy, np.minimum(xy + rng.uniform(8, 40, (n, m, 2)), SIZE - 1)], -1)
    valid = np.ones((n, m), bool)
    valid[1, 4:] = False
    return {"image": rng.uniform(0, 255, (n, SIZE, SIZE, 3)).astype(np.float32),
            "gt_boxes": boxes.astype(np.float32), "gt_classes": rng.randint(0, 5, (n, m)).astype(np.int32),
            "gt_valid": valid}


def _port_batch(b):
    return {"image": _nchw(b["image"]), "gt_boxes": torch.from_numpy(b["gt_boxes"]),
            "gt_classes": torch.from_numpy(b["gt_classes"]), "gt_valid": torch.from_numpy(b["gt_valid"])}


@pytest.mark.parametrize("extra", [[], EMA], ids=["batch", "ema"])
def test_loss_and_every_gradient_match_jax(extra):
    """Base-RetinaNet's losses (focal α 0.25 γ 2, smooth-L1 β 0, i.e. L1)
    with the batch and the ema normalizer: both terms within 1e-5
    relative, and every parameter's gradient within 1e-4 of its own max
    |value| (FrozenBN; the frozen stem and res2 get 0 on both sides). The
    labels the port matched equal JAX's; the ema count moves to
    0.9·100 + 0.1·num_pos in a training ``loss_fn`` only."""
    jm, variables, pm = _pair(extra + ["MODEL.RETINANET.SMOOTH_L1_LOSS_BETA", 0.0])
    batch = _batch(1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    stats = variables["batch_stats"]
    (_, (jloss, jstats)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, stats, jbatch), has_aux=True))(variables["params"])
    anchors = jm._anchors_for((SIZE, SIZE))
    want_labels, _ = jax.vmap(jm.label_anchors, in_axes=(None, 0, 0, 0))(
        anchors, jbatch["gt_boxes"], jbatch["gt_classes"], jbatch["gt_valid"])
    pb = _port_batch(batch)
    for p in pm.model.parameters():  # as SimpleTrainer: the frozen stages' gradient is 0, not None
        p.grad = torch.zeros_like(p)
    labels, _ = pm.label_anchors(torch.cat(pm.anchors_per_level((SIZE, SIZE))), pb["gt_boxes"],
                                 pb["gt_classes"], pb["gt_valid"])
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_labels))
    assert (labels.numpy() < 5).sum() - (labels.numpy() < 0).sum() > 10  # some positives
    if extra:
        pm.model.eval()
        pm.loss_fn(pb)
        assert pm.model.loss_normalizer.item() == 100.0  # an eval loss_fn leaves it
    pm.model.train()
    total, losses = pm.loss_fn(pb)
    total.backward()
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), float(jloss[k]), rtol=1e-5, err_msg=k)
    if extra:
        np.testing.assert_allclose(pm.model.loss_normalizer.item(), float(jstats["loss_normalizer"]), rtol=1e-6)
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    grads = {k: p.grad for k, p in pm.model.named_parameters()}
    assert set(want) == set(grads)
    for k, g in grads.items():
        w = want[k].numpy()
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max(), k
    assert not grads["backbone.bottom_up.stem.conv1.weight"].any()


def test_ema_sgd_trajectory_and_resume_match_jax(tmp_path):
    """Three SGD steps (LR 0.01, momentum 0.9, no warm-up) with the ema
    normalizer, the JAX package's jitted train step against the port's
    optimizer step, each step on its own batch: the running count after
    each step within 1e-6 relative and the losses within 1e-4. Then the
    port's model and optimizer are saved and loaded into a new model: its
    fourth step gives the loss and count the uninterrupted run gives."""
    extra = EMA + ["SOLVER.BASE_LR", 0.01, "SOLVER.WARMUP_ITERS", 0]
    jm, variables, pm = _pair(extra)
    jcfg, pcfg = _cfgs(extra)
    tx = jax_build_optimizer(jcfg, variables["params"])
    state = TrainState.create(jax.tree_util.tree_map(jnp.array, variables), tx)
    step = make_train_step(jm, tx, get_mesh(1))
    opt, sched = build_optimizer(pcfg, pm.model)
    for p in pm.model.parameters():
        p.grad = torch.zeros_like(p)

    def port_step(model, optimizer, b):
        optimizer.zero_grad(set_to_none=False)
        total, _ = model.loss_fn(_port_batch(b))
        total.backward()
        optimizer.step()
        return total.item(), model.model.loss_normalizer.item()

    pm.model.train()
    for i in range(3):
        b = _batch(20 + i)
        state, metrics = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        loss, count = port_step(pm, opt, b)
        sched.step()
        np.testing.assert_allclose(count, float(state.batch_stats["loss_normalizer"]), rtol=1e-6)
        np.testing.assert_allclose(loss, float(metrics["total_loss"]), rtol=1e-4)
    assert count != 100.0
    path = tmp_path / "ckpt.pth"
    torch.save({"model": pm.model.state_dict(), "optimizer": opt.state_dict()}, path)
    _, pcfg2 = _cfgs(extra + ["SEED", 5])
    resumed = build_model(pcfg2)
    opt2, _ = build_optimizer(pcfg2, resumed.model)
    data = torch.load(path, weights_only=True)
    resumed.model.load_state_dict(data["model"])
    opt2.load_state_dict(data["optimizer"])
    for p in resumed.model.parameters():
        p.grad = torch.zeros_like(p)
    resumed.model.train()
    assert resumed.model.loss_normalizer.item() == count
    b = _batch(30)
    assert port_step(resumed, opt2, b) == port_step(pm, opt, b)


# -- inference -------------------------------------------------------------------------------


def _valid_count(scores, threshold=0.05):
    return (np.asarray(scores) > threshold).sum(axis=1)


def test_predict_fn_matches_jax(pair):
    """Two 64² images: the K = 100 slots of JAX's and the port's
    ``predict_fn``: the same validity and classes, scores within 1e-5, boxes
    within 1e-3 px, at least 20 valid detections per image."""
    jm, variables, pm = pair
    x = _images(2, seed=8)
    want = jax.jit(jm.predict_fn)(variables, jnp.asarray(x))
    got = pm.predict_fn(_nchw(x))
    assert got["boxes"].shape == (2, 100, 4)
    assert (_valid_count(want["scores"]) >= 20).all()
    np.testing.assert_array_equal(_valid_count(got["scores"]), _valid_count(want["scores"]))
    np.testing.assert_array_equal(got["classes"].numpy(), np.asarray(want["classes"]))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), rtol=0, atol=1e-3)


def test_default_predictor_matches_jax(pair, monkeypatch):
    """One BGR uint8 image of 50×70 through both DefaultPredictors,
    letterboxed to 64² (the JAX one fed the port's warp): at least 20
    detections, the same classes, scores within 1e-5, boxes within 1e-3 px
    of the image."""
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
    assert len(got) == len(want) >= 20
    np.testing.assert_array_equal(got.pred_classes, want.pred_classes)
    np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.pred_boxes.tensor, np.asarray(want.pred_boxes.tensor), rtol=0, atol=1e-3)


def test_nchw_reshape_without_the_permute_gives_other_detections(pair, monkeypatch):
    """The heads come out NCHW; flattened straight from that layout
    (without the permute to N, H, W, A·C), anchors and classes scramble
    across cells. At 9 anchors and 5 classes that gives other detections
    than JAX's and another loss, which is what the permute prevents."""
    jm, variables, pm = pair
    x = _images(2, seed=8)
    want = jax.jit(jm.predict_fn)(variables, jnp.asarray(x))
    batch = _batch(2)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jtotal, _ = jm.loss_fn(variables["params"], variables["batch_stats"], jbatch)
    monkeypatch.setattr(retinanet, "nhwc_flat", lambda t, width: t.reshape(t.shape[0], -1, width))
    got = pm.predict_fn(_nchw(x))
    assert not np.array_equal(got["classes"].numpy(), np.asarray(want["classes"]))
    assert not np.allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), atol=1e-3)
    pm.model.eval()
    total, _ = pm.loss_fn(_port_batch(batch))
    assert abs(total.item() - float(jtotal)) > 1e-3 * abs(float(jtotal))


def test_retinanet_raises_without_a_card():
    """MODEL.DEVICE is cuda by default: no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "COCO-Detection", "retinanet_R_50_FPN_1x.yaml"))
    with pytest.raises(RuntimeError, match="MODEL.DEVICE=cpu"):
        build_model(cfg)


# -- training and evaluation through DefaultTrainer ----------------------------------------------


def test_default_trainer_trains_two_steps_then_evaluates(tmp_path):
    """``retinanet_R_50_FPN_1x.yaml`` cut in width (ResNet-18, RES2 16, FPN
    32, 2 tower convs) and size (64²), on the synthetic stand-ins, 2 SGD
    steps at batch 2 with the color jitter the YAML leaves on, then the
    evaluation that ends ``train()``: finite losses, a finite bbox AP dict,
    and the final checkpoint."""
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "COCO-Detection", "retinanet_R_50_FPN_1x.yaml"))
    cfg.merge_from_list([
        "MODEL.DEVICE", "cpu", "MODEL.WEIGHTS", "", "MODEL.RESNETS.DEPTH", 18,
        "MODEL.RESNETS.RES2_OUT_CHANNELS", 16, "MODEL.RESNETS.STEM_OUT_CHANNELS", 8, "MODEL.FPN.OUT_CHANNELS", 32,
        "MODEL.RETINANET.NUM_CONVS", 2, "INPUT.TRAIN_SIZE", (SIZE, SIZE), "INPUT.TEST_SIZE", (SIZE, SIZE),
        "SOLVER.IMS_PER_BATCH", 2, "SOLVER.MAX_ITER", 2, "TEST.BATCH_SIZE", 2, "DATALOADER.NUM_WORKERS", 1,
        "DATASETS.TRAIN", ("test_torch_retinanet_train",), "DATASETS.TEST", ("test_torch_retinanet_val",),
        "OUTPUT_DIR", str(tmp_path), "TPU.DTYPE", "float32"])
    ensure_synthetic_datasets(list(cfg.DATASETS.TRAIN) + list(cfg.DATASETS.TEST))
    trainer = DefaultTrainer(cfg)
    assert type(trainer.model).__name__ == "RetinaNet" and trainer.model.device_augment is not None
    trainer.resume_or_load(resume=False)
    results = trainer.train()
    losses = [v for v, _ in trainer.storage.history("total_loss").values()]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    bbox = results["bbox"]
    assert {"AP", "AP50", "AP75"} <= set(bbox) and all(math.isfinite(bbox[k]) for k in ("AP", "AP50", "AP75"))
    assert (tmp_path / "model_final.pth").exists()


def test_chip_smoke_reads_retinanet_as_the_jax_package_does():
    """``chip_smoke.py``'s RetinaNet config is ``retinanet_R_50_FPN_1x.yaml``
    read from its file, the run's dtype, output directory and seed over it
    and no weights file: key for key the JAX package's config of the same
    file and overrides, at full width."""
    import sys

    sys.path.insert(0, REPO)
    import chip_smoke

    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        got = chip_smoke.retinanet_cfg("bfloat16")
    finally:
        os.chdir(cwd)
    want = jax_get_cfg()
    want.merge_from_file(os.path.join(REPO, "configs", "COCO-Detection", "retinanet_R_50_FPN_1x.yaml"))
    want.merge_from_list(["TPU.DTYPE", "bfloat16", "OUTPUT_DIR", "output/chip_smoke", "SEED", 0, "MODEL.WEIGHTS", ""])
    assert _flat(got) == _flat(want)
    assert got.MODEL.RESNETS.DEPTH == 50 and got.MODEL.FPN.OUT_CHANNELS == 256
    assert got.MODEL.RETINANET.NUM_CLASSES == 80 and tuple(got.INPUT.TEST_SIZE) == (800, 800)


def _flat(node, prefix=""):
    out = {}
    for key, val in node.items():
        if isinstance(val, dict):
            out.update(_flat(val, prefix + key + "."))
        else:
            out[prefix + key] = val
    return out
