"""The port's Mask R-CNN slice against the JAX package on the CPU, at a small
size (ResNet-18 with RES2 16 and a stem of 8, FPN 32, FC_DIM 64, a mask head
of 4 convs of 32, 5 classes, 64² inputs; the sizes of ``test_torch_rcnn.py``):
RLE (encode, decode, area, IoU with crowd), ``polygons_to_bitmask`` against
the JAX package's ``cv2.fillPoly`` (the synthetic rectangles after a random
warp, seeded random convex and concave polygons, polygons leaving the
image), ``BitMasks`` and ``PolygonMasks``, ``paste_masks_in_image``, the
mapper's ``gt_masks``, ``crop_gt_masks``, the mask head with weights crossed
from JAX, ``mask_rcnn_loss``, the whole model's loss and every gradient on
JAX's draws, ``predict_fn`` and ``postprocess``, segm COCO evaluation, and
the entry points (``DefaultTrainer``, ``tools/bench``'s name, the options
that still raise).

Tolerances: exact for RLE, the polygon fill, the pasted masks and the
mapper's rasters; 1e-6 for ``crop_gt_masks``; 1e-5 (of the output's scale)
for the head on crossed weights; 1e-5 relative for the losses and 1e-4 of
each gradient's own max for the gradients.
"""

import copy
import importlib
import math
import os

import numpy as np
import pytest
import torch

import cv2
import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from detectron2_centernet_tpu.config import get_cfg as jax_get_cfg
from detectron2_centernet_tpu.data import DatasetCatalog as JaxDatasetCatalog
from detectron2_centernet_tpu.data import MetadataCatalog as JaxMetadataCatalog
from detectron2_centernet_tpu.data.dataset_mapper import DatasetMapper as JaxMapper
from detectron2_centernet_tpu.evaluation import COCOEvaluator as JaxCOCOEvaluator
from detectron2_centernet_tpu.evaluation import instances_to_coco_json as jax_to_json
from detectron2_centernet_tpu.models.roi_heads.mask_head import MaskRCNNConvUpsampleHead as JaxMaskHead
from detectron2_centernet_tpu.structures import Boxes as JaxBoxes
from detectron2_centernet_tpu.structures import Instances as JaxInstances
from detectron2_centernet_tpu_torch.checkpoint import state_dict_from_jax
from detectron2_centernet_tpu_torch.config import get_cfg
from detectron2_centernet_tpu_torch.data import DatasetCatalog, DatasetMapper, MetadataCatalog
from detectron2_centernet_tpu_torch.data.datasets import ensure_synthetic_datasets, register_synthetic_instances
from detectron2_centernet_tpu_torch.engine import DefaultTrainer
from detectron2_centernet_tpu_torch.evaluation import COCOEvaluator, instances_to_coco_json
from detectron2_centernet_tpu_torch.models import build_model
from detectron2_centernet_tpu_torch.models.roi_heads import mask_head
from detectron2_centernet_tpu_torch.structures import Boxes, Instances, masks, rle
from detectron2_centernet_tpu_torch.tools import bench, train_acc

from test_torch_rcnn import SIZE, _anchor_count, _batch, _images, _jax_draws, _nchw, _pair, _port_batch

jax_rle = importlib.import_module("detectron2_centernet_tpu.structures.rle")
jax_masks = importlib.import_module("detectron2_centernet_tpu.structures.masks")
jax_mask_head = importlib.import_module("detectron2_centernet_tpu.models.roi_heads.mask_head")
jax_synthetic = importlib.import_module("detectron2_centernet_tpu.data.datasets.synthetic")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MASK = ["MODEL.MASK_ON", True, "MODEL.ROI_MASK_HEAD.CONV_DIM", 32, "INPUT.MASK_RASTER", 16]


@pytest.fixture(scope="module")
def pair():
    return _pair(MASK)


@pytest.fixture(scope="module")
def jax_predict(pair):
    """JAX's ``predict_fn`` jitted once for the tests below (each calls it
    on two 64² images)."""
    return jax.jit(pair[0].predict_fn)


# -- RLE ---------------------------------------------------------------------------------------------


def _random_masks(seed, n=6, h=23, w=31):
    rng = np.random.RandomState(seed)
    out = [rng.rand(h, w) > rng.uniform(0.2, 0.8) for _ in range(n)]
    out += [np.zeros((h, w), bool), np.ones((h, w), bool)]
    first = np.zeros((h, w), bool)
    first[0, 0] = True  # a mask whose first pixel is set: its counts start with a 0-run
    return out + [first]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rle_encode_decode_and_counts_strings_equal_jax(seed):
    """mask → RLE → mask round trip and the compressed counts string (both
    ways), the port's against JAX's, equal."""
    for m in _random_masks(seed):
        got, want = rle.mask_to_rle(m), jax_rle.mask_to_rle(m)
        assert got == want
        np.testing.assert_array_equal(rle.rle_to_mask(got), m)
        s = rle.encode_counts(got["counts"])
        assert s == jax_rle.encode_counts(want["counts"])
        assert rle.decode_counts(s) == jax_rle.decode_counts(s) == got["counts"]
        assert rle.rle_area(got) == jax_rle.rle_area(want) == int(m.sum())
        np.testing.assert_array_equal(rle.rle_to_mask({"size": got["size"], "counts": s}), m)


@pytest.mark.parametrize("seed", [0, 1])
def test_rle_iou_with_crowd_equals_jax(seed):
    """Pairwise mask IoU of RLEs (some compressed), crowd columns divided by
    the detection's area: the port's matrix equals JAX's, and both equal the
    IoU counted on the pixels."""
    dts, gts = _random_masks(seed), _random_masks(seed + 10)[:5]
    crowd = [0, 1, 0, 1, 0]
    d_rles = [rle.mask_to_rle(m) for m in dts]
    g_rles = [rle.mask_to_rle(m) for m in gts]
    g_rles[1] = {"size": g_rles[1]["size"], "counts": rle.encode_counts(g_rles[1]["counts"])}
    got = rle.rle_iou(d_rles, g_rles, crowd)
    np.testing.assert_array_equal(got, jax_rle.rle_iou(d_rles, g_rles, crowd))
    for i, d in enumerate(dts):
        for j, g in enumerate(gts):
            inter = (d & g).sum()
            den = d.sum() if crowd[j] else (d | g).sum()
            assert got[i, j] == pytest.approx(inter / den if den else 0.0, abs=1e-12)


# -- the polygon fill against cv2 -------------------------------------------------------------------


def _cv2_fill(polys, h, w):
    return jax_masks.polygons_to_bitmask(polys, h, w)


def _random_polygons(rng, h, w, convex, spread=(0.0, 1.0)):
    polys = []
    for _ in range(rng.randint(1, 4)):
        k = rng.randint(3, 12)
        c = rng.uniform(spread[0] * np.array([w, h]), spread[1] * np.array([w, h]))
        ang = np.sort(rng.uniform(0, 2 * np.pi, k)) if convex else rng.uniform(0, 2 * np.pi, k)
        rad = rng.uniform(2, 0.6 * max(h, w), 1 if convex else k)
        pts = c + np.stack([np.cos(ang), np.sin(ang)], 1) * rad[:, None]
        polys.append(pts.reshape(-1))
    return polys


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_polygons_to_bitmask_equals_cv2_on_warped_synthetic_rectangles(seed):
    """The synthetic scenes' rectangles through the train mapper's random
    warps (scale, shift, flip), rasterized in their clipped boxes at 16, 28
    and 64 (the polygon often leaves the raster): the port's fill equals the
    JAX package's ``cv2.fillPoly`` pixel for pixel."""
    from detectron2_centernet_tpu_torch.data.transforms import CenterAffineAug
    from detectron2_centernet_tpu_torch.data.detection_utils import apply_affine_to_points

    rng = np.random.RandomState(seed)
    aug = CenterAffineAug((64, 64), scale_range=(0.6, 1.4), shift_range=0.2, flip_prob=0.5)
    scene_rng = np.random.RandomState(100 + seed)
    for _ in range(10):
        _, annos = jax_synthetic._scene(scene_rng, 96, 128, 4)
        m = aug(96, 128, rng)
        for a in annos:
            poly = apply_affine_to_points(m, np.asarray(a["segmentation"][0]).reshape(-1, 2)).reshape(-1)
            box = np.array([poly[0::2].min(), poly[1::2].min(), poly[0::2].max(), poly[1::2].max()])
            box = np.clip(box, 0, 63)
            if box[2] - box[0] < 1e-5 or box[3] - box[1] < 1e-5:
                continue
            for r in (16, 28, 64):
                np.testing.assert_array_equal(masks.rasterize_in_box([poly], box, r),
                                              jax_masks.rasterize_in_box([poly], box, r))


@pytest.mark.parametrize("convex", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_polygons_to_bitmask_equals_cv2_on_random_polygons(seed, convex):
    """Seeded random convex (angles sorted) and concave or self-crossing
    polygons, one to three per mask, on random canvases from 5² to 70²:
    equal to cv2 on every one."""
    rng = np.random.RandomState(seed + 10 * convex)
    for _ in range(150):
        h, w = rng.randint(5, 71, 2)
        polys = _random_polygons(rng, h, w, convex)
        np.testing.assert_array_equal(masks.polygons_to_bitmask(polys, h, w), _cv2_fill(polys, h, w))


@pytest.mark.parametrize("seed", [0, 1])
def test_polygons_to_bitmask_equals_cv2_where_polygons_leave_the_image(seed):
    """Vertices well outside the canvas on every side (cv2 clips each edge
    and steps the fill from the clipped end points, and polygons of fewer
    than 3 points are dropped): still equal, on 300 cases."""
    rng = np.random.RandomState(seed)
    for _ in range(300):
        h, w = rng.randint(5, 60, 2)
        polys = _random_polygons(rng, h, w, convex=bool(rng.randint(2)), spread=(-0.6, 1.6))
        if rng.rand() < 0.2:
            polys.append(rng.uniform(0, 30, 4))  # two points: dropped
        np.testing.assert_array_equal(masks.polygons_to_bitmask(polys, h, w), _cv2_fill(polys, h, w))


def test_polygons_to_bitmask_equals_cv2_at_image_size():
    """The evaluation's ground truth: polygons filled at 480x640, equal."""
    rng = np.random.RandomState(5)
    for _ in range(6):
        polys = _random_polygons(rng, 480, 640, convex=bool(rng.randint(2)))
        np.testing.assert_array_equal(masks.polygons_to_bitmask(polys, 480, 640), _cv2_fill(polys, 480, 640))


# -- BitMasks, PolygonMasks -------------------------------------------------------------------------


def test_bitmasks_crop_and_resize_equals_cv2():
    """``BitMasks.crop_and_resize`` resizes as cv2's INTER_LINEAR does:
    against cv2's own code (its IPP route off) the crops are equal and the
    resized values within one f32 ulp of 1 (5.96e-8); against the default
    build (IPP on, whose positions are computed apart) within 5e-6."""
    rng = np.random.RandomState(0)
    bm = np.stack([rng.rand(50, 60) > 0.5 for _ in range(8)])
    xy = rng.uniform(0, 40, (8, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(1, 30, (8, 2))], 1)
    ipp = cv2.ipp.useIPP()
    try:
        cv2.ipp.setUseIPP(False)
        np.testing.assert_array_equal(masks.BitMasks(bm).crop_and_resize(boxes, 28),
                                      jax_masks.BitMasks(bm).crop_and_resize(boxes, 28))
        worst = 0.0
        for _ in range(200):
            h, w, oh, ow = rng.randint(1, 60, 4)
            img = rng.rand(h, w).astype(np.float32)
            want = cv2.resize(img, (int(ow), int(oh)), interpolation=cv2.INTER_LINEAR).reshape(oh, ow)
            worst = max(worst, np.abs(masks.resize_bilinear(img, (oh, ow)) - want).max())
        assert worst <= 6e-8, worst
    finally:
        cv2.ipp.setUseIPP(ipp)
    img = rng.rand(47, 41).astype(np.float32)
    want = cv2.resize(img, (37, 29), interpolation=cv2.INTER_LINEAR)
    assert np.abs(masks.resize_bilinear(img, (29, 37)) - want).max() <= 5e-6


def test_bitmask_and_polygon_mask_helpers_equal_jax():
    """Boxes, areas, nonempty, indexing and the polygon → bitmask conversion
    of both containers equal the JAX package's."""
    rng = np.random.RandomState(1)
    polys = [_random_polygons(rng, 40, 50, convex=True) for _ in range(4)] + [[]]
    got, want = masks.PolygonMasks(polys), jax_masks.PolygonMasks(polys)
    np.testing.assert_array_equal(got.get_bounding_boxes().tensor, want.get_bounding_boxes().tensor)
    np.testing.assert_array_equal(got.area(), want.area())
    np.testing.assert_array_equal(got.nonempty(), want.nonempty())
    assert len(got[[0, 2]]) == 2 and len(got[np.array([True, False, True, False, True])]) == 3
    bits = masks.BitMasks.from_polygon_masks(got, 40, 50)
    ref = jax_masks.BitMasks.from_polygon_masks(want, 40, 50)
    np.testing.assert_array_equal(bits.tensor, ref.tensor)
    np.testing.assert_array_equal(bits.get_bounding_boxes().tensor, ref.get_bounding_boxes().tensor)
    np.testing.assert_array_equal(bits.nonempty(), ref.nonempty())
    boxes = np.array([[2, 3, 30, 20]] * 5, np.float32)
    np.testing.assert_array_equal(got.crop_and_resize(boxes, 14), want.crop_and_resize(boxes, 14))


# -- pasting ------------------------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paste_masks_in_image_equals_jax(seed, monkeypatch):
    """(N, 28, 28) probabilities pasted at random sub-pixel boxes (thin ones,
    ones reaching out of the image, an empty one) into canvases up to 120²:
    the port's bool masks equal the JAX package's f64 numpy ones bit for bit,
    in one chunk and in chunks of 2000 window pixels."""
    rng = np.random.RandomState(seed)
    for t in range(8):
        n = rng.randint(1, 12)
        h, w = rng.randint(10, 121, 2)
        probs = rng.rand(n, 28, 28).astype(np.float32)
        xy = rng.uniform(-20, max(h, w), (n, 2))
        wh = rng.uniform(0, 80, (n, 2))
        if t % 3 == 0:
            wh[:, 0] = rng.uniform(0, 2, n)
        boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        boxes[0] = [w + 5, h + 5, w + 9, h + 9]  # wholly outside: an empty window
        want = jax_masks.paste_masks_in_image(probs, boxes, (h, w))
        for chunk in (1 << 24, 2000):
            monkeypatch.setattr(masks, "PASTE_CHUNK", chunk)
            got = masks.paste_masks_in_image(torch.from_numpy(probs), torch.from_numpy(boxes), (h, w))
            assert got.dtype == torch.bool
            np.testing.assert_array_equal(got.numpy(), want)
    assert masks.paste_masks_in_image(np.zeros((0, 28, 28), np.float32), np.zeros((0, 4)), (5, 6)).shape == (0, 5, 6)


# -- the training targets --------------------------------------------------------------------------


def _mapper_cfgs(extra=()):
    common = ["MODEL.MASK_ON", True, "INPUT.MASK_RASTER", 28, "MODEL.CENTERNET.MAX_OBJS", 8,
              "INPUT.TRAIN_SIZE", (64, 64), "INPUT.COLOR_JITTER", False, "DATASETS.TRAIN", ()] + list(extra)
    jcfg, pcfg = jax_get_cfg(), get_cfg()
    jcfg.merge_from_list(common)
    pcfg.merge_from_list(common + ["MODEL.DEVICE", "cpu"])
    return jcfg, pcfg


def _polygon_dicts(seed, n=6):
    """96x128 images whose instances are random concave polygons (one or
    two per instance), their boxes the polygons' extent."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        annos = []
        for _ in range(rng.randint(1, 5)):
            polys = _random_polygons(rng, 96, 128, convex=bool(rng.randint(2)), spread=(0.1, 0.9))[:2]
            pts = np.concatenate([p.reshape(-1, 2) for p in polys])
            x0, y0 = np.clip(pts.min(0), 0, None)
            x1, y1 = np.minimum(pts.max(0), [127, 95])
            if x1 - x0 < 1 or y1 - y0 < 1:
                continue
            annos.append({"bbox": [float(x0), float(y0), float(x1), float(y1)], "bbox_mode": 0,
                          "category_id": int(rng.randint(80)), "iscrowd": 0,
                          "segmentation": [p.tolist() for p in polys]})
        out.append({"image": rng.randint(0, 256, (96, 128, 3)).astype(np.uint8), "height": 96, "width": 128,
                    "image_id": i, "annotations": annos})
    return out


@pytest.mark.parametrize("source", ["synthetic", "polygons"])
def test_mapper_gt_masks_equal_jax(source):
    """The same dicts and RandomStates through both train mappers with
    MODEL.MASK_ON: the warp, the boxes and the (MAX_OBJS, 28, 28) rasters
    equal (the synthetic rectangles, and random concave polygons)."""
    if source == "synthetic":
        name = "test_torch_mask_mapper"
        if name not in DatasetCatalog:
            register_synthetic_instances(name, num_images=6)
        dicts = DatasetCatalog.get(name)
    else:
        dicts = _polygon_dicts(3)
    jcfg, pcfg = _mapper_cfgs()
    filled = 0
    for i, d in enumerate(dicts):
        want = JaxMapper(jcfg, is_train=True)(copy.deepcopy(d), rng=np.random.RandomState(i))
        got = DatasetMapper(pcfg, is_train=True)(copy.deepcopy(d), rng=np.random.RandomState(i))
        for k in ("warp", "gt_boxes", "gt_classes", "gt_valid", "gt_masks"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["gt_masks"].dtype == np.uint8 and got["gt_masks"].shape == (8, 28, 28)
        filled += int(got["gt_masks"].any((1, 2)).sum())
    assert filled >= 6


@pytest.mark.parametrize("seed", [0, 1])
def test_crop_gt_masks_matches_jax(seed):
    """Each sampled roi's 28² target from its matched gt's 16² raster (rois
    around, inside and beyond the gt box): within 1e-6 of JAX's."""
    rng = np.random.RandomState(seed)
    n, m, s, r = 2, 5, 40, 16
    rasters = (rng.rand(n, m, r, r) > 0.5).astype(np.uint8)
    xy = rng.uniform(0, 40, (n, m, 2))
    gt = np.concatenate([xy, xy + rng.uniform(2, 30, (n, m, 2))], -1).astype(np.float32)
    matched = rng.randint(0, m, (n, s))
    g = gt[np.arange(n)[:, None], matched]
    rois = (g + rng.randn(n, s, 4) * 4).astype(np.float32)
    want = jax.vmap(lambda ra, gb, mi, ro: jax_mask_head.crop_gt_masks(ra.astype(jnp.float32), gb, mi, ro, 28))(
        jnp.asarray(rasters), jnp.asarray(gt), jnp.asarray(matched), jnp.asarray(rois))
    got = mask_head.crop_gt_masks(torch.from_numpy(rasters), torch.from_numpy(gt), torch.from_numpy(matched),
                                  torch.from_numpy(rois), 28)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(n * s, 28, 28), rtol=0, atol=1e-6)
    assert 0.1 < (got.numpy() > 0.5).mean() < 0.9


def test_mask_rcnn_loss_matches_jax():
    """BCE at the gt class over the foreground rois (class C rois clamp, and
    weigh 0), within 1e-6 relative: the port's loss takes each roi's
    logits at its clamped class, which its mask head computes alone."""
    rng = np.random.RandomState(0)
    s, c = 30, 5
    logits = (rng.randn(s, 28, 28, c) * 3).astype(np.float32)
    targets = rng.rand(s, 28, 28).astype(np.float32)
    classes = rng.randint(0, c + 1, s)
    fg = (classes < c).astype(np.float32)
    want = jax_mask_head.mask_rcnn_loss(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(classes),
                                        jnp.asarray(fg))
    at_class = logits[np.arange(s), :, :, np.clip(classes, 0, c - 1)]
    got = mask_head.mask_rcnn_loss(torch.from_numpy(at_class), torch.from_numpy(targets), torch.from_numpy(fg))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_mask_head_on_crossed_weights_matches_jax():
    """``MaskRCNNConvUpsampleHead`` (4 convs of 32, the 2x2 stride-2 deconv,
    the f32 1x1 predictor) on random weights crossed from JAX through
    ``state_dict_from_jax`` (the deconv's kernel flipped): logits within
    1e-5 of their scale; with the deconv not flipped they are not."""
    rng = np.random.RandomState(2)
    jhead = JaxMaskHead(5, num_conv=4, conv_dim=32)
    x = rng.randn(6, 14, 14, 24).astype(np.float32)
    shapes = jax.eval_shape(lambda: jhead.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params = {k: (rng.randn(*v.shape) / np.sqrt(np.prod(v.shape[:-1]))).astype(np.float32)
              for k, v in flatten_dict(shapes["params"]).items()}
    from flax.traverse_util import unflatten_dict

    params = unflatten_dict(params)
    want = np.asarray(jhead.apply({"params": params}, jnp.asarray(x))).transpose(0, 3, 1, 2)
    state = {k.removeprefix("roi_heads.mask_head."): v
             for k, v in state_dict_from_jax({"params": {"mask_head": params}}).items()}
    head = mask_head.MaskRCNNConvUpsampleHead(24, 5, 4, 32)
    head.load_state_dict(state)
    got = head(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).detach().numpy()
    assert got.shape == (6, 5, 28, 28)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    with torch.no_grad():
        head.deconv.weight.copy_(head.deconv.weight.flip(-1, -2))
        flipped = head(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    assert np.abs(flipped - want).max() > 1e-2 * scale


# -- the whole model -----------------------------------------------------------------------------


def _mask_batch(seed):
    """``test_torch_rcnn``'s batch (2 images, 6 gt slots) with 16² gt rasters."""
    b = _batch(seed)
    rng = np.random.RandomState(seed + 50)
    b["gt_masks"] = (rng.rand(*b["gt_boxes"].shape[:2], 16, 16) > 0.4).astype(np.uint8)
    return b


def test_loss_and_every_gradient_match_jax(pair):
    """The five losses on JAX's draws (the mask loss on the foreground rois,
    64 sampled per image at a quarter positive) within 1e-5 relative, and
    every parameter's gradient within 1e-4 of its own max |value|; the mask
    head's gradients are not 0."""
    jm, variables, pm = pair
    batch, key = _mask_batch(1), jax.random.PRNGKey(5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch["rng"] = key
    stats = variables["batch_stats"]
    (_, (jloss, _)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, stats, jbatch), has_aux=True))(variables["params"])
    pb = _port_batch(batch, _jax_draws(key, 2, _anchor_count(pm), max(100 + 6, 64)))
    pb["gt_masks"] = torch.from_numpy(batch["gt_masks"])
    for p in pm.model.parameters():
        p.grad = torch.zeros_like(p)
    pm.model.train()
    total, losses = pm.loss_fn(pb)
    total.backward()
    pm.model.eval()
    assert set(losses) == set(jloss) == {"loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "loss_mask"}
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), float(jloss[k]), rtol=1e-5, err_msg=k)
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    grads = {k: p.grad for k, p in pm.model.named_parameters()}
    assert set(want) == set(grads)
    for k, g in grads.items():
        w = want[k].numpy()
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max(), k
    assert grads["roi_heads.mask_head.deconv.weight"].abs().max() > 0


def test_mask_loss_on_the_foreground_block_equals_every_slot(pair, monkeypatch):
    """The port runs the mask head on the first int(64 · 0.25) = 16 slots of
    each image; on all 64 (the JAX package's way: the block widened by a
    positive fraction of 1 for the mask loss alone) the loss is the same to
    1e-6 and so is the predictor's gradient: no foreground roi lies past the
    block."""
    _, _, pm = pair
    batch, key = _mask_batch(2), jax.random.PRNGKey(7)
    draws = _jax_draws(key, 2, _anchor_count(pm), max(100 + 6, 64))
    extra_losses = type(pm)._roi_extra_losses

    def every_slot(self, *args):
        monkeypatch.setattr(self, "roi_positive_fraction", 1.0)
        try:
            return extra_losses(self, *args)
        finally:
            monkeypatch.undo()

    out = []
    for widen in (False, True):
        if widen:
            monkeypatch.setattr(type(pm), "_roi_extra_losses", every_slot)
        pb = _port_batch(batch, draws)
        pb["gt_masks"] = torch.from_numpy(batch["gt_masks"])
        for p in pm.model.parameters():
            p.grad = torch.zeros_like(p)
        pm.model.train()
        try:
            _, losses = pm.loss_fn(pb)
            losses["loss_mask"].backward()
        finally:
            pm.model.eval()
            monkeypatch.undo()
        out.append((losses["loss_mask"].item(), pm.model.roi_heads.mask_head.predictor.weight.grad.clone()))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-6)
    torch.testing.assert_close(out[0][1], out[1][1], rtol=0, atol=1e-6 * out[1][1].abs().max().item())
    assert out[0][0] > 0


def test_predict_fn_masks_match_jax(pair, jax_predict):
    """Two 64² images: ``masks`` (N, 100, 28, 28), the sigmoid at each
    detection's class, within 2e-3 of JAX's (the detections' boxes agree to
    1e-2 px, ``test_torch_rcnn``; the masks are pooled on them), with the
    same classes; and the mask logits of the same boxes pooled on both
    sides within 1e-5 of their scale."""
    jm, variables, pm = pair
    x = _images(2, seed=8)
    want = jax_predict(variables, jnp.asarray(x))
    got = pm.predict_fn(_nchw(x))
    assert got["masks"].shape == (2, 100, 28, 28)
    np.testing.assert_array_equal(got["classes"].numpy(), np.asarray(want["classes"]))
    np.testing.assert_allclose(got["masks"].numpy(), np.asarray(want["masks"]), rtol=0, atol=2e-3)
    assert 0.05 < float(np.asarray(want["masks"]).std())

    boxes = np.array(want["boxes"]).reshape(-1, 4)
    net = type(jm.module)

    @jax.jit
    def mask_logits(variables, x, boxes):
        feats = jm.module.apply(variables, jm.normalize(x), False, method=net.backbone_rpn)[0]
        pooled = jm._pool(feats, boxes, jnp.repeat(jnp.arange(2, dtype=jnp.int32), 100), jm.mask_pooler_resolution)
        return jm.module.apply(variables, pooled, False, method=net.mask_predict)

    want_logits = np.asarray(mask_logits(variables, jnp.asarray(x), jnp.asarray(boxes))).transpose(0, 3, 1, 2)
    with torch.no_grad():
        feats = pm.model(pm.normalize(_nchw(x)))[0]
        got_logits = pm.model.mask_predict(pm.pool(feats, torch.from_numpy(boxes), 100, pm.mask_pooler_resolution))
    assert got_logits.shape == want_logits.shape == (200, pm.num_classes, 28, 28)
    np.testing.assert_allclose(got_logits.numpy(), want_logits, rtol=0, atol=1e-5 * np.abs(want_logits).max())


def test_postprocess_pastes_the_jax_masks_equally(pair, jax_predict):
    """JAX's own ``predict_fn`` output (its boxes, which the random model
    flattens, replaced by random boxes in the 64² frame, a few reaching out
    of it) through both ``postprocess``es, with the identity warp at 64x64
    and a letterbox from 80x96: the same boxes, scores, classes, and the
    pasted (D, H, W) masks equal bit for bit."""
    jm, variables, pm = pair
    from detectron2_centernet_tpu_torch.data import letterbox_transform

    x = _images(2, seed=9)
    dets = {k: np.asarray(v) for k, v in jax_predict(variables, jnp.asarray(x)).items()}
    rng = np.random.RandomState(9)
    xy = rng.uniform(-8, 60, (2, 100, 2))
    dets["boxes"] = np.concatenate([xy, xy + rng.uniform(0.5, 40, (2, 100, 2))], -1).astype(np.float32)
    warps = [np.eye(2, 3, dtype=np.float32), letterbox_transform(80, 96, (SIZE, SIZE)).astype(np.float32)]
    sizes = [(64, 64), (80, 96)]
    got = pm.postprocess(dets, warps, sizes)
    want = jm.postprocess(dets, warps, sizes)
    for g, w in zip(got, want):
        g, w = g["instances"], w["instances"]
        assert len(g) == len(w) > 3
        np.testing.assert_array_equal(g.pred_boxes.tensor, np.asarray(w.pred_boxes.tensor))
        np.testing.assert_array_equal(g.scores, w.scores)
        np.testing.assert_array_equal(g.pred_classes, w.pred_classes)
        assert g.pred_masks.dtype == bool and g.pred_masks.shape == (len(g),) + g.image_size
        np.testing.assert_array_equal(g.pred_masks, w.pred_masks)
        assert g.pred_masks.any()


# -- evaluation -----------------------------------------------------------------------------------


def _register_both(name, dicts, classes):
    for catalog, meta in ((DatasetCatalog, MetadataCatalog), (JaxDatasetCatalog, JaxMetadataCatalog)):
        if name not in catalog:
            catalog.register(name, lambda d=dicts: copy.deepcopy(d))
            meta.get(name).set(thing_classes=classes)


def _predicted_instances(dicts, rng, keypoints=False):
    """Per image, jittered copies of its gt (boxes, filled polygons, grid
    keypoints) and random extra ones, on both packages' Instances."""
    out = []
    for d in dicts:
        h, w = d["height"], d["width"]
        boxes, ms, cls, kps = [], [], [], []
        for a in d["annotations"]:
            x, y, bw, bh = a["bbox"]
            for _ in range(2):
                j = rng.randn(4) * 2
                boxes.append([x + j[0], y + j[1], x + bw + j[2], y + bh + j[3]])
                m = masks.polygons_to_bitmask(a["segmentation"], h, w)
                ms.append(np.roll(m, rng.randint(-3, 4), axis=int(rng.randint(2))))
                cls.append(a["category_id"] if rng.rand() < 0.8 else int(rng.randint(3)))
                if keypoints:
                    k = np.asarray(a["keypoints"], np.float64).reshape(-1, 3)
                    kps.append(np.concatenate([k[:, :2] + rng.randn(17, 2) * 2, rng.rand(17, 1)], 1))
        for _ in range(3):
            xy = rng.uniform(0, [w - 10, h - 10])
            boxes.append([*xy, *(xy + rng.uniform(4, 40, 2))])
            ms.append(rng.rand(h, w) > 0.97)
            cls.append(int(rng.randint(3)))
            if keypoints:
                kps.append(np.concatenate([rng.uniform(0, [w, h], (17, 2)), rng.rand(17, 1)], 1))
        boxes = np.asarray(boxes, np.float32)
        scores = rng.rand(len(boxes)).astype(np.float32)
        fields = dict(scores=scores, pred_classes=np.asarray(cls, np.int64))
        if keypoints:
            fields["pred_keypoints"] = np.asarray(kps)
        else:
            fields["pred_masks"] = np.stack(ms)
        out.append((Instances((h, w), pred_boxes=Boxes(boxes), **fields),
                    JaxInstances((h, w), pred_boxes=JaxBoxes(boxes), **fields)))
    return out


def test_instances_to_coco_json_with_masks_equals_jax():
    """Masks go into the results json as uncompressed RLE, as JAX's do."""
    rng = np.random.RandomState(4)
    for port, ref in _predicted_instances(_learnable_dicts()[:2], rng):
        assert instances_to_coco_json(port, 3) == jax_to_json(ref, 3)


def _learnable_dicts():
    ensure_synthetic_datasets(["synth_learnable"])
    return DatasetCatalog.get("synth_learnable")[:6]


@pytest.mark.parametrize("use_fast_impl", [True, False])
def test_coco_evaluator_segm_equals_jax(use_fast_impl, tmp_path):
    """The same predicted masks (the learnable scenes' polygons shifted, and
    random ones) through both COCOEvaluators: the bbox and segm dicts equal
    JAX's, every entry, through the C++ matcher or the numpy one."""
    name = "test_torch_mask_eval"
    _register_both(name, _learnable_dicts(), ["color_0", "color_1", "color_2"])
    preds = _predicted_instances(DatasetCatalog.get(name), np.random.RandomState(0))
    port = COCOEvaluator(name, output_dir=str(tmp_path / "port"), use_fast_impl=use_fast_impl)
    ref = JaxCOCOEvaluator(name, None, distributed=False, output_dir=str(tmp_path / "jax"),
                           use_fast_impl=use_fast_impl)
    inputs = [{"image_id": d["image_id"]} for d in DatasetCatalog.get(name)]
    port.process(inputs, [{"instances": p} for p, _ in preds])
    ref.process(inputs, [{"instances": r} for _, r in preds])
    got, want = port.evaluate(), ref.evaluate()
    assert set(got) == set(want) == {"bbox", "segm"}
    for task in ("bbox", "segm"):
        assert got[task] == pytest.approx(want[task], rel=0, abs=0, nan_ok=True), task
    assert 0 < got["segm"]["AP"] < 100


# -- entry points ----------------------------------------------------------------------------


def test_default_trainer_trains_two_steps_then_evaluates_segm(tmp_path):
    """``mask_rcnn_R_50_FPN_1x.yaml`` cut in width (ResNet-18, RES2 16, FPN
    32, FC_DIM 64, mask convs of 32) and size (64², top-ks 200/100 and
    100/50, 64 rois), on the synthetic stand-ins: 2 SGD steps at batch 2
    (the mapper's rasters feed the mask loss), then the evaluation: finite
    losses, a loss_mask among them, and bbox and segm AP dicts."""
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "COCO-InstanceSegmentation", "mask_rcnn_R_50_FPN_1x.yaml"))
    cfg.merge_from_list([
        "MODEL.DEVICE", "cpu", "MODEL.WEIGHTS", "", "MODEL.RESNETS.DEPTH", 18,
        "MODEL.RESNETS.RES2_OUT_CHANNELS", 16, "MODEL.RESNETS.STEM_OUT_CHANNELS", 8, "MODEL.FPN.OUT_CHANNELS", 32,
        "MODEL.ROI_BOX_HEAD.FC_DIM", 64, "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 64,
        "MODEL.ROI_MASK_HEAD.CONV_DIM", 32, "MODEL.ROI_HEADS.SCORE_THRESH_TEST", 0.0,
        "MODEL.RPN.PRE_NMS_TOPK_TRAIN", 200, "MODEL.RPN.POST_NMS_TOPK_TRAIN", 100,
        "MODEL.RPN.PRE_NMS_TOPK_TEST", 100, "MODEL.RPN.POST_NMS_TOPK_TEST", 50,
        "INPUT.TRAIN_SIZE", (SIZE, SIZE), "INPUT.TEST_SIZE", (SIZE, SIZE), "SOLVER.BASE_LR", 0.002,
        "SOLVER.IMS_PER_BATCH", 2, "SOLVER.MAX_ITER", 2, "TEST.BATCH_SIZE", 2, "DATALOADER.NUM_WORKERS", 1,
        "DATASETS.TRAIN", ("test_torch_mask_train",), "DATASETS.TEST", ("test_torch_mask_val",),
        "OUTPUT_DIR", str(tmp_path), "TPU.DTYPE", "float32"])
    ensure_synthetic_datasets(list(cfg.DATASETS.TRAIN) + list(cfg.DATASETS.TEST))
    trainer = DefaultTrainer(cfg)
    trainer.resume_or_load(resume=False)
    results = trainer.train()
    losses = [v for v, _ in trainer.storage.history("loss_mask").values()]
    assert len(losses) == 2 and all(math.isfinite(v) and v > 0 for v in losses)
    assert set(results) == {"bbox", "segm"}
    assert all(math.isfinite(results[t][k]) for t in results for k in ("AP", "AP50", "AP75"))


def test_mask_rcnn_raises_without_a_card():
    """MODEL.DEVICE is cuda by default: no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "COCO-InstanceSegmentation", "mask_rcnn_R_50_FPN_1x.yaml"))
    with pytest.raises(RuntimeError, match="MODEL.DEVICE=cpu"):
        build_model(cfg)


@pytest.mark.parametrize("extra", [["MODEL.ROI_MASK_HEAD.NAME", "CoarseMaskHead"],
                                   ["MODEL.ROI_MASK_HEAD.POINT_HEAD_ON", True]])
def test_pointrend_mask_heads_still_raise_naming_a15(extra):
    cfg = get_cfg()
    cfg.merge_from_list(["MODEL.DEVICE", "cpu", "MODEL.MASK_ON", True] + extra)
    with pytest.raises(NotImplementedError, match="A15"):
        build_model(cfg)


def test_bench_names_mask_rcnn_against_its_v100_time():
    """tools/bench calls a GeneralizedRCNN with MASK_ON ``mask_rcnn``,
    against 1 / 0.043 img/s (MODEL_ZOO's Mask R-CNN R50-FPN, BASELINE.md:17),
    and without it ``faster_rcnn`` as before."""
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "COCO-InstanceSegmentation", "mask_rcnn_R_50_FPN_1x.yaml"))
    assert bench.metric_name(cfg) == "mask_rcnn_res50_fpn_800_infer_throughput"
    assert bench.baseline_img_s(cfg) == pytest.approx(1 / 0.043)
    cfg.MODEL.MASK_ON = False
    assert bench.metric_name(cfg) == "faster_rcnn_res50_fpn_800_infer_throughput"


def test_train_acc_reads_the_mask_rcnn_accuracy_config():
    """``tools/train_acc``'s config of ``mask_rcnn_synth_training_acc_test.yaml``
    is the YAML, key for key the JAX package's reading of it, with both bands."""
    yaml_file = os.path.join(REPO, "configs", "quick_schedules", "mask_rcnn_synth_training_acc_test.yaml")
    got = train_acc.acc_cfg(yaml_file, seed=43, device="cpu")
    want = jax_get_cfg()
    want.merge_from_file(yaml_file)
    want.merge_from_list(["SEED", 43])
    assert got.MODEL.MASK_ON and got.MODEL.ROI_MASK_HEAD.CONV_DIM == 32
    assert [list(e) for e in got.TEST.EXPECTED_RESULTS] == [["bbox", "AP", 87.5, 7.0], ["segm", "AP", 84.2, 8.0]]
    for key in ("MODEL.ROI_MASK_HEAD", "MODEL.ROI_HEADS", "SOLVER", "INPUT"):
        node_g, node_w = got, want
        for part in key.split("."):
            node_g, node_w = node_g[part], node_w[part]
        assert dict(node_g) == dict(node_w), key


def test_synthetic_scenes_carry_the_jax_polygons_and_keypoints():
    """The port's scenes from a seed equal the JAX package's ``_scene`` of
    the same seed (image and every annotation, polygons and keypoints
    included); a keypoint stand-in differs only in its class (0, person)."""
    from detectron2_centernet_tpu_torch.data.datasets import synthetic

    for person_only in (False, True):
        got_img, got = synthetic._scene(np.random.RandomState(3), 96, 128, 4, person_only=person_only)
        want_img, want = jax_synthetic._scene(np.random.RandomState(3), 96, 128, 4)
        np.testing.assert_array_equal(got_img, want_img)
        for g, w in zip(got, want):
            if person_only:
                assert g["category_id"] == 0
                w = dict(w, category_id=0)
            assert g == w


@pytest.mark.parametrize("kind", ["mask", "keypoint"])
def test_chip_smoke_reads_the_heads_configs_as_the_jax_package_does(kind):
    """``chip_smoke.py``'s phases 11 and 12 read their YAML files with the
    port's reader, the run's dtype, output directory and seed over them and
    no weights file: key for key the JAX package's config of the same file
    and overrides, at full width."""
    import sys

    from test_torch_rcnn import _flat

    sys.path.insert(0, REPO)
    import chip_smoke

    folder, name, _, _ = chip_smoke.HEADS[kind]
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        got = chip_smoke.rcnn_cfg(name, "bfloat16", folder)
    finally:
        os.chdir(cwd)
    want = jax_get_cfg()
    want.merge_from_file(os.path.join(REPO, "configs", folder, name + ".yaml"))
    want.merge_from_list(["TPU.DTYPE", "bfloat16", "OUTPUT_DIR", "output/chip_smoke", "SEED", 0,
                          "MODEL.WEIGHTS", ""])
    assert _flat(got) == _flat(want)
    assert got.MODEL.RESNETS.DEPTH == 50 and got.MODEL.FPN.OUT_CHANNELS == 256
    assert (got.MODEL.MASK_ON, got.MODEL.KEYPOINT_ON) == (kind == "mask", kind == "keypoint")
