"""The port's Keypoint R-CNN slice against the JAX package on the CPU, at a
small size (ResNet-18 with RES2 16 and a stem of 8, FPN 32, FC_DIM 64, a
keypoint head of 2 convs of 64, 17 keypoints, 5 classes, 64² inputs):
``keypoints_to_heatmap_targets`` and ``encode_keypoint_targets``,
``heatmaps_to_keypoints`` against the JAX package's cv2 ``INTER_CUBIC``, the
keypoint head with weights crossed from JAX (``score_lowres`` unflipped, the
2x bilinear upsample), ``keypoint_rcnn_loss``, the mapper's ``gt_keypoints``
(with the flip permutation), the whole model's loss and every gradient on
JAX's draws, ``predict_fn`` and ``postprocess``, keypoint COCO evaluation,
and the entry points.

Tolerances: exact for the heatmap targets, the mapper's keypoints and the
decoded keypoint positions; 1e-5 of the output's scale for the head on
crossed weights; 1e-5 relative for the losses and 1e-4 of each gradient's
own max for the gradients; keypoint scores within 1e-4 relative (cv2
upsamples 17 channels in f32 to ~1e-5 of the maps' scale, the port in f64),
1e-3 on the random full model's logits of up to ~180.
"""

import copy
import importlib
import math
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import cv2
import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from detectron2_centernet_tpu.config import get_cfg as jax_get_cfg
from detectron2_centernet_tpu.data.dataset_mapper import DatasetMapper as JaxMapper
from detectron2_centernet_tpu.data.datasets.synthetic import ensure_synthetic_datasets as jax_ensure
from detectron2_centernet_tpu.data import DatasetCatalog as JaxDatasetCatalog
from detectron2_centernet_tpu.evaluation import COCOEvaluator as JaxCOCOEvaluator
from detectron2_centernet_tpu.evaluation import instances_to_coco_json as jax_to_json
from detectron2_centernet_tpu.models.roi_heads.keypoint_head import KRCNNConvDeconvUpsampleHead as JaxKpHead
from detectron2_centernet_tpu_torch.checkpoint import state_dict_from_jax
from detectron2_centernet_tpu_torch.config import get_cfg
from detectron2_centernet_tpu_torch.data import DatasetCatalog, DatasetMapper
from detectron2_centernet_tpu_torch.data.datasets import ensure_synthetic_datasets
from detectron2_centernet_tpu_torch.engine import DefaultTrainer
from detectron2_centernet_tpu_torch.evaluation import COCOEvaluator, instances_to_coco_json
from detectron2_centernet_tpu_torch.models import build_model
from detectron2_centernet_tpu_torch.models.roi_heads import keypoint_head
from detectron2_centernet_tpu_torch.structures import keypoints
from detectron2_centernet_tpu_torch.tools import bench, train_acc

from test_torch_mask import _predicted_instances, _register_both
from test_torch_rcnn import SIZE, _anchor_count, _batch, _images, _jax_draws, _nchw, _pair, _port_batch

jax_keypoints = importlib.import_module("detectron2_centernet_tpu.structures.keypoints")
jax_kp_head = importlib.import_module("detectron2_centernet_tpu.models.roi_heads.keypoint_head")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYPOINT = ["MODEL.KEYPOINT_ON", True, "MODEL.ROI_KEYPOINT_HEAD.CONV_DIMS", [64, 64]]
KP_YAML = os.path.join(REPO, "configs", "COCO-Keypoints", "keypoint_rcnn_R_50_FPN_1x.yaml")


@pytest.fixture(scope="module")
def pair():
    return _pair(KEYPOINT)


def _keypoints_in(rng, rois, k=17, spill=0.2):
    """(N, K, 3) keypoints around (N, 4) rois (some outside, some on the far
    edge, a third invisible)."""
    n = len(rois)
    w, h = rois[:, 2:3] - rois[:, 0:1], rois[:, 3:4] - rois[:, 1:2]
    x = rois[:, 0:1] + rng.uniform(-spill, 1 + spill, (n, k)) * w
    y = rois[:, 1:2] + rng.uniform(-spill, 1 + spill, (n, k)) * h
    x[:, 0], y[:, 1] = rois[:, 2], rois[:, 3]  # exactly on the far edges: the last cell
    vis = rng.randint(0, 3, (n, k)).astype(np.float32)
    return np.stack([x, y, vis], -1).astype(np.float32)


def _rois(rng, n, lo=0.0, hi=60.0, size=(2.0, 50.0)):
    xy = rng.uniform(lo, hi, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(*size, (n, 2))], 1).astype(np.float32)


# -- the heatmap codec ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [56, 28, 7])
def test_keypoints_to_heatmap_targets_equal_jax(size):
    """Cell indices and validity of keypoints in and around their rois
    (visible or not, on the far edge), equal."""
    rng = np.random.RandomState(size)
    rois = _rois(rng, 40)
    kp = _keypoints_in(rng, rois)
    got = keypoints.keypoints_to_heatmap_targets(kp, rois, size)
    want = jax_keypoints.keypoints_to_heatmap_targets(kp, rois, size)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[1].sum() > 100 and (got[1] == 0).sum() > 100
    np.testing.assert_array_equal(keypoints.Keypoints(kp).to_heatmap(rois, size)[0], got[0])


@pytest.mark.parametrize("seed", [0, 1])
def test_encode_keypoint_targets_equal_jax(seed):
    """The device encoding of the matched keypoints in the sampled rois
    (f32), equal to JAX's jnp one cell for cell, and valid where the numpy
    codec says so."""
    rng = np.random.RandomState(seed)
    rois = _rois(rng, 60)
    kp = _keypoints_in(rng, rois)
    idx, valid = keypoint_head.encode_keypoint_targets(torch.from_numpy(kp), torch.from_numpy(rois), 56)
    w_idx, w_valid = jax_kp_head.encode_keypoint_targets(jnp.asarray(kp), jnp.asarray(rois), 56)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(w_idx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(w_valid))
    assert valid.sum() > 300


@pytest.mark.parametrize("shape", [(56, 56), (100, 80), (30, 40), (150, 3), (1, 1), (200, 7)])
def test_bicubic_upsample_is_cv2_inter_cubic(shape):
    """``F.interpolate`` bicubic (a = -0.75, half-pixel centres, the border
    replicated), in f64, against cv2's ``INTER_CUBIC`` of a one-channel f32
    map: within 1e-6 of the map's scale (cv2 computes in f32)."""
    rng = np.random.RandomState(sum(shape))
    m = (rng.randn(56, 56) * 3).astype(np.float32)
    want = cv2.resize(m, (shape[1], shape[0]), interpolation=cv2.INTER_CUBIC).reshape(shape)
    got = F.interpolate(torch.from_numpy(m)[None, None].double(), size=shape, mode="bicubic",
                        align_corners=False)[0, 0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(m).max())


@pytest.mark.parametrize("scale", [0.3, 1.0, 3.0])
def test_heatmaps_to_keypoints_equal_jax(scale):
    """(N, 17, 56, 56) random maps of rois from 0.5 to 150 px a side (down
    and up): the decoded positions equal the JAX package's (cv2 INTER_CUBIC
    on 17 channels, f32) on every keypoint of 160 rois, the logits within
    1e-5 of the maps' scale and the scores within 1e-4 relative. The port
    and cv2 differ by ~1e-5 of the scale, so an argmax could move only on a
    tie that close: none happens here."""
    rng = np.random.RandomState(int(scale * 10))
    moved = 0
    for _ in range(20):
        maps = (rng.randn(8, 56, 56, 17) * scale).astype(np.float32)
        xy = rng.uniform(0, 200, (8, 2))
        rois = np.concatenate([xy, xy + rng.uniform(0.5, 150, (8, 2))], 1).astype(np.float32)
        want = jax_keypoints.heatmaps_to_keypoints(maps, rois)
        got = keypoints.heatmaps_to_keypoints(torch.from_numpy(maps.transpose(0, 3, 1, 2).copy()),
                                              torch.from_numpy(rois)).numpy()
        moved += int((got[..., :2] != want[..., :2]).any(-1).sum())
        np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=0, atol=1e-5 * np.abs(maps).max())
        np.testing.assert_allclose(got[..., 3], want[..., 3], rtol=1e-4)
    assert moved == 0


def test_keypoint_head_on_crossed_weights_matches_jax():
    """``KRCNNConvDeconvUpsampleHead`` (2 convs of 64, ``score_lowres`` 4x4
    stride 2 padding 1 in f32, the 2x bilinear upsample) on random weights
    crossed from JAX through ``state_dict_from_jax`` (``score_lowres``'s
    kernel transposed, not flipped): (R, 17, 56, 56) logits within 1e-5 of
    their scale; with the kernel flipped they are not."""
    rng = np.random.RandomState(3)
    jhead = JaxKpHead(17, conv_dims=(64, 64))
    x = rng.randn(5, 14, 14, 24).astype(np.float32)
    shapes = jax.eval_shape(lambda: jhead.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params = unflatten_dict({k: (rng.randn(*v.shape) / np.sqrt(np.prod(v.shape[:-1]))).astype(np.float32)
                             for k, v in flatten_dict(shapes["params"]).items()})
    want = np.asarray(jhead.apply({"params": params}, jnp.asarray(x))).transpose(0, 3, 1, 2)
    state = {k.removeprefix("roi_heads.keypoint_head."): v
             for k, v in state_dict_from_jax({"params": {"keypoint_head": params}}).items()}
    head = keypoint_head.KRCNNConvDeconvUpsampleHead(24, 17, (64, 64))
    head.load_state_dict(state)
    with torch.no_grad():
        got = head(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
        assert got.shape == (5, 17, 56, 56)
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
        head.score_lowres.weight.copy_(head.score_lowres.weight.flip(-1, -2))
        flipped = head(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    assert np.abs(flipped - want).max() > 1e-2 * scale


def test_keypoint_rcnn_loss_matches_jax():
    """Softmax CE over the 56² cells at the valid keypoints of the foreground
    rois, within 1e-6 relative."""
    rng = np.random.RandomState(1)
    s = 20
    logits = (rng.randn(s, 56, 56, 17) * 2).astype(np.float32)
    idx = rng.randint(0, 56 * 56, (s, 17))
    valid = (rng.rand(s, 17) > 0.3).astype(np.float32)
    fg = (rng.rand(s) > 0.4).astype(np.float32)
    want = jax_kp_head.keypoint_rcnn_loss(jnp.asarray(logits), jnp.asarray(idx), jnp.asarray(valid), jnp.asarray(fg))
    got = keypoint_head.keypoint_rcnn_loss(torch.from_numpy(logits.transpose(0, 3, 1, 2).copy()),
                                           torch.from_numpy(idx), torch.from_numpy(valid), torch.from_numpy(fg))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


# -- the mapper -----------------------------------------------------------------------------------


def _kp_mapper_cfgs():
    common = ["MODEL.KEYPOINT_ON", True, "MODEL.CENTERNET.MAX_OBJS", 8, "INPUT.TRAIN_SIZE", (64, 64),
              "INPUT.COLOR_JITTER", False, "DATASETS.TRAIN", ("synth_learnable_kp",)]
    jcfg, pcfg = jax_get_cfg(), get_cfg()
    jcfg.merge_from_list(common)
    pcfg.merge_from_list(common + ["MODEL.DEVICE", "cpu"])
    jax_ensure(["synth_learnable_kp"])
    ensure_synthetic_datasets(["synth_learnable_kp"])
    return jcfg, pcfg


def test_learnable_kp_scenes_equal_jax():
    """``synth_learnable_kp``: the port's scenes equal the JAX package's
    (one class, 17 box-relative keypoints), and both carry the person
    keypoint names and flip map."""
    _kp_mapper_cfgs()
    from detectron2_centernet_tpu.data import MetadataCatalog as JaxMeta
    from detectron2_centernet_tpu_torch.data import MetadataCatalog

    got, want = DatasetCatalog.get("synth_learnable_kp"), JaxDatasetCatalog.get("synth_learnable_kp")
    assert len(got) == len(want) == 24
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["image"], w["image"])
        assert g["annotations"] == w["annotations"]
    for key in ("keypoint_names", "keypoint_flip_map", "thing_classes"):
        assert tuple(MetadataCatalog.get("synth_learnable_kp").get(key)) == tuple(JaxMeta.get("synth_learnable_kp")
                                                                                 .get(key))


@pytest.mark.parametrize("seeds", [range(0, 6), range(6, 12)])
def test_mapper_gt_keypoints_equal_jax(seeds):
    """The learnable keypoint scenes through both train mappers on the same
    RandomStates (half the warps mirror): the warp, the boxes and the
    (MAX_OBJS, 17, 3) warped keypoints equal, the left/right ones swapped
    by the flip map where the warp mirrors, those warped off the image
    invisible."""
    jcfg, pcfg = _kp_mapper_cfgs()
    dicts = DatasetCatalog.get("synth_learnable_kp")
    mirrored = 0
    for i in seeds:
        d = dicts[i]
        want = JaxMapper(jcfg, is_train=True)(copy.deepcopy(d), rng=np.random.RandomState(i))
        got = DatasetMapper(pcfg, is_train=True)(copy.deepcopy(d), rng=np.random.RandomState(i))
        for k in ("warp", "gt_boxes", "gt_classes", "gt_valid", "gt_keypoints"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        mirrored += int(got["warp"][0, 0] < 0)
    assert 0 < mirrored < len(seeds)
    perm = DatasetMapper(pcfg, is_train=True).kp_flip_indices
    assert perm[1] == 2 and perm[2] == 1 and perm[0] == 0 and sorted(perm) == list(range(17))


# -- the whole model ------------------------------------------------------------------------------


def _kp_batch(seed):
    b = _batch(seed)
    rng = np.random.RandomState(seed + 60)
    n, m = b["gt_boxes"].shape[:2]
    b["gt_keypoints"] = np.stack([_keypoints_in(rng, b["gt_boxes"][i], spill=0.05) for i in range(n)])
    return b


def test_loss_and_every_gradient_match_jax(pair):
    """The five losses on JAX's draws (the keypoint loss on the foreground
    rois) within 1e-5 relative, and every parameter's gradient within 1e-4
    of its own max |value|, but ``score_lowres``'s bias: the softmax over a
    map's cells does not see a constant added to it, so its true gradient is
    0, and both sides' are rounding (under 1e-6 against gradients up to
    ~10²)."""
    jm, variables, pm = pair
    batch, key = _kp_batch(1), jax.random.PRNGKey(5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch["rng"] = key
    stats = variables["batch_stats"]
    (_, (jloss, _)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, stats, jbatch), has_aux=True))(variables["params"])
    pb = _port_batch(batch, _jax_draws(key, 2, _anchor_count(pm), max(100 + 6, 64)))
    pb["gt_keypoints"] = torch.from_numpy(batch["gt_keypoints"])
    for p in pm.model.parameters():
        p.grad = torch.zeros_like(p)
    pm.model.train()
    total, losses = pm.loss_fn(pb)
    total.backward()
    pm.model.eval()
    assert set(losses) == set(jloss) == {"loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "loss_keypoint"}
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), float(jloss[k]), rtol=1e-5, err_msg=k)
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    grads = {k: p.grad for k, p in pm.model.named_parameters()}
    assert set(want) == set(grads)
    shift_free = "roi_heads.keypoint_head.score_lowres.bias"
    for k, g in grads.items():
        w = want[k].numpy()
        if k == shift_free:
            assert np.abs(g.numpy()).max() < 1e-6 and np.abs(w).max() < 1e-6
            continue
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max(), k
    assert grads["roi_heads.keypoint_head.score_lowres.weight"].abs().max() > 0


def test_predict_fn_keypoint_heatmaps_match_jax(pair):
    """Two 64² images: ``keypoint_heatmaps`` (N, 100, 17, 56, 56) within
    1e-3 of their scale of JAX's (pooled on detection boxes that agree to
    1e-2 px, ``test_torch_rcnn``), the same classes."""
    jm, variables, pm = pair
    x = _images(2, seed=8)
    want = jax.jit(jm.predict_fn)(variables, jnp.asarray(x))
    got = pm.predict_fn(_nchw(x))
    hm = np.asarray(want["keypoint_heatmaps"]).transpose(0, 1, 4, 2, 3)
    assert got["keypoint_heatmaps"].shape == (2, 100, 17, 56, 56) == hm.shape
    np.testing.assert_array_equal(got["classes"].numpy(), np.asarray(want["classes"]))
    np.testing.assert_allclose(got["keypoint_heatmaps"].numpy(), hm, rtol=0, atol=1e-3 * np.abs(hm).max())


def test_postprocess_decodes_the_jax_heatmaps_equally(pair):
    """JAX's own ``predict_fn`` output (its boxes, which the random model
    flattens, replaced by random boxes in the 64² frame) through both
    ``postprocess``es at 64x64 and from 80x96: the same boxes, scores and
    classes, the (D, 17, 3) keypoint positions equal but at ties, their
    scores within 1e-3 relative (or both under 1e-12): the random model's
    logits reach ~180, where JAX's f32 exp of their differences is good to
    ~1e-4 and its softmax sum overflows to inf (score 0), the port's f64
    one not.

    The ties: the random model's heatmaps were pooled on flat boxes, so
    their rows repeat and cv2's upsampled maps hold exactly equal maxima,
    of which cv2's argmax takes the first and the port's f64 argmax the one
    its rounding puts highest. Every position that differs is checked to be
    such a tie (cv2's value there within 1e-5 of the map's scale of its
    maximum), and they are bounded at 5% of the keypoints."""
    jm, variables, pm = pair
    from detectron2_centernet_tpu_torch.data import letterbox_transform, unwarp_boxes
    from detectron2_centernet_tpu_torch.structures import Boxes

    dets = {k: np.asarray(v) for k, v in jax.jit(jm.predict_fn)(variables, jnp.asarray(_images(2, seed=9))).items()}
    rng = np.random.RandomState(9)
    xy = rng.uniform(-8, 60, (2, 100, 2))
    dets["boxes"] = np.concatenate([xy, xy + rng.uniform(0.5, 40, (2, 100, 2))], -1).astype(np.float32)
    port_dets = dict(dets, keypoint_heatmaps=dets["keypoint_heatmaps"].transpose(0, 1, 4, 2, 3))
    warps = [np.eye(2, 3, dtype=np.float32), letterbox_transform(80, 96, (SIZE, SIZE)).astype(np.float32)]
    sizes = [(64, 64), (80, 96)]
    got, want = pm.postprocess(port_dets, warps, sizes), jm.postprocess(dets, warps, sizes)
    moved = 0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g["instances"], w["instances"]
        assert len(g) == len(w) > 3
        np.testing.assert_array_equal(g.pred_boxes.tensor, np.asarray(w.pred_boxes.tensor))
        np.testing.assert_array_equal(g.scores, w.scores)
        assert g.pred_keypoints.shape == (len(g), 17, 3)
        np.testing.assert_allclose(g.pred_keypoints[..., 2], w.pred_keypoints[..., 2], rtol=1e-3, atol=1e-12)
        keep = dets["scores"][i] > pm.score_threshold
        bx = Boxes(unwarp_boxes(warps[i], dets["boxes"][i][keep]).astype(np.float32))
        bx.clip(sizes[i])
        slots = np.flatnonzero(keep)[bx.nonempty()]
        for d, k in np.argwhere((g.pred_keypoints[..., :2] != w.pred_keypoints[..., :2]).any(-1)):
            moved += 1
            x0, y0, x1, y1 = g.pred_boxes.tensor[d]
            rw, rh = max(x1 - x0, 1.0), max(y1 - y0, 1.0)
            uw, uh = int(np.ceil(rw)), int(np.ceil(rh))
            up = cv2.resize(dets["keypoint_heatmaps"][i][slots[d]], (uw, uh),
                            interpolation=cv2.INTER_CUBIC).reshape(uh, uw, -1)[..., k]
            col = int(round((g.pred_keypoints[d, k, 0] - x0) * uw / rw - 0.5))
            row = int(round((g.pred_keypoints[d, k, 1] - y0) * uh / rh - 0.5))
            assert up[row, col] >= up.max() - 1e-5 * np.abs(up).max(), (i, d, k)
    assert moved <= 0.05 * 17 * sum(len(r["instances"]) for r in got), moved  # 111 of 3332 here


# -- evaluation ------------------------------------------------------------------------------------


def test_instances_to_coco_json_with_keypoints_equals_jax():
    """Keypoints go into the results json with -0.5 on x and y, as JAX's."""
    ensure_synthetic_datasets(["synth_learnable_kp"])
    d = DatasetCatalog.get("synth_learnable_kp")[:2]
    for port, ref in _predicted_instances(d, np.random.RandomState(2), keypoints=True):
        assert instances_to_coco_json(port, 3) == jax_to_json(ref, 3)


@pytest.mark.parametrize("sigmas", [None, [0.05] * 17])
def test_coco_evaluator_keypoints_equals_jax(sigmas, tmp_path):
    """The same predicted keypoints (the scenes' grids jittered, and random
    ones) through both COCOEvaluators, with COCO's OKS sigmas or the
    config's ``TEST.KEYPOINT_OKS_SIGMAS``: the bbox and keypoints dicts
    equal JAX's, every entry; sigmas of the wrong count raise."""
    ensure_synthetic_datasets(["synth_learnable_kp"])
    name = "test_torch_kp_eval"
    _register_both(name, DatasetCatalog.get("synth_learnable_kp")[:6], ["color_0"])
    preds = _predicted_instances(DatasetCatalog.get(name), np.random.RandomState(1), keypoints=True)
    for p, r in preds:
        p.pred_classes[:] = 0
        r.pred_classes[:] = 0
    jcfg, pcfg = jax_get_cfg(), get_cfg()
    if sigmas is not None:
        jcfg.TEST.KEYPOINT_OKS_SIGMAS = pcfg.TEST.KEYPOINT_OKS_SIGMAS = sigmas
    port = COCOEvaluator(name, output_dir=str(tmp_path / "port"), cfg=pcfg)
    ref = JaxCOCOEvaluator(name, jcfg, distributed=False, output_dir=str(tmp_path / "jax"))
    inputs = [{"image_id": d["image_id"]} for d in DatasetCatalog.get(name)]
    port.process(inputs, [{"instances": p} for p, _ in preds])
    ref.process(inputs, [{"instances": r} for _, r in preds])
    got, want = port.evaluate(), ref.evaluate()
    assert set(got) == set(want) == {"bbox", "keypoints"}
    for task in ("bbox", "keypoints"):
        assert got[task] == pytest.approx(want[task], rel=0, abs=0, nan_ok=True), task
    assert 0 < got["keypoints"]["AP"] < 100
    pcfg.TEST.KEYPOINT_OKS_SIGMAS = [0.05] * 5
    bad = COCOEvaluator(name, output_dir=str(tmp_path / "port"), cfg=pcfg)
    bad.process(inputs, [{"instances": p} for p, _ in preds])
    with pytest.raises(ValueError, match="KEYPOINT_OKS_SIGMAS"):
        bad.evaluate()


# -- entry points -----------------------------------------------------------------------------


def test_default_trainer_trains_two_steps_then_evaluates_keypoints(tmp_path):
    """``keypoint_rcnn_R_50_FPN_1x.yaml`` cut in width (ResNet-18, RES2 16,
    FPN 32, FC_DIM 64, keypoint convs of 64) and size (64², top-ks 200/100
    and 100/50, 64 rois) on the person-keypoint stand-ins: 2 SGD steps at
    batch 2, then the evaluation: finite losses with a loss_keypoint, and
    bbox and keypoints AP dicts."""
    cfg = get_cfg()
    cfg.merge_from_file(KP_YAML)
    cfg.merge_from_list([
        "MODEL.DEVICE", "cpu", "MODEL.WEIGHTS", "", "MODEL.RESNETS.DEPTH", 18,
        "MODEL.RESNETS.RES2_OUT_CHANNELS", 16, "MODEL.RESNETS.STEM_OUT_CHANNELS", 8, "MODEL.FPN.OUT_CHANNELS", 32,
        "MODEL.ROI_BOX_HEAD.FC_DIM", 64, "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 64,
        "MODEL.ROI_KEYPOINT_HEAD.CONV_DIMS", [64, 64], "MODEL.ROI_HEADS.SCORE_THRESH_TEST", 0.0,
        "MODEL.RPN.PRE_NMS_TOPK_TRAIN", 200, "MODEL.RPN.POST_NMS_TOPK_TRAIN", 100,
        "MODEL.RPN.PRE_NMS_TOPK_TEST", 100, "MODEL.RPN.POST_NMS_TOPK_TEST", 50,
        "INPUT.TRAIN_SIZE", (SIZE, SIZE), "INPUT.TEST_SIZE", (SIZE, SIZE), "SOLVER.BASE_LR", 0.002,
        "SOLVER.IMS_PER_BATCH", 2, "SOLVER.MAX_ITER", 2, "TEST.BATCH_SIZE", 2, "DATALOADER.NUM_WORKERS", 1,
        "DATASETS.TRAIN", ("test_torch_keypoints_train",), "DATASETS.TEST", ("test_torch_keypoints_val",),
        "OUTPUT_DIR", str(tmp_path), "TPU.DTYPE", "float32"])
    ensure_synthetic_datasets(list(cfg.DATASETS.TRAIN) + list(cfg.DATASETS.TEST))
    trainer = DefaultTrainer(cfg)
    trainer.resume_or_load(resume=False)
    results = trainer.train()
    losses = [v for v, _ in trainer.storage.history("loss_keypoint").values()]
    assert len(losses) == 2 and all(math.isfinite(v) and v > 0 for v in losses)
    assert set(results) == {"bbox", "keypoints"}
    assert all(math.isfinite(results[t][k]) for t in results for k in ("AP", "AP50", "AP75"))


def test_keypoint_rcnn_raises_without_a_card():
    """MODEL.DEVICE is cuda by default: no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = get_cfg()
    cfg.merge_from_file(KP_YAML)
    with pytest.raises(RuntimeError, match="MODEL.DEVICE=cpu"):
        build_model(cfg)


def test_bench_names_keypoint_rcnn_with_no_baseline():
    """tools/bench calls a GeneralizedRCNN with KEYPOINT_ON
    ``keypoint_rcnn``; BASELINE.md has no Keypoint R-CNN time, so its
    ``vs_baseline`` is null."""
    cfg = get_cfg()
    cfg.merge_from_file(KP_YAML)
    assert bench.metric_name(cfg) == "keypoint_rcnn_res50_fpn_800_infer_throughput"
    assert bench.baseline_img_s(cfg) is None


def test_keypoint_configs_read_as_the_jax_package_reads_them():
    """``keypoint_rcnn_R_50_FPN_1x.yaml`` (over its base: one class, 1500
    proposals at training, the 8-conv head of 512) and the accuracy config
    with both bands, through ``tools/train_acc``'s reader: key for key the
    JAX package's."""
    for yaml_file, seed in ((KP_YAML, 0), (os.path.join(REPO, "configs", "quick_schedules",
                                                        "keypoint_rcnn_synth_training_acc_test.yaml"), 42)):
        got = train_acc.acc_cfg(yaml_file, seed=seed, device="cpu")
        want = jax_get_cfg()
        want.merge_from_file(yaml_file)
        want.merge_from_list(["SEED", seed])
        for key in ("MODEL.ROI_KEYPOINT_HEAD", "MODEL.ROI_HEADS", "MODEL.RPN", "SOLVER", "INPUT", "DATASETS"):
            node_g, node_w = got, want
            for part in key.split("."):
                node_g, node_w = node_g[part], node_w[part]
            assert dict(node_g) == dict(node_w), (yaml_file, key)
        assert got.MODEL.KEYPOINT_ON and got.MODEL.ROI_HEADS.NUM_CLASSES == 1
    assert [list(e) for e in got.TEST.EXPECTED_RESULTS] == [["bbox", "AP", 92.1, 7.0], ["keypoints", "AP", 93.3, 8.0]]
    full = train_acc.acc_cfg(KP_YAML, device="cpu")
    assert list(full.MODEL.ROI_KEYPOINT_HEAD.CONV_DIMS) == [512] * 8 and full.MODEL.RPN.POST_NMS_TOPK_TRAIN == 1500
