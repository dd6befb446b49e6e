"""The port's PointRend, instance and semantic, against the JAX package on
the CPU, in f32, at a small size (``tests/test_torch_rcnn.py``'s R18-FPN
Mask R-CNN with ``PointRendROIHeads`` and ``CoarseMaskHead`` of 32
channels, 2 fc of 64 and a 7² output from 14² rois, a point head of 3 fc
of 32 on 28 training points a roi (84 candidates, 21 important) and 3
subdivision steps of at most 100 points, 7² → 56²; the semantic head on
``tests/test_torch_semseg.py``'s Semantic FPN with 32 training points an
image and 2 steps of 256 points): ``point_sample``,
``sample_uncertain_points`` on JAX's draws, ``PointHead``,
``CoarseMaskHead``, ``refine_mask_with_points``, the R-CNN point loss
with every gradient, the subdivided masks of ``predict_fn``, Res5 with a
point head, ``PointRendSemSegHead`` in training (JAX's draws) and
inference with its loss and gradients, and both PointRend YAMLs.

One random variables tree, made with numpy from a seed, goes to both: as it
is to the JAX model, through ``state_dict_from_jax`` to the port. Where
JAX draws (``jax.random.uniform`` from the step's key, and flax's
``make_rng("points")`` in the semantic head), the port is handed the same
uniforms, so the sampled points are equal, not alike. Tolerances: exact
for the sampled points; 1e-6 of the map's scale for ``point_sample``;
1e-5 of the output's scale for the heads, the refined logits and the
semantic logits; 1e-5 relative for the losses; 1e-4 of each gradient's own
max for the gradients; 2e-3 for the mask probabilities of ``predict_fn``
(its boxes agree to 1e-2 px, as Mask R-CNN's).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from detectron2_centernet_tpu.config import get_cfg as jax_get_cfg
from detectron2_centernet_tpu.models.build import build_model as jax_build_model
from detectron2_centernet_tpu.models.meta_arch import semantic_seg as jax_semseg
from detectron2_centernet_tpu.models.roi_heads import mask_head as jax_mask_head
from detectron2_centernet_tpu.models.roi_heads import point_head as jax_point_head
from detectron2_centernet_tpu_torch.checkpoint import state_dict_from_jax
from detectron2_centernet_tpu_torch.config import get_cfg
from detectron2_centernet_tpu_torch.models import build_model
from detectron2_centernet_tpu_torch.models.meta_arch import semantic_seg
from detectron2_centernet_tpu_torch.models.roi_heads import mask_head, point_head

from test_torch_rcnn import (SIZE, SMALL, _anchor_count, _batch, _close, _images, _jax_draws, _nchw, _port_batch,
                             _random_variables)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POINTS = 28  # training points a roi: 84 candidates, int(0.75 · 28) = 21 important, 7 uniform
POINTREND = ["MODEL.MASK_ON", True, "MODEL.ROI_HEADS.NAME", "PointRendROIHeads",
             "MODEL.ROI_MASK_HEAD.NAME", "CoarseMaskHead", "MODEL.ROI_MASK_HEAD.CONV_DIM", 32,
             "MODEL.ROI_MASK_HEAD.FC_DIM", 64, "MODEL.ROI_MASK_HEAD.NUM_FC", 2,
             "MODEL.ROI_MASK_HEAD.OUTPUT_SIDE_RESOLUTION", 7, "MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION", 14,
             "MODEL.ROI_MASK_HEAD.POINT_HEAD_ON", True, "MODEL.POINT_HEAD.FC_DIM", 32, "MODEL.POINT_HEAD.NUM_FC", 3,
             "MODEL.POINT_HEAD.TRAIN_NUM_POINTS", POINTS, "MODEL.POINT_HEAD.SUBDIVISION_STEPS", 3,
             "MODEL.POINT_HEAD.SUBDIVISION_NUM_POINTS", 100, "INPUT.MASK_RASTER", 16]
SEM_POINTS = 32  # an image's: 96 candidates, 24 important, 8 uniform
SEM = ["MODEL.META_ARCHITECTURE", "SemanticSegmentor", "MODEL.SEM_SEG_HEAD.NAME", "PointRendSemSegHead",
       "MODEL.SEM_SEG_HEAD.CONVS_DIM", 16, "MODEL.SEM_SEG_HEAD.NUM_CLASSES", 7,
       "MODEL.SEM_SEG_HEAD.IN_FEATURES", ["p2", "p3", "p4", "p5"], "MODEL.POINT_HEAD.TRAIN_NUM_POINTS", SEM_POINTS,
       "MODEL.POINT_HEAD.FC_DIM", 32, "MODEL.POINT_HEAD.SUBDIVISION_STEPS", 2,
       "MODEL.POINT_HEAD.SUBDIVISION_NUM_POINTS", 256]


def _cfgs(extra=(), yaml=None):
    jcfg, pcfg = jax_get_cfg(), get_cfg()
    if yaml:
        jcfg.merge_from_file(os.path.join(REPO, yaml))
        pcfg.merge_from_file(os.path.join(REPO, yaml))
    jcfg.merge_from_list(SMALL + list(extra))
    pcfg.merge_from_list(SMALL + list(extra) + ["MODEL.DEVICE", "cpu"])
    return jcfg, pcfg


def _pair(extra=(), seed=0, yaml=None):
    jcfg, pcfg = _cfgs(extra, yaml)
    jm = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), (SIZE, SIZE)))
    variables = _random_variables(shapes, seed)
    pm = build_model(pcfg)
    pm.model.load_state_dict(state_dict_from_jax(variables))
    return jm, variables, pm


@pytest.fixture(scope="module")
def rcnn():
    return _pair(POINTREND)


@pytest.fixture(scope="module")
def sem():
    return _pair(SEM, seed=3)


def _point_draws(key, count, num_points, importance=0.75, oversample=3):
    """``sample_uncertain_points``' uniforms from each of ``count`` keys split
    off ``key`` (JAX: one key a roi, split in two: candidates, the rest)."""
    n_imp = int(importance * num_points)

    def one(k):
        r1, r2 = jax.random.split(k)
        return (jax.random.uniform(r1, (oversample * num_points, 2)),
                jax.random.uniform(r2, (num_points - n_imp, 2)))

    cand, rand = jax.vmap(one)(jax.random.split(key, count))
    return torch.from_numpy(np.array(cand)), torch.from_numpy(np.array(rand))


# -- the pieces -----------------------------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(7, 7), (14, 9)])
def test_point_sample_equals_jax(hw):
    """Three (hw, 5) maps at 200 points each, the corners (0, 0), (1, 1)
    and the outer half-pixels among them: within 1e-6 of the maps' scale
    of JAX's, the border clamped as JAX clamps it."""
    rng = np.random.RandomState(hw[1])
    feat = rng.randn(3, *hw, 5).astype(np.float32)
    coords = rng.uniform(0, 1, (3, 200, 2)).astype(np.float32)
    coords[:, :4] = [[0, 0], [1, 1], [0.5 / hw[1], 1], [1, 0.2 / hw[0]]]
    want = np.asarray(jax.vmap(jax_point_head.point_sample)(jnp.asarray(feat), jnp.asarray(coords)))
    got = point_head.point_sample(_nchw(feat), torch.from_numpy(coords)).numpy()
    assert got.shape == (3, 200, 5)
    _close(got, want, 1e-6, "point_sample")


def test_sample_uncertain_points_on_jax_draws_equals_jax():
    """Four rois' 7x7 logits, each with its key: the port on the uniforms
    JAX draws from that key picks the same 21 of 84 candidates (|logit|
    nearest 0), then the same 7 uniform points, exactly."""
    rng = np.random.RandomState(2)
    logits = rng.randn(4, 7, 7).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jax.vmap(lambda lg, k: jax_point_head.sample_uncertain_points(lg, k, POINTS))(
        jnp.asarray(logits), jax.random.split(key, 4)))
    cand, rand = _point_draws(key, 4, POINTS)
    got = point_head.sample_uncertain_points(torch.from_numpy(logits), cand, rand, POINTS, 0.75).numpy()
    np.testing.assert_array_equal(got, want)


def test_point_head_on_crossed_weights_matches_jax():
    """The point MLP (fine 8 + coarse 3 channels, 3 fc of 16, the coarse
    logits appended after each, 3 outputs) on (2, 50) points within 1e-5
    of the output's scale."""
    rng = np.random.RandomState(4)
    fine, coarse = rng.randn(2, 50, 8).astype(np.float32), rng.randn(2, 50, 3).astype(np.float32)
    jhead = jax_point_head.PointHead(3, fc_dim=16, num_fc=3)
    variables = _random_variables(jax.eval_shape(
        lambda: jhead.init(jax.random.PRNGKey(0), jnp.asarray(fine), jnp.asarray(coarse))), 5)
    want = np.asarray(jhead.apply(variables, jnp.asarray(fine), jnp.asarray(coarse)))
    head = point_head.PointHead(8, 3, 3, 16, 3)
    state = state_dict_from_jax({"params": {"point_head": variables["params"]}})
    head.load_state_dict({k.removeprefix("roi_heads.mask_point_head."): v for k, v in state.items()})
    with torch.no_grad():
        got = head(torch.from_numpy(fine), torch.from_numpy(coarse)).numpy()
    _close(got, want, 1e-5, "point head")


@pytest.mark.parametrize("side, cin", [(14, 32), (7, 64)], ids=["fpn_14", "res5_7_reduced"])
def test_coarse_mask_head_on_crossed_weights_matches_jax(side, cin):
    """``CoarseMaskHead`` (conv 32, 2 fc of 64, 7² of 5 classes) on
    (6, side, side, cin) rois: the 1x1 channel reduction only when cin >
    32, the 2x2 stride-2 conv (an odd side padded at its end, flax's SAME),
    the NCHW flatten with ``coarse_mask_fc1``'s input permuted as the
    weights cross, the (class, y, x) prediction: (6, 5, 7, 7) within 1e-5
    of their scale; each roi's class alone too."""
    x = np.random.RandomState(side).randn(6, side, side, cin).astype(np.float32)
    jhead = jax_mask_head.CoarseMaskHead(5, conv_dim=32, fc_dim=64, num_fc=2, output_side=7)
    variables = _random_variables(jax.eval_shape(lambda: jhead.init(jax.random.PRNGKey(0), jnp.asarray(x))), 6)
    want = np.asarray(jhead.apply(variables, jnp.asarray(x))).transpose(0, 3, 1, 2)
    head = mask_head.CoarseMaskHead(cin, 5, side, 32, 64, 2, 7)
    state = state_dict_from_jax({"params": {"mask_head": variables["params"]}})
    head.load_state_dict({k.removeprefix("roi_heads.mask_head."): v for k, v in state.items()})
    assert (head.reduce_channel_dim_conv is not None) == (cin > 32)
    classes = torch.tensor([0, 4, 2, 2, 1, 3])
    with torch.no_grad():
        got = head(_nchw(x)).numpy()
        sel = head(_nchw(x), classes).numpy()
    assert got.shape == want.shape == (6, 5, 7, 7)
    _close(got, want, 1e-5, "coarse mask logits")
    np.testing.assert_array_equal(sel, got[np.arange(6), classes.numpy()])


def test_refine_mask_with_points_matches_jax():
    """Three subdivision steps of five rois' 7² logits (2x bilinear, then
    the 100 least certain of 196, 784 and 3136 re-predicted by the point
    head from 14² fine maps): (5, 56, 56) within 1e-5 of their scale."""
    rng = np.random.RandomState(8)
    logits = rng.randn(5, 7, 7).astype(np.float32) * 3
    fine = rng.randn(5, 14, 14, 6).astype(np.float32)
    jhead = jax_point_head.PointHead(1, fc_dim=16, num_fc=2)
    variables = _random_variables(jax.eval_shape(
        lambda: jhead.init(jax.random.PRNGKey(0), jnp.zeros((4, 6)), jnp.zeros((4, 1)))), 9)
    point_fn = lambda fv, cv: jhead.apply(variables, fv, cv)  # noqa: E731
    want = np.asarray(jax.vmap(lambda lg, f: jax_point_head.refine_mask_with_points(lg, f, point_fn, 100, 3))(
        jnp.asarray(logits), jnp.asarray(fine)))
    head = point_head.PointHead(6, 1, 1, 16, 2)
    state = state_dict_from_jax({"params": {"point_head": variables["params"]}})
    head.load_state_dict({k.removeprefix("roi_heads.mask_point_head."): v for k, v in state.items()})
    with torch.no_grad():
        got = point_head.refine_mask_with_points(torch.from_numpy(logits), _nchw(fine), head, 100, 3).numpy()
    assert got.shape == want.shape == (5, 56, 56)
    _close(got, want, 1e-5, "refined logits")


# -- PointRend R-CNN --------------------------------------------------------------------------------------------


def _rcnn_draws(key, pm, n=2, proposals=100):
    """JAX's uniforms for the whole loss: the RPN's and ROI's
    (``test_torch_rcnn._jax_draws``; the ROI sampler's over the proposals
    and the 6 gt slots), and the point sampler's, one key per sampled roi
    split off the third key."""
    draws = _jax_draws(key, n, _anchor_count(pm), max(proposals + 6, 64))
    draws["point_cand"], draws["point_rand"] = _point_draws(jax.random.split(key, 3)[2], n * 64, POINTS)
    return draws


def _mask_batch(seed):
    b = _batch(seed)
    rng = np.random.RandomState(seed + 50)
    b["gt_masks"] = (rng.rand(*b["gt_boxes"].shape[:2], 16, 16) > 0.4).astype(np.uint8)
    return b


def test_pointrend_rcnn_loss_and_every_gradient_match_jax(rcnn):
    """The six losses on JAX's draws, ``loss_mask_point`` among them (28
    points a foreground roi on its gt class's 7² coarse logits, the point
    head on the rois pooled at 28² over p2-p5 and the coarse logit there,
    against the gt crop sampled there), within 1e-5 relative; every
    parameter's gradient within 1e-4 of its own max |value|, the point
    head's and the coarse head's not 0."""
    jm, variables, pm = rcnn
    batch, key = _mask_batch(1), jax.random.PRNGKey(5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch["rng"] = key
    (_, (jloss, _)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, variables["batch_stats"], jbatch), has_aux=True))(variables["params"])
    pb = _port_batch(batch, _rcnn_draws(key, pm))
    pb["gt_masks"] = torch.from_numpy(batch["gt_masks"])
    for p in pm.model.parameters():
        p.grad = torch.zeros_like(p)
    pm.model.train()
    total, losses = pm.loss_fn(pb)
    total.backward()
    pm.model.eval()
    assert set(losses) == set(jloss) == {"loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "loss_mask",
                                         "loss_mask_point"}
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), float(jloss[k]), rtol=1e-5, err_msg=k)
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    grads = {k: p.grad for k, p in pm.model.named_parameters()}
    assert set(want) == set(grads)
    for k, g in grads.items():
        w = want[k].numpy()
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max(), k
    assert grads["roi_heads.mask_point_head.fc1.weight"].abs().max() > 0
    assert grads["roi_heads.mask_head.coarse_mask_fc1.weight"].abs().max() > 0


def test_pointrend_training_draws_from_the_step_generator(rcnn):
    """Without ``draws`` the point sampler takes its uniforms from the step's
    generator after the samplers', for the foreground block only: two runs
    from one seed give the same loss, another seed another."""
    _, _, pm = rcnn
    batch = _mask_batch(2)
    out = []
    for seed in (3, 3, 4):
        pb = _port_batch(batch)
        pb["gt_masks"] = torch.from_numpy(batch["gt_masks"])
        pb["generator"] = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            out.append(pm.loss_fn(pb)[1]["loss_mask_point"].item())
    assert out[0] == out[1] != out[2] and all(np.isfinite(out))


def test_predict_fn_subdivided_masks_match_jax(rcnn):
    """Two 64² images: ``masks`` (2, 100, 56, 56), the sigmoid of the
    detection's class's 7² coarse logits subdivided three times, within
    2e-3 of JAX's, with the same classes."""
    jm, variables, pm = rcnn
    x = _images(2, seed=8)
    want = jax.jit(jm.predict_fn)(variables, jnp.asarray(x))
    got = pm.predict_fn(_nchw(x))
    assert got["masks"].shape == (2, 100, 56, 56)
    np.testing.assert_array_equal(got["classes"].numpy(), np.asarray(want["classes"]))
    np.testing.assert_allclose(got["masks"].numpy(), np.asarray(want["masks"]), rtol=0, atol=2e-3)
    assert 0.05 < float(np.asarray(want["masks"]).std())


def test_res5_roi_heads_with_a_point_head_match_jax():
    """C4 (``Res5ROIHeads``) with ``POINT_HEAD_ON``: JAX builds it (the conv
    mask head on the res5 output, the point head on res4 pooled at 28²) and
    so does the port; the losses on JAX's draws within 1e-5 relative and the
    masks (2, 100, 56, 56) within 2e-3."""
    extra = ["MODEL.ROI_HEADS.NAME", "Res5ROIHeads", "MODEL.BACKBONE.NAME", "build_resnet_backbone",
             "MODEL.RESNETS.OUT_FEATURES", ["res4"], "MODEL.RPN.IN_FEATURES", ["res4"],
             "MODEL.ROI_HEADS.IN_FEATURES", ["res4"], "MODEL.ANCHOR_GENERATOR.SIZES", [[32, 64]],
             "MODEL.RESNETS.DEPTH", 50, "MODEL.RESNETS.WIDTH_PER_GROUP", 4, "MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION", 14,
             "MODEL.MASK_ON", True, "MODEL.ROI_MASK_HEAD.CONV_DIM", 32, "MODEL.ROI_MASK_HEAD.POINT_HEAD_ON", True,
             "MODEL.POINT_HEAD.FC_DIM", 32, "MODEL.POINT_HEAD.TRAIN_NUM_POINTS", POINTS,
             "MODEL.POINT_HEAD.SUBDIVISION_STEPS", 1, "INPUT.MASK_RASTER", 16]
    jm, variables, pm = _pair(extra, seed=4)
    assert pm.roi_type == "res5" and pm.point_rend_on and hasattr(pm.model.roi_heads, "mask_point_head")
    batch, key = _mask_batch(3), jax.random.PRNGKey(6)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch["rng"] = key
    jloss = jax.jit(lambda p: jm.loss_fn(p, variables["batch_stats"], jbatch)[1][0])(variables["params"])
    pb = _port_batch(batch, _rcnn_draws(key, pm, proposals=min(100, _anchor_count(pm))))
    pb["gt_masks"] = torch.from_numpy(batch["gt_masks"])
    with torch.no_grad():
        losses = pm.loss_fn(pb)[1]
    assert set(losses) == set(jloss) and "loss_mask_point" in losses
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), float(jloss[k]), rtol=1e-5, err_msg=k)
    x = _images(2, seed=9)
    want = jax.jit(jm.predict_fn)(variables, jnp.asarray(x))
    got = pm.predict_fn(_nchw(x))
    assert got["masks"].shape == (2, 100, 28, 28)
    np.testing.assert_allclose(got["masks"].numpy(), np.asarray(want["masks"]), rtol=0, atol=2e-3)


# -- PointRend's semantic head ------------------------------------------------------------------------------


def _sem_draws(jm, variables, rng, n, num_points=SEM_POINTS):
    """The uniforms JAX's ``PointRendSemSegHead`` draws: flax's
    ``make_rng("points")`` in the head's scope from ``rng``, one key an
    image split off it, each split in two (candidates, the rest)."""
    key = jm.module.apply(variables, method=lambda m: m.head.make_rng("points"), rngs={"points": rng})
    cand, rand = _point_draws(key, n, num_points)
    return {"point_cand": cand, "point_rand": rand}


def _sem_labels(seed, n=2):
    rng = np.random.RandomState(seed)
    lab = rng.randint(0, 7, (n, SIZE, SIZE)).astype(np.int32)
    lab[rng.rand(n, SIZE, SIZE) < 0.2] = 255
    return lab


def test_pointrend_sem_seg_head_training_outputs_match_jax(sem):
    """The training forward on JAX's draws: the coarse logits (2, 7, 64, 64)
    within 1e-5 of their scale, the points (the 24 candidates of least
    top-2 logit gap, then 8 uniform) exactly, the point logits (2, 32, 7)
    within 1e-5 of their scale."""
    jm, variables, pm = sem
    x = _images(2, seed=10)
    rng = jax.random.PRNGKey(11)
    (logits, point_logits, coords), _ = jax.jit(lambda v, a: jm.module.apply(
        v, jm.normalize(a), True, rngs={"points": rng}, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    draws = _sem_draws(jm, variables, rng, 2)
    with torch.no_grad():
        got = pm.model(pm.normalize(_nchw(x)), (draws["point_cand"], draws["point_rand"]))
    _close(got[0].numpy(), np.asarray(logits).transpose(0, 3, 1, 2), 1e-5, "coarse logits")
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(coords))
    assert got[1].shape == (2, SEM_POINTS, 7)
    _close(got[1].numpy(), np.asarray(point_logits), 1e-5, "point logits")


def test_pointrend_sem_seg_loss_and_every_gradient_match_jax(sem):
    """``loss_sem_seg`` and ``loss_sem_seg_point`` (the point CE against the
    label at each point's pixel, a fifth ignored) on JAX's draws within
    1e-5 relative; every gradient within 1e-4 of its own max |value|, the
    point head's not 0."""
    jm, variables, pm = sem
    batch = {"image": _images(2, seed=12), "sem_seg": _sem_labels(13)}
    rng = jax.random.PRNGKey(14)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch["rng"] = rng
    (_, (jloss, _)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, variables["batch_stats"], jbatch), has_aux=True))(variables["params"])
    for p in pm.model.parameters():
        p.grad = torch.zeros_like(p)
    pm.model.train()
    total, losses = pm.loss_fn({"image": _nchw(batch["image"]), "sem_seg": torch.from_numpy(batch["sem_seg"]),
                                "draws": _sem_draws(jm, variables, rng, 2)})
    total.backward()
    pm.model.eval()
    assert set(losses) == set(jloss) == {"loss_sem_seg", "loss_sem_seg_point"}
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), float(jloss[k]), rtol=1e-5, err_msg=k)
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    grads = {k: p.grad for k, p in pm.model.named_parameters()}
    assert set(want) == set(grads)
    for k, g in grads.items():
        w = want[k].numpy()
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max(), k
    assert grads["sem_seg_head.point_head.fc1.weight"].abs().max() > 0


def test_pointrend_sem_seg_point_loss_matches_jax():
    """``sem_seg_point_loss`` alone: points on the pixel edges and corners,
    a fifth of the labels ignored: within 1e-6 relative, and its logits'
    gradient within 1e-6 of its max."""
    rng = np.random.RandomState(15)
    logits = rng.randn(2, 40, 7).astype(np.float32)
    coords = rng.uniform(0, 1, (2, 40, 2)).astype(np.float32)
    coords[:, :3] = [[0, 0], [1, 1], [0.5, 1]]
    targets = _sem_labels(16)[:, :20, :30]
    want, want_grad = jax.value_and_grad(lambda lg: jax_semseg.sem_seg_point_loss(
        lg, jnp.asarray(coords), jnp.asarray(targets)))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = semantic_seg.sem_seg_point_loss(x, torch.from_numpy(coords), torch.from_numpy(targets).long())
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    _close(x.grad.numpy(), np.asarray(want_grad), 1e-6, "gradient")


def test_pointrend_sem_seg_inference_refines_as_jax(sem):
    """``predict_fn``: the input-resolution logits refined in place twice
    at the 256 pixels of least top-2 gap: (2, 7, 64, 64) within 1e-5 of
    their scale of JAX's; the refinement moved them from the coarse head's."""
    jm, variables, pm = sem
    x = _images(2, seed=17)
    want = np.asarray(jax.jit(jm.predict_fn)(variables, jnp.asarray(x))["sem_seg"]).transpose(0, 3, 1, 2)
    got = pm.predict_fn(_nchw(x))["sem_seg"]
    assert got.shape == (2, 7, SIZE, SIZE)
    _close(got.numpy(), want, 1e-5, "refined logits")
    with torch.no_grad():
        coarse = pm.model.sem_seg_head.coarse_sem_seg_head(pm.model.backbone(pm.normalize(_nchw(x))))
    moved = (coarse != got).flatten(2).any(1).sum(1)
    assert ((moved > 0) & (moved <= 2 * 256)).all()


# -- the YAMLs ----------------------------------------------------------------------------------------------


@pytest.mark.parametrize("yaml", [
    "projects/PointRend/configs/InstanceSegmentation/pointrend_rcnn_R_50_FPN_1x_coco.yaml",
    "projects/PointRend/configs/SemanticSegmentation/pointrend_semantic_R_101_FPN_1x_cityscapes.yaml"])
def test_pointrend_yamls_build_and_match_jax(yaml):
    """Each PointRend YAML, narrowed (R18 and the small widths above, 64²),
    builds the same network in both packages (every JAX leaf crosses,
    strictly), with the YAML's heads (``CoarseMaskHead`` 7² and 5 steps to
    224², or the semantic head's 2 steps of 8192 points around
    ``SemSegFPNHead``), and ``predict_fn`` agrees: the refined sem-seg
    logits within 1e-5 of their scale; the masks within 2e-3 but at the
    few pixels a point was re-predicted at on one side only (ROADMAP C29:
    the boxes agree to 4e-4 px, and at 784 points of 3136 to 50176 the
    |logit| ranks tie at that rounding; measured 80 of 5 017 600 pixels,
    in 4 of the 100 detections, held to a share of 1e-4)."""
    semantic = "Semantic" in yaml
    narrow = ["MODEL.WEIGHTS", "", "MODEL.ROI_MASK_HEAD.CONV_DIM", 32, "MODEL.ROI_MASK_HEAD.FC_DIM", 64,
              "MODEL.POINT_HEAD.FC_DIM", 32, "MODEL.SEM_SEG_HEAD.CONVS_DIM", 16, "INPUT.COLOR_AUG_SSD", False]
    if semantic:  # the Cityscapes classes over R18-FPN's p2-p5
        narrow += ["MODEL.META_ARCHITECTURE", "SemanticSegmentor", "MODEL.SEM_SEG_HEAD.IN_FEATURES",
                   ["p2", "p3", "p4", "p5"]]
    else:
        narrow += ["MODEL.ROI_HEADS.NUM_CLASSES", 80, "MODEL.ROI_HEADS.NAME", "PointRendROIHeads"]
    jm, variables, pm = _pair(narrow, seed=18, yaml=yaml)
    ph = pm.model.sem_seg_head if semantic else None
    if semantic:
        assert type(ph).__name__ == "PointRendSemSegHead" and ph.subdivision_num_points == 8192
        assert type(ph.coarse_sem_seg_head).__name__ == "SemSegFPNHead" and ph.train_num_points == 2048
    else:
        assert type(pm.model.roi_heads.mask_head).__name__ == "CoarseMaskHead" and pm.point_steps == 5
    x = _images(1, seed=19)
    want = jax.jit(jm.predict_fn)(variables, jnp.asarray(x))
    got = pm.predict_fn(_nchw(x))
    if semantic:
        _close(got["sem_seg"].numpy(), np.asarray(want["sem_seg"]).transpose(0, 3, 1, 2), 1e-5, yaml)
        assert got["sem_seg"].shape == (1, 19, SIZE, SIZE)
    else:
        assert got["masks"].shape == (1, 100, 224, 224)
        off = np.abs(got["masks"].numpy() - np.asarray(want["masks"])) > 2e-3
        assert off.mean() <= 1e-4 and off.any(axis=(2, 3)).sum() <= 10
