"""The port's R-CNNs on the bare ResNet trunk against the JAX package on the
CPU, in f32: C4 (``Res5ROIHeads``: the trunk stops at res4, the res5 stage
runs on 14² rois and feeds the predictor through a global average and, with
``MASK_ON``, the mask head; ``mask_rcnn_R_50_C4_1x.yaml``), its keypoint
variant (the JAX package runs the keypoint head on res4-pooled rois, which
the reference refuses), the C4 ProposalNetwork (``rpn_R_50_C4_1x.yaml``)
and DC5 (``faster_rcnn_R_50_DC5_1x.yaml``: res5 dilated, so at stride 16).

Sizes: ResNet-50 cut to ``WIDTH_PER_GROUP`` 4, ``RES2_OUT_CHANNELS`` 16 and
a stem of 8 (bottleneck blocks as in the reference), 5 classes, mask convs
of 32 on 16² rasters, proposals 200/100 at training and 100/50 at test, 64
rois per image, 64² inputs. The variables are ``test_torch_rcnn``'s random
tree, made from a seed with numpy.

DC5 (ROADMAP C20): the JAX package builds its anchors and its ROI scale for
stride 32 on the stride-16 map (``ResNet.out_feature_strides`` reports 32
whatever the dilation), the port at the stride the blocks take, as the
reference. The port is held to JAX with JAX's strides put right inside the
test (``_fix_jax_strides``); ``test_dc5_jax_anchors_fall_short_of_its_logits``
shows the gap.
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
from detectron2_centernet_tpu.models.anchors import build_anchor_generator as jax_anchor_generator
from detectron2_centernet_tpu.models.build import build_model as jax_build_model
from detectron2_centernet_tpu_torch.checkpoint import canonical_key, state_dict_from_jax, torch_key
from detectron2_centernet_tpu_torch.config import get_cfg
from detectron2_centernet_tpu_torch.data import warp_image
from detectron2_centernet_tpu_torch.data.datasets import ensure_synthetic_datasets
from detectron2_centernet_tpu_torch.engine import DefaultPredictor, DefaultTrainer
from detectron2_centernet_tpu_torch.models import build_model
from detectron2_centernet_tpu_torch.models.backbones.resnet import BottleneckBlock
from detectron2_centernet_tpu_torch.tools import bench

from test_torch_keypoint import _kp_batch
from test_torch_mask import _mask_batch
from test_torch_rcnn import (SIZE, _anchor_count, _batch, _images, _jax_draws, _nchw, _port_batch,
                             _random_variables)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = {"c4": "COCO-InstanceSegmentation/mask_rcnn_R_50_C4_1x.yaml",
         "c4_rpn": "COCO-Detection/rpn_R_50_C4_1x.yaml", "dc5": "COCO-Detection/faster_rcnn_R_50_DC5_1x.yaml"}
NARROW = ["MODEL.WEIGHTS", "", "MODEL.RESNETS.WIDTH_PER_GROUP", 4, "MODEL.RESNETS.RES2_OUT_CHANNELS", 16,
          "MODEL.RESNETS.STEM_OUT_CHANNELS", 8, "MODEL.ROI_HEADS.NUM_CLASSES", 5,
          "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 64, "MODEL.ROI_MASK_HEAD.CONV_DIM", 32, "INPUT.MASK_RASTER", 16,
          "MODEL.ROI_BOX_HEAD.FC_DIM", 64, "MODEL.RPN.PRE_NMS_TOPK_TRAIN", 200, "MODEL.RPN.POST_NMS_TOPK_TRAIN", 100,
          "MODEL.RPN.PRE_NMS_TOPK_TEST", 100, "MODEL.RPN.POST_NMS_TOPK_TEST", 50,
          "INPUT.TRAIN_SIZE", (SIZE, SIZE), "INPUT.TEST_SIZE", (SIZE, SIZE)]
SMALL = NARROW + ["TPU.DTYPE", "float32", "TEST.EXACT_MODE", True, "INPUT.COLOR_JITTER", False,
                  "DATASETS.TRAIN", ()]
KEYPOINT = ["MODEL.MASK_ON", False, "MODEL.KEYPOINT_ON", True, "MODEL.ROI_HEADS.NUM_CLASSES", 1,
            "MODEL.ROI_KEYPOINT_HEAD.CONV_DIMS", [64, 64]]
CASES = {"c4": ("c4", []), "c4_keypoint": ("c4", KEYPOINT), "c4_rpn": ("c4_rpn", []), "dc5": ("dc5", [])}


def _cfgs(case):
    name, extra = CASES[case]
    jcfg, pcfg = jax_get_cfg(), get_cfg()
    for cfg in (jcfg, pcfg):
        cfg.merge_from_file(os.path.join(REPO, "configs", YAMLS[name]))
        cfg.merge_from_list(SMALL + extra)
    pcfg.MODEL.DEVICE = "cpu"
    return jcfg, pcfg


def _fix_jax_strides(jm, jcfg, stride=16):
    """The JAX model's RPN and ROI strides put at DC5's true res5 stride, its
    anchors rebuilt for it: plain attributes, no JAX file changes."""
    jm.rpn_strides = jm.roi_strides = [stride]
    jm.anchor_generator = jax_anchor_generator(jcfg, [stride])


def _port_leaves(variables, pm):
    """A ProposalNetwork's JAX tree also carries the ROI heads its network
    never uses; the port's, like the reference's, has none."""
    if hasattr(pm.model, "roi_heads"):
        return variables
    return unflatten_dict({k: v for k, v in flatten_dict(variables).items() if k[1] in ("backbone", "rpn_head")})


def _pair(case, seed=0):
    jcfg, pcfg = _cfgs(case)
    jm = jax_build_model(jcfg)
    if case == "dc5":
        _fix_jax_strides(jm, jcfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), (SIZE, SIZE)))
    variables = _random_variables(shapes, seed)
    pm = build_model(pcfg)
    pm.model.load_state_dict(state_dict_from_jax(_port_leaves(variables, pm)))
    return jm, variables, pm


@pytest.fixture(scope="module")
def c4():
    return _pair("c4")


@pytest.fixture(scope="module")
def dc5():
    return _pair("dc5")


# -- structure and weights -------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_state_dict_from_jax_covers_every_leaf_once_both_ways(case):
    """Every JAX leaf (the bare trunk under ``backbone``, ``rpn_head``, C4's
    ``res5_block{b}`` with its FrozenBN statistics, ``box_predictor``, the
    mask or keypoint head; DC5's ``box_head``) maps to one port key of its
    shape (``backbone.res4.5.conv3.norm``, ``roi_heads.res5.0.shortcut``,
    ...) and back; the port has no key beyond them."""
    jm, variables, pm = _pair(case)
    leaves = {"/".join(p) for p in flatten_dict(_port_leaves(variables, pm))}
    sd = state_dict_from_jax(_port_leaves(variables, pm))
    own = {k for k in pm.model.state_dict() if not k.endswith("num_batches_tracked")}
    assert sorted(canonical_key(k, trunk="") for k in own) == sorted(leaves)
    assert {torch_key(p) for p in leaves} == own
    for key, t in pm.model.state_dict().items():
        assert t.shape == sd[key].shape, key
    assert canonical_key("backbone.res3.1.conv2.norm.running_var", trunk="") == \
        "batch_stats/backbone/res3_block1/conv2_norm/bn/var"
    if case.startswith("c4") and case != "c4_rpn":
        assert canonical_key("roi_heads.res5.0.shortcut.norm.weight") == "params/res5_block0/shortcut_norm/bn/scale"
        assert torch_key("batch_stats/res5_block2/conv3_norm/bn/mean") == "roi_heads.res5.2.conv3.norm.running_mean"


@pytest.mark.parametrize("stride_in_1x1", [True, False])
def test_res5_head_is_the_trunks_res5_on_the_rois(stride_in_1x1):
    """C4: the trunk stops at res4 (stride 16); the ROI heads hold res5 as
    RESNET_SPECS[50]'s 3 bottleneck blocks, 8·RES2 out, NUM_GROUPS ·
    WIDTH_PER_GROUP · 8 wide, block 0 striding 2 in its first 1x1 or in
    its 3x3 as ``STRIDE_IN_1X1`` says, FrozenBN; the predictor reads its
    (R, 128, 7, 7) output averaged, the mask head (no conv, the deconv on
    128 channels) the output itself."""
    jcfg, pcfg = _cfgs("c4")
    pcfg.MODEL.RESNETS.STRIDE_IN_1X1 = stride_in_1x1
    pm = build_model(pcfg)
    assert pm.model.backbone.stage_names[-1] == "res4" and pm.strides == pm.roi_strides == [16]
    blocks = list(pm.model.roi_heads.res5)
    assert len(blocks) == 3 and all(isinstance(b, BottleneckBlock) for b in blocks)
    first = blocks[0]
    assert (first.conv1.in_channels, first.conv1.out_channels, first.conv3.out_channels) == (64, 32, 128)
    assert (first.conv1.stride, first.conv2.stride) == (((2, 2), (1, 1)) if stride_in_1x1 else ((1, 1), (2, 2)))
    assert type(first.conv1.norm).__name__ == "FrozenBatchNorm" and first.shortcut.stride == (2, 2)
    out = pm.model.res5_transform(torch.randn(3, 64, 14, 14))
    assert out.shape == (3, 128, 7, 7)
    assert pm.model.roi_heads.mask_head.deconv.in_channels == 128 and pm.model.roi_heads.mask_head.num_conv == 0
    scores, deltas = pm.model.box_predict_shared(out)
    torch.testing.assert_close(scores, pm.model.roi_heads.box_predictor(out.mean((2, 3)))[0])


# -- the whole model ------------------------------------------------------------------------------


def _person_batch(seed):
    """``test_torch_keypoint``'s batch, every gt of the one class (person)."""
    b = _kp_batch(seed)
    b["gt_classes"] = np.zeros_like(b["gt_classes"])
    return b


def _loss_and_grads(jm, variables, pm, batch, key, extra_keys=()):
    """JAX's losses and gradients on ``batch`` and the port's on JAX's draws."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch["rng"] = key
    stats = variables["batch_stats"]
    (_, (jloss, _)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, stats, jbatch), has_aux=True))(variables["params"])
    slots = max(100 + batch["gt_boxes"].shape[1], 64)
    pb = _port_batch(batch, _jax_draws(key, 2, _anchor_count(pm), slots))
    for k in extra_keys:
        pb[k] = torch.from_numpy(batch[k])
    for p in pm.model.parameters():
        p.grad = torch.zeros_like(p)
    pm.model.train()
    try:
        total, losses = pm.loss_fn(pb)
        total.backward()
    finally:
        pm.model.eval()
    want = state_dict_from_jax(_port_leaves({"params": jax.tree_util.tree_map(np.asarray, jgrads)}, pm))
    return losses, jloss, {k: p.grad for k, p in pm.model.named_parameters()}, want


# the keypoint head's last bias: a constant added to a map's cells leaves its
# softmax as it is, so its true gradient is 0 and both sides' are rounding
# (``test_torch_keypoint``); it is held under 1e-6 instead
SHIFT_FREE = "roi_heads.keypoint_head.score_lowres.bias"


def _check_losses_and_grads(losses, jloss, grads, want, names):
    assert set(losses) == set(jloss) == names
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), float(jloss[k]), rtol=1e-5, err_msg=k)
    assert set(want) == set(grads)
    for k, g in grads.items():
        w = want[k].numpy()
        if k == SHIFT_FREE:
            assert np.abs(g.numpy()).max() < 1e-6 and np.abs(w).max() < 1e-6
            continue
        assert np.abs(g.numpy() - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-12), k


def test_c4_loss_and_every_gradient_match_jax(c4):
    """The RPN losses, the Fast R-CNN losses on the res5 head's averaged
    output and the mask loss on that same output's foreground block, on
    JAX's draws, within 1e-5 relative; every gradient within 1e-4 of its
    own max |value|: the res5 head's FrozenBN trains (``FREEZE_AT`` 2 stops
    at the trunk's res2) and the stem and res2 get 0."""
    jm, variables, pm = c4
    losses, jloss, grads, want = _loss_and_grads(jm, variables, pm, _mask_batch(1), jax.random.PRNGKey(5),
                                                 ("gt_masks",))
    _check_losses_and_grads(losses, jloss, grads, want,
                            {"loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "loss_mask"})
    assert grads["roi_heads.res5.0.conv1.norm.weight"].abs().max() > 0
    assert grads["roi_heads.mask_head.deconv.weight"].abs().max() > 0
    assert not grads["backbone.stem.conv1.weight"].any() and not grads["backbone.res2.0.conv1.weight"].any()


def test_c4_predict_fn_with_masks_matches_jax(c4):
    """Two 64² images: the K = 100 slots' validity and classes equal JAX's,
    scores within 1e-4, boxes within 1e-2 px (``test_torch_rcnn``'s), the
    masks (res5 again on the detections' 14² pools, then the deconv)
    within 2e-3 (``test_torch_mask``'s); scores unsaturated."""
    jm, variables, pm = c4
    x = _images(2, seed=8)
    want = jax.jit(jm.predict_fn)(variables, jnp.asarray(x))
    got = pm.predict_fn(_nchw(x))
    scores = np.asarray(want["scores"])
    assert got["masks"].shape == (2, 100, 14, 14)
    assert ((scores > 0.05).sum(1) >= 20).all() and ((scores > 0.05) & (scores < 0.9)).any()
    np.testing.assert_array_equal(got["scores"].numpy() > 0.05, scores > 0.05)
    np.testing.assert_array_equal(got["classes"].numpy(), np.asarray(want["classes"]))
    np.testing.assert_allclose(got["scores"].numpy(), scores, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), rtol=0, atol=1e-2)
    np.testing.assert_allclose(got["masks"].numpy(), np.asarray(want["masks"]), rtol=0, atol=2e-3)
    assert 0.05 < float(np.asarray(want["masks"]).std())


def test_c4_default_predictor_with_masks_matches_jax(c4, monkeypatch):
    """One BGR uint8 image of 50×70 through both DefaultPredictors (the JAX
    one fed the port's warp): the same detections, classes, scores within
    1e-4, boxes within 1e-2 px; the pasted masks equal but for pixels on an
    edge the boxes' 1e-2 px put on either side (under 0.1%)."""
    jm, variables, pm = c4
    jcfg, pcfg = _cfgs("c4")
    port = DefaultPredictor(pcfg)
    port.model.model.load_state_dict(state_dict_from_jax(variables))
    monkeypatch.setattr(type(jm), "init", lambda self, rng, size: variables)
    ref = JaxPredictor(jcfg)
    ref._warp_image = lambda img, m, size: warp_image(img, m, size).numpy()
    img = np.random.RandomState(7).randint(0, 256, (50, 70, 3)).astype(np.uint8)
    got = port(img)["instances"]
    want = ref(img)["instances"]
    assert len(got) == len(want) >= 2
    np.testing.assert_array_equal(got.pred_classes, want.pred_classes)
    np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.pred_boxes.tensor, np.asarray(want.pred_boxes.tensor), rtol=0, atol=1e-2)
    assert got.pred_masks.shape == want.pred_masks.shape and got.pred_masks.any()
    assert (got.pred_masks != want.pred_masks).mean() < 1e-3


def test_c4_keypoint_rcnn_loss_gradients_and_heatmaps_match_jax():
    """``Res5ROIHeads`` with ``KEYPOINT_ON`` (one class, a keypoint head of
    two convs of 64 on res4-pooled 14² rois, as the JAX package runs it):
    the losses and every gradient on JAX's draws as above (``SHIFT_FREE``
    under 1e-6), and
    ``predict_fn``'s classes, scores (1e-4) and keypoint heatmaps (within
    1e-3 of their scale: pooled on boxes 1e-2 px apart)."""
    jm, variables, pm = _pair("c4_keypoint")
    losses, jloss, grads, want = _loss_and_grads(jm, variables, pm, _person_batch(1), jax.random.PRNGKey(4),
                                                 ("gt_keypoints",))
    _check_losses_and_grads(losses, jloss, grads, want,
                            {"loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "loss_keypoint"})
    assert grads["roi_heads.keypoint_head.score_lowres.weight"].abs().max() > 0
    x = _images(2, seed=8)
    want = jax.jit(jm.predict_fn)(variables, jnp.asarray(x))
    got = pm.predict_fn(_nchw(x))
    np.testing.assert_array_equal(got["classes"].numpy(), np.asarray(want["classes"]))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), rtol=0, atol=1e-4)
    hm = np.asarray(want["keypoint_heatmaps"]).transpose(0, 1, 4, 2, 3)
    assert got["keypoint_heatmaps"].shape == hm.shape == (2, 100, 17, 56, 56)
    np.testing.assert_allclose(got["keypoint_heatmaps"].numpy(), hm, rtol=0, atol=1e-3 * np.abs(hm).max())


def test_c4_proposal_network_predict_and_loss_match_jax():
    """``rpn_R_50_C4_1x.yaml``: one level of 4·4·15 anchors on res4; the 50
    proposal slots equal JAX's (validity exactly, sigmoid scores within
    1e-5, boxes within 1e-2 px), the two RPN losses on JAX's draws within
    1e-5 relative and the trunk's and RPN head's gradients within 1e-4."""
    jm, variables, pm = _pair("c4_rpn")
    assert not hasattr(pm.model, "roi_heads") and _anchor_count(pm) == 4 * 4 * 15
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
    pm.model.eval()
    want = state_dict_from_jax(_port_leaves({"params": jax.tree_util.tree_map(np.asarray, jgrads)}, pm))
    _check_losses_and_grads(losses, jloss, {k: p.grad for k, p in pm.model.named_parameters()}, want,
                            {"loss_rpn_cls", "loss_rpn_loc"})


def test_dc5_loss_gradients_and_predict_fn_match_jax_at_stride_16(dc5):
    """DC5: res5 dilated 2, its first block unstrided, at stride 16 (4² at
    64²); the RPN and the 7² pooler on it, the 2-fc box head of 64. Against
    JAX with its strides put right: the four losses on JAX's draws and every
    gradient (as above), and ``predict_fn``'s validity, classes, scores
    (1e-4) and boxes (1e-2 px)."""
    jm, variables, pm = dc5
    assert pm.strides == pm.roi_strides == [16] and pm.model.backbone.out_feature_strides["res5"] == 16
    losses, jloss, grads, want = _loss_and_grads(jm, variables, pm, _batch(2), jax.random.PRNGKey(3))
    _check_losses_and_grads(losses, jloss, grads, want, {"loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg"})
    x = _images(2, seed=8)
    want = jax.jit(jm.predict_fn)(variables, jnp.asarray(x))
    got = pm.predict_fn(_nchw(x))
    scores = np.asarray(want["scores"])
    assert ((scores > 0.05).sum(1) >= 20).all()
    np.testing.assert_array_equal(got["scores"].numpy() > 0.05, scores > 0.05)
    np.testing.assert_array_equal(got["classes"].numpy(), np.asarray(want["classes"]))
    np.testing.assert_allclose(got["scores"].numpy(), scores, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), rtol=0, atol=1e-2)


def test_dc5_jax_anchors_fall_short_of_its_logits():
    """ROADMAP C20 on a 64² R18-DC5 (RES2 16): res5 is (1, 4, 4, 128) in
    both packages, so the RPN gives 4·4·15 = 240 logits per image; the JAX
    package, at its reported stride 32, builds 2·2·15 = 60 anchors and a
    1/32 ROI scale (its gathers clamp, so nothing raises); the port builds
    240 anchors at stride 16."""
    jcfg, pcfg = _cfgs("dc5")
    for cfg in (jcfg, pcfg):
        cfg.merge_from_list(["MODEL.RESNETS.DEPTH", 18, "MODEL.RESNETS.RES2_OUT_CHANNELS", 16])
    jm = jax_build_model(jcfg)
    variables = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), (SIZE, SIZE)))
    feats, logits, _ = jax.eval_shape(lambda v, x: jm.module.apply(v, x, False, method=type(jm.module).backbone_rpn),
                                      variables, jax.ShapeDtypeStruct((1, SIZE, SIZE, 3), jnp.float32))
    assert feats["res5"].shape == (1, 4, 4, 128) and logits[0].size == 240
    assert jm.rpn_strides == jm.roi_strides == [32]
    assert sum(a.shape[0] for a in jm._anchors_per_level((SIZE, SIZE))) == 60
    pm = build_model(pcfg)
    _, plogits, _ = pm.model(pm.normalize(torch.zeros(1, 3, SIZE, SIZE)))
    assert plogits[0].numel() == 240 == _anchor_count(pm) and pm.roi_strides == [16]


# -- entry points ----------------------------------------------------------------------------------


@pytest.mark.parametrize("case, extra", [("c4", ["MODEL.MASK_ON", False]), ("c4", KEYPOINT), ("dc5", [])],
                         ids=["res5_roi_heads", "res5_keypoint", "res5_dilation"])
def test_res5_and_dc5_options_that_raised_build_and_run(case, extra):
    """``ROI_HEADS.NAME Res5ROIHeads`` (with and without ``KEYPOINT_ON``) and
    ``RESNETS.RES5_DILATION`` 2 raised before this slice
    (``test_torch_rcnn``'s raise test): they build, serve and take a loss
    with a backward now."""
    _, pcfg = _cfgs(case)
    pcfg.merge_from_list(extra)
    pm = build_model(pcfg)
    dets = pm.predict_fn(_nchw(_images(1, seed=3)))
    assert dets["boxes"].shape == (1, 100, 4) and torch.isfinite(dets["scores"]).all()
    batch = _person_batch(3) if pcfg.MODEL.KEYPOINT_ON else _batch(3)
    pb = _port_batch(batch)
    if pcfg.MODEL.KEYPOINT_ON:
        pb["gt_keypoints"] = torch.from_numpy(batch["gt_keypoints"])
    pb["generator"] = torch.Generator().manual_seed(0)
    pm.model.train()
    total, losses = pm.loss_fn(pb)
    total.backward()
    assert math.isfinite(total.item()) and ("loss_keypoint" in losses) == pcfg.MODEL.KEYPOINT_ON


@pytest.mark.parametrize("case", ["c4", "dc5"])
def test_default_trainer_trains_two_steps_then_evaluates(case, tmp_path):
    """The YAML cut in width and size as above, on the synthetic stand-ins:
    2 SGD steps at batch 2, finite losses, then the evaluation that ends
    ``train()``: bbox (and, for C4 with its masks, segm) AP dicts."""
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", YAMLS[case]))
    cfg.merge_from_list(NARROW + [
        "MODEL.DEVICE", "cpu", "MODEL.ROI_HEADS.NUM_CLASSES", 80, "MODEL.ROI_HEADS.SCORE_THRESH_TEST", 0.0,
        "SOLVER.BASE_LR", 0.002, "SOLVER.IMS_PER_BATCH", 2, "SOLVER.MAX_ITER", 2, "TEST.BATCH_SIZE", 2,
        "DATALOADER.NUM_WORKERS", 1, "DATASETS.TRAIN", (f"test_torch_{case}_train",),
        "DATASETS.TEST", (f"test_torch_{case}_val",), "OUTPUT_DIR", str(tmp_path), "TPU.DTYPE", "float32"])
    ensure_synthetic_datasets(list(cfg.DATASETS.TRAIN) + list(cfg.DATASETS.TEST))
    trainer = DefaultTrainer(cfg)
    trainer.resume_or_load(resume=False)
    results = trainer.train()
    losses = [v for v, _ in trainer.storage.history("total_loss").values()]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    assert set(results) == ({"bbox", "segm"} if case == "c4" else {"bbox"})
    assert all(math.isfinite(results[t][k]) for t in results for k in ("AP", "AP50", "AP75"))


@pytest.mark.parametrize("name, metric", [
    ("Misc/cascade_mask_rcnn_R_50_FPN_1x.yaml", "cascade_mask_rcnn_res50_fpn_800_infer_throughput"),
    ("COCO-InstanceSegmentation/mask_rcnn_R_50_C4_1x.yaml", "mask_rcnn_res50_c4_800_infer_throughput"),
    ("COCO-Detection/faster_rcnn_R_50_DC5_1x.yaml", "faster_rcnn_res50_dc5_512_infer_throughput"),
    ("COCO-Detection/rpn_R_50_C4_1x.yaml", "rpn_res50_c4_800_infer_throughput"),
])
def test_bench_names_the_new_rcnns(name, metric):
    """tools/bench names Cascade, C4 and DC5 apart from the R50-FPN
    configs, with no baseline (BASELINE.md has no time of theirs); the
    FPN Faster R-CNN keeps its name and its V100 time. (The DC5 YAML sets
    no ``INPUT.TEST_SIZE``: the default 512² stands.)"""
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", name))
    assert bench.metric_name(cfg) == metric and bench.baseline_img_s(cfg) is None
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "COCO-Detection", "faster_rcnn_R_50_FPN_1x.yaml"))
    assert bench.metric_name(cfg) == "faster_rcnn_res50_fpn_800_infer_throughput"
    assert bench.baseline_img_s(cfg) == pytest.approx(1 / 0.038)


@pytest.mark.parametrize("kind", ["cascade", "c4", "dc5"])
def test_chip_smoke_reads_the_new_rcnn_configs_as_the_jax_package_does(kind):
    """``chip_smoke.py``'s phases 13-15 read their YAML files with the port's
    reader, their extra pairs (DC5's 800² input), the run's dtype, output
    directory and seed over them and no weights file: key for key the JAX
    package's config of the same file and overrides, at full width."""
    import sys

    from test_torch_rcnn import _flat

    sys.path.insert(0, REPO)
    import chip_smoke

    _, folder, name, _, extra = chip_smoke.VARIANTS[kind]
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        got = chip_smoke.rcnn_cfg(name, "bfloat16", folder, extra)
    finally:
        os.chdir(cwd)
    want = jax_get_cfg()
    want.merge_from_file(os.path.join(REPO, "configs", folder, name + ".yaml"))
    want.merge_from_list(list(extra) + ["TPU.DTYPE", "bfloat16", "OUTPUT_DIR", "output/chip_smoke", "SEED", 0,
                                        "MODEL.WEIGHTS", ""])
    assert _flat(got) == _flat(want)
    assert got.MODEL.RESNETS.DEPTH == 50 and got.MODEL.ROI_HEADS.NUM_CLASSES == 80
    assert tuple(got.INPUT.TEST_SIZE) == tuple(got.INPUT.TRAIN_SIZE) == (800, 800)


@pytest.mark.parametrize("name", ["Misc/cascade_mask_rcnn_R_50_FPN_1x.yaml", YAMLS["c4"], YAMLS["c4_rpn"],
                                  YAMLS["dc5"]])
def test_new_rcnns_raise_without_a_card(name):
    """MODEL.DEVICE is cuda by default: no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", name))
    with pytest.raises(RuntimeError, match="MODEL.DEVICE=cpu"):
        build_model(cfg)
