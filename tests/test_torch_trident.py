"""The port's TridentNet (the trident trunk and ``TridentRCNN``, Fast and
full) against the JAX package on the CPU, in f32: the trunk's res4 in
training (3N, branch-folded), Fast (the middle branch on N) and full (a
tiled 3N batch) modes, the weight sharing, the loss with every gradient on
JAX's draws, both ``predict_fn`` modes, and the two YAMLs building the same
leaves in both packages.

Sizes: ``tests/modeling/test_trident.py``'s (ResNet-50 C4 with RES2 32, a
stem of 16 and WIDTH_PER_GROUP 8, 3 classes, 16 rois, proposals 60/30 at
training and 40/20 at test, 8 detections), 64² inputs, the trident YAML's
``configs/Misc/trident_fast_R_50_C4_1x.yaml`` otherwise (the gt appended
to the proposals, FrozenBN). One random variables tree made with numpy goes to both sides.

Tolerances: res4 within 1e-5 of its scale; losses within 1e-5 relative and
every gradient within 3e-4 of its own largest value (``GRAD_TOL``: JAX's
jit moves one gradient by 1.7e-4 of its largest from its own op-by-op
value); detections slot for
slot, boxes within 1e-4 of the image's scale and scores within 1e-5.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from detectron2_centernet_tpu.config import get_cfg as jax_get_cfg
from detectron2_centernet_tpu.models.build import build_model as jax_build_model
from detectron2_centernet_tpu_torch.checkpoint import canonical_key, state_dict_from_jax, torch_key
from detectron2_centernet_tpu_torch.checkpoint.from_jax import key_options
from detectron2_centernet_tpu_torch.config import get_cfg
from detectron2_centernet_tpu_torch.models import build_model
from detectron2_centernet_tpu_torch.models.backbones.trident import TridentBottleneckBlock, TridentResNet

from test_torch_rcnn import _jax_draws, _random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "configs", "Misc", "trident_fast_R_50_C4_1x.yaml")
SIZE = 64
NARROW = ["MODEL.WEIGHTS", "", "DATASETS.TRAIN", (), "MODEL.RESNETS.RES2_OUT_CHANNELS", 32,
          "MODEL.RESNETS.STEM_OUT_CHANNELS", 16, "MODEL.RESNETS.WIDTH_PER_GROUP", 8, "MODEL.ROI_HEADS.NUM_CLASSES", 3,
          "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 16, "MODEL.RPN.PRE_NMS_TOPK_TRAIN", 60,
          "MODEL.RPN.POST_NMS_TOPK_TRAIN", 30, "MODEL.RPN.PRE_NMS_TOPK_TEST", 40, "MODEL.RPN.POST_NMS_TOPK_TEST", 20,
          "TEST.DETECTIONS_PER_IMAGE", 8, "TPU.DTYPE", "float32", "INPUT.TRAIN_SIZE", (SIZE, SIZE),
          "INPUT.TEST_SIZE", (SIZE, SIZE)]


def _cfgs(extra=(), path=YAML):
    jcfg, pcfg = jax_get_cfg(), get_cfg()
    for cfg in (jcfg, pcfg):
        cfg.merge_from_file(path)
        cfg.merge_from_list(list(extra))
    pcfg.MODEL.DEVICE = "cpu"
    return jcfg, pcfg


@pytest.fixture(scope="module")
def pair():
    """(JAX Fast model, the variables, port Fast model, port full model): the
    two modes share every weight (the trunk is the same network)."""
    jcfg, pcfg = _cfgs(NARROW)
    jm = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), (SIZE, SIZE)))
    variables = _random_variables(shapes, 21)
    sd = state_dict_from_jax(variables)
    pm = build_model(pcfg)
    pm.model.load_state_dict(sd)
    _, full_cfg = _cfgs(NARROW + ["MODEL.TRIDENT.TEST_BRANCH_IDX", -1])
    full = build_model(full_cfg)
    full.model.load_state_dict(sd)
    return jm, variables, pm, full


def _images(n, seed):
    return np.random.RandomState(seed).uniform(0, 255, (n, SIZE, SIZE, 3)).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _close(got, want, rel, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-6), err_msg=what)


def test_trident_leaves_cross_once_and_the_kernel_is_shared(pair):
    """Every JAX leaf maps to one port key of its shape and back: res4's
    blocks hold one ``conv2_kernel`` each (``backbone.res4.{b}.conv2.weight``,
    no copy per branch) beside the trunk's and the C4 heads' leaves."""
    jm, variables, pm, _ = pair
    leaves = {"/".join(p) for p in flatten_dict(variables)}
    own = {k for k in pm.model.state_dict() if not k.endswith("num_batches_tracked")}
    opts = key_options(pm.model)
    assert opts["deform"] == {f"res4_block{b}" for b in range(6)}
    assert sorted(canonical_key(k, **opts) for k in own) == sorted(leaves)
    assert {torch_key(p) for p in leaves} == own
    assert torch_key("params/backbone/res4_block3/conv2_kernel") == "backbone.res4.3.conv2.weight"
    blocks = list(pm.model.backbone.res4)
    assert len(blocks) == 6 and all(isinstance(b, TridentBottleneckBlock) for b in blocks)
    assert [tuple(p.shape) for n, p in pm.model.backbone.named_parameters()
            if n.startswith("res4.0.conv2") and p.dim() == 4] == [(32, 32, 3, 3)]


@pytest.mark.parametrize("mode", ["train", "fast", "full"])
def test_trident_trunk_equals_jax(pair, mode):
    """res4 of two images: in training the 3 branches folded (6 maps, the
    middle fold equal to Fast mode's), Fast mode's middle branch on 2, full
    mode's 3 branches on a batch the caller tiled; within 1e-5 of scale."""
    jm, variables, pm, full = pair
    images = _images(2, 22)
    x = (images - np.asarray(jm.pixel_mean)) / np.asarray(jm.pixel_std)
    train = mode == "train"
    jx = np.tile(x, (3, 1, 1, 1)) if mode == "full" else x
    backbone = jm.backbone.clone(test_branch_idx=-1) if mode == "full" else jm.backbone
    want = backbone.apply({"params": variables["params"]["backbone"],
                           "batch_stats": variables["batch_stats"]["backbone"]}, jnp.asarray(jx), train)["res4"]
    want = np.asarray(want).transpose(0, 3, 1, 2)
    model = full.model if mode == "full" else pm.model
    model.train(train)
    try:
        with torch.no_grad():
            got = model.backbone(_nchw(jx))["res4"].numpy()
    finally:
        model.eval()
    assert got.shape[0] == (2 if mode == "fast" else 6)
    _close(got, want, 1e-5, mode)
    if mode == "train":
        with torch.no_grad():
            fast = pm.model.backbone(_nchw(x))["res4"].numpy()
        _close(got[2:4], fast, 1e-5, "the middle fold is Fast mode's branch")


@pytest.mark.parametrize("dilations", [(1, 2, 3), (1, 3)])
def test_trident_block_branches_share_one_kernel(dilations):
    """A block on a folded batch: fold i is the block's 3x3 at
    ``dilations[i]`` (padding = dilation) on that fold alone; the kernel is
    one parameter, its gradient the sum of the folds'."""
    torch.manual_seed(0)
    block = TridentBottleneckBlock(8, 16, 4, stride=2, dilations=dilations, norm="")
    x = torch.randn(len(dilations) * 2, 8, 9, 9)
    out = block(x, num_branch=len(dilations))
    for i, d in enumerate(dilations):
        fold = x[2 * i:2 * i + 2]
        single = block(fold, num_branch=1, branch_idx=i)
        torch.testing.assert_close(out[2 * i:2 * i + 2], single)
        ref = torch.nn.functional.conv2d(torch.relu(block.conv1(fold)), block.conv2.weight, None, 1, d, d)
        assert ref.shape[-1] == 5
    out.sum().backward()
    assert block.conv2.weight.grad is not None and len(list(block.parameters())) == 4


def _batch(seed, n=2, m=3):
    rng = np.random.RandomState(seed)
    boxes = rng.rand(n, m, 4).astype(np.float32) * 32
    boxes[..., 2:] = boxes[..., :2] + rng.uniform(12, 30, (n, m, 2)).astype(np.float32)
    valid = np.ones((n, m), bool)
    valid[-1, -1] = False
    return {"image": _images(n, seed + 1), "gt_boxes": boxes, "gt_classes": rng.randint(0, 3, (n, m)).astype(np.int32),
            "gt_valid": valid}


# JAX's jitted f32 gradient of res5's last conv on this batch differs from its own op-by-op one by 1.7e-4 of
# its largest value (XLA's fused reductions over the 6 x 16 rois); the port's lies within 3e-6 of JAX's f64
# gradient on every parameter. Every gradient is held within 3e-4 of its largest value.
GRAD_TOL = 3e-4


def test_trident_loss_and_every_gradient_equal_jax(pair):
    """Two images of 3 gts: the gts tiled per branch, the RPN and ROI losses
    of the 6 folded images (res5 on their 6 x 16 rois) on JAX's draws for 6
    images, within 1e-5 relative; every gradient within ``GRAD_TOL`` of its
    own largest value (the kernel's the sum over its three dilations)."""
    jm, variables, pm, _ = pair
    batch, key = _batch(23), jax.random.PRNGKey(6)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch["rng"] = key
    stats = variables["batch_stats"]
    (_, (jloss, _)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, stats, jbatch), has_aux=True))(variables["params"])
    anchors = sum(a.shape[0] for a in pm.anchors_per_level((SIZE, SIZE)))
    pb = {"image": _nchw(batch["image"]), "gt_boxes": torch.from_numpy(batch["gt_boxes"]),
          "gt_classes": torch.from_numpy(batch["gt_classes"]), "gt_valid": torch.from_numpy(batch["gt_valid"]),
          "draws": _jax_draws(key, 6, anchors, max(30 + 3, 16))}  # the YAML appends the gt to the proposals
    for p in pm.model.parameters():
        p.grad = torch.zeros_like(p)
    pm.model.train()
    try:
        total, losses = pm.loss_fn(pb)
        total.backward()
    finally:
        pm.model.eval()
    assert set(losses) == set(jloss) == {"loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg"}
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), float(jloss[k]), rtol=1e-5, err_msg=k)
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    grads = {k: p.grad for k, p in pm.model.named_parameters()}
    assert set(want) == set(grads)
    for k, g in grads.items():
        w = want[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=GRAD_TOL * max(np.abs(w).max(), 1e-6), err_msg=k)
    assert grads["backbone.res4.0.conv2.weight"].abs().sum() > 0


@pytest.mark.parametrize("mode", ["fast", "full"])
def test_trident_predict_fn_equals_jax(pair, mode):
    """Two images, every class a candidate (threshold 0): Fast mode's
    detections, and full mode's (3 branches on the tiled batch, each
    image's 24 merged to 8 by class-aware NMS), slot for slot."""
    jm, variables, pm, full = pair
    images = _images(2, 24)
    jcfg, _ = _cfgs(NARROW + ["MODEL.ROI_HEADS.SCORE_THRESH_TEST", 0.0, "MODEL.TRIDENT.TEST_BRANCH_IDX",
                              -1 if mode == "full" else 1])
    jmodel = jax_build_model(jcfg)
    model = full if mode == "full" else pm
    threshold, model.score_threshold = model.score_threshold, 0.0
    try:
        want = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.predict_fn)(variables, jnp.asarray(images)))
        got = {k: v.numpy() for k, v in model.predict_fn(_nchw(images)).items()}
    finally:
        model.score_threshold = threshold
    assert got["boxes"].shape == want["boxes"].shape == (2, 8, 4)
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=1e-4 * SIZE)
    assert (got["scores"] > 0).sum() > 8


@pytest.mark.parametrize("yaml", ["configs/Misc/trident_fast_R_50_C4_1x.yaml",
                                  "projects/TridentNet/configs/tridentnet_fast_R_50_C4_1x.yaml",
                                  "projects/TridentNet/configs/tridentnet_fast_R_101_C4_3x.yaml"])
def test_trident_yamls_build_the_same_leaves(yaml):
    """The YAML at full width (ResNet-50 or -101, 80 classes) builds a
    TridentRCNN in both packages whose leaves map one to one, shape for
    shape; the project's Base-TridentNet settings (128 rois, 500 training
    proposals, no gt appended) reach both, and every one runs Fast mode's
    middle branch."""
    jcfg, pcfg = _cfgs(["MODEL.WEIGHTS", ""], os.path.join(REPO, yaml))
    jm = jax_build_model(jcfg)
    shapes = flatten_dict(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), (SIZE, SIZE))))
    pm = build_model(pcfg)
    assert type(jm).__name__ == type(pm).__name__ == "TridentRCNN"
    assert isinstance(pm.model.backbone, TridentResNet) and len(pm.model.backbone.res4) == (23 if "101" in yaml else 6)
    opts = key_options(pm.model)
    own = {canonical_key(k, **opts): v.shape for k, v in pm.model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert set(own) == {"/".join(p) for p in shapes}
    for path, shape in shapes.items():
        key = torch_key("/".join(path))
        arr = pm.model.state_dict()[key]
        want = tuple(shape.shape)
        got = tuple(arr.shape)
        assert (got[::-1] if len(got) == 2 else (got[2], got[3], got[1], got[0]) if len(got) == 4 else got) == want, key
    for r in (pcfg.MODEL, jcfg.MODEL):
        assert (r.TRIDENT.TEST_BRANCH_IDX, r.TRIDENT.NUM_BRANCH) == (1, 3)
        if yaml.startswith("projects"):
            assert (r.ROI_HEADS.BATCH_SIZE_PER_IMAGE, r.RPN.POST_NMS_TOPK_TRAIN, r.ROI_HEADS.PROPOSAL_APPEND_GT) == \
                (128, 500, False)
