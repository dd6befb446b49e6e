"""The deformable ResNet trunks of the port on the CPU, held against the JAX
package: the plain DCN (``ops/deform_conv.py``) at stride 1 or 2, dilation 1
or 2, modulated or not, against the JAX exact op (``ops/deform_conv.py::
modulated_deform_conv``, window 0) forward and through ``jax.vjp``; d offset
against a right finite difference where the sample sits on the grid (ROADMAP
C1); ``DeformBottleneckBlock`` against JAX's with the weights crossed by
``state_dict_from_jax`` (both ``STRIDE_IN_1X1`` and both
``DEFORM_MODULATED``, eval and train, and the two points where JAX differs
from the reference, ROADMAP C21); a narrow deformable R50 trunk; and a narrow
dconv Mask R-CNN's losses, gradients, SGD steps with a resume and
detections."""

import copy
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from detectron2_centernet_tpu.config import get_cfg as jax_get_cfg
from detectron2_centernet_tpu.models.backbones import resnet as jax_resnet
from detectron2_centernet_tpu.models.build import build_model as jax_build_model
from detectron2_centernet_tpu.ops.deform_conv import modulated_deform_conv as jax_dcn
from detectron2_centernet_tpu.solver import build_optimizer as jax_build_optimizer
from detectron2_centernet_tpu_torch.checkpoint import Checkpointer, canonical_key, state_dict_from_jax, torch_key
from detectron2_centernet_tpu_torch.config import get_cfg
from detectron2_centernet_tpu_torch.models import build_model
from detectron2_centernet_tpu_torch.models.backbones import resnet
from detectron2_centernet_tpu_torch.ops import dcn
from detectron2_centernet_tpu_torch.ops import deform_conv as plain
from detectron2_centernet_tpu_torch.solver import build_optimizer

GEOMETRY = [(s, d, m) for s in (1, 2) for d in (1, 2) for m in (True, False)]


def _case(seed, n=2, h=13, w=17, cin=8, cout=12, stride=1, reach=3.5, integer=False):
    """NHWC inputs as JAX takes them (offset, mask and g on the output grid),
    offsets uniform within ±``reach`` px (or exactly 0)."""
    rng = np.random.RandomState(seed)
    ho, wo = plain.out_size(h, w, stride)
    x = rng.randn(n, h, w, cin).astype(np.float32)
    off = rng.uniform(-reach, reach, (n, ho, wo, 18)).astype(np.float32)
    if integer:
        off[:] = 0.0
    mask = rng.rand(n, ho, wo, 9).astype(np.float32)
    weight = (rng.randn(3, 3, cin, cout) * 0.2).astype(np.float32)
    g = rng.randn(n, ho, wo, cout).astype(np.float32)
    return x, off, mask, weight, g


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _assert_close(got, want, tol, name):
    scale = max(np.abs(want).max(), 1e-6)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{name}: max error {err:.3e} > {tol} x {scale:.3e}"


def _jax_call(stride, dilation, modulated):
    ones = lambda off: jnp.ones(off.shape[:3] + (9,), jnp.float32)
    if modulated:
        return lambda x, off, mask, w: jax_dcn(x, off, mask, w, stride=stride, dilation=dilation)
    return lambda x, off, w: jax_dcn(x, off, ones(off), w, stride=stride, dilation=dilation)


@pytest.mark.parametrize("stride, dilation, modulated", GEOMETRY)
@pytest.mark.parametrize("shape", [(13, 17), (16, 16)])
def test_plain_forward_matches_jax(stride, dilation, modulated, shape):
    """f32 forward within 1e-5 of the output's scale, odd and non-square
    maps (13 x 17 → 7 x 9 at stride 2), offsets of ±3.5 px; the
    unmodulated form (``mask=None``) against JAX's mask of ones."""
    h, w = shape
    x, off, mask, weight, _ = _case(h + 3 * stride + dilation, h=h, w=w, stride=stride)
    args = (x, off, mask, weight) if modulated else (x, off, weight)
    want = np.asarray(_jax_call(stride, dilation, modulated)(*map(jnp.asarray, args)))
    got = dcn.modulated_deform_conv(_t(x), _t(off), _t(mask) if modulated else None, _oihw(weight),
                                    stride=stride, dilation=dilation)
    assert got.shape[2:] == plain.out_size(h, w, stride) == want.shape[1:3]
    _assert_close(_nhwc(got), want, 1e-5, "forward")


@pytest.mark.parametrize("stride, dilation, modulated", GEOMETRY)
def test_plain_backward_matches_jax_grad(stride, dilation, modulated):
    """dX and dW within 1e-4 of scale against ``jax.vjp`` of the exact op;
    d offset (off-integer: uniform offsets) and d mask too; through the
    autograd Function, which gives no mask gradient without a mask."""
    x, off, mask, weight, g = _case(40 + 4 * stride + 2 * dilation + modulated, stride=stride)
    args = (x, off, mask, weight) if modulated else (x, off, weight)
    _, vjp = jax.vjp(_jax_call(stride, dilation, modulated), *map(jnp.asarray, args))
    want = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    ts = [_t(x).requires_grad_(), _t(off).requires_grad_(), _t(mask).requires_grad_() if modulated else None,
          _oihw(weight).requires_grad_()]
    out = dcn.modulated_deform_conv_ad(*ts, stride=stride, dilation=dilation)
    out.backward(_t(g))
    got = [_nhwc(ts[0].grad), _nhwc(ts[1].grad)] + ([_nhwc(ts[2].grad)] if modulated else []) \
        + [ts[3].grad.permute(2, 3, 1, 0).numpy()]
    names = ["dx", "doffset"] + (["dmask"] if modulated else []) + ["dw"]
    for name, a, b in zip(names, got, want):
        _assert_close(a, b, 1e-4, name)


@pytest.mark.parametrize("stride, dilation, modulated", [(2, 1, False), (2, 2, True), (1, 2, False)])
def test_plain_backward_is_the_gradient_of_the_plain_forward(stride, dilation, modulated):
    """The explicit backward kernels' plain versions (K2-K5) equal torch
    autograd of the plain forward (1e-5 of scale), and K5 is K3 + K4 bit
    for bit; without a mask, d mask is None."""
    x, off, mask, weight, g = (_case(7, stride=stride)[i] for i in range(5))
    x, off, weight, g = _t(x), _t(off), _oihw(weight), _t(g)
    mask = _t(mask) if modulated else None
    doff, dmask = plain.dcn_bwd_dq(x, off, mask, weight, g, stride, dilation)
    doff5, dmask5, dw5 = plain.dcn_bwd_dqdw(x, off, mask, weight, g, stride, dilation)
    dw = plain.dcn_bwd_dw(x, off, mask, g, stride, dilation)
    dx = plain.dcn_bwd_dx(x, off, mask, weight, g, stride, dilation)
    assert torch.equal(doff, doff5) and torch.equal(dw, dw5)
    assert (dmask is None) == (dmask5 is None) == (not modulated)
    leaves = [t.clone().requires_grad_() for t in (x, off, weight)] + \
        ([mask.clone().requires_grad_()] if modulated else [])
    out = plain.modulated_deform_conv(leaves[0], leaves[1], leaves[3] if modulated else None, leaves[2],
                                      stride=stride, dilation=dilation)
    want = torch.autograd.grad(out, leaves, g)
    for name, a, b in zip(("dx", "doffset", "dw", "dmask"), (dx, doff, dw, dmask), want):
        _assert_close(a.numpy(), b.numpy(), 1e-5, name)


@pytest.mark.parametrize("stride, dilation", [(2, 1), (1, 2), (2, 2)])
def test_doffset_is_the_right_derivative_at_integer_positions(stride, dilation):
    """Zero offsets: every sample on the grid, where the JAX tents and the
    floor corners differ (ROADMAP C1). d offset, unmodulated, equals the
    right finite difference (the loss is linear in the offset on [0, 0.25):
    1e-3 of the scale) at 12 entries."""
    x, off, _, weight, g = _case(9, n=1, h=9, w=11, cin=4, cout=4, stride=stride, integer=True)
    x, off, weight, g = _t(x), _t(off), _oihw(weight), _t(g)
    doff, dmask = plain.dcn_bwd_dq(x, off, None, weight, g, stride, dilation)
    assert dmask is None
    loss = lambda o: (plain.modulated_deform_conv(x, o, None, weight, stride=stride, dilation=dilation)
                      * g).double().sum().item()
    base = loss(off)
    rng = np.random.RandomState(5)
    scale = doff.abs().max().item()
    for _ in range(12):
        i = tuple(int(rng.randint(s)) for s in off.shape)
        bumped = off.clone()
        bumped[i] += 0.25
        fd = (loss(bumped) - base) / 0.25
        assert abs(doff[i].item() - fd) <= 1e-3 * scale, (i, doff[i].item(), fd)


@pytest.mark.parametrize("stride, dilation", [(3, 1), (1, 0)])
def test_wrapper_checks_geometry_and_output_grid(stride, dilation):
    """The wrappers hold offset and mask to the output grid of the stride,
    and a CPU call takes any positive stride and dilation (the plain op),
    but not 0."""
    x = torch.randn(1, 4, 10, 10)
    weight = torch.randn(4, 4, 3, 3)
    if dilation == 0:
        with pytest.raises(ValueError):
            dcn.modulated_deform_conv(x, torch.zeros(1, 18, 10, 10), None, weight, stride=stride,
                                      dilation=dilation)
        return
    with pytest.raises(ValueError, match=r"offset must be \(1, 18, 4, 4\)"):
        dcn.modulated_deform_conv(x, torch.zeros(1, 18, 10, 10), None, weight, stride=stride)
    out = dcn.modulated_deform_conv(x, torch.zeros(1, 18, 4, 4), None, weight, stride=stride)
    assert out.shape == (1, 4, 4, 4)


# -- DeformBottleneckBlock and the deformable trunk ------------------------------------------


def _random_variables(shapes, seed, scale=None):
    """Every leaf random: kernels N(0, 1/fan_in) (``scale`` by module name:
    the offset convs' at a fraction, so the offsets reach a pixel or two),
    norm scales and variances in [0.5, 1.5], biases and means N(0, 0.1²)."""
    scale = {"conv2_offset": 0.5, **(scale or {})}
    rng = np.random.RandomState(seed)
    out = {}
    for path, v in flatten_dict(shapes).items():
        leaf = path[-1]
        if leaf in ("kernel", "conv2_kernel"):
            fan_in = np.prod(v.shape[:-1])
            a = rng.randn(*v.shape) / np.sqrt(fan_in) * scale.get(path[-2] if leaf == "kernel" else "", 1.0)
        elif leaf in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, v.shape)
        else:
            a = rng.randn(*v.shape) * 0.1
        out[path] = a.astype(np.float32)
    return unflatten_dict(out)


def _block_state(variables, prefix="res3_block0"):
    """A lone block's JAX variables as the port block's state dict, through
    the trunk's key map (``backbone/trunk/res3_block0``)."""
    tree = {c: {"backbone": {"trunk": {prefix: v}}} for c, v in variables.items()}
    state = state_dict_from_jax(tree)
    return {k.removeprefix("backbone.res3.0."): v for k, v in state.items()}


def _jax_block(stride_in_1x1, modulated, dilation, stride):
    return jax_resnet.DeformBottleneckBlock(64, 16, stride=stride, stride_in_1x1=stride_in_1x1, dilation=dilation,
                                            deform_modulated=modulated)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("modulated", [True, False])
@pytest.mark.parametrize("stride_in_1x1", [True, False])
def test_deform_bottleneck_block_matches_jax(stride_in_1x1, modulated, train):
    """A stride-2 block (32 → 64 channels, bottleneck 16) on a 2 × 32 × 15
    × 17 map, FrozenBN, weights crossed by ``state_dict_from_jax``: the
    output within 1e-5 of its scale (eval: the DCN's forward kernel; train:
    the differentiable one); in train, the gradients of every parameter and
    of the input against ``jax.grad`` within 1e-4 of their scale. With
    ``STRIDE_IN_1X1`` False the DCN takes the stride (15 x 17 → 8 x 9)."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 15, 17, 32).astype(np.float32)
    jb = _jax_block(stride_in_1x1, modulated, 1, 2)
    variables = _random_variables(jax.eval_shape(lambda: jb.init(jax.random.PRNGKey(0), jnp.asarray(x))), 4)
    pb = resnet.DeformBottleneckBlock(32, 64, 16, 2, stride_in_1x1, 1, "FrozenBN", modulated)
    pb.load_state_dict(_block_state(variables))
    assert pb.conv2.stride == (1 if stride_in_1x1 else 2)
    assert pb.conv2_offset.out_channels == (27 if modulated else 18)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    if not train:
        want = np.asarray(jb.apply(variables, jnp.asarray(x)))
        with torch.no_grad():
            got = pb.eval()(xt)
        _assert_close(_nhwc(got), want, 1e-5, "output")
        return
    cot = rng.randn(2, 8, 9, 64).astype(np.float32)
    loss = lambda p, xi: (jb.apply({**variables, "params": p}, xi, True) * cot).sum()
    (jgp, jgx) = jax.grad(loss, argnums=(0, 1))(variables["params"], jnp.asarray(x))
    xt.requires_grad_(True)
    out = pb.train()(xt)
    (out * torch.from_numpy(cot.transpose(0, 3, 1, 2).copy())).sum().backward()
    _assert_close(_nhwc(out), np.asarray(jb.apply(variables, jnp.asarray(x), True)), 1e-5, "output")
    _assert_close(_nhwc(xt.grad), np.asarray(jgx), 1e-4, "d input")
    want = _block_state({"params": jax.tree_util.tree_map(np.asarray, jgp)})
    grads = {k: p.grad for k, p in pb.named_parameters()}
    assert set(grads) == set(want)
    for k, g in grads.items():
        _assert_close(g.numpy(), want[k].numpy(), 1e-4, k)


def test_deform_block_offset_conv_takes_no_dilation_as_in_jax():
    """ROADMAP C21 (1): at dilation 2 the JAX block's offset conv keeps
    padding 1 and no dilation (the reference's has ``padding=dilation,
    dilation=dilation``); the port follows JAX: its ``conv2_offset`` is
    dilation 1, padding 1, and the block's output equals JAX's within 1e-5
    of its scale, its DCN at dilation 2."""
    rng = np.random.RandomState(5)
    x = rng.randn(1, 13, 11, 64).astype(np.float32)
    jb = _jax_block(False, False, 2, 1)
    variables = _random_variables(jax.eval_shape(lambda: jb.init(jax.random.PRNGKey(0), jnp.asarray(x))), 6)
    pb = resnet.DeformBottleneckBlock(64, 64, 16, 1, False, 2, "FrozenBN", False)
    pb.load_state_dict(_block_state(variables))
    assert pb.conv2_offset.dilation == (1, 1) and pb.conv2_offset.padding == (1, 1)
    assert pb.conv2.dilation == 2 and pb.shortcut is None
    with torch.no_grad():
        got = pb.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    _assert_close(_nhwc(got), np.asarray(jb.apply(variables, jnp.asarray(x))), 1e-5, "output")


TRUNK = ["MODEL.RESNETS.DEPTH", 50, "MODEL.RESNETS.RES2_OUT_CHANNELS", 32, "MODEL.RESNETS.WIDTH_PER_GROUP", 8,
         "MODEL.RESNETS.STEM_OUT_CHANNELS", 16, "MODEL.RESNETS.OUT_FEATURES", ["res2", "res3", "res4", "res5"],
         "MODEL.RESNETS.DEFORM_ON_PER_STAGE", [False, True, True, True]]


def _trunks(extra, seed):
    jcfg, pcfg = jax_get_cfg(), get_cfg()
    jcfg.merge_from_list(TRUNK + list(extra))
    pcfg.merge_from_list(TRUNK + list(extra))
    jt = jax_resnet.build_resnet(jcfg)
    x = np.random.RandomState(seed).uniform(-2, 2, (2, 64, 48, 3)).astype(np.float32)
    variables = _random_variables(jax.eval_shape(lambda: jt.init(jax.random.PRNGKey(0), jnp.asarray(x))), seed)
    pt = resnet.build_resnet(pcfg)
    state = state_dict_from_jax({c: {"backbone": {"trunk": v}} for c, v in variables.items()})
    pt.load_state_dict({k.removeprefix("backbone."): v for k, v in state.items()})
    return jt, variables, pt, x


@pytest.mark.parametrize("extra", [
    ["MODEL.RESNETS.DEFORM_MODULATED", False],
    ["MODEL.RESNETS.DEFORM_MODULATED", True, "MODEL.RESNETS.STRIDE_IN_1X1", False],
    ["MODEL.RESNETS.NUM_GROUPS", 4, "MODEL.RESNETS.WIDTH_PER_GROUP", 4],
], ids=["dconv_c3-c5", "modulated_stride_in_3x3", "groups4"])
def test_deformable_trunk_matches_jax(extra):
    """A narrow deformable R50 (RES2 32, a stem of 16, [F, T, T, T]) on two
    64 x 48 images: res2 ... res5 within 1e-5 of their scale (f32). With
    ``NUM_GROUPS`` 4 (ROADMAP C21 (2)): res2's 3x3 is grouped, the
    deformable ones are dense (16 → 16, 3 x 3: JAX's kernel takes no
    groups and reads no ``DEFORM_NUM_GROUPS``; the reference groups both),
    and the outputs agree all the same. Every key maps both ways."""
    jt, variables, pt, x = _trunks(extra, 7)
    want = jax.jit(jt.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = pt.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), ("res2", "res3", "res4", "res5"))
    for name in ("res2", "res3", "res4", "res5"):
        _assert_close(_nhwc(got[name]), np.asarray(want[name]), 1e-5, name)
    groups = 4 if "MODEL.RESNETS.NUM_GROUPS" in extra else 1
    assert pt.res2[0].conv2.groups == groups
    b = pt.res3[0].conv2.weight.shape[0]
    assert pt.res3[0].conv2.weight.shape == (b, b, 3, 3)
    deform = {p.split("/")[-2] for p in flatten_dict(variables, sep="/") if p.endswith("conv2_kernel")}
    assert len(deform) == 4 + 6 + 3
    leaves = {"/".join(k) for k in flatten_dict(variables)}
    own = {"backbone." + k for k in pt.state_dict() if not k.endswith("num_batches_tracked")}
    paths = {p.split("/", 1)[0] + "/backbone/trunk/" + p.split("/", 1)[1] for p in leaves}
    assert {canonical_key(k, deform=deform) for k in own} == paths
    assert {torch_key(p) for p in paths} == own


# -- a narrow dconv Mask R-CNN ----------------------------------------------------------------

SIZE = 64
DCONV_RCNN = [
    "MODEL.META_ARCHITECTURE", "GeneralizedRCNN", "MODEL.BACKBONE.NAME", "build_resnet_fpn_backbone",
    "MODEL.RESNETS.DEPTH", 50, "MODEL.RESNETS.RES2_OUT_CHANNELS", 32, "MODEL.RESNETS.WIDTH_PER_GROUP", 8,
    "MODEL.RESNETS.STEM_OUT_CHANNELS", 16, "MODEL.RESNETS.OUT_FEATURES", ["res2", "res3", "res4", "res5"],
    "MODEL.RESNETS.DEFORM_ON_PER_STAGE", [False, True, True, True], "MODEL.RESNETS.DEFORM_MODULATED", False,
    "MODEL.FPN.IN_FEATURES", ["res2", "res3", "res4", "res5"], "MODEL.FPN.OUT_CHANNELS", 32,
    "MODEL.RPN.IN_FEATURES", ["p2", "p3", "p4", "p5", "p6"], "MODEL.RPN.PRE_NMS_TOPK_TRAIN", 200,
    "MODEL.RPN.POST_NMS_TOPK_TRAIN", 100, "MODEL.RPN.PRE_NMS_TOPK_TEST", 100, "MODEL.RPN.POST_NMS_TOPK_TEST", 50,
    "MODEL.ANCHOR_GENERATOR.SIZES", [[32], [64], [128], [256], [512]],
    "MODEL.ROI_HEADS.NAME", "StandardROIHeads", "MODEL.ROI_HEADS.NUM_CLASSES", 5,
    "MODEL.ROI_HEADS.IN_FEATURES", ["p2", "p3", "p4", "p5"], "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 64,
    "MODEL.ROI_BOX_HEAD.NUM_FC", 2, "MODEL.ROI_BOX_HEAD.FC_DIM", 64,
    "MODEL.MASK_ON", True, "MODEL.ROI_MASK_HEAD.CONV_DIM", 32, "INPUT.MASK_RASTER", 16,
    "INPUT.TRAIN_SIZE", (SIZE, SIZE), "INPUT.TEST_SIZE", (SIZE, SIZE), "TPU.DTYPE", "float32",
    "TEST.EXACT_MODE", True, "INPUT.COLOR_JITTER", False, "DATASETS.TRAIN", (),
    "SOLVER.BASE_LR", 0.01, "SOLVER.WARMUP_ITERS", 2, "SOLVER.WEIGHT_DECAY", 0.001,
]
# the predictors' kernels at a fraction of N(0, 1/fan_in), as in tests/test_torch_rcnn.py; the offset
# convs' too: R-CNN's features are ~50 (PIXEL_STD is 1), and at full scale the offsets would be ~30 px on
# maps of 8-16 px, every sample off the map; at 0.02 they reach a pixel or two, as a trained DCN's do
PREDICTOR_SCALE = {"cls_score": 0.02, "bbox_pred": 0.005, "objectness_logits": 0.05, "anchor_deltas": 0.1,
                   "conv2_offset": 0.02}


@pytest.fixture(scope="module")
def rcnn_pair():
    """(JAX cfg, JAX model, its random variables, port cfg, port model)."""
    jcfg, pcfg = jax_get_cfg(), get_cfg()
    jcfg.merge_from_list(DCONV_RCNN)
    pcfg.merge_from_list(DCONV_RCNN + ["MODEL.DEVICE", "cpu"])
    jm = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), (SIZE, SIZE)))
    variables = _random_variables(shapes, 8, PREDICTOR_SCALE)
    pm = build_model(pcfg)
    pm.model.load_state_dict(state_dict_from_jax(variables))
    return jcfg, jm, variables, pcfg, pm


@pytest.fixture(scope="module")
def jax_loss_grad(rcnn_pair):
    """JAX's loss, its terms and its gradient as one jitted function of
    (params, batch), compiled once for the tests below (every batch has the
    same shapes)."""
    _, jm, variables, _, _ = rcnn_pair
    stats = variables["batch_stats"]
    return jax.jit(jax.value_and_grad(lambda p, b: jm.loss_fn(p, stats, b), has_aux=True))


def _rcnn_batch(seed, n=2, m=6):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 40, (n, m, 2))
    gt = np.concatenate([xy, xy + rng.uniform(8, 24, (n, m, 2))], -1).astype(np.float32)
    valid = np.ones((n, m), bool)
    valid[1, 4:] = False
    return {"image": rng.uniform(0, 255, (n, SIZE, SIZE, 3)).astype(np.float32), "gt_boxes": gt,
            "gt_classes": rng.randint(0, 5, (n, m)).astype(np.int32), "gt_valid": valid,
            "gt_masks": (rng.rand(n, m, 16, 16) > 0.4).astype(np.uint8)}


def _draws(key, n, anchors, slots):
    """The uniforms JAX's loss draws from ``batch["rng"]``: the RPN
    sampler's (N, anchors), the ROI sampler's two (N, slots)."""
    k_rpn, k_roi, _ = jax.random.split(key, 3)
    rpn = np.stack([np.asarray(jax.random.uniform(k, (anchors,))) for k in jax.random.split(k_rpn, n)])
    roi = [jax.random.split(k) for k in jax.random.split(k_roi, n)]
    sub = np.stack([np.asarray(jax.random.uniform(k[0], (slots,))) for k in roi])
    tie = np.stack([np.asarray(jax.random.uniform(k[1], (slots,))) for k in roi])
    return {"rpn": torch.from_numpy(rpn), "roi_sub": torch.from_numpy(sub), "roi_tie": torch.from_numpy(tie)}


def _port_batch(pm, batch, key):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["image"] = torch.from_numpy(batch["image"].transpose(0, 3, 1, 2).copy())
    anchors = sum(a.shape[0] for a in pm.anchors_per_level((SIZE, SIZE)))
    out["draws"] = _draws(key, len(batch["image"]), anchors, max(100 + 6, 64))
    return out


def _jax_batch(batch, key):
    out = {k: jnp.asarray(v) for k, v in batch.items()}
    out["rng"] = key
    return out


def test_dconv_mask_rcnn_loss_and_every_gradient_match_jax(rcnn_pair, jax_loss_grad):
    """The five losses on JAX's draws within 1e-5 relative, every
    parameter's gradient within 1e-4 of its own max |value|, the
    deformable 3x3s' and their offset convs' among them (not 0: FREEZE_AT 2
    leaves res3-res5 trainable)."""
    _, _, variables, _, pm = rcnn_pair
    batch, key = _rcnn_batch(1), jax.random.PRNGKey(5)
    (_, (jloss, _)), jgrads = jax_loss_grad(variables["params"], _jax_batch(batch, key))
    for p in pm.model.parameters():
        p.grad = torch.zeros_like(p)
    pm.model.train()
    total, losses = pm.loss_fn(_port_batch(pm, batch, key))
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
        assert np.abs(g.numpy() - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-12), k
    for k in ("backbone.bottom_up.res3.0.conv2.weight", "backbone.bottom_up.res5.2.conv2_offset.weight"):
        assert grads[k].abs().max() > 0, k


def test_dconv_mask_rcnn_three_sgd_steps_with_a_resume_match_jax(rcnn_pair, jax_loss_grad):
    """Three SGD steps (momentum, weight decay, warmup) of both packages on
    three batches and JAX's draws (JAX's step is the jitted loss gradient
    the loss test compiled, and one jitted optimizer step). The port runs
    them straight through, saving a checkpoint after the second step, from
    which a new model and optimizer resume for the third; the two end bit
    for bit equal. Every parameter is JAX's within 1e-6 of its scale plus 1e-2 of
    BASE_LR times its largest gradient (``tests/test_torch_train.py``'s
    bound on one step: the later steps' gradients come from parameters that
    the first step's rounding already moved apart, and the RPN's top-k and
    NMS may then keep another proposal near a threshold; measured up to
    3e-3, in the mask head)."""
    jcfg, _, variables, pcfg, _ = rcnn_pair
    params = variables["params"]
    tx = jax_build_optimizer(jcfg, params)
    opt_state = jax.jit(tx.init)(params)

    @jax.jit
    def sgd(g, opt_state, params):
        updates, opt_state = tx.update(g, opt_state, params)
        return jax.tree_util.tree_map(lambda p, u: p + u, params, updates), opt_state

    batches = [(_rcnn_batch(10 + i), jax.random.PRNGKey(20 + i)) for i in range(3)]
    gmax = {}
    for b, key in batches:
        _, g = jax_loss_grad(params, _jax_batch(b, key))
        for k, v in state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, g)}).items():
            gmax[k] = max(gmax.get(k, 0.0), float(v.abs().max()))
        params, opt_state = sgd(g, opt_state, params)
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, params)})
    start = state_dict_from_jax(variables)
    fresh = build_model(pcfg)
    fresh.model.load_state_dict(start)

    def trainer():
        pm = copy.deepcopy(fresh)  # a new model at the start weights
        opt, sched = build_optimizer(pcfg, pm.model)
        for p in pm.model.parameters():  # as SimpleTrainer: every gradient exists and starts at 0
            p.grad = torch.zeros_like(p)
        return pm, opt, sched

    def step(pm, opt, sched, b, key):
        pm.model.train()
        total, _ = pm.loss_fn(_port_batch(pm, b, key))
        opt.zero_grad(set_to_none=False)
        total.backward()
        opt.step()
        sched.step()

    straight = trainer()
    with tempfile.TemporaryDirectory() as tmp:
        for b, key in batches[:2]:
            step(*straight, b, key)
        Checkpointer(straight[0].model, tmp, optimizer=straight[1], scheduler=straight[2]).save("model_0000001", 1)
        step(*straight, *batches[2])
        pm, opt, sched = trainer()
        assert Checkpointer(pm.model, tmp, optimizer=opt, scheduler=sched).resume_or_load("", resume=True) == 2
        step(pm, opt, sched, *batches[2])
    lr = float(pcfg.SOLVER.BASE_LR)
    moved = 0
    other = dict(straight[0].model.named_parameters())
    for k, p in pm.model.named_parameters():
        assert torch.equal(p, other[k]), k
        w = want[k].numpy()
        tol = 1e-6 * max(np.abs(w).max(), 1.0) + 1e-2 * lr * gmax[k]
        assert np.abs(p.detach().numpy() - w).max() <= tol, k
        moved += int(not np.array_equal(w, start[k].numpy()))
    assert moved > 100


def test_dconv_mask_rcnn_detections_match_jax(rcnn_pair):
    """Two 64² images: the 100 slots of ``predict_fn`` (the deformable
    trunk through the DCN's forward) equal JAX's: the same classes, boxes
    within 1e-2 px and masks within 2e-3 (the tolerances of
    tests/test_torch_rcnn.py and tests/test_torch_mask.py), scores within
    1e-3: the FPN maps agree to 4e-6 of their scale, and the RPN's deltas,
    decoded by exp on anchors of up to 512 px, move a proposal by up to
    9e-3 px (1e-3 px without the deformable stages), which moves a score by
    up to 3e-4. The masks, the sigmoid of logits up to ~80 in magnitude
    (R-CNN's features are ~50), pooled on boxes that far apart, agree
    within 5e-2 (measured 4e-2 in 52 of 156800 values; 2e-3 in the rest);
    pooled on the same boxes, JAX's, the mask logits agree within 1e-5 of
    their scale."""
    _, jm, variables, _, pm = rcnn_pair
    x = np.random.RandomState(8).uniform(0, 255, (2, SIZE, SIZE, 3)).astype(np.float32)
    want = jax.jit(jm.predict_fn)(variables, jnp.asarray(x))
    pm.model.eval()
    got = pm.predict_fn(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    live = np.asarray(want["scores"]) > 0.05
    assert live.sum(1).min() >= 5
    np.testing.assert_array_equal(got["scores"].numpy() > 0.05, live)
    np.testing.assert_array_equal(got["classes"].numpy(), np.asarray(want["classes"]))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), rtol=0, atol=1e-2)
    np.testing.assert_allclose(got["masks"].numpy(), np.asarray(want["masks"]), rtol=0, atol=5e-2)
    assert (np.abs(got["masks"].numpy() - np.asarray(want["masks"])) > 2e-3).mean() < 1e-3

    boxes = np.array(want["boxes"]).reshape(-1, 4)
    net = type(jm.module)

    @jax.jit
    def mask_logits(variables, x, boxes):
        feats = jm.module.apply(variables, jm.normalize(x), False, method=net.backbone_rpn)[0]
        pooled = jm._pool(feats, boxes, jnp.repeat(jnp.arange(2, dtype=jnp.int32), 100), jm.mask_pooler_resolution)
        return jm.module.apply(variables, pooled, False, method=net.mask_predict)

    want_logits = np.asarray(mask_logits(variables, jnp.asarray(x), jnp.asarray(boxes))).transpose(0, 3, 1, 2)
    with torch.no_grad():
        feats = pm.model(pm.normalize(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())))[0]
        got_logits = pm.model.mask_predict(pm.pool(feats, torch.from_numpy(boxes), 100, pm.mask_pooler_resolution))
    _assert_close(got_logits.numpy(), want_logits, 1e-5, "mask logits")


def _flat(node, prefix=""):
    out = {}
    for key, val in node.items():
        if isinstance(val, dict):
            out.update(_flat(val, prefix + key + "."))
        else:
            out[prefix + key] = val
    return out


@pytest.mark.parametrize("kind", ["dconv", "dconv_s3"])
def test_chip_smoke_reads_the_dconv_config_as_the_jax_package_does(kind):
    """``chip_smoke.py``'s phases 16 and 16s read
    ``Misc/mask_rcnn_R_50_FPN_1x_dconv_c3-c5.yaml`` with the port's reader,
    their extra pairs (16s: ``STRIDE_IN_1X1`` False), the run's dtype,
    output directory and seed over it and no weights file: key for key the
    JAX package's config of the same file and overrides, at full width,
    DCNv1 in res3-res5."""
    import os
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    import chip_smoke

    _, folder, name, _, extra = chip_smoke.VARIANTS[kind]
    cwd = os.getcwd()
    os.chdir(repo)
    try:
        got = chip_smoke.rcnn_cfg(name, "bfloat16", folder, extra)
    finally:
        os.chdir(cwd)
    want = jax_get_cfg()
    want.merge_from_file(os.path.join(repo, "configs", folder, name + ".yaml"))
    want.merge_from_list(list(extra) + ["TPU.DTYPE", "bfloat16", "OUTPUT_DIR", "output/chip_smoke", "SEED", 0,
                                        "MODEL.WEIGHTS", ""])
    assert _flat(got) == _flat(want)
    r = got.MODEL.RESNETS
    assert r.DEPTH == 50 and list(r.DEFORM_ON_PER_STAGE) == [False, True, True, True] and not r.DEFORM_MODULATED
    assert r.STRIDE_IN_1X1 == (kind == "dconv") and tuple(got.INPUT.TEST_SIZE) == (800, 800)
