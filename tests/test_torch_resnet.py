"""The port's ResNet trunks, FrozenBatchNorm and ``get_norm``, the deconv
neck, the heads with and without a tower, and the whole ResNet-18-deconv
CenterNet, against the JAX package on the CPU in f32, at narrow widths and
64² inputs.

One random variables tree, made with numpy from a seed, goes to both: as it is
to the JAX model, through ``state_dict_from_jax`` to the port (which flips
the neck's transposed-conv kernels). JAX runs with ``TPU.DTYPE=float32`` and
``TEST.EXACT_MODE``; the port with ``MODEL.DEVICE=cpu``.
"""

import copy
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec
import optax
from flax import linen as fnn
from flax.traverse_util import flatten_dict, unflatten_dict

from detectron2_centernet_tpu.config import get_cfg as jax_get_cfg
from detectron2_centernet_tpu.engine import DefaultPredictor as JaxPredictor
from detectron2_centernet_tpu.engine.train_state import TrainState, make_train_step
from detectron2_centernet_tpu.models.build import build_model as jax_build_model
from detectron2_centernet_tpu.models.layers import FrozenBatchNorm as JaxFrozenBN
from detectron2_centernet_tpu.parallel import get_mesh
from detectron2_centernet_tpu.solver import build_optimizer as jax_build_optimizer
from detectron2_centernet_tpu.solver.build import param_group_labels as jax_labels
from detectron2_centernet_tpu_torch.checkpoint import canonical_key, state_dict_from_jax, torch_key
from detectron2_centernet_tpu_torch.config import get_cfg
from detectron2_centernet_tpu_torch.data import warp_image
from detectron2_centernet_tpu_torch.engine import DefaultPredictor
from detectron2_centernet_tpu_torch.models import build_model
from detectron2_centernet_tpu_torch.models.layers import BatchNorm2d, FrozenBatchNorm, get_norm
from detectron2_centernet_tpu_torch.models.meta_arch.centernet import DeconvNeck, F32Conv2d, head_out
from detectron2_centernet_tpu_torch.solver import build_optimizer, param_group_labels

SIZE = 64
R18 = ["MODEL.BACKBONE.NAME", "build_resnet_deconv_backbone", "MODEL.RESNETS.DEPTH", 18,
       "MODEL.RESNETS.RES2_OUT_CHANNELS", 16, "MODEL.RESNETS.STEM_OUT_CHANNELS", 8]
R50 = ["MODEL.BACKBONE.NAME", "build_resnet_backbone", "MODEL.RESNETS.DEPTH", 50,
       "MODEL.RESNETS.RES2_OUT_CHANNELS", 32, "MODEL.RESNETS.STEM_OUT_CHANNELS", 8,
       "MODEL.RESNETS.WIDTH_PER_GROUP", 8]
TRUNKS = {  # name: config overrides (NORM FrozenBN and FREEZE_AT 2 unless set)
    "r18_frozen_bn": R18,
    "r18_bn_freeze0": R18 + ["MODEL.RESNETS.NORM", "BN", "MODEL.BACKBONE.FREEZE_AT", 0],
    "r50_frozen_bn": R50,
    "r50_bn_stride_in_3x3_groups2": R50 + ["MODEL.RESNETS.NORM", "BN", "MODEL.RESNETS.STRIDE_IN_1X1", False,
                                          "MODEL.RESNETS.NUM_GROUPS", 2, "MODEL.RESNETS.WIDTH_PER_GROUP", 4],
    "r50_gn_all_features": R50 + ["MODEL.RESNETS.NORM", "GN", "MODEL.RESNETS.RES2_OUT_CHANNELS", 64,
                                  "MODEL.RESNETS.STEM_OUT_CHANNELS", 32, "MODEL.RESNETS.WIDTH_PER_GROUP", 32,
                                  "MODEL.RESNETS.OUT_FEATURES", ["stem", "res2", "res3", "res4", "res5"]],
}


def _cfgs(extra, head_conv=16):
    common = ["MODEL.META_ARCHITECTURE", "CenterNet", "MODEL.CENTERNET.HEAD_CONV", head_conv,
              "MODEL.CENTERNET.TASK.HM", 4, "DATASETS.TRAIN", (), "INPUT.TRAIN_SIZE", (SIZE, SIZE),
              "INPUT.TEST_SIZE", (SIZE, SIZE), "TPU.DTYPE", "float32", "TEST.EXACT_MODE", True,
              "INPUT.COLOR_JITTER", False]
    jcfg, pcfg = jax_get_cfg(), get_cfg()
    jcfg.merge_from_list(common + list(extra))
    pcfg.merge_from_list(common + list(extra) + ["MODEL.DEVICE", "cpu"])
    return jcfg, pcfg


def _random_variables(shapes, seed):
    """Every leaf random: kernels N(0, 1/fan_in), norm scales and variances
    in [0.5, 1.5], biases and means N(0, 0.1²), the hm bias near -2.19."""
    rng = np.random.RandomState(seed)
    out = {}
    for path, v in flatten_dict(shapes).items():
        leaf = path[-1]
        if leaf == "kernel":
            a = rng.randn(*v.shape) / np.sqrt(np.prod(v.shape[:-1]))
        elif leaf in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, v.shape)
        elif path[-2] == "hm_out":
            a = -2.19 + rng.randn(*v.shape) * 0.5
        else:
            a = rng.randn(*v.shape) * 0.1
        out[path] = a.astype(np.float32)
    return unflatten_dict(out)


def _pair(extra, head_conv=16, seed=0):
    """(JAX CenterNet, its random variables, the port's CenterNet with them)."""
    jcfg, pcfg = _cfgs(extra, head_conv)
    jm = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), (SIZE, SIZE)))
    variables = _random_variables(shapes, seed)
    pm = build_model(pcfg)
    pm.model.load_state_dict(state_dict_from_jax(variables))
    return jm, variables, pm


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _images(n, seed):
    return np.random.RandomState(seed).uniform(-2, 2, (n, SIZE, SIZE, 3)).astype(np.float32)


def _under(tree, *keys):
    for k in keys:
        tree = tree[k]
    return tree


def _close(got, want, rel, what):
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-6), err_msg=what)


# -- FrozenBatchNorm and get_norm ---------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frozen_batchnorm_matches_jax(dtype):
    """JAX's FrozenBatchNorm and the port's on one map: scale and bias are
    trainable parameters on both sides (the JAX module declares them with
    ``self.param``), the statistics are not; the output equals within f32
    rounding (1e-6 of its scale), or bf16's (both multiply in bf16: 1e-2)."""
    rng = np.random.RandomState(0)
    c = 12
    x = rng.randn(2, 5, 7, c).astype(np.float32) * 3
    leaves = {"scale": rng.uniform(0.5, 1.5, c), "bias": rng.randn(c), "mean": rng.randn(c),
              "var": rng.uniform(0.5, 1.5, c)}
    leaves = {k: v.astype(np.float32) for k, v in leaves.items()}
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    mod = JaxFrozenBN(c, dtype=jdt)
    variables = {"params": {"scale": leaves["scale"], "bias": leaves["bias"]},
                 "batch_stats": {"mean": leaves["mean"], "var": leaves["var"]}}
    assert set(mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]) == {"scale", "bias"}
    want = np.asarray(mod.apply(variables, jnp.asarray(x, jdt)).astype(jnp.float32))
    port = FrozenBatchNorm(c)
    port.load_state_dict({"weight": torch.from_numpy(leaves["scale"]), "bias": torch.from_numpy(leaves["bias"]),
                          "running_mean": torch.from_numpy(leaves["mean"]),
                          "running_var": torch.from_numpy(leaves["var"]),
                          "num_batches_tracked": torch.tensor(0)})  # a BatchNorm's counter is dropped
    assert {n for n, _ in port.named_parameters()} == {"weight", "bias"}
    assert {n for n, _ in port.named_buffers()} == {"running_mean", "running_var"}
    tdt = getattr(torch, dtype)
    got = _nhwc(port.train()(_nchw(x).to(tdt)).float())
    _close(got, want, 1e-6 if dtype == "float32" else 1e-2, dtype)


def test_get_norm_kinds_and_group_norm_matches_flax():
    """``get_norm`` by name: BN, SyncBN and NaiveSyncBN → the port's
    BatchNorm2d (flax's running variance), FrozenBN → FrozenBatchNorm, GN →
    32 groups with flax's epsilon (GroupNorm against flax's within 1e-5),
    "" → None; anything else raises."""
    for name in ("BN", "SyncBN", "NaiveSyncBN", "naiveSyncBN"):
        assert type(get_norm(name, 64)) is BatchNorm2d
    assert type(get_norm("FrozenBN", 64)) is FrozenBatchNorm
    assert get_norm("", 64) is None
    with pytest.raises(ValueError):
        get_norm("LayerNorm", 64)
    gn = get_norm("GN", 64)
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 5, 64).astype(np.float32) * 2 + 1
    scale, bias = rng.uniform(0.5, 1.5, 64).astype(np.float32), rng.randn(64).astype(np.float32)
    want = np.asarray(fnn.GroupNorm(num_groups=32).apply({"params": {"scale": scale, "bias": bias}}, x))
    gn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    _close(_nhwc(gn(_nchw(x))), want, 1e-5, "GN")


# -- ResNet trunks ------------------------------------------------------------------


@pytest.fixture(scope="module", params=list(TRUNKS))
def trunk_pair(request):
    return (request.param,) + _pair(TRUNKS[request.param])


def test_state_dict_from_jax_covers_every_leaf_once(trunk_pair):
    """Every JAX leaf maps to one port key of the same shape and back
    (``canonical_key``); the port has no key beyond them but the BatchNorm
    counters."""
    name, jm, variables, pm = trunk_pair
    norm = "gn" if "gn" in name else "bn"
    sd = state_dict_from_jax(variables)
    own = pm.model.state_dict()
    assert set(own) == {k for k in sd if k in own} and set(own) - set(sd) == set()
    leaves = {"/".join(p) for p in flatten_dict(variables)}
    mapped = [canonical_key(k, norm) for k in own if not k.endswith("num_batches_tracked")]
    assert sorted(mapped) == sorted(leaves)
    for key, t in own.items():
        assert t.shape == sd[key].shape, key
    assert any(k.startswith("backbone.res4.0.conv1") for k in own)
    assert any(k.startswith("deconv_layers.4.") for k in own)


@pytest.mark.parametrize("train", [False, True])
def test_resnet_trunk_matches_jax(trunk_pair, train):
    """Each of the trunk's out features (res4 alone, or stem and res2-res5),
    in eval mode and in train mode (batch statistics), and after the train
    forward every BatchNorm's running mean and variance. Eval mode: 1e-5 of
    each tensor's scale. Train mode: 2e-4 (BatchNorm and GroupNorm take
    their statistics over 32 values per channel at res4 here, and the two
    frameworks' f32 sums round differently; through ResNet-50's 16 blocks
    that reaches 7.4e-5, through ResNet-18's 8 blocks 7e-6). GroupNorm
    normalizes by its statistics in both modes: 2e-4 in both."""
    name, jm, variables, pm = trunk_pair
    trunk = jm.backbone.trunk
    v = {k: variables[k]["backbone"]["trunk"] for k in variables if "trunk" in variables[k]["backbone"]}
    tol = 2e-4 if train or "gn" in name else 1e-5
    x = _images(2, seed=3)
    if train:
        want, mutated = trunk.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = trunk.apply(v, jnp.asarray(x), train=False)
    port = copy.deepcopy(pm.model.backbone).train(train)  # the fixture's model keeps its statistics
    with torch.no_grad():
        got = port(_nchw(x))
    assert set(got) == set(want) == set(trunk.out_features)
    for k in want:
        _close(_nhwc(got[k]), np.asarray(want[k]), tol, k)
    if train and "batch_stats" in mutated:
        stats = state_dict_from_jax({"batch_stats": {"backbone": {"trunk": mutated["batch_stats"]}}})
        own = port.state_dict()
        moved = [k for k in stats if "running" in k]
        assert moved
        for k in moved:
            _close(own[k.removeprefix("backbone.")].numpy(), stats[k].numpy(), tol, k)


def test_resnet_stages_after_the_last_feature_run_only_in_training():
    """With OUT_FEATURES res2 only asked for res2, eval stops after res2;
    training runs every built stage (their BatchNorm statistics move in the
    JAX package's train step too)."""
    _, pcfg = _cfgs(R18 + ["MODEL.RESNETS.NORM", "BN", "MODEL.RESNETS.OUT_FEATURES", ["res2", "res4"]])
    trunk = build_model(pcfg).model.backbone
    x = torch.randn(1, 3, SIZE, SIZE)
    ran = []
    hooks = [getattr(trunk, n).register_forward_hook(lambda m, i, o, n=n: ran.append(n)) for n in trunk.stage_names]
    with torch.no_grad():
        assert set(trunk.eval()(x, ("res2",))) == {"res2"}
        assert ran == ["res2"]
        ran.clear()
        assert set(trunk.train()(x, ("res2",))) == {"res2"}
        assert ran == ["res2", "res3", "res4"]
    for h in hooks:
        h.remove()


def test_unported_resnet_options_raise_and_name_their_item():
    """The trunk options that raised before they were ported build: the
    deformable trunk (``DEFORM_ON_PER_STAGE``, A14.5) holds a
    ``DeformBottleneckBlock`` for each block of its deformable stages up to
    res4, CenterNet's (tests/test_torch_dconv.py holds it to the JAX
    package); the DeepLab stem (``STEM_TYPE deeplab``) and
    ``build_resnet_deeplab_backbone`` (A15.2) build CenterNet's trunk as
    JAX builds it, the three-conv stem, and res4 at the stride the blocks
    take (JAX's tree crosses strictly; tests/test_torch_deeplab.py holds
    the DeepLab trunk to JAX's). An unknown ``STEM_TYPE`` raises."""
    _, pcfg = _cfgs(R50 + ["MODEL.RESNETS.DEFORM_ON_PER_STAGE", [False, True, True, True]])
    trunk = build_model(pcfg).model.backbone
    assert [type(b).__name__ for b in trunk.res3] == ["DeformBottleneckBlock"] * 4
    assert [type(b).__name__ for b in trunk.res2] == ["BottleneckBlock"] * 3
    for extra in (["MODEL.RESNETS.STEM_TYPE", "deeplab"],
                  ["MODEL.BACKBONE.NAME", "build_resnet_deeplab_backbone", "MODEL.RESNETS.STEM_TYPE", "deeplab"]):
        jcfg, pcfg = _cfgs(R50 + extra)
        model = build_model(pcfg)
        assert type(model.model.backbone.stem).__name__ == "DeepLabStem"
        jm = jax_build_model(jcfg)
        shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), (SIZE, SIZE)))
        model.model.load_state_dict(state_dict_from_jax(_random_variables(shapes, 0)))
        assert model.model.backbone.out_feature_strides["res4"] == 16
    _, pcfg = _cfgs(R50 + ["MODEL.RESNETS.STEM_TYPE", "wide"])
    with pytest.raises(ValueError, match="STEM_TYPE"):
        build_model(pcfg)


# -- the deconv neck and the heads -----------------------------------------------------


@pytest.mark.parametrize("train", [False, True])
def test_deconv_neck_matches_jax(trunk_pair, train):
    """The JAX DeconvNeck (``build_resnet_backbone``) or ResNetDeconv
    (``build_resnet_deconv_backbone``): res4 → 2 × [ConvTranspose 256 k4 s2 +
    BN + ReLU], the stride-4 map and, after the train forward, the neck's
    BatchNorm statistics: 1e-5 of their scale in eval mode, 2e-4 in train
    mode or with GroupNorm (see the trunk test; measured up to 4.9e-5)."""
    name, jm, variables, pm = trunk_pair
    x = _images(2, seed=4)
    v = {k: variables[k]["backbone"] for k in variables}
    if train:
        want, mutated = jm.backbone.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = jm.backbone.apply(v, jnp.asarray(x), train=False)
    model = copy.deepcopy(pm.model).train(train)  # the fixture's model keeps its statistics
    with torch.no_grad():
        got = model.deconv_layers(model.backbone(_nchw(x))["res4"])
    tol = 2e-4 if train or "gn" in name else 1e-5
    assert got.shape == (2, 256, SIZE // 4, SIZE // 4)
    _close(_nhwc(got), np.asarray(want), tol, name)
    if train:
        stats = state_dict_from_jax({"batch_stats": {"backbone": {
            k: s for k, s in mutated["batch_stats"].items() if k.startswith("deconv")}}})
        own = model.state_dict()
        for k, t in stats.items():
            if "running" in k:
                _close(own[k].numpy(), t.numpy(), tol, k)


def test_deconv_kernel_crosses_over_flipped():
    """flax's ConvTranspose correlates with its kernel as stored, torch's
    with the kernel flipped: the neck's weights must cross flipped. Loaded
    unflipped, the same random kernel gives another map (the test catches a
    missing flip)."""
    rng = np.random.RandomState(5)
    kernel = rng.randn(4, 4, 6, 5).astype(np.float32)
    x = rng.randn(1, 7, 9, 6).astype(np.float32)
    want = np.asarray(fnn.ConvTranspose(5, (4, 4), strides=(2, 2), padding="SAME", use_bias=False)
                      .apply({"params": {"kernel": kernel}}, x))
    deconv = DeconvNeck(6, channels=5, num_deconv=1)[0]
    for flip, ok in ((True, True), (False, False)):
        k = kernel[::-1, ::-1] if flip else kernel
        deconv.weight.data = torch.from_numpy(np.ascontiguousarray(k.transpose(2, 3, 0, 1)))
        with torch.no_grad():
            got = _nhwc(deconv(_nchw(x)))
        assert got.shape == want.shape == (1, 14, 18, 5)
        assert np.allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max()) == ok


@pytest.mark.parametrize("head_conv", [0, 16])
def test_centernet_heads_with_and_without_tower_match_jax(head_conv):
    """HEAD_CONV 16 (3x3 tower + ReLU + 1x1) and 0 (one 1x1 conv per head,
    key ``hm.weight``): hm, wh and reg within 1e-5 of their scale; the last
    conv of every head runs in f32; the hm bias starts at -2.19 in both
    forms."""
    jm, variables, pm = _pair(R18, head_conv)
    assert isinstance(head_out(pm.model.hm), F32Conv2d)
    assert ("hm.weight" in pm.model.state_dict()) == (head_conv == 0)
    x = _images(2, seed=6)
    want = jax.jit(lambda v, xi: jm.module.apply(v, xi, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = pm.model.eval()(_nchw(x))
    for k in ("hm", "wh", "reg"):
        _close(_nhwc(got[k]), np.asarray(want[k]), 1e-5, k)
    _, pcfg = _cfgs(R18, head_conv)
    assert torch.all(head_out(build_model(pcfg).model.hm).bias == -2.19)


def test_param_group_labels_match_jax_leaf_for_leaf():
    """ResNet-50 with FrozenBN and ResNet-18-deconv with GN: every JAX params
    leaf's optimizer group (norm / bias / default, by path) equals the
    group of the port's parameter it maps to (by module type)."""
    for extra in (R50, R18 + ["MODEL.RESNETS.NORM", "GN", "MODEL.RESNETS.RES2_OUT_CHANNELS", 32,
                              "MODEL.RESNETS.STEM_OUT_CHANNELS", 32]):
        jcfg, pcfg = _cfgs(extra)
        jm = jax_build_model(jcfg)
        params = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), (SIZE, SIZE)))["params"]
        want = {"/".join(("params",) + k): v for k, v in flatten_dict(jax_labels(params)).items()}
        got = param_group_labels(build_model(pcfg).model)
        assert {torch_key(p): label for p, label in want.items()} == got
        assert set(got.values()) == {"default", "norm", "bias"}


# -- the whole ResNet-18-deconv CenterNet -------------------------------------------------


def _batch(seed, n=2, m=6):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 40, (n, m, 2))
    boxes = np.concatenate([xy, np.minimum(xy + rng.uniform(4, 30, (n, m, 2)), SIZE - 1)], -1)
    valid = np.ones((n, m), bool)
    valid[1, 4:] = False
    return {"image": rng.uniform(0, 255, (n, SIZE, SIZE, 3)).astype(np.float32),
            "gt_boxes": boxes.astype(np.float32), "gt_classes": rng.randint(0, 4, (n, m)).astype(np.int32),
            "gt_valid": valid}


def _port_batch(b):
    return {"image": _nchw(b["image"]), "gt_boxes": torch.from_numpy(b["gt_boxes"]),
            "gt_classes": torch.from_numpy(b["gt_classes"]), "gt_valid": torch.from_numpy(b["gt_valid"])}


def test_r18_deconv_loss_and_every_gradient_match_jax():
    """ResNet-18-deconv (BN, FREEZE_AT 0): the loss terms within 1e-5
    relative, and every parameter's gradient within 1e-2 of its max |value|
    plus 5e-4 of the largest gradient, the DLA-34 step's tolerance
    (``test_torch_train``): no DCN here, but 21 train-mode BatchNorms over
    maps down to 4x4 magnify f32 rounding along the backward (measured:
    3.9e-3 of its own scale at worst, the neck's second transposed conv)."""
    jm, variables, pm = _pair(R18 + ["MODEL.RESNETS.NORM", "BN", "MODEL.BACKBONE.FREEZE_AT", 0])
    batch = _batch(1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (_, (jloss, _)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, variables["batch_stats"], jbatch), has_aux=True))(variables["params"])
    pm.model.train()
    total, losses = pm.loss_fn(_port_batch(batch))
    total.backward()
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), float(jloss[k]), rtol=1e-5, err_msg=k)
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    grads = {k: p.grad for k, p in pm.model.named_parameters()}
    assert set(want) == set(grads)
    floor = 5e-4 * max(np.abs(w.numpy()).max() for w in want.values())
    for k, g in grads.items():
        w = want[k].numpy()
        assert np.abs(g.numpy() - w).max() <= 1e-2 * np.abs(w).max() + floor, k


def test_r18_adam_trajectory_with_frozen_stages_matches_jax():
    """Five Adam steps (LR 1e-3, WEIGHT_DECAY 1e-4, no warm-up) of
    ResNet-18-deconv with FrozenBN and FREEZE_AT 2, the JAX package's
    jitted train step against the port's optimizer step, each step on its
    own batch: the total loss of every step within 1e-4 relative. The
    frozen stem and res2 get a zero gradient on both sides and still move,
    by the decay under Adam, as they do in JAX (ROADMAP C12)."""
    extra = R18 + ["SOLVER.OPTIMIZER", "ADAM", "SOLVER.BASE_LR", 1e-3, "SOLVER.WARMUP_ITERS", 0,
                   "SOLVER.WEIGHT_DECAY", 1e-4]
    jm, variables, pm = _pair(extra)
    jcfg, pcfg = _cfgs(extra)
    tx = jax_build_optimizer(jcfg, variables["params"])
    mesh = get_mesh(1)
    # placed as the step returns it (replicated on the mesh), so its later calls reuse the first's program
    state = jax.device_put(TrainState.create(jax.tree_util.tree_map(jnp.array, variables), tx),
                           NamedSharding(mesh, PartitionSpec()))
    step = make_train_step(jm, tx, mesh)
    opt, sched = build_optimizer(pcfg, pm.model)
    for p in pm.model.parameters():
        p.grad = torch.zeros_like(p)
    stem = pm.model.backbone.stem.conv1.weight
    stem0 = stem.detach().clone()
    jlosses, plosses = [], []
    pm.model.train()
    for i in range(5):
        b = _batch(10 + i)
        state, metrics = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        jlosses.append(float(metrics["total_loss"]))
        opt.zero_grad(set_to_none=False)
        total, _ = pm.loss_fn(_port_batch(b))
        total.backward()
        assert torch.count_nonzero(stem.grad) == 0
        opt.step()
        sched.step()
        plosses.append(total.item())
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-4)
    jstem = np.asarray(state.params["backbone"]["trunk"]["stem"]["conv1"]["kernel"]).transpose(3, 2, 0, 1)
    assert not torch.equal(stem.detach(), stem0)
    _close(stem.detach().numpy(), jstem, 1e-5, "frozen stem after 5 Adam steps")


def test_freeze_at_one_sgd_step_moves_frozen_weights_by_the_decay_as_jax():
    """What FREEZE_AT does to the optimizer in the JAX package, measured: one
    SGD step (LR 0.01, momentum 0.9, WEIGHT_DECAY 1e-3) leaves the frozen
    stem's gradient at 0 but multiplies its kernel by 1 - LR·decay, as
    optax's decay acts on every leaf (the reference detectron2 sets
    ``requires_grad=False`` and would leave it as it was). The port's step
    does the same, to 1e-6 of the kernel's scale."""
    lr, wd = 0.01, 1e-3
    extra = R18 + ["SOLVER.BASE_LR", lr, "SOLVER.WARMUP_ITERS", 0, "SOLVER.WEIGHT_DECAY", wd]
    jm, variables, pm = _pair(extra)
    jcfg, pcfg = _cfgs(extra)
    batch = _batch(2)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (_, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, variables["batch_stats"], jbatch), has_aux=True))(variables["params"])
    tx = jax_build_optimizer(jcfg, variables["params"])
    updates, _ = tx.update(jgrads, tx.init(variables["params"]), variables["params"])
    new = optax.apply_updates(variables["params"], updates)
    path = ("backbone", "trunk", "stem", "conv1", "kernel")
    w0 = np.asarray(_under(variables["params"], *path))
    assert np.count_nonzero(np.asarray(_under(jgrads, *path))) == 0
    w1 = np.asarray(_under(new, *path))
    np.testing.assert_allclose(w1, w0 * (1 - lr * wd), rtol=1e-6)

    opt, sched = build_optimizer(pcfg, pm.model)
    for p in pm.model.parameters():
        p.grad = torch.zeros_like(p)
    pm.model.train()
    total, _ = pm.loss_fn(_port_batch(batch))
    total.backward()
    opt.step()
    _close(pm.model.backbone.stem.conv1.weight.detach().numpy(), w1.transpose(3, 2, 0, 1), 1e-6, "stem")


def test_r18_default_predictor_matches_jax(monkeypatch):
    """One BGR uint8 image through both DefaultPredictors (the JAX one fed
    the port's warp, as in ``test_torch_centernet``): the same classes,
    scores within 1e-5, boxes within 1e-2 px of the image."""
    jm, variables, pm = _pair(R18)
    _, pcfg = _cfgs(R18)
    port = DefaultPredictor(pcfg)
    port.model.model.load_state_dict(state_dict_from_jax(variables))
    monkeypatch.setattr(type(jm), "init", lambda self, rng, size: variables)
    jcfg, _ = _cfgs(R18)
    ref = JaxPredictor(jcfg)
    ref._warp_image = lambda img, m, size: warp_image(img, m, size).numpy()
    img = np.random.RandomState(7).randint(0, 256, (50, 70, 3)).astype(np.uint8)
    got = port(img)["instances"]
    want = ref(img)["instances"]
    assert len(got) == len(want) > 5
    np.testing.assert_array_equal(got.pred_classes, want.pred_classes)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.pred_boxes.tensor, np.asarray(want.pred_boxes.tensor), atol=1e-2)
    assert math.isfinite(float(got.scores.sum()))
