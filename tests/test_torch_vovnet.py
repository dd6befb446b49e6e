"""The port's VoVNet trunks (OSA blocks, eSE, the SAME max pool) and the
VoVNet-deconv CenterNet against the JAX package on the CPU in f32, 64²
inputs: ``V-19-slim-eSE`` (the ``ctdet_vovnet2_19_slim_1x.yaml`` trunk) and
``V-19-slim-dw-eSE`` (depthwise) at their published widths, weights made
with numpy from a seed and carried across through ``state_dict_from_jax``.
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp
from flax import linen as fnn
from flax.traverse_util import flatten_dict, unflatten_dict

from detectron2_centernet_tpu.config import get_cfg as jax_get_cfg
from detectron2_centernet_tpu.models.backbones.vovnet import VOVNET_SPECS as JAX_SPECS
from detectron2_centernet_tpu.models.backbones.vovnet import VoVNet as JaxVoVNet
from detectron2_centernet_tpu.models.backbones.vovnet import eSEModule as JaxESE
from detectron2_centernet_tpu.models.build import build_model as jax_build_model
from detectron2_centernet_tpu.solver.build import param_group_labels as jax_labels
from detectron2_centernet_tpu_torch.checkpoint import canonical_key, state_dict_from_jax, torch_key
from detectron2_centernet_tpu_torch.config import get_cfg
from detectron2_centernet_tpu_torch.models import build_model
from detectron2_centernet_tpu_torch.models.meta_arch.centernet import head_out
from detectron2_centernet_tpu_torch.models.backbones.vovnet import VOVNET_SPECS, MaxPoolSame, VoVNet, eSEModule
from detectron2_centernet_tpu_torch.solver import param_group_labels

SIZE = 64
VARIANTS = ("V-19-slim-eSE", "V-19-slim-dw-eSE")


def _cfgs(variant):
    extra = ["MODEL.META_ARCHITECTURE", "CenterNet", "MODEL.BACKBONE.NAME", "build_vovnet_backbone",
             "MODEL.VOVNET.CONV_BODY", variant, "MODEL.CENTERNET.HEAD_CONV", 16, "MODEL.CENTERNET.TASK.HM", 4,
             "DATASETS.TRAIN", (), "TPU.DTYPE", "float32", "TEST.EXACT_MODE", True]
    jcfg, pcfg = jax_get_cfg(), get_cfg()
    jcfg.merge_from_list(extra)
    pcfg.merge_from_list(extra + ["MODEL.DEVICE", "cpu"])
    return jcfg, pcfg


def _random_variables(shapes, seed):
    """Every leaf random: kernels N(0, 1/fan_in), BN scales and variances in
    [0.5, 1.5], biases and means N(0, 0.1²)."""
    rng = np.random.RandomState(seed)
    out = {}
    for path, v in flatten_dict(shapes).items():
        leaf = path[-1]
        if leaf == "kernel":
            a = rng.randn(*v.shape) / np.sqrt(np.prod(v.shape[:-1]))
        elif leaf in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, v.shape)
        else:
            a = rng.randn(*v.shape) * 0.1
        out[path] = a.astype(np.float32)
    return unflatten_dict(out)


@pytest.fixture(scope="module", params=VARIANTS)
def pair(request):
    jcfg, pcfg = _cfgs(request.param)
    jm = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), (SIZE, SIZE)))
    variables = _random_variables(shapes, seed=0)
    pm = build_model(pcfg)
    pm.model.load_state_dict(state_dict_from_jax(variables))
    return request.param, jm, variables, pm


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


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _close(got, want, rel, what):
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-6), err_msg=what)


def test_state_dict_from_jax_covers_every_leaf_once(pair):
    """Every JAX leaf maps to one port key of the same shape and back; the
    keys are the reference's (``stem.stem_1/conv``,
    ``stage2.OSA2_1.layers.0.OSA2_1_0/...``, ``deconv_layers.N``)."""
    variant, jm, variables, pm = pair
    sd = state_dict_from_jax(variables)
    own = pm.model.state_dict()
    assert set(own) == set(sd)
    leaves = {"/".join(p) for p in flatten_dict(variables)}
    mapped = [canonical_key(k) for k in own if not k.endswith("num_batches_tracked")]
    assert sorted(mapped) == sorted(leaves)
    for key, t in own.items():
        assert t.shape == sd[key].shape, key
    dw = "dw" in variant
    assert ("backbone.stage3.OSA3_1.layers.0.OSA3_1_0/dw_conv3x3.weight" in own) == dw
    assert ("backbone.stage3.OSA3_1.conv_reduction.OSA3_1_reduction_0/conv.weight" in own) == dw
    assert "backbone.stage5.OSA5_1.ese.fc.bias" in own and "backbone.stem.stem_3/norm.running_var" in own


@pytest.mark.parametrize("train", [False, True])
def test_vovnet_trunk_matches_jax(pair, train):
    """stage2-stage5 in eval mode and in train mode (batch statistics; every
    stage's BatchNorm statistics after the forward): 1e-5 of each tensor's
    scale in eval mode, 1e-3 in train mode. There each BatchNorm divides by
    the statistics of as few as 8 values per channel (2x2 maps at stage5,
    batch 2), which the two frameworks' f32 sums round differently: measured
    1.5e-5 (slim) and 3.4e-4 (slim-dw, whose depthwise 3x3 on a 2x2 map
    leaves some channels nearly constant) at stage5, at most 3.5e-5 before
    it."""
    variant, jm, variables, pm = pair
    trunk = jm.backbone.trunk
    v = {k: variables[k]["backbone"]["trunk"] for k in variables}
    x = np.random.RandomState(3).uniform(-2, 2, (2, SIZE, SIZE, 3)).astype(np.float32)
    if train:
        want, mutated = trunk.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = trunk.apply(v, jnp.asarray(x), train=False)
    port = copy.deepcopy(pm.model.backbone).train(train)
    with torch.no_grad():
        got = port(_nchw(x))
    tol = 1e-3 if train else 1e-5
    assert set(got) == set(want) == {"stage2", "stage3", "stage4", "stage5"}
    for k in want:
        assert got[k].shape[1] == VOVNET_SPECS[variant][2][int(k[-1]) - 2]
        _close(_nhwc(got[k]), np.asarray(want[k]), tol, k)
    if train:
        stats = state_dict_from_jax({"batch_stats": {"backbone": {"trunk": mutated["batch_stats"]}}})
        own = port.state_dict()
        for k, t in stats.items():
            if "running" in k:
                _close(own[k.removeprefix("backbone.")].numpy(), t.numpy(), tol, k)


@pytest.mark.parametrize("train", [False, True])
def test_vovnet_centernet_heads_match_jax(pair, train):
    """The whole VoVNet-deconv CenterNet (stage4 → deconv neck → heads):
    hm, wh and reg within 1e-5 of their scale in eval mode, 2e-4 in train
    mode."""
    variant, jm, variables, pm = pair
    x = np.random.RandomState(4).uniform(-2, 2, (2, SIZE, SIZE, 3)).astype(np.float32)
    if train:
        want, _ = jax.jit(lambda v, xi: jm.module.apply(v, xi, train=True, mutable=["batch_stats"]))(
            variables, jnp.asarray(x))
    else:
        want = jax.jit(lambda v, xi: jm.module.apply(v, xi, train=False))(variables, jnp.asarray(x))
    model = copy.deepcopy(pm.model).train(train)
    with torch.no_grad():
        got = model(_nchw(x))
    for k in ("hm", "wh", "reg"):
        assert got[k].shape[2:] == (SIZE // 4, SIZE // 4)
        _close(_nhwc(got[k]), np.asarray(want[k]), 2e-4 if train else 1e-5, k)


def _f64(module):
    """The JAX CenterNet module computing its trunk, neck and head towers
    in f64; the heads' last convs and the losses stay f32, as the JAX
    package pins them."""
    neck = module.backbone
    return module.clone(dtype=jnp.float64, backbone=neck.clone(dtype=jnp.float64,
                                                               trunk=neck.trunk.clone(dtype=jnp.float64)))


def test_vovnet_centernet_loss_and_every_gradient_match_jax_in_f64(pair):
    """The VoVNet-deconv CenterNet's train step (batch statistics, eSE, the
    OSA concatenations, the depthwise layers, the SAME pool, stage5 run for
    its statistics only) against the JAX package's ``loss_fn``, both sides
    in f64 but for the heads' last convs and the losses, which both keep in
    f32. In f32 these gradients cannot be compared: the f32 forward drifts
    far enough from f64 that some ReLUs after a BatchNorm flip and pass or
    block their cotangent (``tools/grad_conditioning.py``: 2 and 68 flips,
    gradients up to 2.6% and 35% of their scale off). Measured in f64:
    losses within 2.2e-7 relative, gradients within 4.9e-7 of their max
    |value|; held to 1e-6 and 1e-5. Stage5's gradients are 0 in JAX, and
    the port leaves them unset."""
    variant, jm, variables, pm = pair
    batch = _batch(1)
    with jax.enable_x64(True):
        jm64 = copy.copy(jm)
        jm64.module = _f64(jm.module)
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        (_, (jloss, _)), jgrads = jax.jit(jax.value_and_grad(
            lambda p: jm64.loss_fn(p, v64["batch_stats"], {k: jnp.asarray(v) for k, v in batch.items()}),
            has_aux=True))(v64["params"])
        jloss = {k: float(v) for k, v in jloss.items()}
        want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    model = copy.deepcopy(pm.model).double().train()
    for name in model.head_names:
        head_out(getattr(model, name)).float()
    model.backbone.register_forward_pre_hook(lambda m, args: (args[0].double(),) + args[1:])
    port = copy.copy(pm)
    port.model = model
    total, losses = port.loss_fn(_port_batch(batch))
    total.backward()
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), jloss[k], rtol=1e-6, err_msg=k)
    grads = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
    stage5 = {k for k in want if k.startswith("backbone.stage5.")}
    assert stage5 and set(grads) == set(want) - stage5
    assert all(not want[k].any() for k in stage5)
    for k, g in grads.items():
        w = want[k].numpy()
        assert np.abs(g.double().numpy() - w).max() <= 1e-5 * np.abs(w).max(), k


def test_vovnet_stage5_runs_only_in_training(pair):
    """CenterNet reads stage4. In eval mode stage5 is skipped; in training
    it runs, so its BatchNorm statistics move as in the JAX package's train
    step (which returns them)."""
    _, _, _, pm = pair
    model = copy.deepcopy(pm.model)
    calls = []
    model.backbone.stage5.register_forward_hook(lambda m, i, o: calls.append(1))
    x = torch.randn(1, 3, SIZE, SIZE)
    with torch.no_grad():
        model.eval()(x)
        assert calls == []
        before = model.backbone.stage5.OSA5_1.concat[1].running_mean.clone()
        model.train()(x)
    assert calls == [1]
    assert not torch.equal(model.backbone.stage5.OSA5_1.concat[1].running_mean, before)


@pytest.mark.parametrize("hw", [(16, 16), (15, 9), (8, 13)])
def test_max_pool_same_matches_flax(hw):
    """The stage pool: flax's 3x3 stride-2 ``padding="SAME"`` max pool
    exactly, at even and odd sizes; ``nn.MaxPool2d(3, 2, padding=1)`` shifts
    the windows at an even size and gives other values (the test catches
    that)."""
    h, w = hw
    x = np.random.RandomState(h * 31 + w).randn(2, h, w, 5).astype(np.float32)
    want = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding="SAME"))
    got = _nhwc(MaxPoolSame()(_nchw(x)))
    np.testing.assert_array_equal(got, want)
    if h % 2 == 0:
        shifted = _nhwc(nn.MaxPool2d(3, 2, padding=1)(_nchw(x)))
        assert shifted.shape == want.shape and not np.array_equal(shifted, want)


def test_ese_matches_jax():
    """eSE: global mean → 1x1 conv with bias → hard sigmoid (relu6(x+3)/6)
    gate, within 1e-6 of the output's scale."""
    rng = np.random.RandomState(6)
    x = rng.randn(2, 7, 5, 24).astype(np.float32) * 2
    kernel = (rng.randn(1, 1, 24, 24) / np.sqrt(24)).astype(np.float32) * 4
    bias = rng.randn(24).astype(np.float32)
    want = np.asarray(JaxESE(24).apply({"params": {"fc": {"kernel": kernel, "bias": bias}}}, jnp.asarray(x)))
    port = eSEModule(24)
    port.fc.weight.data = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())
    port.fc.bias.data = torch.from_numpy(bias)
    gate = want / x
    assert (gate < 1e-3).any() and (gate > 1 - 1e-3).any()  # both ends of the hard sigmoid
    _close(_nhwc(port(_nchw(x))), want, 1e-6, "eSE")


@pytest.mark.parametrize("variant", sorted(JAX_SPECS))
def test_every_variant_builds_with_the_jax_parameter_count(variant):
    """All seven variants of the table build, with the JAX trunk's number of
    parameters (and of BatchNorm statistics)."""
    assert VOVNET_SPECS[variant] == JAX_SPECS[variant]
    shapes = jax.eval_shape(lambda: JaxVoVNet(variant).init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    counts = {c: sum(int(np.prod(v.shape)) for v in flatten_dict(shapes[c]).values()) for c in shapes}
    port = VoVNet(variant)
    assert sum(p.numel() for p in port.parameters()) == counts["params"]
    assert sum(b.numel() for n, b in port.named_buffers() if "running" in n) == counts["batch_stats"]


def test_param_group_labels_match_jax_leaf_for_leaf():
    """V-19-slim-dw-eSE: every JAX params leaf's optimizer group equals the
    group of the port's parameter it maps to (eSE biases "bias", BatchNorm
    affines "norm", kernels "default")."""
    jcfg, pcfg = _cfgs("V-19-slim-dw-eSE")
    jm = jax_build_model(jcfg)
    params = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), (SIZE, SIZE)))["params"]
    want = {"/".join(("params",) + k): v for k, v in flatten_dict(jax_labels(params)).items()}
    got = param_group_labels(build_model(pcfg).model)
    assert {torch_key(p): label for p, label in want.items()} == got
