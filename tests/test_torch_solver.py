"""The port's solver (``solver/``) against the JAX package's optax one: the
three LR schedules step by step, the parameter-group labels leaf for leaf
through ``from_jax``'s key map, and three SGD / Adam updates with per-group
weight decay and LR factor, unclipped and with both clip types."""

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp
import optax
from flax.traverse_util import flatten_dict

from detectron2_centernet_tpu.config import get_cfg as jax_get_cfg
from detectron2_centernet_tpu.models.build import build_model as jax_build_model
from detectron2_centernet_tpu.solver import build_optimizer as jax_build_optimizer
from detectron2_centernet_tpu.solver import lr_scheduler as jax_lr
from detectron2_centernet_tpu.solver.build import param_group_labels as jax_labels
from detectron2_centernet_tpu_torch.checkpoint import torch_key
from detectron2_centernet_tpu_torch.config import get_cfg
from detectron2_centernet_tpu_torch.models import build_model
from detectron2_centernet_tpu_torch.solver import build_optimizer, param_group_labels
from detectron2_centernet_tpu_torch.solver import lr_scheduler as port_lr

STEPS = range(0, 130)


@pytest.mark.parametrize("make", [
    lambda m: m.warmup_multistep_lr(0.1, (40, 90), gamma=0.5, warmup_factor=0.01, warmup_iters=20),
    lambda m: m.warmup_multistep_lr(0.1, (40,), warmup_iters=10, warmup_method="constant"),
    lambda m: m.warmup_cosine_lr(0.02, 120, warmup_iters=15),
    lambda m: m.warmup_poly_lr(0.05, 120, power=0.9, constant_ending=0.3, warmup_iters=10),
    lambda m: m.warmup_poly_lr(0.05, 100, warmup_iters=0),
], ids=["multistep", "multistep_constant", "cosine", "poly_constant_ending", "poly"])
def test_schedules_match_jax_step_by_step(make):
    """Every step 0..129 (past max_iter for cosine and poly): 1e-6 relative,
    or 1e-7 absolute where the lr nears 0 (JAX evaluates in f32, the port in
    f64; f32 cos is good to ~1e-7 of the base rate)."""
    want = np.array([float(make(jax_lr)(jnp.asarray(s))) for s in STEPS])
    got = np.array([make(port_lr)(s) for s in STEPS])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_param_group_labels_match_jax_leaf_for_leaf():
    """The small ctdet DLA-34: every JAX params leaf's label (by path) equals
    the label of the port's parameter it maps to (by module type)."""
    small = ["MODEL.CENTERNET.CHANNELS", [8, 8, 16, 16, 32, 32], "MODEL.CENTERNET.HEAD_CONV", 16,
             "MODEL.CENTERNET.TASK.HM", 4]
    jcfg = jax_get_cfg()
    jcfg.merge_from_list(["MODEL.META_ARCHITECTURE", "CenterNet",
                          "MODEL.BACKBONE.NAME", "build_dla34_backbone"] + small)
    jm = jax_build_model(jcfg)
    params = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), (64, 64)))["params"]
    want = {"/".join(("params",) + k): v for k, v in flatten_dict(jax_labels(params)).items()}
    pcfg = get_cfg()
    pcfg.merge_from_list(["MODEL.META_ARCHITECTURE", "CenterNet", "MODEL.BACKBONE.NAME",
                          "build_dla34_backbone", "MODEL.DEVICE", "cpu"] + small)
    got = param_group_labels(build_model(pcfg).model)
    assert len(got) == len(want)
    assert {torch_key(p): label for p, label in want.items()} == got
    assert set(got.values()) == {"default", "norm", "bias"}


class _Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 4, 3)
        self.bn = nn.BatchNorm2d(4)


_JAX_PATH = {"conv.weight": ("conv", "kernel"), "conv.bias": ("conv", "bias"),
             "bn.weight": ("bn", "scale"), "bn.bias": ("bn", "bias")}


def _solver_cfg(get, optimizer, clip, nesterov):
    cfg = get()
    cfg.merge_from_list([
        "SOLVER.OPTIMIZER", optimizer, "SOLVER.BASE_LR", 0.1, "SOLVER.WARMUP_ITERS", 2,
        "SOLVER.STEPS", (2,), "SOLVER.GAMMA", 0.5, "SOLVER.WEIGHT_DECAY", 0.01,
        "SOLVER.WEIGHT_DECAY_NORM", 0.001, "SOLVER.WEIGHT_DECAY_BIAS", 0.02,
        "SOLVER.BIAS_LR_FACTOR", 2.0, "SOLVER.MOMENTUM", 0.9, "SOLVER.NESTEROV", nesterov,
        "SOLVER.CLIP_GRADIENTS.ENABLED", clip != "none",
        "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "value" if clip == "none" else clip,
        "SOLVER.CLIP_GRADIENTS.CLIP_VALUE", 0.5,
    ])
    return cfg


@pytest.mark.parametrize("clip", ["none", "value", "norm"])
@pytest.mark.parametrize("optimizer,nesterov", [("SGD", False), ("SGD", True), ("ADAM", False)])
def test_three_updates_match_optax(optimizer, nesterov, clip):
    """Three steps with the same gradients (N(0, 1), so both clips fire)
    through warmup and a milestone: the parameters agree to 1e-6 relative."""
    model = _Tiny()
    rng = np.random.RandomState(0)
    init = {k: rng.randn(*p.shape).astype(np.float32) for k, p in model.named_parameters()}
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(torch.from_numpy(init[k]))
    params = {"conv": {}, "bn": {}}
    for k, path in _JAX_PATH.items():
        params[path[0]][path[1]] = jnp.asarray(init[k])
    tx = jax_build_optimizer(_solver_cfg(jax_get_cfg, optimizer, clip, nesterov), params)
    opt_state = tx.init(params)
    opt, sched = build_optimizer(_solver_cfg(get_cfg, optimizer, clip, nesterov), model)
    for _ in range(3):
        grads = {k: rng.randn(*v.shape).astype(np.float32) for k, v in init.items()}
        jgrads = {"conv": {}, "bn": {}}
        for k, path in _JAX_PATH.items():
            jgrads[path[0]][path[1]] = jnp.asarray(grads[k])
        updates, opt_state = tx.update(jgrads, opt_state, params)
        params = optax.apply_updates(params, updates)
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[k].copy())
        opt.step()
        sched.step()
    for k, p in model.named_parameters():
        want = np.asarray(params[_JAX_PATH[k][0]][_JAX_PATH[k][1]])
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-6, atol=1e-6, err_msg=k)
