"""Two repairs of the port's first slice, held against the JAX package: a
bf16 model keeps its parameters and BatchNorm statistics in f32 (ROADMAP C5;
flax's ``param_dtype`` is f32 whatever ``dtype``), and conv kernels are drawn
as flax's truncated lecun-normal."""

import math

import numpy as np
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from detectron2_centernet_tpu.config import get_cfg as jax_get_cfg
from detectron2_centernet_tpu.models.build import build_model as jax_build_model
from detectron2_centernet_tpu_torch.checkpoint import state_dict_from_jax
from detectron2_centernet_tpu_torch.config import get_cfg
from detectron2_centernet_tpu_torch.models import build_model
from detectron2_centernet_tpu_torch.models.layers import TRUNC_NORMAL_STD, init_weights
from detectron2_centernet_tpu_torch.solver import build_optimizer

SIZE = 64
SMALL = [
    "MODEL.META_ARCHITECTURE", "CenterNet", "MODEL.BACKBONE.NAME", "build_dla34_backbone",
    "MODEL.CENTERNET.CHANNELS", [8, 8, 16, 16, 32, 32], "MODEL.CENTERNET.HEAD_CONV", 16,
    "MODEL.CENTERNET.TASK.HM", 4, "DATASETS.TRAIN", (), "TPU.DTYPE", "bfloat16",
    "TPU.DCN_IMPL", "exact", "TEST.EXACT_MODE", True, "SOLVER.BASE_LR", 1e-4,
    "SOLVER.WARMUP_ITERS", 0,
]


def _variables(shapes, seed):
    """Random leaves: kernels N(0, 1/fan_in) (offset convs x0.25), BN affine
    and statistics away from identity."""
    rng = np.random.RandomState(seed)
    out = {}
    for path, v in flatten_dict(shapes).items():
        if path[-1] == "kernel":
            a = rng.randn(*v.shape) / np.sqrt(np.prod(v.shape[:-1]))
            a = a * (0.25 if "conv_offset_mask" in path else 1.0)
        elif path[-1] in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, v.shape)
        else:
            a = rng.randn(*v.shape) * 0.1
        out[path] = a.astype(np.float32)
    return unflatten_dict(out)


def test_bf16_model_keeps_f32_parameters_and_bn_statistics():
    """ROADMAP C5 repaired. A bf16 model keeps every parameter and BN buffer
    in f32 and computes at bf16. (1) After one train-mode forward, the first
    BatchNorm's running variance matches the JAX bf16 model's to 1.5e-3
    relative (both fold the biased batch variance, ROADMAP C6; the two round
    their bf16 convolutions differently, 6e-4 measured). (2) One SGD step at lr 1e-4 moves the BN
    scales by ~1e-4: in f32 they move, where bf16 storage (slice 1) would
    round the step away (half a bf16 ulp at 1 is 2e-3)."""
    jcfg, pcfg = jax_get_cfg(), get_cfg()
    jcfg.merge_from_list(SMALL)
    pcfg.merge_from_list(SMALL + ["MODEL.DEVICE", "cpu"])
    jm = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), (SIZE, SIZE)))
    variables = _variables(shapes, seed=2)
    pm = build_model(pcfg)
    pm.model.load_state_dict(state_dict_from_jax(variables))
    for k, t in pm.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert t.dtype == torch.float32, k
    rng = np.random.RandomState(3)
    x = rng.uniform(0, 255, (2, SIZE, SIZE, 3)).astype(np.float32)
    _, mutated = jax.jit(lambda v, xi: jm.module.apply(v, jm.normalize(xi), train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    pm.model.train()
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        pm.model(pm.normalize(xt))
    bn = pm.model.backbone.base.base_layer[1]
    want = np.asarray(mutated["batch_stats"]["backbone"]["base"]["base_layer"]["bn"]["var"])
    np.testing.assert_allclose(bn.running_var.numpy(), want, rtol=1.5e-3)

    opt, _ = build_optimizer(pcfg, pm.model)
    before = bn.weight.detach().clone()
    z = pm.model(pm.normalize(xt))
    assert z["hm"].dtype == torch.float32
    (z["hm"].square().mean() + z["wh"].square().mean()).backward()
    opt.step()
    step = (bn.weight.detach() - before).abs()
    assert bn.weight.dtype == torch.float32
    assert (step > 0).all() and step.max() < 2e-3, step


def test_init_is_flax_truncated_lecun_normal():
    """``init_weights`` draws conv kernels as flax's lecun_normal: a normal
    cut at ±2σ with σ = 1/√fan_in / 0.8796, so the variance is 1/fan_in.
    On 1.18M draws: the std within 0.5% of 1/√fan_in and of a flax draw of
    the same shape, nothing beyond the cut, the cut reached (max within 1%
    of 2σ), and the kurtosis of a ±2 truncated normal (2.36, where an
    untruncated draw gives 3), within 0.02 of flax's."""
    conv = torch.nn.Conv2d(256, 512, 3)
    init_weights(conv, torch.Generator().manual_seed(0))
    w = conv.weight.detach().numpy().ravel().astype(np.float64)
    fan_in = 256 * 9
    flax_w = np.asarray(jax.nn.initializers.lecun_normal()(jax.random.PRNGKey(0), (3, 3, 256, 512)),
                        np.float64).ravel()
    sigma = 1 / math.sqrt(fan_in) / TRUNC_NORMAL_STD
    kurt = lambda a: np.mean(a ** 4) / np.mean(a ** 2) ** 2
    assert abs(w.std() * math.sqrt(fan_in) - 1) < 5e-3
    assert abs(w.std() / flax_w.std() - 1) < 5e-3
    assert np.abs(w).max() <= 2 * sigma * (1 + 1e-6)
    assert np.abs(w).max() > 0.99 * 2 * sigma
    assert abs(kurt(w) - kurt(flax_w)) < 0.02 and abs(kurt(w) - 2.36) < 0.03
