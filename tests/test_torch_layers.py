"""The port's layers (``detectron2_centernet_tpu_torch/models/layers.py``)
against the JAX package's flax modules, with the same random weights carried
across by ``checkpoint/from_jax.py`` and the same inputs (NHWC on the JAX
side, NCHW on the port's). All f32 on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from detectron2_centernet_tpu.models import layers as jl
from detectron2_centernet_tpu_torch.checkpoint import state_dict_from_jax
from detectron2_centernet_tpu_torch.models import layers as tl


def _under(owner, variables):
    """Load a lone module's JAX variables through the whole-model key map by
    hanging them under an ``owner`` of the DLA (``proj_1``, ``up_1``)."""
    tree = {coll: {owner: v} for coll, v in variables.items()}
    return {k[len(owner) + 1:]: v for k, v in state_dict_from_jax(tree).items()}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("cin,cout,hw", [(8, 16, (12, 16)), (16, 8, (9, 11))])
def test_deform_conv_v2_eval_matches_jax(cin, cout, hw):
    """Eval: BN and bias folded into the DCN epilogue on the port's side, the
    exact op then BatchNorm and ReLU on the JAX side. Random BN statistics
    and a random offset conv (offsets of a few px). Tolerance 1e-4."""
    rng = np.random.RandomState(cin + cout)
    x = rng.randn(2, *hw, cin).astype(np.float32)
    mod = jl.DeformConvV2(features=cout, impl="exact")
    variables = jax.tree_util.tree_map(np.asarray, mod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    p, bs = variables["params"], variables["batch_stats"]
    p["kernel"] = rng.randn(*p["kernel"].shape).astype(np.float32) / np.sqrt(9 * cin)
    p["bias"] = rng.randn(cout).astype(np.float32) * 0.1
    com = p["conv_offset_mask"]
    com["kernel"] = rng.randn(*com["kernel"].shape).astype(np.float32) * 0.5
    com["bias"] = rng.randn(27).astype(np.float32) * 0.5
    p["bn"]["scale"] = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    p["bn"]["bias"] = rng.randn(cout).astype(np.float32) * 0.1
    bs["bn"]["mean"] = rng.randn(cout).astype(np.float32) * 0.1
    bs["bn"]["var"] = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    want = np.asarray(mod.apply(variables, jnp.asarray(x), train=False))

    port = tl.DeformConvV2(cin, cout)
    port.load_state_dict(_under("proj_1", variables))
    port.eval()
    with torch.no_grad():
        got = port(_nchw(x))
        om = port.conv.offset_mask(_nchw(x))[0]
    assert om.abs().max() > 1.0  # the offsets really move the samples
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize(
    "f,h,w,c",
    [
        (2, 8, 8, 8),    # JAX phase-decomposed branch (f=2, <= 32x32)
        (2, 5, 7, 16),   # phase branch, odd extents
        (2, 40, 36, 8),  # JAX input-dilated conv branch (> 32x32)
        (4, 6, 5, 8),    # f=4
    ],
)
def test_bilinear_upsample_matches_jax(f, h, w, c):
    """Random (unsymmetric) kernels, so a missing spatial flip shows; 1e-5."""
    rng = np.random.RandomState(f * 100 + h)
    x = rng.randn(2, h, w, c).astype(np.float32)
    k = rng.randn(2 * f, 2 * f, 1, c).astype(np.float32)
    want = np.asarray(jl.BilinearUpsample(factor=f).apply(
        {"params": {"kernel": jnp.asarray(k)}}, jnp.asarray(x)))
    port = tl.BilinearUpsample(c, f)
    port.load_state_dict(_under("up_1", {"params": {"kernel": k}}))
    with torch.no_grad():
        got = port(_nchw(x))
    assert got.shape == (2, c, f * h, f * w)
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-5, atol=1e-5)


def test_bilinear_init_matches_jax():
    """The port's default init is the JAX package's bilinear stencil."""
    for f in (2, 4):
        want = jl._bilinear_kernel(f)
        got = tl.BilinearUpsample(3, f).weight.detach().numpy()
        np.testing.assert_array_equal(got[1, 0], want)


def test_conv_bn_act_matches_jax_stride2():
    """Symmetric padding under stride 2 (flax SAME would pad asymmetrically),
    eval BatchNorm with random statistics; 1e-5."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, 9, 10, 4).astype(np.float32)
    mod = jl.ConvBnAct(6, strides=2)
    variables = jax.tree_util.tree_map(np.asarray, mod.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    variables["params"]["conv"]["kernel"] = rng.randn(3, 3, 4, 6).astype(np.float32)
    variables["batch_stats"]["bn"]["mean"] = rng.randn(6).astype(np.float32)
    variables["batch_stats"]["bn"]["var"] = rng.uniform(0.5, 2, 6).astype(np.float32)
    want = np.asarray(mod.apply(variables, jnp.asarray(x)))
    port = tl.ConvBnAct(4, 6, 3, stride=2)
    sd = _under("project", variables)  # project.0 = conv, project.1 = BN
    port.load_state_dict(sd)
    port.eval()
    with torch.no_grad():
        got = port(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-5, atol=1e-5)
