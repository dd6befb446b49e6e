"""The port's CenterNet losses (``models/meta_arch/centernet.py``) and their
gradients against the JAX package's ``focal_loss``, ``reg_l1_loss`` and
``_resolve_alpha`` with ``jax.grad``, on the same numpy inputs. The port is
NCHW, JAX NHWC; the center index is y·W + x on both."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from detectron2_centernet_tpu.models.meta_arch import centernet as jax_cn
from detectron2_centernet_tpu_torch.models.meta_arch import centernet as port_cn

N, C, H, W, M = 2, 4, 8, 10, 5


def _heatmaps(seed, positives=True):
    rng = np.random.RandomState(seed)
    logits = rng.randn(N, H, W, C).astype(np.float32) * 2
    gt = rng.uniform(0, 0.99, (N, H, W, C)).astype(np.float32)
    if positives:
        gt[0, 1, 2, 3] = gt[1, 5, 7, 0] = gt[1, 0, 0, 2] = 1.0
    return logits, gt


def _t(a):  # NHWC → NCHW tensor
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("positives", [True, False])
@pytest.mark.parametrize("alpha", [[1.0], [0.5, 2.0]])
def test_focal_loss_and_grad_match_jax(positives, alpha):
    """Value and d loss / d logits, f32: 1e-5 relative (with no positive the
    loss is the negative sum alone)."""
    logits, gt = _heatmaps(0, positives)
    a = jax_cn._resolve_alpha(alpha, C)
    np.testing.assert_array_equal(port_cn._resolve_alpha(alpha, C), a)
    f = lambda z: jax_cn.focal_loss(z, jnp.asarray(gt), jnp.asarray(a))
    want, want_g = jax.value_and_grad(f)(jnp.asarray(logits))
    z = _t(logits).requires_grad_()
    got = port_cn.focal_loss(z, _t(gt), torch.from_numpy(a))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(z.grad.permute(0, 2, 3, 1).numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-5 * np.abs(np.asarray(want_g)).max())


def test_resolve_alpha_pads_and_cuts():
    for cfg in (0.25, [1.0, 2.0], [1.0, 2.0, 3.0, 4.0, 5.0]):
        np.testing.assert_array_equal(port_cn._resolve_alpha(cfg, C), jax_cn._resolve_alpha(cfg, C))


def test_reg_l1_loss_and_grad_match_jax():
    """Masked L1 at y·W + x, invalid slots masked; value and gradient 1e-6."""
    rng = np.random.RandomState(2)
    out = rng.randn(N, H, W, 2).astype(np.float32)
    ind = rng.randint(0, H * W, (N, M)).astype(np.int32)
    ind[1, 3] = ind[1, 1]  # two objects on one center: the gradient adds up
    mask = (rng.rand(N, M) > 0.3).astype(np.float32)
    target = rng.uniform(0, 5, (N, M, 2)).astype(np.float32)
    f = lambda o: jax_cn.reg_l1_loss(o, jnp.asarray(mask), jnp.asarray(ind), jnp.asarray(target))
    want, want_g = jax.value_and_grad(f)(jnp.asarray(out))
    o = _t(out).requires_grad_()
    got = port_cn.reg_l1_loss(o, torch.from_numpy(mask), torch.from_numpy(ind).long(),
                              torch.from_numpy(target))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(o.grad.permute(0, 2, 3, 1).numpy(), np.asarray(want_g), atol=1e-6)
