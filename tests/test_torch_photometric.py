"""The port's color jitter (``ops/photometric.py``) against the JAX
package's ``device_color_jitter``: the port's deterministic core is fed the
draws JAX makes from its key, so the two compute the same function."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from detectron2_centernet_tpu.ops.photometric import device_color_jitter as jax_jitter
from detectron2_centernet_tpu_torch.ops.photometric import color_jitter, device_color_jitter


def _jax_draws(key, n, prob=0.4, lo=0.8, hi=1.2, lighting_scale=0.1):
    """JAX's draws, as its function makes them from ``key``: gated factors
    and the gated lighting weights."""
    ks = jax.random.split(key, 8)
    u = lambda k: np.asarray(jax.random.uniform(k, (n, 1, 1, 1), minval=lo, maxval=hi))[:, 0, 0, 0]
    gate = lambda k: (np.asarray(jax.random.uniform(k, (n, 1, 1, 1)))[:, 0, 0, 0] < prob).astype(np.float32)
    factor = lambda g, d: 1.0 + g * (d - 1.0)
    alpha = np.asarray(jax.random.normal(ks[6], (n, 3))) * lighting_scale * gate(ks[7])[:, None]
    return (factor(gate(ks[0]), u(ks[1])), factor(gate(ks[2]), u(ks[3])),
            factor(gate(ks[4]), u(ks[5])), alpha)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_core_on_jax_draws_matches_jax(seed):
    """8 images of 0..255 noise: the jittered batches agree to 1e-4 of 255
    (f32 sums in another order)."""
    n = 8
    images = np.random.RandomState(seed).uniform(0, 255, (n, 12, 10, 3)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_jitter(jnp.asarray(images), key))
    draws = [torch.from_numpy(np.asarray(d, np.float32)) for d in _jax_draws(key, n)]
    got = color_jitter(torch.from_numpy(images.transpose(0, 3, 1, 2).copy()), *draws)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-4 * 255)


def test_core_identity_draws_return_images():
    images = torch.rand(2, 3, 5, 4) * 255
    one, zero = torch.ones(2), torch.zeros(2, 3)
    torch.testing.assert_close(color_jitter(images, one, one, one, zero), images)


def test_generator_draws_are_gated_and_seeded():
    """The wrapper: the same generator seed gives the same batch; over 400
    images about 40% of each jitter fires (gates at prob 0.4), and the
    factors stay inside [0.8, 1.2]."""
    images = torch.full((400, 3, 2, 2), 100.0)
    out1 = device_color_jitter(images, torch.Generator().manual_seed(3))
    out2 = device_color_jitter(images, torch.Generator().manual_seed(3))
    torch.testing.assert_close(out1, out2)
    # a flat gray image: contrast and saturation leave it, brightness scales it,
    # lighting shifts its channels apart
    ratio = out1.mean((1, 2, 3)) / 100.0
    changed = (out1 - images).abs().amax((1, 2, 3)) > 1e-3
    assert 0.55 < changed.float().mean().item() < 0.8  # 1 - 0.6 * 0.6 = 0.64
    assert ((ratio > 0.8 - 0.05) & (ratio < 1.2 + 0.05)).all()
