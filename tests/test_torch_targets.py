"""The port's CenterNet targets (``ops/target_gen.py``) against the JAX
package's ``gen_centernet_targets_batch`` on the same numpy boxes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from detectron2_centernet_tpu.ops.target_gen import gaussian_radius as jax_radius
from detectron2_centernet_tpu.ops.target_gen import gen_centernet_targets_batch
from detectron2_centernet_tpu_torch.ops.target_gen import gaussian_radius, gen_centernet_targets

C, OUT, DOWN = 4, 16, 4


def _boxes():
    """Two images, 6 slots: random boxes, an invalid slot, a zero-width box,
    a box on the image's edge, two objects of one class that overlap."""
    rng = np.random.RandomState(0)
    n, m = 2, 6
    xy = rng.uniform(0, 40, (n, m, 2))
    wh = rng.uniform(2, 30, (n, m, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, 63.0)], -1).astype(np.float32)
    classes = rng.randint(0, C, (n, m)).astype(np.int32)
    valid = np.ones((n, m), bool)
    valid[0, 5] = False                      # an invalid slot with a real-looking box
    boxes[0, 4, 2] = boxes[0, 4, 0]          # zero width
    boxes[1, 0] = [0.0, 0.0, 63.0, 9.5]      # on the image's edge
    boxes[1, 1] = [10.0, 10.0, 30.0, 26.0]   # two objects of one class
    boxes[1, 2] = [14.0, 12.0, 33.0, 30.0]
    classes[1, 1] = classes[1, 2] = 3
    return boxes, classes, valid


def test_gaussian_radius_matches_jax():
    """The three-root minimum with the "/2 on all roots" quirk, f32: 1e-6."""
    rng = np.random.RandomState(1)
    h, w = (np.ceil(rng.uniform(0, 40, (2, 50))).astype(np.float32))
    want = np.asarray(jax_radius(jnp.asarray(h), jnp.asarray(w)))
    got = gaussian_radius(torch.from_numpy(h), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_targets_match_jax():
    """hm exactly up to f32 exp (1e-6); wh, reg, ind and reg_mask exactly."""
    boxes, classes, valid = _boxes()
    want = gen_centernet_targets_batch(jnp.asarray(boxes), jnp.asarray(classes), jnp.asarray(valid),
                                       C, OUT, OUT, DOWN)
    got = gen_centernet_targets(torch.from_numpy(boxes), torch.from_numpy(classes),
                                torch.from_numpy(valid), C, OUT, OUT, DOWN)
    np.testing.assert_allclose(got["hm"].permute(0, 2, 3, 1).numpy(), np.asarray(want["hm"]), atol=1e-6)
    for k in ("wh", "reg", "reg_mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_array_equal(got["ind"].numpy(), np.asarray(want["ind"]))
    assert got["reg_mask"][0, 5] == 0 and got["reg_mask"][0, 4] == 0  # invalid, zero width
    # both objects of class 3 peak at 1 on one map: the per-class max
    hm3 = got["hm"][1, 3].flatten()
    assert hm3[got["ind"][1, 1]] == hm3[got["ind"][1, 2]] == 1.0


@pytest.mark.parametrize("down_ratio", [2, 4])
def test_targets_match_jax_dense_scene(down_ratio):
    """40 objects over 80 classes on a non-square map, every slot valid."""
    rng = np.random.RandomState(down_ratio)
    n, m, c = 1, 40, 80
    xy = rng.uniform(0, 90, (n, m, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(1, 40, (n, m, 2))], -1).astype(np.float32)
    classes = rng.randint(0, c, (n, m)).astype(np.int32)
    valid = np.ones((n, m), bool)
    oh, ow = 128 // down_ratio, 96 // down_ratio
    want = gen_centernet_targets_batch(jnp.asarray(boxes), jnp.asarray(classes), jnp.asarray(valid),
                                       c, oh, ow, down_ratio)
    got = gen_centernet_targets(torch.from_numpy(boxes), torch.from_numpy(classes),
                                torch.from_numpy(valid), c, oh, ow, down_ratio)
    np.testing.assert_allclose(got["hm"].permute(0, 2, 3, 1).numpy(), np.asarray(want["hm"]), atol=1e-6)
    np.testing.assert_array_equal(got["ind"].numpy(), np.asarray(want["ind"]))
    np.testing.assert_array_equal(got["wh"].numpy(), np.asarray(want["wh"]))
