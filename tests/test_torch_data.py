"""The port's eval-time geometry (``detectron2_centernet_tpu_torch/data``)
against the JAX package's: the letterbox matrix, the box un-warp, and the
image warp, which the JAX package does with ``cv2.warpAffine`` and the port
with bilinear sampling in PyTorch (zero fill outside the source)."""

import numpy as np
import pytest
import torch

from detectron2_centernet_tpu.data import detection_utils as jdu
from detectron2_centernet_tpu.data.transforms import letterbox_transform as jax_letterbox
from detectron2_centernet_tpu_torch.data import (
    get_affine_transform,
    letterbox_transform,
    unwarp_boxes,
    warp_image,
)


@pytest.mark.parametrize("h,w", [(50, 70), (97, 31), (480, 640), (512, 512)])
def test_letterbox_warp_matches_cv2(h, w):
    """uint8 images of random pixels (the steepest gradients there are) under
    the ctdet letterbox. cv2 may place a sample up to 1/64 px away (it
    quantizes positions to 1/32 px); here it agrees to 1e-3 of the 0..255
    range (f32 coordinate rounding), and the test allows 1e-2."""
    img = np.random.RandomState(h).randint(0, 256, (h, w, 3)).astype(np.uint8)
    m = letterbox_transform(h, w, (96, 96))
    np.testing.assert_array_equal(m, jax_letterbox(h, w, (96, 96)))
    want = jdu.warp_image(img.astype(np.float32), m, (96, 96))
    got = warp_image(img, m, (96, 96))
    assert got.dtype == torch.float32 and got.shape == (96, 96, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-2)


@pytest.mark.parametrize(
    "center,scale,out",
    [((29.3, 17.7), 47.9, (96, 80)), ((10.1, 33.3), 123.4, (64, 64)), ((30.0, 20.0), 60.0, (128, 128))],
)
def test_affine_warp_matches_cv2(center, scale, out):
    """Off-centre crops, up- and down-scaling, samples beyond the border."""
    img = np.random.RandomState(0).randint(0, 256, (40, 60, 3)).astype(np.float32)
    m = get_affine_transform(np.array(center), scale, out)
    np.testing.assert_array_equal(m, jdu.get_affine_transform(np.array(center), scale, out))
    np.testing.assert_allclose(warp_image(img, m, out).numpy(), jdu.warp_image(img, m, out),
                               rtol=0, atol=1e-2)


def test_unwarp_boxes_matches_jax():
    rng = np.random.RandomState(1)
    m = letterbox_transform(300, 500, (512, 512))
    boxes = np.sort(rng.uniform(0, 512, (7, 2, 2)), axis=1).reshape(7, 4)  # x0 y0 x1 y1
    np.testing.assert_allclose(unwarp_boxes(m, boxes), jdu.unwarp_boxes(m, boxes), rtol=1e-12)
    assert unwarp_boxes(m, np.zeros((0, 4))).shape == (0, 4)
