"""The port's DCNv2 forward (``detectron2_centernet_tpu_torch/ops``) against
the JAX package.

On the CPU the wrapper runs its plain PyTorch version; it is held against the
JAX exact op, the float64 loop reference, and the Pallas kernel (interpreted)
where the vertical offsets stay inside that kernel's |dy| <= 3 band. The
Hopper kernel itself is held against the plain version on the card, in
``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from detectron2_centernet_tpu.ops.deform_conv import modulated_deform_conv as jax_dcn
from detectron2_centernet_tpu.ops.pallas_dcn import dcn_conv_pallas
from detectron2_centernet_tpu_torch.ops import dcn
from ops.naive_ref import naive_modulated_deform_conv


def _case(seed, n=2, h=12, w=16, cin=8, cout=16, dy=2.8, dx=8.0):
    """NHWC inputs as the JAX package takes them."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, cin).astype(np.float32)
    off = np.empty((n, h, w, 18), np.float32)
    off[..., 0::2] = rng.uniform(-dy, dy, (n, h, w, 9))
    off[..., 1::2] = rng.uniform(-dx, dx, (n, h, w, 9))
    mask = rng.rand(n, h, w, 9).astype(np.float32)
    weight = (rng.randn(3, 3, cin, cout) * 0.2).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    scale = (np.abs(rng.randn(cout)) + 0.1).astype(np.float32)
    shift = rng.randn(cout).astype(np.float32)
    return x, off, mask, weight, bias, scale, shift


def _nchw(x, off, mask, weight):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))
    return t(x), t(off), t(mask), torch.from_numpy(np.ascontiguousarray(weight.transpose(3, 2, 0, 1)))


def _nhwc(y):
    return y.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("with_bias", [False, True])
def test_plain_matches_jax_exact_op(with_bias):
    """Offsets up to ±8 px, so samples leave the image; f32 on both sides,
    tolerance 1e-4 (f32 sums over 9·Cin = 72 terms in another order)."""
    x, off, mask, weight, bias, _, _ = _case(0, dy=8.0)
    b = bias if with_bias else None
    want = np.asarray(jax_dcn(jnp.asarray(x), jnp.asarray(off), jnp.asarray(mask),
                              jnp.asarray(weight), None if b is None else jnp.asarray(b)))
    got = dcn.modulated_deform_conv(*_nchw(x, off, mask, weight),
                                    None if b is None else torch.from_numpy(b))
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-4, atol=1e-4)


def test_plain_matches_naive_loop_reference():
    """Against the float64 loop of ``tests/ops/naive_ref.py``: 1e-4."""
    x, off, mask, weight, bias, _, _ = _case(1, n=1, h=6, w=7, cin=3, cout=4, dy=3.0, dx=3.0)
    want = naive_modulated_deform_conv(x, off, mask, weight, bias)
    got = dcn.modulated_deform_conv(*_nchw(x, off, mask, weight), torch.from_numpy(bias))
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("relu", [False, True])
def test_plain_epilogue_matches_pallas_kernel_in_band(relu):
    """The fused epilogue (``out * scale + shift``, ReLU) against the TPU
    kernel run interpreted, with |dy| <= 2.8 (inside its band; beyond it the
    TPU kernel drops samples and the port does not) and |dx| <= 8: 1e-4."""
    x, off, mask, weight, _, scale, shift = _case(2)
    want = np.asarray(dcn_conv_pallas(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(mask), jnp.asarray(weight), None,
        v_window=3, interpret=True, post_scale=jnp.asarray(scale),
        post_shift=jnp.asarray(shift), post_relu=relu,
    ))
    got = dcn.modulated_deform_conv(
        *_nchw(x, off, mask, weight), post_scale=torch.from_numpy(scale),
        post_shift=torch.from_numpy(shift), post_relu=relu,
    )
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-4, atol=1e-4)


def test_plain_bf16_follows_f32():
    """bf16 x and weight: samples and weights round to bf16 (8 bits of
    mantissa) before an f32 accumulation, so the output is within 2e-2 of
    the f32 result relative to its scale."""
    x, off, mask, weight, bias, _, _ = _case(3)
    xt, ot, mt, wt = _nchw(x, off, mask, weight)
    ref = dcn.modulated_deform_conv(xt, ot, mt, wt, torch.from_numpy(bias))
    got = dcn.modulated_deform_conv(xt.bfloat16(), ot, mt, wt.bfloat16(), torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    err = (got.float() - ref).abs().max().item()
    assert err <= 2e-2 * ref.abs().max().item(), err


def test_cpu_tensor_leaves_launch_counter_at_zero():
    x, off, mask, weight, _, scale, shift = _case(4)
    before = dcn.modulated_deform_conv.launches
    dcn.modulated_deform_conv(*_nchw(x, off, mask, weight), post_scale=torch.from_numpy(scale),
                              post_shift=torch.from_numpy(shift), post_relu=True)
    assert dcn.modulated_deform_conv.launches == before == 0


@pytest.mark.parametrize("bad", ["offset_shape", "weight_dtype", "mask_dtype", "noncontig"])
def test_wrapper_rejects_bad_inputs(bad):
    xt, ot, mt, wt = _nchw(*_case(5)[:4])
    if bad == "offset_shape":
        ot = ot[:, :9]
    elif bad == "weight_dtype":
        wt = wt.double()
    elif bad == "mask_dtype":
        mt = mt.bfloat16()
    else:
        xt = xt.transpose(2, 3).contiguous().transpose(2, 3)  # same shape, strided
    with pytest.raises(ValueError):
        dcn.modulated_deform_conv(xt, ot, mt, wt)
