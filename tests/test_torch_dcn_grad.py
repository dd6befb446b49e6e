"""The DCN backward of the port on the CPU: the plain versions of the four
backward kernels (``ops/deform_conv.py``: K2 dX, K3 d offset / d mask, K4 dW,
K5 = K3 + K4) and the autograd Function (``ops/dcn.py``) that routes them,
held against torch autograd of the plain forward, ``jax.grad`` of the JAX
exact op (off-integer), the JAX Pallas VJP run interpreted (inside its
|dy| <= 3 band, fused and split backward), and a right finite difference at
integer sample positions, where the JAX paths disagree (ROADMAP C1)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from detectron2_centernet_tpu.ops.deform_conv import modulated_deform_conv as jax_dcn
from detectron2_centernet_tpu.ops.pallas_dcn import dcn_conv_pallas_ad
from detectron2_centernet_tpu_torch.ops import dcn
from detectron2_centernet_tpu_torch.ops import deform_conv as plain


def _case(seed, n=2, h=10, w=12, cin=8, cout=16, dy=6.0, dx=6.0, integer=False):
    """NHWC inputs as JAX takes them, and a cotangent g; offsets off-integer
    (or exactly 0)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, cin).astype(np.float32)
    off = np.empty((n, h, w, 18), np.float32)
    off[..., 0::2] = rng.uniform(-dy, dy, (n, h, w, 9))
    off[..., 1::2] = rng.uniform(-dx, dx, (n, h, w, 9))
    if integer:
        off[:] = 0.0
    mask = rng.rand(n, h, w, 9).astype(np.float32)
    weight = (rng.randn(3, 3, cin, cout) * 0.2).astype(np.float32)
    g = rng.randn(n, h, w, cout).astype(np.float32)
    return x, off, mask, weight, g


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _port(x, off, mask, weight, g):
    return _t(x), _t(off), _t(mask), torch.from_numpy(np.ascontiguousarray(weight.transpose(3, 2, 0, 1))), _t(g)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _hwio(t):
    return t.permute(2, 3, 1, 0).numpy()


def _plain_grads(args):
    """The four plain backward kernels: (dx, doffset, dmask, dw) NCHW / OIHW."""
    x, off, mask, weight, g = args
    doff, dmask = plain.dcn_bwd_dq(x, off, mask, weight, g)
    doff5, dmask5, dw5 = plain.dcn_bwd_dqdw(x, off, mask, weight, g)
    dw = plain.dcn_bwd_dw(x, off, mask, g)
    for a, b in ((doff, doff5), (dmask, dmask5), (dw, dw5)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)  # K5 is K3 + K4
    return plain.dcn_bwd_dx(x, off, mask, weight, g), doff, dmask, dw


def _assert_close(got, want, tol, name):
    scale = max(np.abs(want).max(), 1e-6)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{name}: max error {err:.3e} > {tol} x {scale:.3e}"


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_backward_equals_autograd_of_plain_forward(seed):
    """f32: the explicit kernels' plain versions are the gradient of the
    plain forward (1e-5 of each gradient's max |value|: sums in another
    order), offsets up to ±6 px so samples leave the image."""
    args = _port(*_case(seed))
    x, off, mask, weight, g = [a.clone() for a in args]
    for t in (x, off, mask, weight):
        t.requires_grad_()
    out = plain.modulated_deform_conv(x, off, mask, weight)
    want = torch.autograd.grad(out, (x, off, mask, weight), g)
    for name, a, b in zip(("dx", "doffset", "dmask", "dw"), _plain_grads(args), want):
        _assert_close(a.numpy(), b.numpy(), 1e-5, name)


def test_plain_backward_matches_jax_exact_op():
    """Against ``jax.vjp`` of the JAX exact op (window 0) off-integer, f32:
    1e-4 of each gradient's max |value|."""
    x, off, mask, weight, g = _case(2)
    _, vjp = jax.vjp(lambda *a: jax_dcn(*a), *map(jnp.asarray, (x, off, mask, weight)))
    want = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    dx, doff, dmask, dw = _plain_grads(_port(x, off, mask, weight, g))
    for name, got, w in zip(("dx", "doffset", "dmask", "dw"),
                            (_nhwc(dx), _nhwc(doff), _nhwc(dmask), _hwio(dw)), want):
        _assert_close(got, w, 1e-4, name)


@pytest.mark.parametrize("fused", ["1", "0"])
def test_backward_matches_pallas_vjp_in_band(monkeypatch, fused):
    """Against the TPU kernels' VJP run interpreted, |dy| <= 2.5 (inside
    its band), with the fused dq+dw kernel (``PALLAS_DCN_FUSED_BWD=1``, K5)
    and the split kernels (``0``, K3 + K4): 1e-4 of each gradient's scale."""
    monkeypatch.setenv("PALLAS_DCN_FUSED_BWD", fused)
    x, off, mask, weight, g = _case(3, n=1, h=8, w=32, cin=8, cout=8, dy=2.5, dx=4.0)
    _, vjp = jax.vjp(lambda *a: dcn_conv_pallas_ad(*a, v_window=3, interpret=True),
                     *map(jnp.asarray, (x, off, mask, weight)))
    want = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    args = [t.requires_grad_() for t in _port(x, off, mask, weight, g)[:4]]
    out = dcn.modulated_deform_conv_ad(*args)
    out.backward(_port(x, off, mask, weight, g)[4])
    got = (_nhwc(args[0].grad), _nhwc(args[1].grad), _nhwc(args[2].grad), _hwio(args[3].grad))
    for name, a, w in zip(("dx", "doffset", "dmask", "dw"), got, want):
        _assert_close(a, w, 1e-4, name)


def test_doffset_is_the_right_derivative_at_integer_positions():
    """Zero offsets (the init): every sample on the grid. d offset equals the
    right finite difference (the loss is linear in the offset on [0, 0.25),
    so only f32 rounding remains: 1e-3 of the scale) at 12 entries."""
    x, off, mask, weight, g = _port(*_case(4, n=1, h=6, w=7, cin=4, cout=4, integer=True))
    doff, _ = plain.dcn_bwd_dq(x, off, mask, weight, g)
    loss = lambda o: (plain.modulated_deform_conv(x, o, mask, weight) * g).double().sum().item()
    base = loss(off)
    rng = np.random.RandomState(5)
    scale = doff.abs().max().item()
    for _ in range(12):
        i = tuple(int(rng.randint(s)) for s in off.shape)
        bumped = off.clone()
        bumped[i] += 0.25
        fd = (loss(bumped) - base) / 0.25
        assert abs(doff[i].item() - fd) <= 1e-3 * scale, (i, doff[i].item(), fd)


@pytest.mark.parametrize("needs", ["all", "no_weight", "no_offset_mask", "x_only"])
def test_autograd_function_routes_kernels(monkeypatch, needs):
    """K2 whenever x needs a gradient; K5 when offset/mask and the weight do;
    K3 alone without the weight; K4 alone without offset and mask. The
    gradients equal the plain kernels', the bias gets its gradient from
    autograd, and each gradient is in its input's dtype."""
    calls = []
    for name in ("dcn_bwd_dx", "dcn_bwd_dq", "dcn_bwd_dw", "dcn_bwd_dqdw"):
        fn = getattr(dcn, name)
        monkeypatch.setattr(dcn, name, lambda *a, _fn=fn, _name=name: calls.append(_name) or _fn(*a))
    args = _port(*_case(6, n=1, h=6, w=9, cin=4, cout=8))
    x, off, mask, weight, g = [a.clone() for a in args]
    grad_of = {"all": (1, 1, 1, 1), "no_weight": (1, 1, 1, 0), "no_offset_mask": (1, 0, 0, 1),
               "x_only": (1, 0, 0, 0)}[needs]
    for t, need in zip((x, off, mask, weight), grad_of):
        t.requires_grad_(bool(need))
    bias = torch.randn(8, requires_grad=True)
    out = dcn.modulated_deform_conv_ad(x, off, mask, weight, bias)
    out.backward(g)
    want_calls = {"all": ["dcn_bwd_dx", "dcn_bwd_dqdw"], "no_weight": ["dcn_bwd_dx", "dcn_bwd_dq"],
                  "no_offset_mask": ["dcn_bwd_dx", "dcn_bwd_dw"], "x_only": ["dcn_bwd_dx"]}[needs]
    assert calls == want_calls
    torch.testing.assert_close(bias.grad, g.sum((0, 2, 3)))
    for t, want, need in zip((x, off, mask, weight), _plain_grads(args), grad_of):
        if need:
            assert t.grad.dtype == t.dtype
            torch.testing.assert_close(t.grad, want, rtol=1e-5, atol=1e-5)
        else:
            assert t.grad is None


def test_autograd_function_bf16_dtypes():
    """bf16 x and weight with f32 offset and mask (the train path's types):
    dX and dW come back bf16, d offset and d mask f32, within 2e-2 of the
    f32 gradients' scale."""
    args = _port(*_case(7, n=1, h=6, w=9, cin=8, cout=8))
    ref = _plain_grads(args)
    x, off, mask, weight = args[0].bfloat16(), args[1].clone(), args[2].clone(), args[3].bfloat16()
    for t in (x, off, mask, weight):
        t.requires_grad_()
    dcn.modulated_deform_conv_ad(x, off, mask, weight).backward(args[4].bfloat16())
    for t, want, dtype in zip((x, off, mask, weight), ref,
                              (torch.bfloat16, torch.float32, torch.float32, torch.bfloat16)):
        assert t.grad.dtype == dtype
        _assert_close(t.grad.float().numpy(), want.numpy(), 2e-2, str(dtype))


def test_wrappers_reject_bad_cotangent():
    x, off, mask, weight, g = _port(*_case(8, n=1, h=5, w=5, cin=4, cout=4))
    with pytest.raises(ValueError):
        dcn.dcn_bwd_dx(x, off, mask, weight, g[:, :2])
    with pytest.raises(ValueError):
        dcn.dcn_bwd_dw(x, off, mask, g.bfloat16())


# DLA-34 at 512x512: the DCN shapes of one pass as (Cin, Cout, H = W)
_DLA_SHAPES = [(512, 256, 16), (256, 256, 32), (256, 128, 32), (256, 64, 32),
               (128, 128, 64), (128, 64, 64), (64, 64, 128)]


@pytest.mark.parametrize("n, cin, cout, h, w", [
    *[(b, cin, cout, hw, hw) for cin, cout, hw in _DLA_SHAPES for b in (1, 32)],
    (3, 20, 16, 13, 21), (3, 40, 80, 9, 30), (3, 24, 256, 17, 16), (1, 1, 1, 1, 1), (2, 48, 80, 20, 24),
])
def test_bwd_plan_spans_cover_every_tile_once(n, cin, cout, h, w):
    """The host-side plan of K3-K5 (``dcn.bwd_plan``): the spans of the
    splits cover each of the n·ceil(H·W / 64) pixel tiles exactly once, no
    span is empty (the kernel refuses a plan otherwise), and the grid is at
    least half of its aim of four blocks per SM wherever there are enough
    tiles, on a 132-SM and a 114-SM card."""
    for sms in (132, 114):
        plan = dcn.bwd_plan(n, cin, h, w, cout, sms=sms)
        tiles = n * -(-(h * w) // dcn.BWD_TILE_PIXELS)
        assert plan["tiles"] == tiles
        assert plan["chunks"] == -(-cin // dcn.BWD_CHUNK_CHANNELS)
        assert plan["cout_tiles"] == -(-cout // dcn.BWD_COUT_TILE)
        span, splits = plan["span"], plan["splits"]
        owned = [t for s in range(splits) for t in range(s * span, min((s + 1) * span, tiles))]
        assert sorted(owned) == list(range(tiles)) and len(owned) == tiles
        assert (splits - 1) * span < tiles <= splits * span
        base = plan["chunks"] * plan["cout_tiles"]
        aim = min(dcn.BWD_BLOCKS_PER_SM * sms, base * tiles)
        assert base * splits >= aim / 2 or base >= aim
