"""The port on the card (marker ``cuda``): the Hopper DCN kernels (forward
and the four backward kernels) against their plain PyTorch versions, and the
small DLA-34 CenterNet on the card against itself on the CPU, at inference
and for one training step.

Every test decides inside itself whether there is a card and skips here,
where there is none. This file imports neither JAX nor the JAX package, so it
runs on the card's machine, which has neither (``tests/conftest.py`` imports
JAX, hence ``--noconftest``)::

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from detectron2_centernet_tpu_torch.config import get_cfg
from detectron2_centernet_tpu_torch.models import build_model
from detectron2_centernet_tpu_torch.ops import dcn
from detectron2_centernet_tpu_torch.ops import deform_conv as plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False  # f32 comparisons in true f32
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(seed, n=2, cin=48, cout=80, h=20, w=24, off=8.0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, cin, h, w, generator=g)
    offset = (torch.rand(n, 18, h, w, generator=g) * 2 - 1) * off
    mask = torch.rand(n, 9, h, w, generator=g)
    weight = torch.randn(cout, cin, 3, 3, generator=g) / (9 * cin) ** 0.5
    vec = lambda lo, hi: torch.rand(cout, generator=g) * (hi - lo) + lo
    return x, offset, mask, weight, dict(bias=vec(-1, 1), post_scale=vec(0.5, 1.5), post_shift=vec(-1, 1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("shape", [(48, 80, 20, 24), (16, 64, 7, 130), (64, 16, 33, 5)])
def test_kernel_matches_plain(card, dtype, epilogue, shape):
    """Ragged pixel and channel tiles, offsets up to ±8 px. f32: 1e-4 of the
    output's scale (f32 sums in another order). bf16: 1e-2 (the output's one
    bf16 rounding; a sample may round the other way at a tie)."""
    cin, cout, h, w = shape
    x, offset, mask, weight, vecs = _case(sum(shape), cin=cin, cout=cout, h=h, w=w)
    dt = getattr(torch, dtype)
    args = (x.to(card, dt), offset.to(card), mask.to(card), weight.to(card, dt))
    kw = {k: v.to(card) for k, v in vecs.items()}
    if epilogue:
        kw["post_relu"] = True
    else:
        del kw["post_scale"], kw["post_shift"]
    before = dcn.modulated_deform_conv.launches
    got = dcn.modulated_deform_conv(*args, **kw)
    torch.cuda.synchronize()
    assert dcn.modulated_deform_conv.launches == before + 1
    assert got.dtype == dt and got.shape == (2, cout, h, w)
    ref = dcn.modulated_deform_conv_plain(*args, **kw)
    err = (got.float() - ref.float()).abs().max().item()
    tol = 1e-4 if dtype == "float32" else 1e-2
    assert err <= tol * max(1.0, ref.float().abs().max().item()), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(48, 80, 20, 24), (16, 64, 7, 130), (64, 16, 33, 5)])
def test_backward_kernels_match_plain(card, dtype, shape):
    """K2 (dX), K3 (d offset, d mask), K4 (dW) and K5 (K3 + K4) at ragged
    pixel and channel tiles, offsets up to ±8 px, each within a tolerance
    relative to the gradient's max |value|: f32 1e-4 (sums in another order;
    dX, d offset and d mask through atomics), bf16 1e-2 (dX and dW round once
    to bf16; d offset and d mask stay f32)."""
    cin, cout, h, w = shape
    x, offset, mask, weight, _ = _case(sum(shape) + 1, cin=cin, cout=cout, h=h, w=w)
    dt = getattr(torch, dtype)
    g = torch.randn(2, cout, h, w, generator=torch.Generator().manual_seed(3))
    args = (x.to(card, dt), offset.to(card), mask.to(card), weight.to(card, dt), g.to(card, dt))
    tol = 1e-4 if dtype == "float32" else 1e-2
    counts = [f.launches for f in (dcn.dcn_bwd_dx, dcn.dcn_bwd_dq, dcn.dcn_bwd_dw, dcn.dcn_bwd_dqdw)]
    got = {
        "dx": dcn.dcn_bwd_dx(*args), "dq": dcn.dcn_bwd_dq(*args),
        "dw": dcn.dcn_bwd_dw(*args[:3], args[4]), "dqdw": dcn.dcn_bwd_dqdw(*args),
    }
    torch.cuda.synchronize()
    assert [f.launches for f in (dcn.dcn_bwd_dx, dcn.dcn_bwd_dq, dcn.dcn_bwd_dw,
                                 dcn.dcn_bwd_dqdw)] == [c + 1 for c in counts]
    want = {
        "dx": plain.dcn_bwd_dx(*args), "dq": plain.dcn_bwd_dq(*args),
        "dw": plain.dcn_bwd_dw(*args[:3], args[4]), "dqdw": plain.dcn_bwd_dqdw(*args),
    }
    for name in got:
        pairs = zip(*(t if isinstance(t, tuple) else (t,) for t in (got[name], want[name])))
        for a, b in pairs:
            assert a.dtype == b.dtype and a.shape == b.shape, name
            err = (a.float() - b.float()).abs().max().item()
            assert err <= tol * max(b.float().abs().max().item(), 1e-12), (name, err)


def _offsets(regime, n, h, w, seed):
    """Offsets of one regime: 0 (every sample on the grid, as training
    starts), about a pixel (normal, σ = 1 px) or uniform within ±40 px (most
    samples beyond K2's 8-pixel halo, many off the map)."""
    g = torch.Generator().manual_seed(seed)
    if regime == "zero":
        return torch.zeros(n, 18, h, w)
    if regime == "1px":
        return torch.randn(n, 18, h, w, generator=g)
    return (torch.rand(n, 18, h, w, generator=g) * 2 - 1) * 40.0


def _backward_args(card, dtype, cin, cout, h, w, n, regime, seed):
    x, _, mask, weight, _ = _case(seed, n=n, cin=cin, cout=cout, h=h, w=w)
    offset = _offsets(regime, n, h, w, seed + 1)
    g = torch.randn(n, cout, h, w, generator=torch.Generator().manual_seed(seed + 2))
    return (x.to(card, dtype), offset.to(card), mask.to(card), weight.to(card, dtype), g.to(card, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("regime", ["zero", "1px", "40px"])
@pytest.mark.parametrize("shape", [(20, 16, 13, 21), (40, 80, 9, 30), (24, 256, 17, 16)])
def test_backward_kernels_ragged_tiles_and_offsets(card, dtype, regime, shape):
    """Batch 3, H and W not multiples of K2's 8 x 8 tile, Cin not a multiple
    of the 16-channel chunk, Cout 16 / 80 / 256 (K3-K5 tile Cout by 64),
    offsets 0, about 1 px and ±40 px: K2-K5 against their plain versions,
    with the tolerances of ``test_backward_kernels_match_plain``."""
    cin, cout, h, w = shape
    dt = getattr(torch, dtype)
    args = _backward_args(card, dt, cin, cout, h, w, 3, regime, sum(shape))
    tol = 1e-4 if dtype == "float32" else 1e-2
    got = {"dx": dcn.dcn_bwd_dx(*args), "dq": dcn.dcn_bwd_dq(*args),
           "dw": dcn.dcn_bwd_dw(*args[:3], args[4]), "dqdw": dcn.dcn_bwd_dqdw(*args)}
    torch.cuda.synchronize()
    want = {"dx": plain.dcn_bwd_dx(*args), "dq": plain.dcn_bwd_dq(*args),
            "dw": plain.dcn_bwd_dw(*args[:3], args[4]), "dqdw": plain.dcn_bwd_dqdw(*args)}
    for name in got:
        pairs = zip(*(t if isinstance(t, tuple) else (t,) for t in (got[name], want[name])))
        for a, b in pairs:
            assert a.dtype == b.dtype and a.shape == b.shape, name
            err = (a.float() - b.float()).abs().max().item()
            assert err <= tol * max(b.float().abs().max().item(), 1e-12), (name, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dw_is_bit_identical_between_launches(card, dtype):
    """K4 and K5 reduce dW through per-split partials summed in a fixed
    order, with no atomics: two launches on the same inputs give the same
    bits."""
    args = _backward_args(card, getattr(torch, dtype), 40, 80, 20, 24, 3, "1px", 9)
    for run in (lambda: dcn.dcn_bwd_dw(*args[:3], args[4]), lambda: dcn.dcn_bwd_dqdw(*args)[2]):
        first, second = run(), run()
        torch.cuda.synchronize()
        assert torch.equal(first, second)


def test_autograd_function_launches_each_backward_kernel(card):
    """Through ``modulated_deform_conv_ad``: all four inputs need a gradient
    → K1, K2, K5; no weight gradient → K3; no offset/mask gradient → K4."""
    x, offset, mask, weight, _ = _case(5, cin=32, cout=32, h=16, w=16)
    fns = (dcn.modulated_deform_conv, dcn.dcn_bwd_dx, dcn.dcn_bwd_dq, dcn.dcn_bwd_dw, dcn.dcn_bwd_dqdw)
    for needs, want in (((1, 1, 1, 1), (1, 1, 0, 0, 1)), ((1, 1, 1, 0), (1, 1, 1, 0, 0)),
                        ((1, 0, 0, 1), (1, 1, 0, 1, 0))):
        ts = [t.to(card).requires_grad_(bool(n)) for t, n in zip((x, offset, mask, weight), needs)]
        before = [f.launches for f in fns]
        dcn.modulated_deform_conv_ad(*ts).square().sum().backward()
        torch.cuda.synchronize()
        assert tuple(f.launches - b for f, b in zip(fns, before)) == want, needs


def test_small_train_step_on_card_matches_cpu(card):
    """One f32 training step of the small CenterNet (random offset convs,
    TF32 off) on the card and on the CPU: the loss terms to 1e-4 relative,
    every parameter's gradient within 1e-2 of its max |value| plus 5e-4 of
    the largest gradient (train-mode BatchNorm over small maps magnifies f32
    rounding; the DCN biases' true gradient is 0). One step launches 16 of
    K1, K2 and K5."""
    cfg = _small_cfg()
    host = build_model(cfg)
    _randomize(host)
    with torch.no_grad():  # offsets of under a pixel: gradients stay well conditioned
        for name, t in host.model.named_parameters():
            if "conv_offset_mask.weight" in name:
                t.mul_(0.01)
    cfg.MODEL.DEVICE = "cuda"
    dev = build_model(cfg)
    dev.model.load_state_dict(host.model.state_dict())
    rng = np.random.RandomState(1)
    batch = {
        "image": torch.from_numpy(rng.uniform(0, 255, (2, 3, 64, 64)).astype(np.float32)),
        "gt_boxes": torch.tensor([[[4.0, 6.0, 30.0, 40.0], [20.0, 8.0, 60.0, 30.0]]] * 2),
        "gt_classes": torch.tensor([[1, 3]] * 2),
        "gt_valid": torch.tensor([[True, True], [True, False]]),
    }
    fns = (dcn.modulated_deform_conv, dcn.dcn_bwd_dx, dcn.dcn_bwd_dqdw)
    before = [f.launches for f in fns]
    out = {}
    for name, m in (("cuda", dev), ("cpu", host)):
        m.model.train()
        total, losses = m.loss_fn({k: v.to(m.device) for k, v in batch.items()})
        total.backward()
        out[name] = (losses, {k: p.grad.cpu() for k, p in m.model.named_parameters() if p.grad is not None})
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(fns, before)] == [16, 16, 16]
    for k, v in out["cpu"][0].items():
        assert abs(out["cuda"][0][k].item() - v.item()) <= 1e-4 * abs(v.item()), k
    grads = out["cpu"][1]
    assert set(out["cuda"][1]) == set(grads)
    floor = 5e-4 * max(g.abs().max().item() for g in grads.values())
    for k, g in grads.items():
        err = (out["cuda"][1][k] - g).abs().max().item()
        assert err <= 1e-2 * g.abs().max().item() + floor, k


def _small_cfg():
    cfg = get_cfg()
    cfg.merge_from_list([
        "MODEL.META_ARCHITECTURE", "CenterNet", "MODEL.BACKBONE.NAME", "build_dla34_backbone",
        "MODEL.CENTERNET.CHANNELS", [8, 8, 16, 16, 32, 32], "MODEL.CENTERNET.HEAD_CONV", 16,
        "MODEL.CENTERNET.TASK.HM", 4, "TPU.DTYPE", "float32", "MODEL.DEVICE", "cpu",
    ])
    return cfg


def _randomize(model):
    """Random offset convs (offsets of about a pixel) and BN statistics."""
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, t in model.model.state_dict().items():
            if "conv_offset_mask" in name or "running" in name:
                t.copy_(torch.rand(t.shape, generator=g) * (0.5 if "mask" in name else 1.0)
                        + (0.5 if "running_var" in name else 0.0))


def test_small_centernet_on_card_matches_cpu(card):
    """The small DLA-34 CenterNet in f32 (random offset convs and BN
    statistics): one forward makes 16 kernel launches, and its heads agree
    with the CPU model's to 1e-3 of their scale."""
    cfg = _small_cfg()
    host = build_model(cfg)
    _randomize(host)
    cfg.MODEL.DEVICE = "cuda"
    dev = build_model(cfg)
    dev.model.load_state_dict(host.model.state_dict())
    x = torch.from_numpy(np.random.RandomState(0).uniform(0, 255, (2, 3, 64, 64)).astype(np.float32))
    before = dcn.modulated_deform_conv.launches
    with torch.inference_mode():
        zd = dev.model(dev.normalize(x))
        zh = host.model(host.normalize(x))
    assert dcn.modulated_deform_conv.launches == before + 16
    for k in ("hm", "wh", "reg"):
        scale = max(1.0, zh[k].abs().max().item())
        assert (zd[k].cpu() - zh[k]).abs().max().item() <= 1e-3 * scale, k
