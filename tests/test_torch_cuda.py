"""The port on the card (marker ``cuda``): the Hopper DCN kernels (forward
and the four backward kernels) against their plain PyTorch versions (at
stride 1 and 2, dilation 1 and 2, with and without a mask too, and a
stride-3 call raising), the
small DLA-34 CenterNet on the card against itself on the CPU, at inference
and for one training step, the f32 heads at PyTorch's default TF32 flags,
a short evaluation through ``DefaultTrainer.test``, one f32 training
step of small ResNet- and VoVNet-deconv CenterNets (card against CPU, and
at the default TF32 flags against TF32 off), a small RetinaNet's heads,
loss and detections and the port's NMS, card against CPU, the NMS kernels
(``ops/csrc/nms.cu``) against their plain loop and the algorithm's mirror at
the RetinaNet, RPN, box head and LVIS shapes and on rows that take two
or more chunks (disjoint and clustered boxes), a small Faster R-CNN's RPN heads, losses and detections,
card against CPU, the mask paste, the keypoint decode and a small R-CNN
with the mask and keypoint heads, card against CPU, and a small Semantic FPN
and Panoptic FPN (logits, losses, gradients, the label maps and the
panoptic merge on the card), card against CPU; small DeepLab V3 and V3+
networks, and PointRend's point head, subdivision, training losses and
semantic head, card against CPU; the rotated IoU kernel
(``ops/csrc/iou_rotated.cu``) and the rotated NMS (``nms.cu``'s rotated
pipeline) against their plain versions on random, degenerate, matching-
and sampling-shaped pairs and on RPN-like, ragged, all-suppressed,
multi-chunk and per-class rows; K1 and the NMS as ``torch.library``
custom ops under ``opcheck`` with their CUDA implementations, and a narrow
ctdet exported, saved, loaded and run on the card against eager.

Every test decides inside itself whether there is a card and skips here,
where there is none. This file imports neither JAX nor the JAX package, so it
runs on the card's machine, which has neither (``tests/conftest.py`` imports
JAX, hence ``--noconftest``)::

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py
"""

import json
import math

import numpy as np
import pytest
import torch

from detectron2_centernet_tpu_torch.config import get_cfg
from detectron2_centernet_tpu_torch.data import DatasetCatalog
from detectron2_centernet_tpu_torch.data.datasets import register_synthetic_instances
from detectron2_centernet_tpu_torch.engine import DefaultTrainer
from detectron2_centernet_tpu_torch.evaluation import COCOEval
from detectron2_centernet_tpu_torch.models import build_model
from detectron2_centernet_tpu_torch.models.layers import ieee_f32
from detectron2_centernet_tpu_torch.ops.fast_cocoeval import FastCOCOEval
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


# (n, Cin, Cout, H, W, route of dcn.fwd_plan on the card)
_FWD_ROUTES = [
    (1, 64, 64, 16, 16, "split"),  # 4 pixel tiles: a split per channel chunk
    (2, 256, 256, 32, 32, "split"),  # the 256-row Cout tile
    (2, 32, 64, 95, 97, "whole"),  # 312 blocks: one split, the epilogue in the main kernel; ragged tiles
    (1, 24, 320, 13, 21, "split"),  # Cin 24; Cout 320: two Cout tiles repeat the gather
    (40, 24, 320, 13, 21, "whole"),  # the Cout-tile fallback with one split
    (3, 40, 80, 9, 30, "split"),  # Cout 80: a ragged 128-row slab
]


def _fwd_args(card, dtype, n, cin, cout, h, w, regime, seed):
    x, _, mask, weight, vecs = _case(seed, n=n, cin=cin, cout=cout, h=h, w=w)
    offset = _offsets(regime, n, h, w, seed + 1)
    args = (x.to(card, dtype), offset.to(card), mask.to(card), weight.to(card, dtype))
    return args, {k: v.to(card) for k, v in vecs.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("regime", ["zero", "1px", "8px", "40px"])
@pytest.mark.parametrize("n, cin, cout, h, w, route", _FWD_ROUTES)
def test_kernel_routes_match_plain(card, dtype, epilogue, regime, n, cin, cout, h, w, route):
    """K1 on each route of ``dcn.fwd_plan`` (split partials summed by the
    second kernel, or one split with the epilogue in the main kernel), the
    Cout-tile fallback (Cout 320) and a ragged slab (Cout 80), Cin 24,
    ragged pixel tiles, offsets 0, ~1, ±8 and ±40 px, with and without the
    epilogue, against the plain version: f32 within 1e-4 of the output's
    scale, bf16 within 1e-2 (the one rounding of the output)."""
    dt = getattr(torch, dtype)
    plan = dcn.fwd_plan(n, cin, h, w, cout, torch.cuda.get_device_properties(0).multi_processor_count,
                        torch.tensor([], dtype=dt).element_size())
    assert (plan["splits"] > 1) == (route == "split"), plan
    args, vecs = _fwd_args(card, dt, n, cin, cout, h, w, regime, n + cin + cout + h)
    kw = dict(post_scale=vecs["post_scale"], post_shift=vecs["post_shift"], post_relu=True) if epilogue else {}
    got = dcn.modulated_deform_conv(*args, **kw)
    torch.cuda.synchronize()
    ref = dcn.modulated_deform_conv_plain(*args, **kw)
    assert got.dtype == dt and got.shape == (n, cout, h, w)
    err = (got.float() - ref.float()).abs().max().item()
    tol = 1e-4 if dtype == "float32" else 1e-2
    assert err <= tol * max(1.0, ref.float().abs().max().item()), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_is_bit_identical_between_launches(card, dtype):
    """K1 sums the splits' f32 partials in a fixed order, with no atomics:
    two launches at split shapes give the same bits."""
    for n, cin, cout, h, w, route in _FWD_ROUTES[:2]:
        args, vecs = _fwd_args(card, getattr(torch, dtype), n, cin, cout, h, w, "1px", 11)
        first = dcn.modulated_deform_conv(*args, bias=vecs["bias"])
        second = dcn.modulated_deform_conv(*args, bias=vecs["bias"])
        torch.cuda.synchronize()
        assert torch.equal(first, second)


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
    starts), about a pixel (normal, σ = 1 px), uniform within ±8 px or
    within ±40 px (most samples beyond K2's 8-pixel halo, many off the map)."""
    g = torch.Generator().manual_seed(seed)
    if regime == "zero":
        return torch.zeros(n, 18, h, w)
    if regime == "1px":
        return torch.randn(n, 18, h, w, generator=g)
    return (torch.rand(n, 18, h, w, generator=g) * 2 - 1) * {"8px": 8.0, "40px": 40.0}[regime]


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


# (Cin, Cout, H, W) of the DeformBottleneckBlock cases: odd, non-square maps
# (25 x 23 at stride 2 → 13 x 12), a ragged Cin chunk and Cout tile
_GEOMETRY_SHAPES = [(40, 80, 25, 23), (24, 320, 13, 17)]


def _geometry_args(card, dtype, cin, cout, h, w, stride, dilation, modulated, regime, seed, n=3):
    """x at H × W, offset, mask (None when not ``modulated``) and g at the
    output grid of ``stride``."""
    ho, wo = plain.out_size(h, w, stride)
    x, _, _, weight, vecs = _case(seed, n=n, cin=cin, cout=cout, h=h, w=w)
    offset = _offsets(regime, n, ho, wo, seed + 1)
    gen = torch.Generator().manual_seed(seed + 2)
    mask = torch.rand(n, 9, ho, wo, generator=gen).to(card) if modulated else None
    g = torch.randn(n, cout, ho, wo, generator=gen)
    return (x.to(card, dtype), offset.to(card), mask, weight.to(card, dtype), g.to(card, dtype)), vecs


def _assert_close(got, want, tol, name):
    for a, b in zip(*(t if isinstance(t, tuple) else (t,) for t in (got, want))):
        assert (a is None) == (b is None), name
        if a is None:
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        err = (a.float() - b.float()).abs().max().item()
        assert err <= tol * max(b.float().abs().max().item(), 1e-12), (name, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("modulated", [True, False])
@pytest.mark.parametrize("stride, dilation", [(1, 1), (2, 1), (1, 2), (2, 2)])
@pytest.mark.parametrize("regime", ["1px", "8px"])
@pytest.mark.parametrize("shape", _GEOMETRY_SHAPES)
def test_kernels_at_stride_dilation_and_unmodulated_match_plain(card, dtype, modulated, stride, dilation,
                                                                 regime, shape):
    """K1-K5 at stride 1 or 2, dilation 1 or 2, with a mask or without one
    (the DCNv1 of the ResNet trunks: no mask read, no d mask), against
    their plain versions with the tolerances of the stride-1 cases: f32
    1e-4, bf16 1e-2 of each output's max |value|. Each wrapper launches its
    kernel once."""
    cin, cout, h, w = shape
    dt = getattr(torch, dtype)
    args, vecs = _geometry_args(card, dt, cin, cout, h, w, stride, dilation, modulated, regime, sum(shape))
    geo = dict(stride=stride, dilation=dilation)
    tol = 1e-4 if dtype == "float32" else 1e-2
    fns = (dcn.modulated_deform_conv, dcn.dcn_bwd_dx, dcn.dcn_bwd_dq, dcn.dcn_bwd_dw, dcn.dcn_bwd_dqdw)
    before = [f.launches for f in fns]
    epi = dict(post_scale=vecs["post_scale"].to(card), post_shift=vecs["post_shift"].to(card), post_relu=True)
    got = {"fwd": dcn.modulated_deform_conv(*args[:4], **epi, **geo), "dx": dcn.dcn_bwd_dx(*args, **geo),
           "dq": dcn.dcn_bwd_dq(*args, **geo), "dw": dcn.dcn_bwd_dw(*args[:3], args[4], **geo),
           "dqdw": dcn.dcn_bwd_dqdw(*args, **geo)}
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(fns, before)] == [1] * 5
    want = {"fwd": plain.modulated_deform_conv(*args[:4], **epi, **geo), "dx": plain.dcn_bwd_dx(*args, **geo),
            "dq": plain.dcn_bwd_dq(*args, **geo), "dw": plain.dcn_bwd_dw(*args[:3], args[4], **geo),
            "dqdw": plain.dcn_bwd_dqdw(*args, **geo)}
    assert got["fwd"].shape[2:] == plain.out_size(h, w, stride)
    assert (got["dq"][1] is None) == (not modulated)
    for name in got:
        _assert_close(got[name], want[name], tol, name)


@pytest.mark.parametrize("stride, dilation", [(3, 1), (1, 3), (0, 1)])
def test_kernels_raise_at_a_geometry_they_do_not_take(card, stride, dilation):
    """A CUDA call at stride 3 or dilation 3 raises before any launch; it
    never falls back to the plain version."""
    ho, wo = plain.out_size(12, 12, max(stride, 1))
    x = torch.randn(1, 16, 12, 12, device=card)
    offset = torch.zeros(1, 18, ho, wo, device=card)
    weight = torch.randn(16, 16, 3, 3, device=card)
    g = torch.randn(1, 16, ho, wo, device=card)
    before = dcn.modulated_deform_conv.launches, dcn.dcn_bwd_dx.launches
    with pytest.raises(ValueError):
        dcn.modulated_deform_conv(x, offset, None, weight, stride=stride, dilation=dilation)
    with pytest.raises(ValueError):
        dcn.dcn_bwd_dx(x, offset, None, weight, g, stride=stride, dilation=dilation)
    assert (dcn.modulated_deform_conv.launches, dcn.dcn_bwd_dx.launches) == before


def test_unmodulated_autograd_launches_k1_k2_k5_and_gives_no_mask_gradient(card):
    """``modulated_deform_conv_ad`` with no mask at stride 2: K1, K2 and K5,
    the gradients against the plain version's autograd (f32, 1e-4)."""
    args, _ = _geometry_args(card, torch.float32, 32, 48, 21, 19, 2, 1, False, "1px", 4)
    x, offset, _, weight, g = args
    fns = (dcn.modulated_deform_conv, dcn.dcn_bwd_dx, dcn.dcn_bwd_dq, dcn.dcn_bwd_dw, dcn.dcn_bwd_dqdw)
    before = [f.launches for f in fns]
    ts = [t.clone().requires_grad_(True) for t in (x, offset, weight)]
    (dcn.modulated_deform_conv_ad(ts[0], ts[1], None, ts[2], stride=2) * g).sum().backward()
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(fns, before)] == [1, 1, 0, 0, 1]
    want = (plain.dcn_bwd_dx(x, offset, None, weight, g, 2), plain.dcn_bwd_dqdw(x, offset, None, weight, g, 2))
    _assert_close((ts[0].grad, ts[1].grad, ts[2].grad), (want[0], want[1][0], want[1][2]), 1e-4, "grads")


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


def test_f32_heads_at_default_tf32_flags_match_cpu(card):
    """ROADMAP C9: with cuDNN's TF32 flags at PyTorch's defaults (the
    fixture turns them off; this test turns them back on), ctdet DLA-34 at
    full width in f32 (128² input, random offset convs and BN statistics)
    keeps its convolutions in IEEE f32 through the model's own context: the
    heads within 1e-3 of their scale of the CPU's (chip_smoke.py's
    HEAD_TOL), and the process-wide flag is as the test left it."""
    cfg = _small_cfg()
    cfg.merge_from_list(["MODEL.CENTERNET.CHANNELS", [16, 32, 64, 128, 256, 512],
                         "MODEL.CENTERNET.HEAD_CONV", 256])
    host = build_model(cfg)
    _randomize(host)
    cfg.MODEL.DEVICE = "cuda"
    dev = build_model(cfg)
    dev.model.load_state_dict(host.model.state_dict())
    x = torch.from_numpy(np.random.RandomState(2).uniform(0, 255, (1, 3, 128, 128)).astype(np.float32))
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.inference_mode():
            zd = dev.model(dev.normalize(x))
            zh = host.model(host.normalize(x))
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    for k in ("hm", "wh", "reg"):
        scale = max(1.0, zh[k].abs().max().item())
        assert (zd[k].float().cpu() - zh[k]).abs().max().item() <= 1e-3 * scale, k


def test_evaluation_on_card(card, tmp_path):
    """DefaultTrainer.test on the card: 10 synthetic 48x64 images at batch 4
    (3 batches, the last short), the letterbox to 64², the small f32
    CenterNet. 16 K1 launches per batch, a complete bbox AP dict, finite
    but for the classes without a ground-truth box, and the COCO numbers of the card's detections equal, exactly,
    whether the C++ or the numpy evaluator computes them."""
    name = "test_torch_cuda_eval"
    if name not in DatasetCatalog:
        register_synthetic_instances(name, num_images=10, image_size=(48, 64))
    cfg = _small_cfg()
    cfg.merge_from_list(["MODEL.DEVICE", "cuda", "MODEL.CENTERNET.TASK.HM", 80, "DATASETS.TEST", (name,),
                         "INPUT.TEST_SIZE", (64, 64), "TEST.BATCH_SIZE", 4, "OUTPUT_DIR", str(tmp_path),
                         "MODEL.CENTERNET.SCORE_THRESH_TEST", 0.0])  # every one of the top 100 is a detection
    model = build_model(cfg)
    _randomize(model)
    with torch.no_grad():  # boxes of about 8 px: the random heads alone give empty ones
        model.model.wh[2].bias.fill_(8.0)
    before = dcn.modulated_deform_conv.launches
    results = DefaultTrainer.test(cfg, model)
    assert dcn.modulated_deform_conv.launches - before == 16 * 3
    bbox = results["bbox"]
    dets = json.loads((tmp_path / "coco_instances_results.json").read_text())
    gt = json.loads((tmp_path / f"{name}_coco_format.json").read_text())
    names = [c["name"] for c in gt["categories"]]
    present = {names[a["category_id"]] for a in gt["annotations"]}
    assert all(math.isfinite(bbox[k]) for k in ("AP", "AP50", "AP75", "APs", "APm", "APl"))
    # a class without a ground-truth box has a NaN AP, as in COCO
    assert all(math.isfinite(bbox[f"AP-{n}"]) == (n in present) for n in names)
    assert len(dets) > 0
    stats = []
    for cls in (FastCOCOEval, COCOEval):
        ev = cls(gt["annotations"], dets, [i["id"] for i in gt["images"]], [c["id"] for c in gt["categories"]])
        ev.evaluate()
        stats.append(ev.summarize())
    np.testing.assert_array_equal(stats[0], stats[1])
    assert stats[0][0] * 100 == bbox["AP"]


_SMALL_TRUNKS = {  # the ResNet and VoVNet CenterNets at narrow widths (64² input)
    "resnet18_bn": ["MODEL.BACKBONE.NAME", "build_resnet_deconv_backbone", "MODEL.RESNETS.DEPTH", 18,
                    "MODEL.RESNETS.RES2_OUT_CHANNELS", 16, "MODEL.RESNETS.STEM_OUT_CHANNELS", 8,
                    "MODEL.RESNETS.NORM", "BN", "MODEL.BACKBONE.FREEZE_AT", 0],
    "resnet50_frozen_bn": ["MODEL.BACKBONE.NAME", "build_resnet_backbone", "MODEL.RESNETS.DEPTH", 50,
                           "MODEL.RESNETS.RES2_OUT_CHANNELS", 32, "MODEL.RESNETS.STEM_OUT_CHANNELS", 8,
                           "MODEL.RESNETS.WIDTH_PER_GROUP", 8, "MODEL.CENTERNET.HEAD_CONV", 0],
    "vovnet19_slim": ["MODEL.BACKBONE.NAME", "build_vovnet_backbone", "MODEL.VOVNET.CONV_BODY", "V-19-slim-eSE"],
    "vovnet19_slim_dw": ["MODEL.BACKBONE.NAME", "build_vovnet_backbone",
                         "MODEL.VOVNET.CONV_BODY", "V-19-slim-dw-eSE"],
}
# The VoVNets' f32 gradients are ill-conditioned in these small random
# models: their f32 forward drifts far enough from f64 that some ReLUs after
# a BatchNorm flip, passing their cotangent in one run and blocking it in the
# other. On the CPU alone (tools/grad_conditioning.py, the port's init) f32
# against f64 flips 68 (slim-dw) and 2 (slim) of ~8e5 such ReLUs and moves
# the gradients by up to 35% and 2.6% of their scale; ResNet-18 flips none
# and stays within 1.1e-5. So their f32 gradients cannot be held to the
# CPU's; their losses and their TF32 check still are, and their gradients
# are held to the JAX package's in f64 on the CPU (test_torch_vovnet.py).
_F32_GRADIENTS_MEANINGLESS = {"vovnet19_slim", "vovnet19_slim_dw"}


@pytest.mark.parametrize("trunk", list(_SMALL_TRUNKS))
def test_small_trunk_train_step_on_card_matches_cpu(card, trunk):
    """One f32 training step of a small ResNet- or VoVNet-deconv CenterNet
    on the card, no DCN kernel launched. With cuDNN's TF32 flags at
    PyTorch's defaults the step equals the one with TF32 off (the model's
    ``ieee_f32`` context covers these trunks, and the backward runs under it
    as ``SimpleTrainer`` runs it): losses within 1e-6 relative, gradients
    within twice the difference between two TF32-off steps (cuDNN's backward
    is not bit-reproducible, and the depthwise VoVNet magnifies that to
    1.9e-4 of a gradient's scale) plus 1e-5 of their scale (a backward left
    in TF32 was measured 3e-4 to 1.6e-3 off on the ResNets). Against the CPU: the loss terms within 1e-3 relative, every
    gradient within 1e-2 of its max |value| plus 5e-4 of the largest
    gradient (cuDNN and oneDNN round f32 differently, magnified by
    train-mode BatchNorm over 4x4 maps of 32 values per channel: the
    depthwise VoVNet's off_loss was measured 3.0e-4 apart, the ResNets'
    losses within 6.5e-6); not for the VoVNets' gradients, which f32 cannot
    resolve in these models (``_F32_GRADIENTS_MEANINGLESS``)."""
    cfg = get_cfg()
    cfg.merge_from_list(["MODEL.META_ARCHITECTURE", "CenterNet", "MODEL.CENTERNET.HEAD_CONV", 16,
                         "MODEL.CENTERNET.TASK.HM", 4, "TPU.DTYPE", "float32", "MODEL.DEVICE", "cpu"]
                        + _SMALL_TRUNKS[trunk])
    host = build_model(cfg)
    cfg.MODEL.DEVICE = "cuda"
    rng = np.random.RandomState(2)
    batch = {
        "image": torch.from_numpy(rng.uniform(0, 255, (2, 3, 64, 64)).astype(np.float32)),
        "gt_boxes": torch.tensor([[[4.0, 6.0, 30.0, 40.0], [20.0, 8.0, 60.0, 30.0]]] * 2),
        "gt_classes": torch.tensor([[1, 3]] * 2),
        "gt_valid": torch.tensor([[True, True], [True, False]]),
    }
    fns = (dcn.modulated_deform_conv, dcn.dcn_bwd_dx, dcn.dcn_bwd_dq, dcn.dcn_bwd_dw, dcn.dcn_bwd_dqdw)
    before = [f.launches for f in fns]

    def step(m):
        m.model.train()
        for p in m.model.parameters():
            p.grad = torch.zeros_like(p)
        total, losses = m.loss_fn({k: v.to(m.device) for k, v in batch.items()})
        with ieee_f32():  # as SimpleTrainer runs the backward
            total.backward()
        return ({k: v.item() for k, v in losses.items()},
                {k: p.grad.cpu() for k, p in m.model.named_parameters()})

    out = {"cpu": step(host)}
    for run, tf32 in (("cuda", False), ("cuda_again", False), ("cuda_default_tf32", True)):
        dev = build_model(cfg)
        dev.model.load_state_dict(host.model.state_dict())
        torch.backends.cudnn.allow_tf32 = tf32  # True is PyTorch's default
        try:
            out[run] = step(dev)
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.allow_tf32 = False
    assert [f.launches - b for f, b in zip(fns, before)] == [0] * 5
    grads = out["cpu"][1]
    floor = 5e-4 * max(g.abs().max().item() for g in grads.values())
    for k, v in out["cuda"][0].items():
        assert abs(out["cuda_default_tf32"][0][k] - v) <= 1e-6 * abs(v), k
        assert abs(v - out["cpu"][0][k]) <= 1e-3 * abs(out["cpu"][0][k]), k
    for k, g in grads.items():
        got, again, tf32 = out["cuda"][1][k], out["cuda_again"][1][k], out["cuda_default_tf32"][1][k]
        spread = (again - got).abs().max().item()  # cuDNN's backward is not bit-reproducible
        assert (tf32 - got).abs().max().item() <= 2 * spread + 1e-5 * got.abs().max().item(), k
        if trunk not in _F32_GRADIENTS_MEANINGLESS:
            assert (got - g).abs().max().item() <= 1e-2 * g.abs().max().item() + floor, k


_SMALL_RETINANET = ["MODEL.META_ARCHITECTURE", "RetinaNet", "MODEL.BACKBONE.NAME", "build_retinanet_resnet_fpn_backbone",
                    "MODEL.RESNETS.DEPTH", 18, "MODEL.RESNETS.RES2_OUT_CHANNELS", 16,
                    "MODEL.RESNETS.STEM_OUT_CHANNELS", 8, "MODEL.RESNETS.OUT_FEATURES", ["res3", "res4", "res5"],
                    "MODEL.FPN.IN_FEATURES", ["res3", "res4", "res5"], "MODEL.FPN.OUT_CHANNELS", 32,
                    "MODEL.RETINANET.NUM_CLASSES", 5, "MODEL.RETINANET.NUM_CONVS", 2, "TPU.DTYPE", "float32",
                    "INPUT.TEST_SIZE", (96, 96), "DATASETS.TRAIN", (),
                    "MODEL.PIXEL_MEAN", [103.53, 116.28, 123.675], "MODEL.PIXEL_STD", [57.375, 57.12, 58.395]]


def test_small_retinanet_heads_and_loss_on_card_match_cpu(card):
    """A small RetinaNet (ResNet-18-FPN, 32 channels, 5 classes) in f32 on
    96² images, the same weights on the card and on the CPU: every level's
    ``cls_score`` and ``bbox_pred`` within 1e-4 of their scale (the model's
    ``ieee_f32``: no TF32), the training loss terms within 1e-4 relative,
    and ``predict_fn``'s detections (slots, classes, scores within 1e-4)."""
    cfg = get_cfg()
    cfg.merge_from_list(_SMALL_RETINANET + ["MODEL.DEVICE", "cpu"])
    host = build_model(cfg)
    cfg.MODEL.DEVICE = "cuda"
    dev = build_model(cfg)
    with torch.no_grad():  # a cls_score bias that lets scores clear the threshold
        host.model.head.cls_score.bias.fill_(-2.0)
    dev.model.load_state_dict(host.model.state_dict())
    g = torch.Generator().manual_seed(3)
    x = torch.rand(2, 3, 96, 96, generator=g) * 255
    with torch.no_grad():
        zh = host.model(host.normalize(x))
        zc = dev.model(dev.normalize(x.to(card)))
    for maps_h, maps_c in zip(zh, zc):
        for h, c in zip(maps_h, maps_c):
            assert c.dtype == torch.float32
            assert (c.cpu() - h).abs().max().item() <= 1e-4 * max(h.abs().max().item(), 1e-6)
    batch = {"image": x, "gt_boxes": torch.tensor([[[8.0, 10.0, 60.0, 70.0], [40.0, 30.0, 90.0, 80.0]]] * 2),
             "gt_classes": torch.tensor([[1, 4]] * 2), "gt_valid": torch.tensor([[True, True], [True, False]])}
    for m in (host, dev):
        m.model.train()
    _, lh = host.loss_fn(batch)
    _, lc = dev.loss_fn({k: v.to(card) for k, v in batch.items()})
    for k in lh:
        assert abs(lc[k].item() - lh[k].item()) <= 1e-4 * abs(lh[k].item()), k
    for m in (host, dev):
        m.model.eval()
    dh = host.predict_fn(x)
    dc = {k: v.cpu() for k, v in dev.predict_fn(x.to(card)).items()}
    assert (dh["scores"] > host.score_threshold).sum() > 20
    assert torch.equal(dc["classes"], dh["classes"])
    assert (dc["scores"] - dh["scores"]).abs().max().item() <= 1e-4
    assert (dc["boxes"] - dh["boxes"]).abs().max().item() <= 1e-2


def test_nms_on_card_keeps_the_cpus_indices(card):
    """The port's fixed-K NMS (``ops/nms.py``) on the card and on the CPU,
    on the same candidates: 16 images × 4441 boxes (RetinaNet's count at
    800²), 80 classes, a third of the scores dead; equal kept indices and
    validity."""
    from detectron2_centernet_tpu_torch.ops.nms import batched_nms_fixed

    g = torch.Generator().manual_seed(0)
    n, c = 16, 4441
    xy = torch.rand(n, c, 2, generator=g) * 700
    boxes = torch.cat([xy, xy + 8 + torch.rand(n, c, 2, generator=g) * 200], -1)
    scores = torch.rand(n, c, generator=g)
    scores[torch.rand(n, c, generator=g) < 0.33] = float("-inf")
    classes = torch.randint(0, 80, (n, c), generator=g)
    keep_h, valid_h = batched_nms_fixed(boxes, scores, classes, 0.5, 100)
    keep_c, valid_c = batched_nms_fixed(boxes.to(card), scores.to(card), classes.to(card), 0.5, 100)
    assert torch.equal(valid_c.cpu(), valid_h) and torch.equal(keep_c.cpu(), keep_h)
    assert valid_h.all()


def _nms_rows(g, rows, cands, live, spread=700.0, ties=False):
    xy = torch.rand(rows, cands, 2, generator=g) * spread
    boxes = torch.cat([xy, xy + 4 + torch.rand(rows, cands, 2, generator=g) * spread / 4], -1)
    scores = torch.rand(rows, cands, generator=g)
    if ties:  # many equal scores, and some boxes of no area
        scores = torch.floor(scores * 8) / 8
        boxes[:, ::7, 2:] = boxes[:, ::7, :2]
    scores[torch.rand(rows, cands, generator=g) >= live] = float("-inf")
    return boxes, scores


# NMS case: (rows, candidates, picks, live share, IoU threshold); the RPN's counts repeat per image
_NMS_CASES = {
    "retinanet": (16, 4441, 100, 0.3, 0.5), "rpn": (80, 1000, [1000] * 4 + [507], 1.0, 0.7),
    "rpn_train": (80, 2000, [1000] * 4 + [507], 1.0, 0.7), "box_head": (16, 80000, 100, 0.2, 0.5),
    "box_head_sparse": (16, 80000, 100, 0.05, 0.5), "ties": (8, 3000, 300, 0.8, 0.5),
    "rpn_c4": (16, 6000, 1000, 1.0, 0.7), "rpn_c4_train": (16, 12000, 2000, 1.0, 0.7),
    "lvis_b1": (1, 1000 * 1203, 300, 0.54, 0.5), "lvis_b16": (16, 1000 * 1203, 300, 0.54, 0.5),
    "chunks": (1, 20000, 10000, 1.0, 0.5), "clusters": (2, 40000, 10000, 1.0, 0.7),
}


def _nms_case(name):
    """(boxes, scores, picks) of an NMS case on the CPU, from seed 1."""
    rows, cands, picks, live, _ = _NMS_CASES[name]
    g = torch.Generator().manual_seed(1)
    if name.startswith("lvis"):  # each proposal once per class, moved apart by the class offsets
        proposals, classes = 1000, 1203
        xy = torch.rand(rows, proposals, 1, 2, generator=g) * 700
        base = torch.cat([xy, xy + 20 + torch.rand(rows, proposals, 1, 2, generator=g) * 300], -1)
        boxes = (base + (torch.rand(rows, proposals, classes, 4, generator=g) - 0.5) * 6).reshape(rows, -1, 4)
        cls = torch.arange(classes).repeat(rows, proposals).to(boxes.dtype)
        boxes = boxes + cls[:, :, None] * (boxes.flatten(1).amax(dim=1) + 1.0)[:, None, None]
        scores = torch.rand(rows, cands, generator=g) ** 3
        scores[scores < (1 - live) ** 3] = float("-inf")
    elif name == "chunks":  # disjoint boxes: every candidate a pick
        xy = torch.arange(cands, dtype=torch.float32)[None, :, None].expand(rows, cands, 2) * 10
        boxes, scores = torch.cat([xy, xy + 5], -1), torch.rand(rows, cands, generator=g)
    elif name == "clusters":  # clusters of 5 jittered boxes, each member's score drawn on its own
        n = cands // 5
        centres = torch.rand(rows, n, 1, 2, generator=g) * 2000
        size = 20 + torch.rand(rows, n, 1, 2, generator=g) * 40
        base = torch.cat([centres - size / 2, centres + size / 2], -1)
        jitter = (torch.rand(rows, n, 5, 4, generator=g) - 0.5) * torch.cat([size, size], -1) * 0.2
        boxes, scores = (base + jitter).reshape(rows, cands, 4), torch.rand(rows, cands, generator=g)
    else:
        boxes, scores = _nms_rows(g, rows, cands, live, ties=name == "ties")
    if isinstance(picks, list):
        picks = torch.tensor(picks * (rows // len(picks)), dtype=torch.int32)
    return boxes, scores, picks


@pytest.mark.parametrize("case", list(_NMS_CASES))
def test_nms_kernel_matches_plain_on_card(card, case):
    """The NMS kernels (``ops/csrc/nms.cu``) against the plain loop and the
    algorithm's plain mirror (``nms_sorted_reference``), all on the card, at
    the main paths' shapes: RetinaNet's 16 × 4441 candidates, 100 picks;
    the RPN's 16 images × 5 level rows of 1000 (2000 at training) with 1000
    picks on p2-p5 and 507 on p6 (13 × 13 × 3 anchors); the box head's 16
    × 80 000 (1000 proposals × 80 classes), 100 picks, a fifth and a
    twentieth of them live; the C4 and DC5 RPN's one level, 16 rows of
    6000 with 1000 picks at test and of 12 000 with 2000 at training (rows
    past one chunk: the selection passes); LVIS's box head, 1 and 16 rows
    of 1000 × 1203 candidates through the class offsets, ~54% live, 300
    picks; ties: scores on 8 values and boxes of no area. And rows that
    take more than one chunk of 8192, whose later rounds the card launches
    itself: 20 000 disjoint boxes with 10 000 picks (two chunks), and 2 rows
    of 8000 clusters of 5 overlapping boxes at IoU 0.7 with 10 000 picks
    (four chunks a row; picks of earlier chunks suppress half the later
    candidates). Indices and validity exactly equal; one launch per call;
    the chunks the card counted equal the mirror's, at least one a row."""
    from detectron2_centernet_tpu_torch.ops import nms

    rows, thr = _NMS_CASES[case][0], _NMS_CASES[case][4]
    boxes, scores, counts = _nms_case(case)
    boxes, scores = boxes.to(card), scores.to(card)
    before, rounds = nms.greedy_nms.launches, nms.rounds_taken()
    keep, valid = nms.greedy_nms(boxes, scores, thr, counts)
    assert nms.greedy_nms.launches == before + 1
    taken = nms.rounds_taken() - rounds
    want_keep, want_valid = nms.nms_fixed(boxes, scores, thr, counts)
    assert torch.equal(valid, want_valid) and torch.equal(keep, want_keep)
    ref_keep, ref_valid, chunks = nms.nms_sorted_reference(boxes, scores, thr, counts)
    assert torch.equal(valid, ref_valid) and torch.equal(keep, ref_keep)
    assert taken == int(chunks.sum()) >= rows
    if case in ("chunks", "clusters"):
        assert taken > rows and bool(valid.all())
    assert valid.sum() > rows


@pytest.mark.parametrize("case", ["lvis_b1", "clusters"])
def test_nms_kernel_does_not_wait_for_the_card(card, case):
    """A call on rows past one chunk (whose later rounds, if any, the card
    launches itself) returns to the host while ~50 ms of work queued before
    it still runs, and its result, read after, equals the plain loop's."""
    import time

    from detectron2_centernet_tpu_torch.ops import nms

    boxes, scores, counts = _nms_case(case)
    boxes, scores, thr = boxes.to(card), scores.to(card), _NMS_CASES[case][4]
    nms.greedy_nms(boxes, scores, thr, counts)  # built and warm
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(80_000_000)
    end.record()
    t0 = time.perf_counter()
    keep, valid = nms.greedy_nms(boxes, scores, thr, counts)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    assert host_ms < start.elapsed_time(end) / 2
    want_keep, want_valid = nms.nms_fixed(boxes, scores, thr, counts)
    assert torch.equal(valid, want_valid) and torch.equal(keep, want_keep)


_SMALL_RCNN = ["MODEL.META_ARCHITECTURE", "GeneralizedRCNN", "MODEL.BACKBONE.NAME", "build_resnet_fpn_backbone",
               "MODEL.RESNETS.DEPTH", 18, "MODEL.RESNETS.RES2_OUT_CHANNELS", 16, "MODEL.RESNETS.STEM_OUT_CHANNELS", 8,
               "MODEL.RESNETS.OUT_FEATURES", ["res2", "res3", "res4", "res5"],
               "MODEL.FPN.IN_FEATURES", ["res2", "res3", "res4", "res5"], "MODEL.FPN.OUT_CHANNELS", 32,
               "MODEL.RPN.IN_FEATURES", ["p2", "p3", "p4", "p5", "p6"], "MODEL.RPN.PRE_NMS_TOPK_TEST", 200,
               "MODEL.RPN.POST_NMS_TOPK_TEST", 100, "MODEL.RPN.PRE_NMS_TOPK_TRAIN", 200,
               "MODEL.RPN.POST_NMS_TOPK_TRAIN", 100, "MODEL.ANCHOR_GENERATOR.SIZES", [[32], [64], [128], [256], [512]],
               "MODEL.ROI_HEADS.NAME", "StandardROIHeads", "MODEL.ROI_HEADS.NUM_CLASSES", 5,
               "MODEL.ROI_HEADS.IN_FEATURES", ["p2", "p3", "p4", "p5"], "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 64,
               "MODEL.ROI_BOX_HEAD.NUM_FC", 2, "MODEL.ROI_BOX_HEAD.FC_DIM", 64, "TPU.DTYPE", "float32",
               "INPUT.TEST_SIZE", (96, 96), "DATASETS.TRAIN", ()]


def test_small_faster_rcnn_on_card_matches_cpu(card):
    """A small Faster R-CNN (ResNet-18-FPN, 32 channels, 5 classes) in f32
    on 96² images, the same weights on the card and on the CPU: the RPN's
    f32 logits and deltas within 1e-4 of their scale, the four training
    losses on the same draws within 1e-3 relative, and ``predict_fn``'s
    detections (classes equal, scores within 1e-3: the class logits, 30
    times the init's, magnify the two convolution libraries' ~1e-5
    differences in the pooled features; boxes within 1e-2 px), through two
    NMS kernel launches per call on the card."""
    from detectron2_centernet_tpu_torch.ops import nms

    cfg = get_cfg()
    cfg.merge_from_list(_SMALL_RCNN + ["MODEL.DEVICE", "cpu"])
    host = build_model(cfg)
    cfg.MODEL.DEVICE = "cuda"
    dev = build_model(cfg)
    with torch.no_grad():  # scores spread, so that classes clear the threshold
        host.model.roi_heads.box_predictor.cls_score.weight.mul_(30.0)
    dev.model.load_state_dict(host.model.state_dict())
    g = torch.Generator().manual_seed(3)
    x = torch.rand(2, 3, 96, 96, generator=g) * 255
    with torch.no_grad():
        _, lh, dh = host.model(host.normalize(x))
        _, lc, dc = dev.model(dev.normalize(x.to(card)))
    for h, c in zip(lh + dh, lc + dc):
        assert c.dtype == torch.float32
        assert (c.cpu() - h).abs().max().item() <= 1e-4 * max(h.abs().max().item(), 1e-6)
    anchors = sum(a.shape[0] for a in host.anchors_per_level((96, 96)))
    draws = {"rpn": torch.rand(2, anchors, generator=g), "roi_sub": torch.rand(2, 102, generator=g),
             "roi_tie": torch.rand(2, 102, generator=g)}
    batch = {"image": x, "gt_boxes": torch.tensor([[[8.0, 10.0, 60.0, 70.0], [40.0, 30.0, 90.0, 80.0]]] * 2),
             "gt_classes": torch.tensor([[1, 4]] * 2), "gt_valid": torch.tensor([[True, True], [True, False]])}
    for m in (host, dev):
        m.model.train()
    _, losses_h = host.loss_fn(dict(batch, draws=draws))
    _, losses_c = dev.loss_fn(dict({k: v.to(card) for k, v in batch.items()}, draws=draws))
    for k in losses_h:
        assert abs(losses_c[k].item() - losses_h[k].item()) <= 1e-3 * abs(losses_h[k].item()), k
    for m in (host, dev):
        m.model.eval()
    det_h = host.predict_fn(x)
    before = nms.greedy_nms.launches
    det_c = {k: v.cpu() for k, v in dev.predict_fn(x.to(card)).items()}
    assert nms.greedy_nms.launches == before + 2
    assert (det_h["scores"] > host.score_threshold).sum() > 20
    assert torch.equal(det_c["classes"], det_h["classes"])
    assert (det_c["scores"] - det_h["scores"]).abs().max().item() <= 1e-3
    assert (det_c["boxes"] - det_h["boxes"]).abs().max().item() <= 1e-2


def test_paste_masks_on_card_equals_cpu(card, monkeypatch):
    """``paste_masks_in_image`` on the card in f64 (every operation its own
    IEEE kernel) against the same on the CPU: the bool masks equal bit for
    bit, in one chunk and in small ones."""
    from detectron2_centernet_tpu_torch.structures import masks
    from detectron2_centernet_tpu_torch.structures.masks import paste_masks_in_image

    g = torch.Generator().manual_seed(4)
    probs = torch.rand(40, 28, 28, generator=g)
    xy = torch.rand(40, 2, generator=g) * 700 - 50
    boxes = torch.cat([xy, xy + torch.rand(40, 2, generator=g) * 300], 1)
    want = paste_masks_in_image(probs, boxes, (600, 800))
    for chunk in (1 << 24, 1 << 16):
        monkeypatch.setattr(masks, "PASTE_CHUNK", chunk)
        got = paste_masks_in_image(probs.to(card), boxes.to(card), (600, 800))
        assert got.device.type == "cuda" and torch.equal(got.cpu(), want)
    assert want.any()


def test_heatmaps_to_keypoints_on_card_equals_cpu(card):
    """The keypoint decode on the card (bicubic in f64) against the CPU's on
    random maps (no ties): the positions equal, the logits and scores within
    1e-9 relative."""
    from detectron2_centernet_tpu_torch.structures.keypoints import heatmaps_to_keypoints

    g = torch.Generator().manual_seed(5)
    maps = torch.randn(30, 17, 56, 56, generator=g) * 3
    xy = torch.rand(30, 2, generator=g) * 400
    rois = torch.cat([xy, xy + torch.rand(30, 2, generator=g) * 300 + 0.5], 1)
    want = heatmaps_to_keypoints(maps, rois)
    got = heatmaps_to_keypoints(maps.to(card), rois.to(card))
    assert torch.equal(got[..., :2], want[..., :2])
    torch.testing.assert_close(got[..., 2:], want[..., 2:], rtol=1e-9, atol=0)


def test_small_mask_and_keypoint_rcnn_on_card_matches_cpu(card):
    """A small R-CNN with both heads (ResNet-18-FPN, 32 channels, 5
    classes, a mask head of 32, a keypoint head of 2 convs of 64) in f32 on
    96² images, the same weights on both devices: the six training losses on
    the same draws within 1e-3 relative; ``predict_fn``'s masks within 1e-3
    and its heatmaps within 1e-3 of their scale, with the classes equal."""
    cfg = get_cfg()
    cfg.merge_from_list(_SMALL_RCNN + ["MODEL.DEVICE", "cpu", "MODEL.MASK_ON", True, "MODEL.KEYPOINT_ON", True,
                                       "MODEL.ROI_MASK_HEAD.CONV_DIM", 32, "MODEL.ROI_KEYPOINT_HEAD.CONV_DIMS", [64, 64],
                                       "INPUT.MASK_RASTER", 16])
    host = build_model(cfg)
    cfg.MODEL.DEVICE = "cuda"
    dev = build_model(cfg)
    with torch.no_grad():
        host.model.roi_heads.box_predictor.cls_score.weight.mul_(30.0)
    dev.model.load_state_dict(host.model.state_dict())
    g = torch.Generator().manual_seed(6)
    x = torch.rand(2, 3, 96, 96, generator=g) * 255
    anchors = sum(a.shape[0] for a in host.anchors_per_level((96, 96)))
    draws = {"rpn": torch.rand(2, anchors, generator=g), "roi_sub": torch.rand(2, 102, generator=g),
             "roi_tie": torch.rand(2, 102, generator=g)}
    gt = torch.tensor([[[8.0, 10.0, 60.0, 70.0], [40.0, 30.0, 90.0, 80.0]]] * 2)
    kp = torch.cat([gt[..., None, :2] + torch.rand(2, 2, 17, 2, generator=g) * (gt[..., None, 2:] - gt[..., None, :2]),
                    torch.full((2, 2, 17, 1), 2.0)], -1)
    batch = {"image": x, "gt_boxes": gt, "gt_classes": torch.tensor([[1, 4]] * 2),
             "gt_valid": torch.tensor([[True, True], [True, False]]),
             "gt_masks": (torch.rand(2, 2, 16, 16, generator=g) > 0.4).to(torch.uint8), "gt_keypoints": kp}
    for m in (host, dev):
        m.model.train()
    _, losses_h = host.loss_fn(dict(batch, draws=draws))
    _, losses_c = dev.loss_fn(dict({k: v.to(card) for k, v in batch.items()}, draws=draws))
    assert {"loss_mask", "loss_keypoint"} <= set(losses_h)
    for k in losses_h:
        assert abs(losses_c[k].item() - losses_h[k].item()) <= 1e-3 * abs(losses_h[k].item()), k
    for m in (host, dev):
        m.model.eval()
    det_h = host.predict_fn(x)
    det_c = {k: v.cpu() for k, v in dev.predict_fn(x.to(card)).items()}
    assert torch.equal(det_c["classes"], det_h["classes"])
    assert (det_c["masks"] - det_h["masks"]).abs().max().item() <= 1e-3
    hm = det_h["keypoint_heatmaps"]
    assert (det_c["keypoint_heatmaps"] - hm).abs().max().item() <= 1e-3 * hm.abs().max().item()


_SMALL_SEM_SEG = ["MODEL.SEM_SEG_HEAD.CONVS_DIM", 16, "MODEL.SEM_SEG_HEAD.NUM_CLASSES", 7,
                  "MODEL.SEM_SEG_HEAD.IN_FEATURES", ["p2", "p3", "p4", "p5"]]


def test_small_semantic_fpn_on_card_matches_cpu(card):
    """A small Semantic FPN (ResNet-18-FPN, 32 channels, a head of 16, 7
    classes) in f32 on 96² images, the same weights on both devices: the
    logits within 1e-4 of their scale, the loss (a tenth of the pixels
    ignored) within 1e-4 relative, every gradient within 1e-3 of its own
    max; the label maps un-warped on the card (a letterbox from 120x90)
    agree with the CPU's where the CPU's top-2 gap exceeds 1e-3."""
    from detectron2_centernet_tpu_torch.data import letterbox_transform

    cfg = get_cfg()
    cfg.merge_from_list(_SMALL_RCNN + _SMALL_SEM_SEG + ["MODEL.DEVICE", "cpu", "MODEL.META_ARCHITECTURE",
                                                        "SemanticSegmentor"])
    host = build_model(cfg)
    cfg.MODEL.DEVICE = "cuda"
    dev = build_model(cfg)
    dev.model.load_state_dict(host.model.state_dict())
    g = torch.Generator().manual_seed(7)
    x = torch.rand(2, 3, 96, 96, generator=g) * 255
    labels = torch.randint(0, 7, (2, 96, 96), generator=g)
    labels[torch.rand(2, 96, 96, generator=g) < 0.1] = 255
    lh, lc = host.predict_fn(x)["sem_seg"], dev.predict_fn(x.to(card))["sem_seg"]
    assert lc.dtype == torch.float32 and lc.shape == (2, 7, 96, 96)
    assert (lc.cpu() - lh).abs().max().item() <= 1e-4 * lh.abs().max().item()
    losses = []
    for m, dv in ((host, "cpu"), (dev, card)):
        m.model.train()
        for p in m.model.parameters():
            p.grad = None
        total, _ = m.loss_fn({"image": x.to(dv), "sem_seg": labels.to(dv)})
        total.backward()
        m.model.eval()
        losses.append(total.item())
    assert abs(losses[1] - losses[0]) <= 1e-4 * abs(losses[0])
    for (k, ph), pc in zip(host.model.named_parameters(), dev.model.parameters()):
        if ph.grad is not None and ph.grad.abs().max() > 0:
            assert (pc.grad.cpu() - ph.grad).abs().max().item() <= 1e-3 * ph.grad.abs().max().item(), k
    warps, sizes = [letterbox_transform(120, 90, (96, 96))] * 2, [(120, 90)] * 2
    want = host.device_postprocess({"sem_seg": lh}, warps, sizes)["sem_seg"]
    got = dev.device_postprocess({"sem_seg": lc}, warps, sizes)["sem_seg"].cpu()
    assert got.shape == want.shape == (2, 120, 90) and got.dtype == torch.uint8
    from detectron2_centernet_tpu_torch.data import warp_image
    from detectron2_centernet_tpu_torch.data.detection_utils import invert_affine

    for i in range(2):
        warped = warp_image(lh[i].permute(1, 2, 0), invert_affine(warps[i]), sizes[i])
        top = warped.topk(2, dim=-1).values
        decided = (top[..., 0] - top[..., 1]) > 1e-3
        assert torch.equal(got[i][decided], want[i][decided]) and decided.float().mean() > 0.5


def test_small_panoptic_fpn_on_card_matches_cpu(card):
    """A small Panoptic FPN (the small Mask R-CNN with the head of 16 and 7
    stuff classes) in f32 on 96² images, the same weights on both devices:
    the six training losses on the same draws within 1e-3 relative,
    ``predict_fn``'s classes equal, masks within 1e-3 and sem-seg logits
    within 1e-4 of their scale; the panoptic merge of the CPU's detections
    on the card equal to the CPU's."""
    cfg = get_cfg()
    cfg.merge_from_list(_SMALL_RCNN + _SMALL_SEM_SEG + [
        "MODEL.DEVICE", "cpu", "MODEL.META_ARCHITECTURE", "PanopticFPN", "MODEL.MASK_ON", True,
        "MODEL.ROI_MASK_HEAD.CONV_DIM", 32, "INPUT.MASK_RASTER", 16,
        "MODEL.PANOPTIC_FPN.COMBINE.STUFF_AREA_LIMIT", 50])
    host = build_model(cfg)
    cfg.MODEL.DEVICE = "cuda"
    dev = build_model(cfg)
    with torch.no_grad():
        host.model.roi_heads.box_predictor.cls_score.weight.mul_(30.0)
    dev.model.load_state_dict(host.model.state_dict())
    g = torch.Generator().manual_seed(8)
    x = torch.rand(2, 3, 96, 96, generator=g) * 255
    anchors = sum(a.shape[0] for a in host.anchors_per_level((96, 96)))
    draws = {"rpn": torch.rand(2, anchors, generator=g), "roi_sub": torch.rand(2, 102, generator=g),
             "roi_tie": torch.rand(2, 102, generator=g)}
    batch = {"image": x, "gt_boxes": torch.tensor([[[8.0, 10.0, 60.0, 70.0], [40.0, 30.0, 90.0, 80.0]]] * 2),
             "gt_classes": torch.tensor([[1, 4]] * 2), "gt_valid": torch.tensor([[True, True], [False, False]]),
             "gt_masks": (torch.rand(2, 2, 16, 16, generator=g) > 0.4).to(torch.uint8),
             "sem_seg": torch.randint(0, 7, (2, 96, 96), generator=g)}
    for m in (host, dev):
        m.model.train()
    _, losses_h = host.loss_fn(dict(batch, draws=draws))
    _, losses_c = dev.loss_fn(dict({k: v.to(card) for k, v in batch.items()}, draws=draws))
    assert "loss_sem_seg" in losses_h and len(losses_h) == 6
    for k in losses_h:
        assert abs(losses_c[k].item() - losses_h[k].item()) <= 1e-3 * abs(losses_h[k].item()), k
    for m in (host, dev):
        m.model.eval()
    det_h = host.predict_fn(x)
    det_c = {k: v.cpu() for k, v in dev.predict_fn(x.to(card)).items()}
    assert torch.equal(det_c["classes"], det_h["classes"])
    assert (det_c["masks"] - det_h["masks"]).abs().max().item() <= 1e-3
    sem = det_h["sem_seg"]
    assert (det_c["sem_seg"] - sem).abs().max().item() <= 1e-4 * sem.abs().max().item()
    dets = {k: v.numpy() for k, v in host.device_postprocess(det_h, None, [(96, 96)] * 2).items()}
    want, got = host.postprocess(dets, None, [(96, 96)] * 2), dev.postprocess(dets, None, [(96, 96)] * 2)
    for w, c in zip(want, got):
        assert torch.equal(torch.from_numpy(c["panoptic_seg"][0]), torch.from_numpy(w["panoptic_seg"][0]))
        assert c["panoptic_seg"][1] == w["panoptic_seg"][1] and len(w["panoptic_seg"][1]) > 1


_SMALL_DEEPLAB = ["MODEL.META_ARCHITECTURE", "SemanticSegmentor", "MODEL.BACKBONE.NAME", "build_resnet_deeplab_backbone",
                  "MODEL.RESNETS.DEPTH", 50, "MODEL.RESNETS.RES2_OUT_CHANNELS", 32,
                  "MODEL.RESNETS.WIDTH_PER_GROUP", 8, "MODEL.RESNETS.STEM_OUT_CHANNELS", 16,
                  "MODEL.RESNETS.NORM", "BN", "MODEL.RESNETS.STEM_TYPE", "deeplab", "MODEL.RESNETS.RES5_DILATION", 2,
                  "MODEL.RESNETS.RES5_MULTI_GRID", [1, 2, 4], "MODEL.RESNETS.OUT_FEATURES", ["res2", "res5"],
                  "MODEL.BACKBONE.FREEZE_AT", 0, "MODEL.SEM_SEG_HEAD.NAME", "DeepLabV3PlusHead",
                  "MODEL.SEM_SEG_HEAD.IN_FEATURES", ["res2", "res5"], "MODEL.SEM_SEG_HEAD.CONVS_DIM", 16,
                  "MODEL.SEM_SEG_HEAD.NUM_CLASSES", 5, "MODEL.SEM_SEG_HEAD.COMMON_STRIDE", 4,
                  "MODEL.SEM_SEG_HEAD.LOSS_TYPE", "hard_pixel_mining", "TPU.DTYPE", "float32", "DATASETS.TRAIN", ()]


@pytest.mark.parametrize("head", ["DeepLabV3PlusHead", "DeepLabV3Head"])
def test_small_deeplab_on_card_matches_cpu(card, head):
    """A small DeepLab (ResNet-50 with RES2 32, the DeepLab stem, BatchNorm,
    res5 at dilation 2 · (1, 2, 4); ASPP of 16; 5 classes) in f32 on 96²
    images, the same weights on both devices: the trunk's res2 and res5
    within 1e-4 of their scale, each head on the card's maps (on both
    devices) within 1e-5, the logits within 1e-4, the hard-mining loss in
    training mode within 1e-4 relative; the head's gradients of the pixel
    loss on the card's maps (on both devices; through the train-mode trunk
    the gradients of two correct implementations drift apart, as
    tests/test_torch_deeplab.py measured) within 1e-3 of their own max."""
    extra = [] if head == "DeepLabV3PlusHead" else [
        "MODEL.SEM_SEG_HEAD.NAME", head, "MODEL.SEM_SEG_HEAD.IN_FEATURES", ["res5"],
        "MODEL.SEM_SEG_HEAD.COMMON_STRIDE", 16, "MODEL.RESNETS.OUT_FEATURES", ["res5"]]
    cfg = get_cfg()
    cfg.merge_from_list(_SMALL_DEEPLAB + extra + ["MODEL.DEVICE", "cpu"])
    host = build_model(cfg)
    cfg.MODEL.DEVICE = "cuda"
    dev = build_model(cfg)
    dev.model.load_state_dict(host.model.state_dict())
    g = torch.Generator().manual_seed(9)
    x = torch.rand(2, 3, 96, 96, generator=g) * 255
    with torch.no_grad(), ieee_f32():
        fh, fc = host.model.backbone(host.normalize(x)), dev.model.backbone(dev.normalize(x.to(card)))
        for k in fh:
            assert (fc[k].cpu() - fh[k]).abs().max().item() <= 1e-4 * fh[k].abs().max().item(), k
        on_card = dev.model.sem_seg_head(fc)
        on_host = host.model.sem_seg_head({k: v.cpu() for k, v in fc.items()})
    assert (on_card.cpu() - on_host).abs().max().item() <= 1e-5 * on_host.abs().max().item()
    lh, lc = host.predict_fn(x)["sem_seg"], dev.predict_fn(x.to(card))["sem_seg"]
    assert lc.dtype == torch.float32 and lc.shape == (2, 5, 96, 96)
    assert (lc.cpu() - lh).abs().max().item() <= 1e-4 * lh.abs().max().item()
    labels = torch.randint(0, 5, (2, 96, 96), generator=g)
    labels[torch.rand(2, 96, 96, generator=g) < 0.1] = 255
    losses = []
    for m, dv in ((host, "cpu"), (dev, card)):
        m.model.train()
        with torch.no_grad():
            losses.append(m.loss_fn({"image": x.to(dv), "sem_seg": labels.to(dv)})[0].item())
        m.model.eval()
    assert abs(losses[1] - losses[0]) <= 1e-4 * abs(losses[0])
    from detectron2_centernet_tpu_torch.models.meta_arch.semantic_seg import sem_seg_loss

    for m, maps in ((host, {k: v.cpu() for k, v in fc.items()}), (dev, fc)):
        for p in m.model.sem_seg_head.parameters():
            p.grad = None
        with ieee_f32():
            sem_seg_loss(m.model.sem_seg_head(maps), labels.to(m.device)).backward()
    for (k, ph), pc in zip(host.model.sem_seg_head.named_parameters(), dev.model.sem_seg_head.parameters()):
        assert (pc.grad.cpu() - ph.grad).abs().max().item() <= 1e-3 * ph.grad.abs().max().item(), k


def test_small_pointrend_on_card_matches_cpu(card):
    """A small PointRend R-CNN (the small Mask R-CNN with
    ``PointRendROIHeads``, ``CoarseMaskHead`` 7² and a point head of 3 fc
    of 32) in f32 on 96² images, the same weights on both devices: the
    point head on the same points (on both devices) within 1e-5 of its
    scale, the subdivision (3 steps of 100 points, 7² → 56²) of the same
    coarse logits and fine maps within 1e-4, the six training losses on the
    same draws within 1e-3 relative, ``loss_mask_point`` among them; and a
    small PointRend semantic head's refined logits within 1e-4."""
    from detectron2_centernet_tpu_torch.models.roi_heads.point_head import refine_mask_with_points

    cfg = get_cfg()
    cfg.merge_from_list(_SMALL_RCNN + [
        "MODEL.DEVICE", "cpu", "MODEL.MASK_ON", True, "MODEL.ROI_HEADS.NAME", "PointRendROIHeads",
        "MODEL.ROI_MASK_HEAD.NAME", "CoarseMaskHead", "MODEL.ROI_MASK_HEAD.CONV_DIM", 32,
        "MODEL.ROI_MASK_HEAD.FC_DIM", 64, "MODEL.POINT_HEAD.FC_DIM", 32, "MODEL.POINT_HEAD.TRAIN_NUM_POINTS", 28,
        "MODEL.POINT_HEAD.SUBDIVISION_STEPS", 3, "MODEL.POINT_HEAD.SUBDIVISION_NUM_POINTS", 100,
        "INPUT.MASK_RASTER", 16])
    host = build_model(cfg)
    cfg.MODEL.DEVICE = "cuda"
    dev = build_model(cfg)
    dev.model.load_state_dict(host.model.state_dict())
    g = torch.Generator().manual_seed(10)
    fine, coarse = torch.randn(40, 28, 32, generator=g), torch.randn(40, 28, 1, generator=g)
    with torch.no_grad():
        ph, pc = host.model.point_predict(fine, coarse), dev.model.point_predict(fine.to(card), coarse.to(card))
        assert (pc.cpu() - ph).abs().max().item() <= 1e-5 * ph.abs().max().item()
        logits, maps = torch.randn(40, 7, 7, generator=g) * 3, torch.randn(40, 32, 14, 14, generator=g)
        rh = refine_mask_with_points(logits, maps, host.model.point_predict, 100, 3)
        rc = refine_mask_with_points(logits.to(card), maps.to(card), dev.model.point_predict, 100, 3)
    assert rc.shape == (40, 56, 56) and (rc.cpu() - rh).abs().max().item() <= 1e-4 * rh.abs().max().item()
    x = torch.rand(2, 3, 96, 96, generator=g) * 255
    anchors = sum(a.shape[0] for a in host.anchors_per_level((96, 96)))
    draws = {"rpn": torch.rand(2, anchors, generator=g), "roi_sub": torch.rand(2, 102, generator=g),
             "roi_tie": torch.rand(2, 102, generator=g), "point_cand": torch.rand(128, 84, 2, generator=g),
             "point_rand": torch.rand(128, 7, 2, generator=g)}
    batch = {"image": x, "gt_boxes": torch.tensor([[[8.0, 10.0, 60.0, 70.0], [40.0, 30.0, 90.0, 80.0]]] * 2),
             "gt_classes": torch.tensor([[1, 4]] * 2), "gt_valid": torch.tensor([[True, True], [True, False]]),
             "gt_masks": (torch.rand(2, 2, 16, 16, generator=g) > 0.4).to(torch.uint8)}
    for m in (host, dev):
        m.model.train()
    _, losses_h = host.loss_fn(dict(batch, draws=draws))
    _, losses_c = dev.loss_fn(dict({k: v.to(card) for k, v in batch.items()}, draws=draws))
    assert len(losses_h) == 6 and losses_h["loss_mask_point"].item() > 0
    for k in losses_h:
        assert abs(losses_c[k].item() - losses_h[k].item()) <= 1e-3 * abs(losses_h[k].item()), k

    sem = get_cfg()
    sem.merge_from_list(_SMALL_RCNN + _SMALL_SEM_SEG + [
        "MODEL.DEVICE", "cpu", "MODEL.META_ARCHITECTURE", "SemanticSegmentor",
        "MODEL.SEM_SEG_HEAD.NAME", "PointRendSemSegHead", "MODEL.POINT_HEAD.SUBDIVISION_NUM_POINTS", 512])
    host = build_model(sem)
    sem.MODEL.DEVICE = "cuda"
    dev = build_model(sem)
    dev.model.load_state_dict(host.model.state_dict())
    with torch.no_grad(), ieee_f32():
        fc = dev.model.backbone(dev.normalize(x.to(card)))
        lc = dev.model.sem_seg_head(fc)
        lh = host.model.sem_seg_head({k: v.cpu() for k, v in fc.items()})
    assert lc.shape == (2, 7, 96, 96) and (lc.cpu() - lh).abs().max().item() <= 1e-4 * lh.abs().max().item()


# -- the rotated IoU (R1, ops/csrc/iou_rotated.cu) and the rotated NMS (R2, nms.cu's rotated kind) -----------


def _rotated(g, n, lo=0.0, hi=800.0, size=(8.0, 300.0), angles=180.0):
    """(n, 5) rotated boxes: centres in [lo, hi)², sides in ``size``, angles in ±``angles``°."""
    xy = lo + torch.rand(n, 2, generator=g) * (hi - lo)
    wh = size[0] + torch.rand(n, 2, generator=g) * (size[1] - size[0])
    return torch.cat([xy, wh, (torch.rand(n, 1, generator=g) * 2 - 1) * angles], 1)


def _degenerate_pairs():
    """(a, b) pairs: identical, a shared (collinear) edge, one inside the
    other, 90° turns, a thin box, a zero-size subject, -180 against 180, a
    touching corner, far apart; both ways round but for the clip by the
    zero-size box (its edges clip nothing: the union is rounding)."""
    a = torch.tensor([[20, 20, 10, 6, 30], [20, 20, 10, 6, 0], [20, 20, 10, 6, 0], [20, 20, 4, 2, 15],
                      [20, 20, 10, 6, 0], [20, 20, 8, 8, 0], [20, 20, 10, 1e-4, 20], [20, 20, 10, 6, -180],
                      [20, 20, 10, 10, 0], [20, 20, 10, 6, 45], [20, 20, 0, 0, 0]], dtype=torch.float32)
    b = torch.tensor([[20, 20, 10, 6, 30], [30, 20, 10, 6, 0], [20, 23, 10, 6, 0], [20, 20, 10, 6, 15],
                      [20, 20, 10, 6, 90], [20, 20, 8, 8, 90], [20, 20, 10, 6, 20], [20, 20, 10, 6, 180],
                      [30, 30, 10, 10, 0], [60, 60, 10, 6, 45], [20, 20, 10, 6, 0]], dtype=torch.float32)
    return torch.cat([a, b[:-1]]), torch.cat([b, a[:-1]])


@pytest.mark.parametrize("case", ["random", "degenerate", "matching", "sampling"])
def test_iou_rotated_kernel_matches_plain(card, case):
    """R1 against the plain clip on the card, within 1e-5: 300 x 500 random
    pairs; the degenerate pairs (each pair alone); the RRPN's matching shape,
    2 images of 20 gts against the 112 500 anchors of a 50 x 50 res4 map at
    45 anchors a cell (broadcast over the batch); the proposal sampling's,
    16 images of 20 gts against their own 2020 boxes. One launch a call."""
    from detectron2_centernet_tpu_torch.models.anchors import RotatedAnchorGenerator
    from detectron2_centernet_tpu_torch.ops import roi_align_rotated as rot

    g = torch.Generator().manual_seed(2)
    if case == "random":
        a, b = _rotated(g, 300), _rotated(g, 500)
    elif case == "degenerate":
        a, b = _degenerate_pairs()
        a, b = a[:, None], b[:, None]  # (pairs, 1, 5): each pair its own batch entry
    elif case == "matching":
        anchors = RotatedAnchorGenerator([[32, 64, 128, 256, 512]], [[0.5, 1.0, 2.0]], [[-90, 0, 90]], [16])
        a = torch.stack([_rotated(g, 20, 50, 750, (20, 400), 45) for _ in range(2)])
        b = torch.from_numpy(anchors([(50, 50)]))
    else:
        a = torch.stack([_rotated(g, 20, 50, 750, (20, 400), 45) for _ in range(16)])
        b = torch.cat([torch.stack([_rotated(g, 2000) for _ in range(16)]), a], 1)
    before = rot.pairwise_iou_rotated.launches
    got = rot.pairwise_iou_rotated(a.to(card), b.to(card))
    assert rot.pairwise_iou_rotated.launches == before + 1
    want = rot.pairwise_iou_rotated_plain(a.to(card), b.to(card))
    torch.cuda.synchronize()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= 1e-5
    if case == "degenerate":
        torch.testing.assert_close(got.cpu().flatten(), rot.pairwise_iou_rotated(a, b).flatten(), rtol=0, atol=1e-5)
    assert got.max().item() > 0.3


def _rotated_nms_case(name):
    """(boxes (R, C, 5), scores (R, C), classes or None, picks, threshold) of a
    rotated NMS case, from seed 3."""
    g = torch.Generator().manual_seed(3)
    if name == "rpn":  # 2 images' level rows of 3000, 300 picks, the RRPN's threshold
        rows, cands, picks, thr = 2, 3000, 300, 0.7
    elif name == "ragged":  # rows of their own counts and their own live shares
        rows, cands, picks, thr = 5, 1500, [400, 7, 1500, 60, 200], 0.5
    elif name == "multi_chunk":  # 200 tight clusters of 50: the picks run out of the first chunk of 8192
        g2 = torch.Generator().manual_seed(4)
        centres = torch.rand(1, 200, 1, 2, generator=g2) * 3000
        size = 20 + torch.rand(1, 200, 1, 3, generator=g2) * torch.tensor([60.0, 60.0, 90.0])
        jitter = torch.randn(1, 200, 50, 5, generator=g2) * torch.tensor([1.0, 1.0, 1.0, 1.0, 2.0])
        boxes = (torch.cat([centres.expand(1, 200, 50, 2), size.expand(1, 200, 50, 3)], -1) + jitter).reshape(1, -1, 5)
        return boxes, torch.rand(1, 10000, generator=g2), None, 300, 0.5
    else:  # the box head's: 4 x 100 candidates of 80 classes, 100 picks, suppression within a class
        rows, cands, picks, thr = 4, 400, 100, 0.5
    centres = torch.rand(rows, cands // 6, 1, 2, generator=g) * 800
    xy = (centres + torch.randn(rows, cands // 6, 6, 2, generator=g) * 12).reshape(rows, -1, 2)
    xy = torch.cat([xy, torch.rand(rows, cands - xy.shape[1], 2, generator=g) * 800], 1)
    boxes = torch.cat([xy, 16 + torch.rand(rows, cands, 2, generator=g) * 80,
                       (torch.rand(rows, cands, 1, generator=g) * 2 - 1) * 90], -1)
    scores = torch.rand(rows, cands, generator=g)
    if name == "ragged":
        for r, live in enumerate((1.0, 0.5, 0.2, 0.0, 0.9)):
            scores[r, torch.rand(cands, generator=g) >= live] = float("-inf")
        boxes[4, :] = boxes[4, :1]  # one box repeated: all suppressed by the first pick
    classes = torch.randint(0, 80, (rows, cands), generator=g) if name == "classes" else None
    if isinstance(picks, list):
        picks = torch.tensor(picks, dtype=torch.int32)
    return boxes, scores, classes, picks, thr


@pytest.mark.parametrize("case", ["rpn", "ragged", "multi_chunk", "classes", "degenerate"])
def test_nms_rotated_kernel_matches_plain(card, case):
    """R2 (nms.cu's pipeline for rotated boxes) against the plain argmax loop
    (``nms_rotated_fixed``) on the card: an RRPN-like row pair, ragged pick
    counts and live shares (a row dead, a row of one repeated box, all
    suppressed by its first pick), a row of 200 clusters of 50 whose picks
    run out of its first chunk (the card's own next round), per-class rows, and
    the degenerate pairs as one row. Index for index, but a row whose first
    difference is decided by an IoU within 1e-5 of the threshold
    (``nms_pick_ties``), at most 0.1% of the picks; one launch a call."""
    from detectron2_centernet_tpu_torch.ops import nms
    from detectron2_centernet_tpu_torch.ops import roi_align_rotated as rot

    if case == "degenerate":
        a, b = _degenerate_pairs()
        boxes, classes, picks, thr = torch.cat([a, b])[None], None, 44, 0.5
        scores = torch.linspace(1, 0.1, boxes.shape[1])[None]
    else:
        boxes, scores, classes, picks, thr = _rotated_nms_case(case)
    boxes, scores = boxes.to(card), scores.to(card)
    classes = None if classes is None else classes.to(card)
    before, rounds = rot.nms_rotated.launches, nms.rounds_taken()
    got = rot.nms_rotated(boxes, scores, thr, picks, classes)
    assert rot.nms_rotated.launches == before + 1
    taken = nms.rounds_taken() - rounds
    want = rot.nms_rotated_fixed(boxes, scores, thr, picks, classes)
    ties = rot.nms_pick_ties(boxes, scores, thr, got, want, classes)
    assert ties["not_ties"] == 0 and ties["ties"] <= 0.001 * ties["picks"], ties
    if ties["differing_rows"] == 0:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert taken >= 1 + (case == "multi_chunk")
    if case == "ragged":
        assert not bool(got[1][3].any()) and int(got[1][4].sum()) == 1 and int(got[1][1].sum()) == 7
    assert int(want[1].sum()) > boxes.shape[0]


def test_iou_rotated_kernel_at_the_rrpn_matching_shape(card):
    """R1 on a train step's RRPN matching: 2 images of 128 gt slots, the
    first 23 and 41 of them gts (angles in ±45°), the rest padded as the
    train loader pads them (zero boxes at the origin, with an angle), against
    the 112 500 anchors of a 50 x 50 res4 map: within 1e-5 of the plain clip
    on the card; a padded slot's IoU is 0 throughout. One launch."""
    from detectron2_centernet_tpu_torch.models.anchors import RotatedAnchorGenerator
    from detectron2_centernet_tpu_torch.ops import roi_align_rotated as rot

    g = torch.Generator().manual_seed(5)
    anchors = RotatedAnchorGenerator([[32, 64, 128, 256, 512]], [[0.5, 1.0, 2.0]], [[-90, 0, 90]], [16])
    b = torch.from_numpy(anchors([(50, 50)])).to(card)
    a = torch.zeros(2, 128, 5)
    a[..., 4] = (torch.rand(2, 128, generator=g) * 2 - 1) * 45
    a[0, :23] = _rotated(g, 23, 50, 750, (20, 400), 45)
    a[1, :41] = _rotated(g, 41, 50, 750, (20, 400), 45)
    a = a.to(card)
    before = rot.pairwise_iou_rotated.launches
    got = rot.pairwise_iou_rotated(a, b)
    assert rot.pairwise_iou_rotated.launches == before + 1
    want = rot.pairwise_iou_rotated_plain(a, b)
    torch.cuda.synchronize()
    assert got.shape == (2, 128, 112500) and bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= 1e-5
    assert not bool(got[0, 23:].any()) and not bool(got[1, 41:].any())
    assert int((got[:, :23] > 0.7).sum()) > 20


def _rpn_train_rows(g, rows=16, cands=12000):
    """(rows, cands, 5) clustered rotated proposals in an 800² image, as the
    RRPN's training rows are (most of a row's picks kept, ~2600 sorted
    candidates deep for 2000 picks), and their scores."""
    centres = torch.rand(rows, cands // 4, 1, 2, generator=g) * 800
    xy = (centres + torch.randn(rows, cands // 4, 4, 2, generator=g) * 6).reshape(rows, cands, 2)
    wh = 16 + torch.rand(rows, cands, 2, generator=g) * 200
    angle = (torch.rand(rows, cands, 1, generator=g) * 2 - 1) * 90
    return torch.cat([xy, wh, angle], -1), torch.rand(rows, cands, generator=g)


def test_nms_rotated_kernel_at_the_rrpn_training_shape(card):
    """R2 on the RRPN's training rows: 16 x 12 000 clustered candidates (past
    one chunk of 8192: the selection passes), 2000 picks, threshold 0.7, in
    one call; its first two rows index for index to the plain argmax loop
    (``nms_rotated_fixed``) on those rows, but for rows whose first
    difference is a tie within 1e-5 of the threshold; every row makes its
    2000 picks."""
    from detectron2_centernet_tpu_torch.ops import roi_align_rotated as rot

    boxes, scores = _rpn_train_rows(torch.Generator().manual_seed(6))
    boxes, scores = boxes.to(card), scores.to(card)
    before = rot.nms_rotated.launches
    keep, valid = rot.nms_rotated(boxes, scores, 0.7, 2000)
    assert rot.nms_rotated.launches == before + 1
    want = rot.nms_rotated_fixed(boxes[:2], scores[:2], 0.7, 2000)
    ties = rot.nms_pick_ties(boxes[:2], scores[:2], 0.7, (keep[:2], valid[:2]), want)
    assert ties["not_ties"] == 0 and ties["ties"] <= 0.001 * ties["picks"], ties
    if ties["differing_rows"] == 0:
        assert torch.equal(keep[:2], want[0]) and torch.equal(valid[:2], want[1])
    assert bool(valid.all())


def test_nms_rotated_kernel_on_near_duplicates_at_the_threshold(card):
    """A row of 600 pairs of near-duplicate rotated boxes: each box's twin
    moved along its own axis so that their IoU lies within 1e-3 of the
    threshold 0.5 (either side; ten of them within 1e-5), the pairs apart
    from each other, scores random. R2 against the plain argmax loop: a difference only where an IoU
    within 1e-5 of the threshold decides it (``nms_pick_ties``)."""
    from detectron2_centernet_tpu_torch.ops import roi_align_rotated as rot

    g = torch.Generator().manual_seed(7)
    n = 600
    # a 30 x 20 grid 40 apart around the origin (f32's rounding of the shoelace grows with the coordinates)
    grid = torch.stack(torch.meshgrid(torch.arange(30.0) - 14.5, torch.arange(20.0) - 9.5, indexing="ij"),
                       -1).reshape(-1, 2) * 40
    w, h = 10 + torch.rand(n, generator=g) * 6, 5 + torch.rand(n, generator=g) * 3
    angle = (torch.rand(n, generator=g) * 2 - 1) * 180
    # same-size boxes shifted by d along the width: IoU = (w - d) / (w + d) = 0.5 at d = w / 3
    d = w / 3 * (1 + (torch.rand(n, generator=g) * 2 - 1) * 2e-3)
    t = torch.deg2rad(angle)
    first = torch.stack([grid[:, 0], grid[:, 1], w, h, angle], -1)
    twin = first.clone()
    twin[:, 0] += d * torch.cos(t)
    twin[:, 1] += d * torch.sin(t)
    boxes = torch.stack([first, twin], 1).reshape(1, 2 * n, 5)
    iou = rot.pairwise_iou_rotated_plain(first[:, None], twin[:, None]).flatten()
    assert (iou - 0.5).abs().max().item() <= 1e-3 and bool((iou > 0.5).any()) and bool((iou <= 0.5).any())
    scores = torch.rand(1, 2 * n, generator=g)
    boxes, scores = boxes.to(card), scores.to(card)
    got = rot.nms_rotated(boxes, scores, 0.5, 2 * n)
    want = rot.nms_rotated_fixed(boxes, scores, 0.5, 2 * n)
    ties = rot.nms_pick_ties(boxes, scores, 0.5, got, want)
    assert ties["not_ties"] == 0, ties
    if ties["differing_rows"] == 0:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert n < int(want[1].sum()) < 2 * n


@pytest.mark.parametrize("case", ["retinanet", "rpn_c4_train", "clusters"])
def test_axis_nms_beside_the_rotated_kind(card, case):
    """The axis-aligned kernels (``greedy_nms``) on existing cases, called
    between two rotated calls of the same library: the picks still equal the
    plain loop's, and only ``greedy_nms``'s count moves."""
    from detectron2_centernet_tpu_torch.ops import nms
    from detectron2_centernet_tpu_torch.ops import roi_align_rotated as rot

    rb, rs = _rpn_train_rows(torch.Generator().manual_seed(8), rows=2, cands=3000)
    rb, rs = rb.to(card), rs.to(card)
    boxes, scores, counts = _nms_case(case)
    boxes, scores, thr = boxes.to(card), scores.to(card), _NMS_CASES[case][4]
    rotated_before = rot.nms_rotated(rb, rs, 0.7, 300)
    launches = (nms.greedy_nms.launches, rot.nms_rotated.launches)
    keep, valid = nms.greedy_nms(boxes, scores, thr, counts)
    assert (nms.greedy_nms.launches, rot.nms_rotated.launches) == (launches[0] + 1, launches[1])
    rotated_after = rot.nms_rotated(rb, rs, 0.7, 300)
    want_keep, want_valid = nms.nms_fixed(boxes, scores, thr, counts)
    assert torch.equal(valid, want_valid) and torch.equal(keep, want_keep)
    assert all(torch.equal(x, y) for x, y in zip(rotated_before, rotated_after))


# -- K1 and the NMS as custom ops; the exported program on the card -------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dcn_custom_op_passes_opcheck_on_the_card(card, dtype):
    """``torch.ops.d2ct.dcn_fwd`` with its CUDA implementation (the kernel):
    schema, fake, autograd registration and AOT dispatch; equal to the
    plain version within the DLA shapes' tolerance, one launch counted a
    call."""
    g = torch.Generator(device="cuda").manual_seed(7)
    dt = getattr(torch, dtype)
    x = torch.randn(2, 32, 12, 14, device=card, generator=g).to(dt)
    offset = torch.randn(2, 18, 12, 14, device=card, generator=g)
    mask = torch.rand(2, 9, 12, 14, device=card, generator=g)
    weight = torch.randn(24, 32, 3, 3, device=card, generator=g).to(dt)
    scale, shift = torch.rand(24, device=card, generator=g) + 0.5, torch.randn(24, device=card, generator=g)
    args = (x, offset, mask, weight, None, scale, shift, True, 1, 1)
    torch.library.opcheck(torch.ops.d2ct.dcn_fwd, args)
    before = dcn.modulated_deform_conv.launches
    got = dcn.modulated_deform_conv(x, offset, mask, weight, post_scale=scale, post_shift=shift, post_relu=True)
    assert dcn.modulated_deform_conv.launches == before + 1
    want = plain.modulated_deform_conv(*args)
    tol = 1e-4 if dtype == "float32" else 1e-2
    assert (got.float() - want.float()).abs().max().item() <= tol * want.float().abs().max().item()


def test_nms_custom_op_passes_opcheck_on_the_card(card):
    """``torch.ops.d2ct.greedy_nms`` with the pipeline of ``nms.cu``: opcheck
    with one count and with a count a row; indices and validity equal to
    the plain loop's."""
    from detectron2_centernet_tpu_torch.ops import nms

    g = torch.Generator(device="cuda").manual_seed(3)
    xy = torch.rand(4, 500, 2, device=card, generator=g) * 300
    boxes = torch.cat([xy, xy + torch.rand(4, 500, 2, device=card, generator=g) * 80 + 1], -1)
    scores = torch.rand(4, 500, device=card, generator=g)
    for k, counts in ((50, None), (40, [10, 40, 0, 25])):
        torch.library.opcheck(torch.ops.d2ct.greedy_nms, (boxes, scores, 0.5, k, counts))
        got = nms.greedy_nms(boxes, scores, 0.5, k if counts is None else counts)
        want = nms.nms_fixed(boxes, scores, 0.5, k if counts is None else counts)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_exported_ctdet_matches_eager_on_the_card(card, tmp_path):
    """A narrow ctdet DLA-34 (bf16) exported on the card, saved, loaded and
    run: 16 K1 launches a forward, its outputs equal eager ``predict_fn``'s;
    the f32 heads in IEEE f32 (``ExportedModel`` runs under ``ieee_f32``)."""
    from detectron2_centernet_tpu_torch.export import custom_op_nodes, export_program, load_exported

    cfg = get_cfg()
    cfg.merge_from_file("configs/COCO-Detection/ctdet_dla_34_1x.yaml")
    cfg.merge_from_list(["MODEL.CENTERNET.CHANNELS", [8, 8, 16, 16, 32, 32], "MODEL.CENTERNET.HEAD_CONV", 16,
                         "DATASETS.TRAIN", (), "TPU.DTYPE", "bfloat16"])
    model = build_model(cfg)
    path = str(tmp_path / "ctdet.pt2")
    program = export_program(model, 2, (128, 128), path)
    assert custom_op_nodes(program) == {"d2ct.dcn_fwd.default": 16}
    x = torch.rand(2, 3, 128, 128, device=card, generator=torch.Generator(device="cuda").manual_seed(1)) * 255
    eager = model.predict_fn(x)
    loaded = load_exported(path)
    before = dcn.modulated_deform_conv.launches
    got = loaded(x)
    assert dcn.modulated_deform_conv.launches == before + 16
    for k, v in eager.items():
        assert torch.equal(got[k], v), k
