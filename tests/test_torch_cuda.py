"""The port on the card (marker ``cuda``): the Hopper DCN kernel against its
plain PyTorch version, and the small DLA-34 CenterNet on the card against
itself on the CPU.

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


def test_kernel_refuses_autograd(card):
    x, offset, mask, weight, _ = _case(1)
    x = x.to(card).requires_grad_()
    with pytest.raises(NotImplementedError):
        dcn.modulated_deform_conv(x, offset.to(card), mask.to(card), weight.to(card))


def test_small_centernet_on_card_matches_cpu(card):
    """The small DLA-34 CenterNet in f32 (random offset convs and BN
    statistics): one forward makes 16 kernel launches, and its heads agree
    with the CPU model's to 1e-3 of their scale."""
    cfg = get_cfg()
    cfg.merge_from_list([
        "MODEL.META_ARCHITECTURE", "CenterNet", "MODEL.BACKBONE.NAME", "build_dla34_backbone",
        "MODEL.CENTERNET.CHANNELS", [8, 8, 16, 16, 32, 32], "MODEL.CENTERNET.HEAD_CONV", 16,
        "MODEL.CENTERNET.TASK.HM", 4, "TPU.DTYPE", "float32", "MODEL.DEVICE", "cpu",
    ])
    host = build_model(cfg)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, t in host.model.state_dict().items():
            if "conv_offset_mask" in name or "running" in name:
                t.copy_(torch.rand(t.shape, generator=g) * (0.5 if "mask" in name else 1.0)
                        + (0.5 if "running_var" in name else 0.0))
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
