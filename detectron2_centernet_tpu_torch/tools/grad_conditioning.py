#!/usr/bin/env python3
"""How far f32 rounding moves the training gradients of the small ResNet-
and VoVNet-deconv CenterNets that the tests compare (64², batch 2, weights
from the port's init at ``SEED`` 0, 4 classes), on the CPU.

For each model it runs the loss and backward once in f32 and once in f64
(trunk, neck and head towers in f64; the heads' last convs and the losses
stay f32, as in both packages) and prints, f32 run against f64 run:
  * ``forward_drift``: the neck's output (what the heads read), relative
    to its max |value|;
  * ``relu_flips``: BatchNorm outputs on the way to the heads whose sign
    differs, so that the ReLU after them passes the cotangent in one run
    and blocks it in the other, and how many outputs there are;
  * ``cotangent``: the loss's gradient at the head outputs, relative to
    its max |value|;
  * ``grad_worst`` and ``grad_median``: every parameter's gradient,
    relative to its max |value|, worst and median over the parameters.
The last line is all of it as JSON.

Usage:
  python -m detectron2_centernet_tpu_torch.tools.grad_conditioning
"""

import copy
import json

import numpy as np
import torch

from ..config import get_cfg
from ..models import build_model
from ..models.meta_arch.centernet import head_out

SIZE = 64
MODELS = {  # as tests/test_torch_cuda.py's small trunks
    "resnet18_bn": ["MODEL.BACKBONE.NAME", "build_resnet_deconv_backbone", "MODEL.RESNETS.DEPTH", 18,
                    "MODEL.RESNETS.RES2_OUT_CHANNELS", 16, "MODEL.RESNETS.STEM_OUT_CHANNELS", 8,
                    "MODEL.RESNETS.NORM", "BN", "MODEL.BACKBONE.FREEZE_AT", 0],
    "vovnet19_slim": ["MODEL.BACKBONE.NAME", "build_vovnet_backbone", "MODEL.VOVNET.CONV_BODY", "V-19-slim-eSE"],
    "vovnet19_slim_dw": ["MODEL.BACKBONE.NAME", "build_vovnet_backbone",
                         "MODEL.VOVNET.CONV_BODY", "V-19-slim-dw-eSE"],
}


def batch(seed: int = 1, n: int = 2, m: int = 6) -> dict:
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 40, (n, m, 2))
    boxes = np.concatenate([xy, np.minimum(xy + rng.uniform(4, 30, (n, m, 2)), SIZE - 1)], -1)
    return {"image": torch.from_numpy(rng.uniform(0, 255, (n, 3, SIZE, SIZE)).astype(np.float32)),
            "gt_boxes": torch.from_numpy(boxes.astype(np.float32)),
            "gt_classes": torch.from_numpy(rng.randint(0, 4, (n, m))), "gt_valid": torch.ones(n, m, dtype=torch.bool)}


def f64(model: torch.nn.Module) -> torch.nn.Module:
    """A copy computing in f64 but for the heads' last convs (f32)."""
    model = copy.deepcopy(model).double()
    for name in model.head_names:
        head_out(getattr(model, name)).float()
    model.backbone.register_forward_pre_hook(lambda m, args: (args[0].double(),) + args[1:])
    return model


def run(meta, model, data) -> dict:
    """The neck's output, the BatchNorm outputs that reach the heads, the
    head outputs' cotangent and the parameters' gradients of one loss and
    backward."""
    meta = copy.copy(meta)
    meta.model = model.train()
    seen = {"heads": {}, "norms": {}}
    model.deconv_layers.register_forward_hook(lambda m, i, o: seen.__setitem__("neck", o.detach().double()))
    for name in model.head_names:
        getattr(model, name).register_forward_hook(lambda m, i, o, name=name: seen["heads"].__setitem__(name, o))
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d) and not name.startswith("backbone.stage5"):  # stage5 feeds no head
            m.register_forward_hook(lambda m, i, o, name=name: seen["norms"].__setitem__(name, o.detach() > 0))
    total, _ = meta.loss_fn(data)
    for z in seen["heads"].values():
        z.retain_grad()
    total.backward()
    seen["cotangent"] = {k: z.grad.double() for k, z in seen["heads"].items()}
    seen["grads"] = {k: p.grad.double() for k, p in model.named_parameters() if p.grad is not None}
    return seen


def rel(got: dict, want: dict) -> list:
    return [((got[k] - w).abs().max() / w.abs().max()).item() for k, w in want.items()]


def main() -> dict:
    out = {}
    data = batch()
    for name, extra in MODELS.items():
        cfg = get_cfg()
        cfg.merge_from_list(["MODEL.META_ARCHITECTURE", "CenterNet", "MODEL.CENTERNET.HEAD_CONV", 16,
                             "MODEL.CENTERNET.TASK.HM", 4, "TPU.DTYPE", "float32", "MODEL.DEVICE", "cpu",
                             "SEED", 0] + extra)
        meta = build_model(cfg)
        want = run(meta, f64(meta.model), data)
        got = run(meta, copy.deepcopy(meta.model), data)
        grad = rel(got["grads"], want["grads"])
        out[name] = {"forward_drift": max(rel({0: got["neck"]}, {0: want["neck"]})),
                     "relu_flips": sum(int((got["norms"][k] != v).sum()) for k, v in want["norms"].items()),
                     "bn_outputs": sum(v.numel() for v in want["norms"].values()),
                     "cotangent": max(rel(got["cotangent"], want["cotangent"])),
                     "grad_worst": max(grad), "grad_median": float(np.median(grad))}
        print(name, " ".join(f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}" for k, v in out[name].items()))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
