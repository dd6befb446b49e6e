#!/usr/bin/env python3
"""How much an R-CNN trunk magnifies f32 rounding, on the CPU: the dconv Mask
R-CNN (``Misc/mask_rcnn_R_50_FPN_1x_dconv_c3-c5.yaml``, DCNv1 in res3-res5)
against the plain Mask R-CNN R50-FPN, at full width on two 320² images, with
the weights ``chip_smoke.py`` serves: the port's init at ``SEED`` 0, random
offset convs (N(0, 1/fan_in): about a pixel) and FrozenBN statistics measured
on the images.

Every 3x3 of the bottom-up trunk (deformable or not) has its output
multiplied by (1 + eps · N(0, 1)), and the script prints how far that moves
each FPN map, relative to the map's max |value|: a rounding error of eps at
every 3x3 ends up that large at the FPN. The last line is all of it as JSON.

Usage:
  python -m detectron2_centernet_tpu_torch.tools.rounding_gain [--eps 1e-6] [--size 320]
"""

import argparse
import json
import math
import os

import numpy as np
import torch

from ..config import get_cfg
from ..models import build_model
from ..models.backbones.resnet import BottleneckBlock, DeformBottleneckBlock
from ..models.layers import FrozenBatchNorm

CONFIGS = {"dconv": ("Misc", "mask_rcnn_R_50_FPN_1x_dconv_c3-c5"),
           "plain": ("COCO-InstanceSegmentation", "mask_rcnn_R_50_FPN_1x")}
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def seeded_model(folder: str, name: str, images: torch.Tensor):
    """The config's model on the CPU in f32 with random offset convs and
    FrozenBN statistics := the images' (biased, as flax's)."""
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", folder, name + ".yaml"))
    cfg.merge_from_list(["MODEL.WEIGHTS", "", "MODEL.DEVICE", "cpu", "TPU.DTYPE", "float32", "SEED", 0])
    model = build_model(cfg)
    g = torch.Generator().manual_seed(0)

    def calibrate(frozen, inputs):
        frozen.running_mean.copy_(inputs[0].mean((0, 2, 3)))
        frozen.running_var.copy_(inputs[0].var((0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(calibrate) for m in model.model.modules() if isinstance(m, FrozenBatchNorm)]
    with torch.no_grad():
        for m in model.model.modules():
            if isinstance(m, DeformBottleneckBlock):
                w = m.conv2_offset.weight
                w.copy_(torch.randn(w.shape, generator=g) / math.sqrt(w[0].numel()))
        model.model(model.normalize(images))
    for h in hooks:
        h.remove()
    return model.model.eval(), model.normalize


def fpn_drift(net, normalize, image: torch.Tensor, eps: float) -> dict:
    """{FPN level: max |perturbed − clean| / max |clean|}."""
    def run(perturb):
        g = torch.Generator().manual_seed(1)
        hooks = [m.conv2.register_forward_hook(lambda mod, inp, out: out * (1 + eps * torch.randn(out.shape, generator=g)))
                 for m in net.modules() if perturb and isinstance(m, (BottleneckBlock, DeformBottleneckBlock))]
        with torch.no_grad():
            feats = net(normalize(image))[0]
        for h in hooks:
            h.remove()
        return feats

    clean, perturbed = run(False), run(True)
    return {k: ((clean[k] - perturbed[k]).abs().max() / clean[k].abs().max()).item() for k in clean}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--eps", type=float, default=1e-6)
    parser.add_argument("--size", type=int, default=320)
    args = parser.parse_args()
    images = torch.from_numpy(np.random.RandomState(5).randint(0, 256, (2, 3, args.size, args.size))
                              .astype(np.float32))
    out = {}
    for label, (folder, name) in CONFIGS.items():
        net, normalize = seeded_model(folder, name, images)
        out[label] = fpn_drift(net, normalize, images[:1], args.eps)
        print(f"{label:5s} ({name}): " + ", ".join(f"{k} {v:.2e}" for k, v in out[label].items()))
    print(json.dumps({"eps": args.eps, "size": args.size, "fpn_drift": out}))


if __name__ == "__main__":
    main()
