#!/usr/bin/env python3
"""Model analysis (counterpart of the repository's ``tools/analyze_model.py``;
the reference's): the parameter table, the FLOPs of one image at
``INPUT.TEST_SIZE`` (``predict_fn`` at batch 1, ``utils/analysis.py::
flop_count``) and the module structure of a config's model, built on
``MODEL.DEVICE``.

Usage:
  python -m detectron2_centernet_tpu_torch.tools.analyze_model \\
      --config-file configs/COCO-Detection/ctdet_dla_34_1x.yaml [--tasks parameter flop structure --] \\
      [KEY VALUE ...]
"""

import argparse
import sys

import torch

from ..config import get_cfg
from ..models import build_model
from ..utils.analysis import flop_count, parameter_count_table


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--tasks", nargs="+", default=["parameter"], choices=["flop", "parameter", "structure"])
    parser.add_argument("opts", default=[], nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    opts = args.opts[1:] if args.opts[:1] == ["--"] else args.opts  # "--tasks a b -- KEY VALUE ..."

    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(opts)
    cfg.freeze()

    model = build_model(cfg)
    size = tuple(cfg.INPUT.TEST_SIZE)
    for task in args.tasks:
        if task == "parameter":
            print(parameter_count_table(model.model))
        elif task == "structure":
            print(model.model)
        elif task == "flop":
            images = torch.zeros((1, 3, size[0], size[1]), dtype=torch.float32, device=model.device)
            flops = flop_count(model.predict_fn, images)
            print(f"inference flops: {flops / 1e9:.2f} GFLOPs/image")
    return 0


if __name__ == "__main__":
    sys.exit(main())
