#!/usr/bin/env python3
"""Export a model to a deployable ``torch.export`` artifact (counterpart of
the repository's ``tools/export_model.py``; the reference's
``tools/deploy/caffe2_converter.py``).

It builds the config's model on ``MODEL.DEVICE`` (``cuda`` by default),
loads ``MODEL.WEIGHTS`` when given (else the seeded init), optionally
quantizes its conv and dense kernels to int8 and back (``--int8``), traces
``predict_fn`` at a fixed batch and image size and writes, under
``--output``:

  model.pt2          the program with its weights (``export/api.py``)
  export_meta.json   format, meta-architecture, batch, size, int8, bytes, the custom-op nodes
  config.yaml        the config (the port's YAML emitter)

``--run-smoke`` loads the artifact back and runs it once on zeros.

Usage:
  python -m detectron2_centernet_tpu_torch.tools.export_model \\
      --config-file configs/COCO-Detection/ctdet_dla_34_1x.yaml --output out/ctdet \\
      [--batch-size 16] [--image-size 512 512] [--int8] [--run-smoke] [KEY VALUE ...]
"""

import argparse
import json
import logging
import os
import sys

import torch

from ..config import get_cfg

logger = logging.getLogger("export_model")


def setup_cfg(args):
    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts or [])
    cfg.freeze()
    return cfg


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Export a model to a torch.export deployment artifact.")
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--output", required=True, help="output directory")
    parser.add_argument("--format", choices=["pt2"], default="pt2",
                        help="artifact format (a torch.export program, torch.export.save's .pt2)")
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--image-size", type=int, nargs=2, default=None, metavar=("H", "W"),
                        help="input size; defaults to cfg.INPUT.TEST_SIZE")
    parser.add_argument("--int8", action="store_true",
                        help="quantize conv/linear kernels to int8 (PTQ) and back before export")
    parser.add_argument("--run-smoke", action="store_true",
                        help="reload the artifact and run one forward to validate it")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    logger.info("Command line arguments: %s", args)

    from ..checkpoint.torch_import import load_model_weights
    from ..export import custom_op_nodes, dequantize_variables, export_program, load_exported, quantize_variables
    from ..models import build_model

    cfg = setup_cfg(args)
    size = tuple(args.image_size) if args.image_size else tuple(cfg.INPUT.TEST_SIZE)
    model = build_model(cfg)
    if cfg.MODEL.WEIGHTS:
        load_model_weights(model.model, cfg.MODEL.WEIGHTS, per_collection=False)
    else:
        logger.warning("MODEL.WEIGHTS is empty; exporting the seeded init.")
    if args.int8:
        model.model.load_state_dict(dequantize_variables(quantize_variables(model.model)))
        logger.info("Applied int8 PTQ to conv/linear kernels.")

    os.makedirs(args.output, exist_ok=True)
    path = os.path.join(args.output, "model.pt2")
    program = export_program(model, batch_size=args.batch_size, image_size=size, path=path)
    meta = {
        "format": args.format,
        "meta_architecture": cfg.MODEL.META_ARCHITECTURE,
        "batch_size": args.batch_size,
        "image_size": list(size),
        "int8": bool(args.int8),
        "bytes": os.path.getsize(path),
        "custom_ops": custom_op_nodes(program),
        "device": cfg.MODEL.DEVICE,
    }
    with open(os.path.join(args.output, "export_meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    with open(os.path.join(args.output, "config.yaml"), "w") as f:
        f.write(cfg.dump())
    logger.info("Wrote %d-byte artifact to %s", meta["bytes"], path)

    if args.run_smoke:
        exported = load_exported(path)
        out = exported(torch.zeros(exported.input_shape))
        for k, v in sorted(out.items()):
            logger.info("smoke output %-12s shape=%s dtype=%s", k, tuple(v.shape), v.dtype)
        logger.info("Smoke run OK.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
