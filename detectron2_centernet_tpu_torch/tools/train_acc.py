#!/usr/bin/env python3
"""Training-accuracy run of a detector config on the card: a
``configs/quick_schedules/*training_acc_test.yaml`` read as it is
(``merge_from_file``) with only ``SEED``, ``MODEL.DEVICE``, ``OUTPUT_DIR``
and, as a diagnostic, ``TPU.DTYPE`` set over it, trained through
``tools/train_net``'s ``Trainer`` on the learnable synthetic scenes, then the
evaluation of the test set's ``evaluator_type`` (COCO's, or the sem-seg one)
and ``verify_results`` against the YAML's ``EXPECTED_RESULTS``.

Six configs are meant:
  * ``ctdet_dla_synth_training_acc_test.yaml`` (the default): DLA-34, Adam
    at LR 1e-3, 1500 iterations, batch 8, 128², bf16, PreciseBN over 20
    batches; band bbox AP 93.2 ± 6, measured once on a TPU through the JAX
    package's drop-far Pallas DCN, whose offsets never trained (ROADMAP C1,
    C11);
  * ``ctdet_synth_training_acc_test.yaml``: ResNet-18-deconv (no DCN),
    FREEZE_AT 0, BN, f32, EXACT_MODE, the same schedule; band 91.9 ± 6;
  * ``retinanet_synth_training_acc_test.yaml``: RetinaNet R18-FPN (no DCN),
    BN, f32, SGD at LR 0.01 for 300 steps, batch 8, 128², no PreciseBN;
    band 61.2 ± 8, a JAX measurement;
  * ``mask_rcnn_synth_training_acc_test.yaml``: Mask R-CNN R18-FPN (FPN 32,
    a 2-conv mask head of 32), BN, f32, SGD at LR 0.005 for 300 steps,
    batch 8, 128²; bands bbox AP 87.5 ± 7 and segm AP 84.2 ± 8;
  * ``keypoint_rcnn_synth_training_acc_test.yaml``: Keypoint R-CNN R18-FPN,
    one class, the 8-conv keypoint head of 512, f32, SGD at LR 0.005 for
    1200 steps on ``synth_learnable_kp``; bands bbox AP 92.1 ± 7 and
    keypoints AP 93.3 ± 8;
  * ``semantic_synth_training_acc_test.yaml``: SemanticSegmentor R18-FPN
    (FPN 32, the sem-seg head of 32, 4 classes: the background and the
    three colors), BN, f32, SGD at LR 0.01 for 300 steps, batch 8, 128², on
    ``synth_learnable_semseg``; band sem_seg mIoU 94.9 ± 5.
The bands are the YAMLs' ``TEST.EXPECTED_RESULTS``, measured by the JAX
package on a TPU. The run reports; it tunes nothing to reach a band.
Trailing ``KEY VALUE`` pairs go over the YAML (e.g. ``MODEL.ROI_HEADS.NAME
CascadeROIHeads MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG True`` trains
Cascade Mask R-CNN on the Mask R-CNN config, for which no band exists: its
AP is recorded, not judged).

Each seed trains in a subprocess of its own. For each, the number of every
task the YAML's ``EXPECTED_RESULTS`` names (bbox, segm, keypoints AP; sem_seg mIoU), the
exit code (``verify_results`` exits 1 on a miss) and the wall time are
printed (and, as a diagnostic when the config runs PreciseBN, the AP with
the training EMA's running statistics in place of PreciseBN's), and the
whole summary goes to
``OUTPUT/summary.json``; the last line of the output is the summary as
JSON. The script exits non-zero only when a seed's run did not reach its
evaluation.

Two diagnostics, not the accuracy run: ``--dtype float32`` trains at f32
in place of the YAML's width; ``--freeze-offsets`` zeroes the gradient of
the 18 offset rows of every DCN's ``conv_offset_mask``, so the
zero-initialised offsets stay 0 and only the masks train, as under the JAX
package's TPU kernel, whose offset gradient is 0 at integer sample
positions (ROADMAP C1).

Usage:
  python -m detectron2_centernet_tpu_torch.tools.train_acc [--config-file YAML]
      [--seeds 42 43 44] [--output-dir output/train_acc] [--device cuda]
      [--dtype bfloat16|float32] [--freeze-offsets] [KEY VALUE ...]
"""

import argparse
import json
import logging
import os
import subprocess
import sys
import time
from typing import Optional, Sequence

import torch

YAML = "configs/quick_schedules/ctdet_dla_synth_training_acc_test.yaml"
SEEDS = (42, 43, 44)  # the YAML's SEED first


def acc_cfg(config_file: str = YAML, seed: int = 42, device: str = "cuda",
            output_dir: Optional[str] = None, dtype: Optional[str] = None, opts: Sequence[str] = ()):
    """``config_file`` over the defaults, then the ``opts`` pairs, with
    ``SEED`` and ``MODEL.DEVICE`` set, ``TPU.DTYPE`` when ``dtype`` is given
    and ``OUTPUT_DIR`` when ``output_dir`` is."""
    from ..config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(config_file)
    cfg.merge_from_list(list(opts) + ["SEED", seed, "MODEL.DEVICE", device])
    if dtype is not None:
        cfg.TPU.DTYPE = dtype
    if output_dir is not None:
        cfg.OUTPUT_DIR = output_dir
    return cfg


def run_one(config_file: str, seed: int, device: str, output_dir: str, dtype: Optional[str],
            freeze_offsets: bool, opts: Sequence[str] = ()) -> int:
    """Train and evaluate one seed in this process; write ``result.json``
    (the results, whether they passed) before ``verify_results`` exits.
    When the config runs PreciseBN, it records beside the verified AP, as a
    diagnostic, the AP of the same weights with the running statistics that
    PreciseBN replaced (the EMA of training); else that entry is null."""
    from ..data.datasets import ensure_synthetic_datasets
    from ..engine import hooks
    from ..models.layers import DCNv2
    from .train_net import Trainer

    cfg = acc_cfg(config_file, seed, device, output_dir, dtype, opts)
    ensure_synthetic_datasets(list(cfg.DATASETS.TRAIN) + list(cfg.DATASETS.TEST))
    trainer = Trainer(cfg)
    trainer.resume_or_load(resume=False)
    net = trainer.model.model
    if freeze_offsets:
        if not any(isinstance(m, DCNv2) for m in net.modules()):
            raise SystemExit(f"--freeze-offsets: the model of {config_file} has no DCN")
        for m in net.modules():
            if isinstance(m, DCNv2):
                for p in (m.conv_offset_mask.weight, m.conv_offset_mask.bias):
                    keep = torch.ones_like(p)
                    keep[:18] = 0  # rows 0-17: the offsets; 18-26: the mask logits
                    p.register_hook(lambda g, keep=keep: g * keep)
    running = lambda: {k: v.clone() for k, v in net.state_dict().items() if "running" in k}
    ema = {}
    precise = next((h for h in trainer._hooks if isinstance(h, hooks.PreciseBN)), None)
    if precise is not None:
        update = precise.update_stats

        def keep_ema_then_update():
            ema.clear()
            ema.update(running())
            update()

        precise.update_stats = keep_ema_then_update
    code = 0
    try:
        trainer.train()
    except SystemExit as e:  # verify_results' miss: recorded, then passed on
        code = int(e.code or 0)
    results = getattr(trainer, "_last_eval_results", None)
    results_ema = None
    if precise is not None:
        net.load_state_dict(ema, strict=False)
        ema_cfg = cfg.clone()
        ema_cfg.OUTPUT_DIR = os.path.join(output_dir, "ema_statistics")
        results_ema = Trainer.test(ema_cfg, trainer.model)
    with open(os.path.join(output_dir, "result.json"), "w") as f:
        json.dump({"seed": seed, "results": results, "verify_exit_code": code,
                   "results_with_ema_statistics": results_ema}, f)
    return code


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config-file", default=YAML, metavar="YAML")
    parser.add_argument("--seeds", type=int, nargs="+", default=list(SEEDS))
    parser.add_argument("--output-dir", default="output/train_acc")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), help="default: the YAML's TPU.DTYPE")
    parser.add_argument("--freeze-offsets", action="store_true")
    parser.add_argument("--one-seed", type=int, help=argparse.SUPPRESS)  # a child's seed
    parser.add_argument("opts", nargs=argparse.REMAINDER, help="KEY VALUE pairs over the YAML")
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    if args.one_seed is not None:
        return run_one(args.config_file, args.one_seed, args.device, args.output_dir, args.dtype,
                       args.freeze_offsets, args.opts)

    cfg = acc_cfg(args.config_file, device="cpu", dtype=args.dtype, opts=args.opts)
    expected = [list(e) for e in cfg.TEST.EXPECTED_RESULTS]
    runs, crashed = [], False
    for seed in args.seeds:
        out = os.path.join(args.output_dir, f"seed_{seed}")
        os.makedirs(out, exist_ok=True)
        t0 = time.perf_counter()
        with open(os.path.join(out, "log.txt"), "w") as log:
            proc = subprocess.run(
                [sys.executable, "-m", "detectron2_centernet_tpu_torch.tools.train_acc",
                 "--config-file", args.config_file, "--one-seed", str(seed), "--device", args.device,
                 "--output-dir", out] + (["--dtype", args.dtype] if args.dtype else [])
                + (["--freeze-offsets"] if args.freeze_offsets else []) + list(args.opts),
                stdout=log, stderr=subprocess.STDOUT)
        wall = time.perf_counter() - t0
        path = os.path.join(out, "result.json")
        result = json.load(open(path)) if os.path.exists(path) else None
        results = (result or {}).get("results") or {}
        ap = results.get("bbox", {}).get("AP")
        measured = {f"{task}_{metric}": results.get(task, {}).get(metric) for task, metric, _, _ in expected}
        ap_ema = ((result or {}).get("results_with_ema_statistics") or {}).get("bbox", {}).get("AP")
        crashed |= result is None or any(v is None for v in measured.values())
        runs.append({"seed": seed, "bbox_AP": ap, **measured, "exit_code": proc.returncode, "wall_s": wall,
                     "bbox_AP_with_ema_statistics": ap_ema})
        print(f"seed {seed}: {measured}, exit code {proc.returncode}, {wall:.1f} s (expected {expected}); "
              f"bbox AP with the EMA statistics in place of PreciseBN's {ap_ema}", flush=True)
    summary = {"config": args.config_file, "opts": list(args.opts), "dtype": cfg.TPU.DTYPE, "freeze_offsets": args.freeze_offsets,
               "expected": expected, "runs": runs}
    with open(os.path.join(args.output_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 1 if crashed else 0


if __name__ == "__main__":
    sys.exit(main())
