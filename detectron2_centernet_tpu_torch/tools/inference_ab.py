"""Inference latency of one checkout of the PyTorch port, for A/B runs on one
card: ``predict_fn`` at batch 1 (host clock around synchronized calls, median
of 30), a ``DefaultPredictor`` request (median of 30) and ``predict_fn`` at
batch 16 (CUDA events over 10 calls); ctdet DLA-34, 512², bf16, the model's
own init. The checkout measured is the one on PYTHONPATH, whatever checkout
this file comes from: to compare two, unpack one with ``git archive`` into a
directory git ignores and run them in turns in one call (a, b, b, a)::

    for t in output/parent . . output/parent; do
        PYTHONPATH=$t python3 detectron2_centernet_tpu_torch/tools/inference_ab.py; done
"""
import statistics
import time

import numpy as np
import torch

import detectron2_centernet_tpu_torch as pkg
from detectron2_centernet_tpu_torch.config import get_cfg
from detectron2_centernet_tpu_torch.data import letterbox_transform, warp_image
from detectron2_centernet_tpu_torch.engine import DefaultPredictor


def main() -> None:
    cfg = get_cfg()
    cfg.merge_from_list([
        "MODEL.META_ARCHITECTURE", "CenterNet", "MODEL.BACKBONE.NAME", "build_dla34_backbone",
        "MODEL.PIXEL_MEAN", [0.408, 0.447, 0.470], "MODEL.PIXEL_STD", [0.289, 0.274, 0.278],
        "INPUT.TEST_SIZE", (512, 512), "TEST.BATCH_SIZE", 16, "TPU.DTYPE", "bfloat16", "SEED", 0,
    ])
    predictor = DefaultPredictor(cfg)
    model = predictor.model
    img = np.random.RandomState(0).randint(0, 256, (480, 640, 3)).astype(np.uint8)
    warped = warp_image(img, letterbox_transform(480, 640, (512, 512)), (512, 512), device="cuda")
    batch = torch.stack([warped.permute(2, 0, 1)] * 16)
    one = batch[:1].contiguous()
    for _ in range(5):
        model.predict_fn(one)
        predictor(img)
    torch.cuda.synchronize()
    b1, req = [], []
    for _ in range(30):
        t0 = time.perf_counter()
        model.predict_fn(one)
        torch.cuda.synchronize()
        b1.append((time.perf_counter() - t0) * 1e3)
    for _ in range(30):
        t0 = time.perf_counter()
        predictor(img)  # returns host arrays: the card's work is done
        req.append((time.perf_counter() - t0) * 1e3)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(2):
        model.predict_fn(batch)
    start.record()
    for _ in range(10):
        model.predict_fn(batch)
    end.record()
    end.synchronize()
    tree = pkg.__file__.split("/detectron2_centernet_tpu_torch")[0]
    print(f"{tree}: predict_fn b1 median {statistics.median(b1):.3f} ms, request median "
          f"{statistics.median(req):.3f} ms, b16 {16e4 / start.elapsed_time(end):.1f} img/s", flush=True)


if __name__ == "__main__":
    main()
