"""The f32 TTA comparison of ``chip_smoke.py`` 25a over more cases, on one
card: ctdet DLA-34 at full width, ``TTAPredictor`` at 416² and 512² with the
flip, the card's merged detections against the CPU's by
``chip_smoke.merged_close`` (the comparison 25a makes, with its tolerances
and its cap on near-ties).

* Cases: seeded weights from each of ``--weight-seeds`` (calibrated as 25a's
  seed 0 is, on two letterboxed images of that seed), each on
  ``--images`` random 480x640 images (``RandomState(25 + k)``; k = 0 of
  weight seed 0 is 25a's own case); the first case is run ``--repeats``
  times on the card (run-to-run changes).
* Wrong K1s, on the first case: the real kernel with its inputs or output
  changed, ``mutant_op``'s kinds: "bf16_out" (the output rounded through
  bf16, as a kernel that kept its f32 result in bf16), "offset_1/16px"
  (every offset moved by 1/16 px), "centre_tap_unmasked" (the centre tap's
  mask read as 1). The comparison must fail each of them.

Every line is one case's ``merged_close`` result, each unpaired detection
traced through the variants' detections before the merge (``trace``);
``--json`` also writes them all. Run from the repository's root::

    PYTHONPATH=. python3 detectron2_centernet_tpu_torch/tools/tta_check.py --json output/tta_check.json
"""
import argparse
import json
import time

import numpy as np
import torch

from detectron2_centernet_tpu_torch.models.test_time_augmentation import TTAPredictor
from detectron2_centernet_tpu_torch.ops import dcn

MUTANTS = ("bf16_out", "offset_1/16px", "centre_tap_unmasked")


def mutant_op(kind: str, real):
    """K1's custom op ``real`` with the change ``kind`` (see the module's
    docstring) around the kernel."""

    def op(x, offset, mask, weight, *rest):
        if kind == "offset_1/16px":
            offset = offset + 1 / 16
        elif kind == "centre_tap_unmasked":
            mask = mask.clone()
            mask[:, 4] = 1
        out = real(x, offset, mask, weight, *rest)
        return out.to(torch.bfloat16).to(out.dtype) if kind == "bf16_out" else out

    return op


def record_variants(tta: TTAPredictor) -> None:
    """Keep the detections of each variant of ``tta``'s next call, after
    ``postprocess`` and before the merge, in ``tta.variants``."""
    post = tta.model.postprocess
    tta.variants = []

    def recording(*args, **kwargs):
        out = post(*args, **kwargs)
        tta.variants.append(out[0]["instances"])
        return out

    tta.model.postprocess = recording


def iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of box ``a`` (4,) with each of ``b`` (M, 4), XYXY."""
    w = np.clip(np.minimum(a[2], b[:, 2]) - np.maximum(a[0], b[:, 0]), 0, None)
    h = np.clip(np.minimum(a[3], b[:, 3]) - np.maximum(a[1], b[:, 1]), 0, None)
    inter = w * h
    area = lambda x: (x[..., 2] - x[..., 0]) * (x[..., 3] - x[..., 1])
    return inter / np.maximum(area(a) + area(b) - inter, 1e-12)


def trace(lone, merged: dict, variants: dict, score_tol: float, box_tol: float, nms_thresh: float) -> list:
    """Where each unpaired detection ``(side, rank, class, score)`` of
    ``merged_close`` comes from: the variant and rank that gave it on its
    side, and on the other side either the variant detection that matches
    it (class, score, box) with the IoU of its box against the other
    side's merged boxes of its class that score higher (the merge's NMS
    dropped it there where that IoU is over ``nms_thresh``; else the cut at
    the merged top K did) or, where none matches, the nearest variant
    detection of its class (a peak, a class or a variant's top-K cut that
    the rounding moved): the nearest by box, the nearest by score (with
    the distance of the box centres) and the same box under another
    class."""
    out = []
    for side, rank, cls, score in lone:
        other = "want" if side == "got" else "got"
        box = np.asarray(merged[side]["instances"].pred_boxes.tensor[rank])
        mine = [(v, r) for v, inst in enumerate(variants[side]) for r in range(len(inst))
                if inst.pred_classes[r] == cls and abs(inst.scores[r] - score) <= score_tol
                and np.abs(np.asarray(inst.pred_boxes.tensor[r]) - box).max() <= box_tol]
        row = dict(side=side, rank=rank, cls=cls, score=score, from_variant=mine[:1])
        found, nearest, closest, same_box = None, None, None, None
        centre = (box[:2] + box[2:]) / 2
        for v, inst in enumerate(variants[other]):
            for r in range(len(inst)):
                b = np.asarray(inst.pred_boxes.tensor[r])
                d = float(np.abs(b - box).max())
                ds = float(inst.scores[r] - score)
                if inst.pred_classes[r] != cls:
                    if d <= box_tol and same_box is None:  # the same box under another class
                        same_box = dict(at=(v, r), cls=int(inst.pred_classes[r]), score_diff=ds)
                    continue
                if d <= box_tol and abs(ds) <= score_tol and found is None:
                    found = (v, r)
                if nearest is None or d < nearest["box_px"]:
                    nearest = dict(at=(v, r), box_px=d, score_diff=ds)
                if closest is None or abs(ds) < abs(closest["score_diff"]):
                    closest = dict(at=(v, r), score_diff=ds, box_px=d,
                                   centre_px=float(np.abs((b[:2] + b[2:]) / 2 - centre).max()))
        if found is not None:
            m = merged[other]["instances"]
            above = (m.pred_classes == cls) & (m.scores > score)
            overlap = iou(box, np.asarray(m.pred_boxes.tensor)[above]).max(initial=0.0)
            row.update(other_side="in a variant", at=found, max_iou_with_kept=float(overlap),
                       dropped_by="the merge's NMS" if overlap > nms_thresh else "the top-K cut",
                       other_lowest_kept=float(m.scores.min()))
        else:
            row.update(other_side="in no variant", nearest_box=nearest, nearest_score=closest,
                       same_box_other_class=same_box)
        out.append(row)
    return out


def main() -> None:
    import chip_smoke as cs  # the repository's root on PYTHONPATH

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--weight-seeds", type=int, nargs="+", default=[0, 1, 2])
    parser.add_argument("--images", type=int, default=3, help="images per weight seed")
    parser.add_argument("--repeats", type=int, default=3, help="card runs of the first case")
    parser.add_argument("--json", help="also write every case's result to this file")
    args = parser.parse_args()
    torch.backends.cudnn.allow_tf32 = False  # as chip_smoke.py: f32 comparisons in true f32
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = cs.ctdet_cfg(cs.DLA, "float32")
    rows = []

    def record(case, close, seconds, merged):
        close = dict(case=case, seconds=seconds, **close)
        if close["lone"]:
            variants = {"got": tta["cuda"].variants, "want": tta["cpu"].variants}
            close["trace"] = trace(close["lone"], merged, variants, cs.TTA_SCORE_TOL, cs.TTA_BOX_TOL,
                                   tta["cpu"].nms_thresh)
        rows.append(close)
        print(json.dumps(close, default=float), flush=True)

    for seed in args.weight_seeds:
        calib = cs.letterboxed(np.random.RandomState(seed), "cpu", 2, (512, 512))
        weights = cs.seeded_weights(cfg32, calib, seed=seed)
        tta = {}
        for dev in ("cuda", "cpu"):
            c = cfg32.clone()
            c.MODEL.DEVICE = dev
            model = cs.build_model(c)
            model.model.load_state_dict(weights)
            tta[dev] = TTAPredictor(c, model, sizes=cs.TTA_SIZES_CPU, flip=True)
            record_variants(tta[dev])
        for k in range(args.images):
            img = np.random.RandomState(25 + k).randint(0, 256, cs.EVAL_SIZE + (3,)).astype(np.uint8)
            t0 = time.perf_counter()
            tta["cpu"].variants.clear()
            want = tta["cpu"](img)
            first = seed == args.weight_seeds[0] and k == 0
            for r in range(args.repeats if first else 1):
                tta["cuda"].variants.clear()
                got = tta["cuda"](img)
                record(f"weights {seed}, image {k}" + (f", card run {r}" if first else ""),
                       cs.merged_close(got, want), time.perf_counter() - t0, {"got": got, "want": want})
            if first:
                real = dcn.dcn_fwd_op
                for kind in MUTANTS:
                    dcn.dcn_fwd_op = mutant_op(kind, real)
                    try:
                        tta["cuda"].variants.clear()
                        got = tta["cuda"](img)
                    finally:
                        dcn.dcn_fwd_op = real
                    record(f"weights {seed}, image {k}, wrong K1: {kind}", cs.merged_close(got, want), 0.0,
                           {"got": got, "want": want})
    sound = [r for r in rows if "wrong K1" not in r["case"]]
    mutants = [r for r in rows if "wrong K1" in r["case"]]
    print(f"seeded cases passing: {sum(r['ok'] for r in sound)} of {len(sound)}; wrong K1s failing: "
          f"{sum(not r['ok'] for r in mutants)} of {len(mutants)}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, default=float, indent=1)


if __name__ == "__main__":
    main()
