"""COCO evaluation with the matching loop in C++ (ctypes binding; a copy of
the JAX package's ``ops/fast_cocoeval.py``).

Counterpart of the reference's ``COCOeval_opt`` (``fast_eval_api.py:10-118``
driving ``_C.COCOevalEvaluateImages``): numpy computes the IoUs, C++
(``csrc/cocoeval.cpp``, the port's own copy) runs the per-image greedy
matching of all images of a (category, area range) in one call, numpy
accumulates the precision/recall curves. The results are
``evaluation.cocoeval_np.COCOEval``'s, exactly (tested).

The library is built at first use with g++ into ``_build/`` beside this
package, cached by the hash of source and flags, as ``ops/dcn.py`` builds
the DCN libraries. A failed build raises: nothing switches to the numpy
evaluator behind the caller's back.
"""

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from ..evaluation.cocoeval_np import COCOEval

logger = logging.getLogger(__name__)

__all__ = ["FastCOCOEval", "SOURCE", "build_library", "load_library"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "cocoeval.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O2", "-shared", "-fPIC")
_LIB: Optional[ctypes.CDLL] = None


def build_library() -> Path:
    """The shared library of ``SOURCE``, built with g++ unless a library of
    the same source and flags is there. Raises when g++ fails."""
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    path = BUILD_DIR / f"libcocoeval_{tag}.so"
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    logger.info("Compiling %s with g++", SOURCE.name)
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent build never loads a partial file
    return path


def load_library() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build_library()))
    lib.cocoeval_evaluate_images.restype = None
    lib.cocoeval_evaluate_images.argtypes = [
        ctypes.c_int,
        np.ctypeslib.ndpointer(np.int64, flags="C"),
        np.ctypeslib.ndpointer(np.int64, flags="C"),
        np.ctypeslib.ndpointer(np.int64, flags="C"),
        np.ctypeslib.ndpointer(np.float64, flags="C"),
        np.ctypeslib.ndpointer(np.float64, flags="C"),
        np.ctypeslib.ndpointer(np.uint8, flags="C"),
        np.ctypeslib.ndpointer(np.uint8, flags="C"),
        np.ctypeslib.ndpointer(np.float64, flags="C"),
        np.ctypeslib.ndpointer(np.float64, flags="C"),
        ctypes.c_int,
        ctypes.c_double,
        ctypes.c_double,
        np.ctypeslib.ndpointer(np.int64, flags="C"),
        np.ctypeslib.ndpointer(np.uint8, flags="C"),
        np.ctypeslib.ndpointer(np.uint8, flags="C"),
        np.ctypeslib.ndpointer(np.int32, flags="C"),
    ]
    _LIB = lib
    return lib


class FastCOCOEval(COCOEval):
    """Drop-in replacement for the numpy COCOEval with the C++ hot loop."""

    def evaluate(self) -> None:
        lib = load_library()
        T = len(self.IOU_THRS)
        R = len(self.REC_THRS)
        K = len(self.cat_ids)
        A = len(self.AREA_RNG)
        M = len(self.MAX_DETS)
        max_det = self.MAX_DETS[-1]
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        scores_out = -np.ones((T, R, K, A, M))
        iou_thrs = np.ascontiguousarray(self.IOU_THRS, np.float64)

        for k, cat_id in enumerate(self.cat_ids):
            # per-image prep shared across area ranges
            prepped = []
            for img_id in self.img_ids:
                gts = self._gts[(img_id, cat_id)]
                dts = self._dts[(img_id, cat_id)]
                if not gts and not dts:
                    continue
                d_order = np.argsort(
                    [-d["score"] for d in dts], kind="stable"
                )[:max_det]
                dts = [dts[i] for i in d_order]
                crowd = np.array([int(g["iscrowd"]) for g in gts], np.uint8)
                prepped.append(
                    dict(
                        ious=np.ascontiguousarray(
                            self._compute_iou(dts, gts, crowd), np.float64
                        ),
                        det_scores=np.array([d["score"] for d in dts], np.float64),
                        det_areas=np.array([d["area"] for d in dts], np.float64),
                        gt_areas=np.array([g["area"] for g in gts], np.float64),
                        gt_crowd=crowd,
                        gt_ignore0=np.array(
                            [1 if g["ignore"] else 0 for g in gts], np.uint8
                        ),
                    )
                )
            if not prepped:
                continue

            n_img = len(prepped)
            det_off = np.zeros(n_img + 1, np.int64)
            gt_off = np.zeros(n_img + 1, np.int64)
            iou_off = np.zeros(n_img + 1, np.int64)
            for i, p in enumerate(prepped):
                det_off[i + 1] = det_off[i] + len(p["det_scores"])
                gt_off[i + 1] = gt_off[i] + len(p["gt_areas"])
                iou_off[i + 1] = iou_off[i] + p["ious"].size
            total_d = int(det_off[-1])
            total_g = int(gt_off[-1])
            ious_cat = (
                np.concatenate([p["ious"].reshape(-1) for p in prepped])
                if total_d * total_g >= 0
                else np.zeros(0)
            )
            ious_cat = np.ascontiguousarray(ious_cat, np.float64)
            det_scores = np.concatenate([p["det_scores"] for p in prepped]) if total_d else np.zeros(0)
            det_areas = np.ascontiguousarray(
                np.concatenate([p["det_areas"] for p in prepped]) if total_d else np.zeros(0), np.float64
            )
            gt_areas = np.ascontiguousarray(
                np.concatenate([p["gt_areas"] for p in prepped]) if total_g else np.zeros(0), np.float64
            )
            gt_crowd = np.ascontiguousarray(
                np.concatenate([p["gt_crowd"] for p in prepped]) if total_g else np.zeros(0, np.uint8)
            )
            gt_ig0 = np.ascontiguousarray(
                np.concatenate([p["gt_ignore0"] for p in prepped]) if total_g else np.zeros(0, np.uint8)
            )

            for a, (aname, arng) in enumerate(self.AREA_RNG.items()):
                dtm = np.zeros(T * max(total_d, 1), np.int64)
                dt_ig = np.zeros(T * max(total_d, 1), np.uint8)
                gt_ig = np.zeros(max(total_g, 1), np.uint8)
                num_gt = np.zeros(n_img, np.int32)
                lib.cocoeval_evaluate_images(
                    n_img, det_off, gt_off, iou_off,
                    ious_cat if ious_cat.size else np.zeros(1, np.float64),
                    gt_areas if total_g else np.zeros(1, np.float64),
                    gt_crowd if total_g else np.zeros(1, np.uint8),
                    gt_ig0 if total_g else np.zeros(1, np.uint8),
                    det_areas if total_d else np.zeros(1, np.float64),
                    iou_thrs, T, float(arng[0]), float(arng[1]),
                    dtm, dt_ig, gt_ig, num_gt,
                )
                # assemble per-image blocks -> accumulate (numpy, vectorized)
                per_img = []
                for i in range(n_img):
                    d0, d1 = int(det_off[i]), int(det_off[i + 1])
                    di = d1 - d0
                    per_img.append(
                        {
                            "dt_matches": dtm[T * d0 : T * d1].reshape(T, di),
                            "dt_ignore": dt_ig[T * d0 : T * d1].reshape(T, di).astype(bool),
                            "dt_scores": det_scores[d0:d1],
                            "num_gt": int(num_gt[i]),
                        }
                    )
                self._accumulate_cat(
                    per_img, k, a, precision, recall, scores_out
                )
        self.eval = {"precision": precision, "recall": recall, "scores": scores_out}

    accumulate = evaluate

    def _accumulate_cat(self, per_img, k, a, precision, recall, scores_out):
        T = len(self.IOU_THRS)
        R = len(self.REC_THRS)
        for m, max_det in enumerate(self.MAX_DETS):
            dt_scores = np.concatenate([e["dt_scores"][:max_det] for e in per_img])
            order = np.argsort(-dt_scores, kind="mergesort")
            dtm = np.concatenate(
                [e["dt_matches"][:, :max_det] for e in per_img], axis=1
            )[:, order]
            dt_ig = np.concatenate(
                [e["dt_ignore"][:, :max_det] for e in per_img], axis=1
            )[:, order]
            npig = sum(e["num_gt"] for e in per_img)
            if npig == 0:
                continue
            tps = (dtm > 0) & ~dt_ig
            fps = (dtm == 0) & ~dt_ig
            tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
            fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
            sorted_scores = dt_scores[order]
            for t in range(T):
                tp, fp = tp_sum[t], fp_sum[t]
                nd = len(tp)
                rc = tp / npig
                pr = tp / np.maximum(fp + tp, np.spacing(1))
                recall[t, k, a, m] = rc[-1] if nd else 0
                pr = pr.tolist()
                for i in range(nd - 1, 0, -1):
                    if pr[i] > pr[i - 1]:
                        pr[i - 1] = pr[i]
                inds = np.searchsorted(rc, self.REC_THRS, side="left")
                q = np.zeros(R)
                ss = np.zeros(R)
                for ri, pi in enumerate(inds):
                    if pi < nd:
                        q[ri] = pr[pi]
                        ss[ri] = sorted_scores[pi]
                precision[t, :, k, a, m] = q
                scores_out[t, :, k, a, m] = ss
