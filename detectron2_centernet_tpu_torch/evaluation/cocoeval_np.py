"""COCO evaluation in numpy (a copy of the JAX package's
``evaluation/cocoeval_np.py``; the COCOeval algorithm from its published
specification, as pycocotools computes it).

Semantics (COCOeval's defaults for ``iou_type="bbox"``):
  * IoU thresholds 0.50:0.05:0.95, recall grid 0:0.01:1
  * area ranges all/small/medium/large, maxDets (1, 10, 100)
  * crowd GTs are ignore-matchable many times, IoU against a crowd uses the
    detection's area as denominator
  * greedy per-image matching in descending score order, preferring higher
    IoU and non-ignored GTs; unmatched detections outside the area range are
    ignored rather than counted as false positives
  * 101-point interpolated precision averaging

``iou_type="keypoints"`` (OKS, pycocotools' keypoint parameters),
``"segm"`` (the mask IoU of RLE masks, ``structures/rle.py::rle_iou``) and
``"rotated_bbox"`` (boxes (cx, cy, w, h, angle), the float64 polygon IoU of
``structures/rotated_boxes.py::pairwise_iou_rotated``) are carried too.
"""

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..structures.rle import rle_area, rle_iou
from ..structures.rotated_boxes import pairwise_iou_rotated

__all__ = ["COCOEval", "iou_xywh"]

def iou_xywh(dets: np.ndarray, gts: np.ndarray, iscrowd: Sequence[int]) -> np.ndarray:
    """Pairwise IoU of XYWH boxes; crowd GT -> intersection / det area."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)), np.float64)
    dx0, dy0 = dets[:, 0], dets[:, 1]
    dx1, dy1 = dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]
    gx0, gy0 = gts[:, 0], gts[:, 1]
    gx1, gy1 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    iw = np.clip(
        np.minimum(dx1[:, None], gx1[None]) - np.maximum(dx0[:, None], gx0[None]), 0, None
    )
    ih = np.clip(
        np.minimum(dy1[:, None], gy1[None]) - np.maximum(dy0[:, None], gy0[None]), 0, None
    )
    inter = iw * ih
    d_area = (dets[:, 2] * dets[:, 3])[:, None]
    g_area = (gts[:, 2] * gts[:, 3])[None]
    crowd = np.asarray(iscrowd, bool)[None]
    union = np.where(crowd, d_area, d_area + g_area - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


class COCOEval:
    """Evaluate detection results against COCO-format ground truth.

    Parameters
    ----------
    gt_anns : list of dicts with image_id, category_id, bbox (XYWH), iscrowd,
        area (optional; defaults to w*h), ignore (optional)
    dt_anns : list of dicts with image_id, category_id, bbox (XYWH), score
    img_ids / cat_ids : the full id sets to evaluate over
    """

    IOU_THRS = np.linspace(0.5, 0.95, 10)
    REC_THRS = np.linspace(0.0, 1.00, 101)
    AREA_RNG = {
        "all": (0.0, 1e10),
        "small": (0.0, 32.0 ** 2),
        "medium": (32.0 ** 2, 96.0 ** 2),
        "large": (96.0 ** 2, 1e10),
    }
    MAX_DETS = (1, 10, 100)

    # subclasses may register additional iou types (projects/DensePose)
    EXTRA_IOU_TYPES: tuple = ()

    # COCO person-keypoint OKS sigmas (pycocotools Params.setKpParams)
    KPT_OKS_SIGMAS = np.array(
        [.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62,
         1.07, 1.07, .87, .87, .89, .89]
    ) / 10.0

    def __init__(
        self,
        gt_anns: List[dict],
        dt_anns: List[dict],
        img_ids: Sequence,
        cat_ids: Sequence,
        iou_type: str = "bbox",
        kpt_oks_sigmas: Optional[Sequence[float]] = None,
    ) -> None:
        assert iou_type in (
            ("bbox", "segm", "rotated_bbox", "keypoints") + self.EXTRA_IOU_TYPES
        ), iou_type
        self.iou_type = iou_type
        if iou_type == "keypoints":
            # pycocotools keypoint params: maxDets [20], no "small" range
            self.MAX_DETS = (20,)
            self.AREA_RNG = {
                "all": (0.0, 1e10),
                "medium": (32.0 ** 2, 96.0 ** 2),
                "large": (96.0 ** 2, 1e10),
            }
        self.kpt_oks_sigmas = np.asarray(
            kpt_oks_sigmas if kpt_oks_sigmas is not None else self.KPT_OKS_SIGMAS,
            np.float64,
        )
        self.img_ids = list(img_ids)
        self.cat_ids = list(cat_ids)
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        for g in gt_anns:
            g = dict(g)
            if "bbox" in g:
                g.setdefault("area", abs(g["bbox"][2] * g["bbox"][3]))
            else:
                g.setdefault("area", rle_area(g["segmentation"]))
            g.setdefault("iscrowd", 0)
            g["ignore"] = g.get("ignore", 0) or g["iscrowd"]
            if iou_type == "keypoints":
                # pycocotools _prepare: gts with no labeled keypoints ignore
                nk = g.get(
                    "num_keypoints",
                    int(np.count_nonzero(np.asarray(g["keypoints"])[2::3] > 0)),
                )
                g["ignore"] = g["ignore"] or nk == 0
            self._gts[(g["image_id"], g["category_id"])].append(g)
        for d in dt_anns:
            d = dict(d)
            if "bbox" in d:
                d.setdefault("area", d["bbox"][2] * d["bbox"][3])
            else:
                d.setdefault("area", rle_area(d["segmentation"]))
            self._dts[(d["image_id"], d["category_id"])].append(d)
        self.eval: Optional[dict] = None
        self.stats: Optional[np.ndarray] = None

    # -- per-image matching --------------------------------------------------
    def _evaluate_img(self, img_id, cat_id, area_rng, max_det) -> Optional[dict]:
        gts = self._gts[(img_id, cat_id)]
        dts = self._dts[(img_id, cat_id)]
        if len(gts) == 0 and len(dts) == 0:
            return None
        g_ignore = np.array(
            [g["ignore"] or g["area"] < area_rng[0] or g["area"] > area_rng[1] for g in gts],
            bool,
        )
        # sort: non-ignored gts first (COCO convention), dets by score desc
        g_order = np.argsort(g_ignore, kind="stable")
        gts = [gts[i] for i in g_order]
        g_ignore = g_ignore[g_order]
        d_order = np.argsort([-d["score"] for d in dts], kind="stable")[:max_det]
        dts = [dts[i] for i in d_order]

        iscrowd = [int(g["iscrowd"]) for g in gts]
        ious = self._compute_iou(dts, gts, iscrowd)

        T = len(self.IOU_THRS)
        D, G = len(dts), len(gts)
        dtm = np.zeros((T, D), np.int64)
        gtm = np.zeros((T, G), np.int64)
        dt_ignore = np.zeros((T, D), bool)
        for t, thr in enumerate(self.IOU_THRS):
            for dind in range(D):
                best_iou = min(thr, 1 - 1e-10)
                m = -1
                for gind in range(G):
                    if gtm[t, gind] > 0 and not iscrowd[gind]:
                        continue
                    # gts are sorted ignore-last: stop at ignores once matched
                    if m > -1 and not g_ignore[m] and g_ignore[gind]:
                        break
                    if ious[dind, gind] < best_iou:
                        continue
                    best_iou = ious[dind, gind]
                    m = gind
                if m == -1:
                    continue
                dt_ignore[t, dind] = g_ignore[m]
                dtm[t, dind] = m + 1
                gtm[t, m] = dind + 1
        # unmatched dets outside the area range are ignored
        d_out = np.array(
            [d["area"] < area_rng[0] or d["area"] > area_rng[1] for d in dts], bool
        )
        dt_ignore |= (dtm == 0) & d_out[None]
        # subclass hook (DensePose: unmatched dets on ignored gts with high
        # box IoU inherit the ignore flag, densepose_coco_evaluation.py:750-772)
        self._post_match_ignore(dts, gts, g_ignore, dtm, gtm, dt_ignore)
        return {
            "dt_matches": dtm,
            "dt_scores": np.array([d["score"] for d in dts], np.float64),
            "dt_ignore": dt_ignore,
            "gt_ignore": g_ignore,
            "num_gt": int((~g_ignore).sum()),
        }

    def _post_match_ignore(self, dts, gts, g_ignore, dtm, gtm, dt_ignore):
        """Hook for subclasses to adjust ignore flags after matching."""

    def _compute_iou(self, dts, gts, iscrowd) -> np.ndarray:
        if self.iou_type == "keypoints":
            return self._compute_oks(dts, gts)
        if self.iou_type == "rotated_bbox":
            d5 = np.array([d["bbox"] for d in dts], np.float64).reshape(-1, 5)
            g5 = np.array([g["bbox"] for g in gts], np.float64).reshape(-1, 5)
            return pairwise_iou_rotated(d5, g5)
        if self.iou_type == "segm":
            return rle_iou([d["segmentation"] for d in dts], [g["segmentation"] for g in gts], iscrowd)
        g_boxes = np.array([g["bbox"] for g in gts], np.float64).reshape(-1, 4)
        d_boxes = np.array([d["bbox"] for d in dts], np.float64).reshape(-1, 4)
        return iou_xywh(d_boxes, g_boxes, iscrowd)

    def _compute_oks(self, dts, gts) -> np.ndarray:
        """Object keypoint similarity (pycocotools COCOeval.computeOks)."""
        sig = self.kpt_oks_sigmas
        var = (sig * 2.0) ** 2
        k = len(sig)
        ious = np.zeros((len(dts), len(gts)), np.float64)
        for j, gt in enumerate(gts):
            g = np.asarray(gt["keypoints"], np.float64)
            xg, yg, vg = g[0::3], g[1::3], g[2::3]
            k1 = int(np.count_nonzero(vg > 0))
            bb = gt["bbox"]
            x0, x1 = bb[0] - bb[2], bb[0] + bb[2] * 2
            y0, y1 = bb[1] - bb[3], bb[1] + bb[3] * 2
            for i, dt in enumerate(dts):
                d = np.asarray(dt["keypoints"], np.float64)
                xd, yd = d[0::3], d[1::3]
                if k1 > 0:
                    dx, dy = xd - xg, yd - yg
                else:
                    # no labeled keypoints: distance to the 2x-expanded box
                    z = np.zeros((k,))
                    dx = np.maximum(z, x0 - xd) + np.maximum(z, xd - x1)
                    dy = np.maximum(z, y0 - yd) + np.maximum(z, yd - y1)
                e = (dx ** 2 + dy ** 2) / var / (gt["area"] + np.spacing(1)) / 2
                if k1 > 0:
                    e = e[vg > 0]
                ious[i, j] = np.sum(np.exp(-e)) / e.shape[0]
        return ious

    # -- accumulate ----------------------------------------------------------
    def evaluate(self) -> None:
        T = len(self.IOU_THRS)
        R = len(self.REC_THRS)
        K = len(self.cat_ids)
        A = len(self.AREA_RNG)
        M = len(self.MAX_DETS)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        scores = -np.ones((T, R, K, A, M))

        for k, cat_id in enumerate(self.cat_ids):
            for a, (aname, arng) in enumerate(self.AREA_RNG.items()):
                per_img = [
                    self._evaluate_img(img_id, cat_id, arng, self.MAX_DETS[-1])
                    for img_id in self.img_ids
                ]
                per_img = [e for e in per_img if e is not None]
                if not per_img:
                    continue
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
                        tp = tp_sum[t]
                        fp = fp_sum[t]
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / np.maximum(fp + tp, np.spacing(1))
                        recall[t, k, a, m] = rc[-1] if nd else 0
                        # make precision monotonically decreasing
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
                        scores[t, :, k, a, m] = ss
        self.eval = {"precision": precision, "recall": recall, "scores": scores}

    accumulate = evaluate  # the split exists for API parity; evaluate does both

    # -- summarize -----------------------------------------------------------
    def _summarize(self, ap: bool, iou_thr: Optional[float] = None, area: str = "all", max_dets: int = 100) -> float:
        assert self.eval is not None, "run evaluate() first"
        a = list(self.AREA_RNG).index(area)
        m = list(self.MAX_DETS).index(max_dets)
        if ap:
            s = self.eval["precision"][:, :, :, a, m]
            if iou_thr is not None:
                t = int(np.argwhere(np.isclose(self.IOU_THRS, iou_thr))[0, 0])
                s = s[t : t + 1]
        else:
            s = self.eval["recall"][:, :, a, m]
            if iou_thr is not None:
                t = int(np.argwhere(np.isclose(self.IOU_THRS, iou_thr))[0, 0])
                s = s[t : t + 1]
        valid = s[s > -1]
        return float(valid.mean()) if valid.size else -1.0

    def summarize(self) -> np.ndarray:
        """The 12-number COCO stats vector (10 for keypoints)."""
        if self.iou_type == "keypoints":
            md = self.MAX_DETS[-1]
            self.stats = np.array(
                [
                    self._summarize(True, max_dets=md),
                    self._summarize(True, iou_thr=0.5, max_dets=md),
                    self._summarize(True, iou_thr=0.75, max_dets=md),
                    self._summarize(True, area="medium", max_dets=md),
                    self._summarize(True, area="large", max_dets=md),
                    self._summarize(False, max_dets=md),
                    self._summarize(False, iou_thr=0.5, max_dets=md),
                    self._summarize(False, iou_thr=0.75, max_dets=md),
                    self._summarize(False, area="medium", max_dets=md),
                    self._summarize(False, area="large", max_dets=md),
                ]
            )
            return self.stats
        self.stats = np.array(
            [
                self._summarize(True),
                self._summarize(True, iou_thr=0.5),
                self._summarize(True, iou_thr=0.75),
                self._summarize(True, area="small"),
                self._summarize(True, area="medium"),
                self._summarize(True, area="large"),
                self._summarize(False, max_dets=1),
                self._summarize(False, max_dets=10),
                self._summarize(False, max_dets=100),
                self._summarize(False, area="small"),
                self._summarize(False, area="medium"),
                self._summarize(False, area="large"),
            ]
        )
        return self.stats

    def per_category_ap(self) -> Dict:
        """AP per category id (precision averaged over IoU/recall, area=all,
        maxDets=100) — used for the evaluator's per-category table."""
        assert self.eval is not None
        out = {}
        a = list(self.AREA_RNG).index("all")
        m = len(self.MAX_DETS) - 1  # top maxDets (100; 20 for keypoints)
        for k, cat_id in enumerate(self.cat_ids):
            p = self.eval["precision"][:, :, k, a, m]
            valid = p[p > -1]
            out[cat_id] = float(valid.mean()) if valid.size else float("nan")
        return out
