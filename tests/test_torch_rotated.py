"""The port's rotated Faster R-CNN (RRPN + RROIHeads) against the JAX package
on the CPU, in f32: the XYWHA box modes, ``RotatedBoxes``,
``Box2BoxTransformRotated``, ``RotatedAnchorGenerator``, the plain rotated IoU
(R1's plain version) and the plain rotated NMS (R2's) with and without
classes, ``roi_align_rotated``, ``rrpn_losses`` and
``find_top_rrpn_proposals`` on JAX's draws, the whole model's
``predict_fn``, its loss with every gradient, ``postprocess``'s un-warp and
the rotated COCO evaluation.

Sizes: ``tests/modeling/test_rotated_rcnn.py``'s (ResNet-18 with RES2 64 on
res4, anchors 32 and 64 at one ratio and angles -90/0/90, proposals 60/30 at
training and 40/20 at test, 16 rois, one fc of 32 on 5² pools, 3 classes, 8
detections), 64² inputs. One random variables tree made with numpy goes to
both sides (``state_dict_from_jax`` to the port). The rotated ops of the
JAX package are XLA (no Pallas kernel): its functions run jitted here.

Tolerances: the IoU within 1e-5 (both sides clip in f32; XLA and PyTorch
round the corners' trigonometry apart by an ulp); an NMS index for index,
except a row whose first difference is decided by an IoU within 1e-5 of
the threshold (``nms_pick_ties``, none expected on these seeds); pooled
features within 1e-5 of their scale; losses within 1e-5 relative and every
gradient within 1e-4 of its own largest value.
"""

import importlib
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from detectron2_centernet_tpu.config import get_cfg as jax_get_cfg
from detectron2_centernet_tpu.data import DatasetCatalog as JaxDatasetCatalog
from detectron2_centernet_tpu.evaluation import RotatedCOCOEvaluator as JaxRotatedEvaluator
from detectron2_centernet_tpu.models.anchors import RotatedAnchorGenerator as JaxRotatedAnchors
from detectron2_centernet_tpu.models.box_regression import Box2BoxTransformRotated as JaxB2BRot
from detectron2_centernet_tpu.models.build import build_model as jax_build_model
from detectron2_centernet_tpu.models.matcher import Matcher as JaxMatcher
from detectron2_centernet_tpu.structures import BoxMode as JaxBoxMode
from detectron2_centernet_tpu.structures import Instances as JaxInstances
from detectron2_centernet_tpu.structures.rotated_boxes import RotatedBoxes as JaxRotatedBoxes
from detectron2_centernet_tpu_torch.checkpoint import canonical_key, state_dict_from_jax, torch_key
from detectron2_centernet_tpu_torch.config import get_cfg
from detectron2_centernet_tpu_torch.data import DatasetCatalog
from detectron2_centernet_tpu_torch.engine import SimpleTrainer
from detectron2_centernet_tpu_torch.evaluation import RotatedCOCOEvaluator, inference_on_dataset
from detectron2_centernet_tpu_torch.models import build_model
from detectron2_centernet_tpu_torch.models.anchors import RotatedAnchorGenerator
from detectron2_centernet_tpu_torch.models.box_regression import Box2BoxTransformRotated
from detectron2_centernet_tpu_torch.models.matcher import Matcher
from detectron2_centernet_tpu_torch.models.meta_arch.rotated_rcnn import RotatedRCNN
from detectron2_centernet_tpu_torch.models.proposal_generator import rrpn
from detectron2_centernet_tpu_torch.ops import roi_align_rotated as rot
from detectron2_centernet_tpu_torch.structures import BoxMode, Instances, RotatedBoxes
from detectron2_centernet_tpu_torch.structures import rotated_boxes as host_rot

from test_torch_rcnn import _random_variables

jax_rot = importlib.import_module("detectron2_centernet_tpu.ops.roi_align_rotated")
jax_rrpn = importlib.import_module("detectron2_centernet_tpu.models.proposal_generator.rrpn")
jax_host_rot = importlib.import_module("detectron2_centernet_tpu.structures.rotated_boxes")
jax_rotated_rcnn = importlib.import_module("detectron2_centernet_tpu.models.meta_arch.rotated_rcnn")

SIZE = 64
NARROW = ["MODEL.META_ARCHITECTURE", "GeneralizedRCNN", "MODEL.PROPOSAL_GENERATOR.NAME", "RRPN",
          "MODEL.ROI_HEADS.NAME", "RROIHeads", "MODEL.BACKBONE.NAME", "build_resnet_backbone",
          "MODEL.RESNETS.DEPTH", 18, "MODEL.RESNETS.RES2_OUT_CHANNELS", 64, "MODEL.RESNETS.OUT_FEATURES", ["res4"],
          "MODEL.RPN.IN_FEATURES", ["res4"], "MODEL.ANCHOR_GENERATOR.SIZES", [[32, 64]],
          "MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS", [[1.0]], "MODEL.ANCHOR_GENERATOR.ANGLES", [[-90, 0, 90]],
          "MODEL.RPN.PRE_NMS_TOPK_TRAIN", 60, "MODEL.RPN.POST_NMS_TOPK_TRAIN", 30,
          "MODEL.RPN.PRE_NMS_TOPK_TEST", 40, "MODEL.RPN.POST_NMS_TOPK_TEST", 20,
          "MODEL.ROI_HEADS.NUM_CLASSES", 3, "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 16,
          "MODEL.ROI_BOX_HEAD.NUM_FC", 1, "MODEL.ROI_BOX_HEAD.FC_DIM", 32, "MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION", 5,
          "TEST.DETECTIONS_PER_IMAGE", 8, "TPU.DTYPE", "float32", "MODEL.WEIGHTS", ""]

jax_iou = jax.jit(jax_rot.pairwise_iou_rotated_jnp)


def _rboxes(rng, n, lo=5.0, hi=59.0, size=(3.0, 30.0)):
    """(n, 5) f32 rotated boxes: centres in [lo, hi)², sides in ``size``, angles in ±180°."""
    return np.concatenate([rng.uniform(lo, hi, (n, 2)), rng.uniform(*size, (n, 2)),
                           rng.uniform(-180, 180, (n, 1))], 1).astype(np.float32)


def _degenerate():
    """Pairs (a, b) the clip must survive: identical boxes, a shared
    (collinear) edge, one box inside the other, 90° turns of one box
    (the same rectangle when square), zero and near-zero sides, the same box
    at -180 and 180, a touching corner, far apart."""
    a = [[20, 20, 10, 6, 30], [20, 20, 10, 6, 0], [20, 20, 10, 6, 0], [20, 20, 4, 2, 15], [20, 20, 10, 6, 0],
         [20, 20, 8, 8, 0], [20, 20, 10, 0, 20], [20, 20, 10, 1e-4, 20], [20, 20, 10, 6, -180],
         [20, 20, 10, 10, 0], [20, 20, 10, 6, 45], [20, 20, 0, 0, 0]]
    b = [[20, 20, 10, 6, 30], [30, 20, 10, 6, 0], [20, 23, 10, 6, 0], [20, 20, 10, 6, 15], [20, 20, 10, 6, 90],
         [20, 20, 8, 8, 90], [20, 20, 10, 6, 20], [20, 20, 10, 6, 20], [20, 20, 10, 6, 180],
         [30, 30, 10, 10, 0], [60, 60, 10, 6, 45], [20, 20, 10, 6, 0]]
    return np.asarray(a, np.float32), np.asarray(b, np.float32)


# -- boxes -------------------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["xywha_to_xyxy", "xywh_to_xywha"])
def test_box_mode_rotated_conversions_equal_jax(mode):
    """XYWHA_ABS → XYXY_ABS (the corners' axis-aligned hull) and XYWH_ABS →
    XYWHA_ABS (angle 0) of (N, k) arrays and of one box, as JAX's."""
    rng = np.random.RandomState(0)
    src, dst = {"xywha_to_xyxy": (BoxMode.XYWHA_ABS, BoxMode.XYXY_ABS),
                "xywh_to_xywha": (BoxMode.XYWH_ABS, BoxMode.XYWHA_ABS)}[mode]
    arr = _rboxes(rng, 7).astype(np.float64) if src == BoxMode.XYWHA_ABS else rng.uniform(0, 50, (7, 4))
    want = JaxBoxMode.convert(arr, JaxBoxMode(int(src)), JaxBoxMode(int(dst)))
    np.testing.assert_array_equal(BoxMode.convert(arr, src, dst), want)
    one = [float(v) for v in arr[0]]
    np.testing.assert_array_equal(BoxMode.convert(one, src, dst),
                                  JaxBoxMode.convert(one, JaxBoxMode(int(src)), JaxBoxMode(int(dst))))


def test_rotated_boxes_equal_jax():
    """``RotatedBoxes``: area, normalize_angles, clip (only |angle| <= 1°
    boxes move), nonempty, inside_box and indexing, as JAX's on the same
    (N, 5) tensor; the host ``nms_rotated`` (float64, the evaluator's
    module) keeps JAX's picks."""
    rng = np.random.RandomState(1)
    t = _rboxes(rng, 40, -20, 90, (0.0, 40.0))
    t[::4, 4] = rng.uniform(-1, 1, 10)  # near-horizontal: clipped
    t[1::8, 4] += 360.0
    got, want = RotatedBoxes(t.copy()), JaxRotatedBoxes(t.copy())
    np.testing.assert_array_equal(got.area(), want.area())
    np.testing.assert_array_equal(got.nonempty(5.0), want.nonempty(5.0))
    np.testing.assert_array_equal(got.inside_box((64, 48), 3), want.inside_box((64, 48), 3))
    got.clip((64, 48))
    want.clip((64, 48))
    np.testing.assert_array_equal(got.tensor, want.tensor)
    assert len(got[3:9]) == 6 and got[2].tensor.shape == (1, 5)
    np.testing.assert_array_equal(host_rot.rotated_box_vertices(t), jax_host_rot.rotated_box_vertices(t))
    boxes, scores = _rboxes(rng, 30, 10, 40, (6, 20)), rng.uniform(0, 1, 30)
    np.testing.assert_array_equal(host_rot.nms_rotated(boxes, scores, 0.3), jax_host_rot.nms_rotated(boxes, scores, 0.3))


def test_box2box_transform_rotated_equals_jax_and_round_trips():
    """Deltas and their inverse at (10, 10, 5, 5, 1), angles wrapped by
    ``torch.remainder`` as jnp's ``%`` (``torch.fmod`` would give positive
    wraps for negative angles): equal to JAX within 1e-6 of scale, and
    ``apply_deltas(get_deltas(src, dst), src)`` gives dst back (the angle
    modulo 360)."""
    rng = np.random.RandomState(2)
    src, dst = _rboxes(rng, 50), _rboxes(rng, 50)
    dst[:10, 4] = src[:10, 4] - 350.0  # differences past ±180
    w = (10.0, 10.0, 5.0, 5.0, 1.0)
    got = Box2BoxTransformRotated(w).get_deltas(torch.from_numpy(src), torch.from_numpy(dst))
    want = np.asarray(JaxB2BRot(w).get_deltas(jnp.asarray(src), jnp.asarray(dst)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())
    back = Box2BoxTransformRotated(w).apply_deltas(got, torch.from_numpy(src)).numpy()
    want_back = np.asarray(JaxB2BRot(w).apply_deltas(jnp.asarray(want), jnp.asarray(src)))
    np.testing.assert_allclose(back, want_back, rtol=0, atol=1e-4)
    np.testing.assert_allclose(back[:, :4], dst[:, :4], rtol=1e-4, atol=1e-3)
    assert np.abs((back[:, 4] - dst[:, 4] + 180) % 360 - 180).max() < 1e-3
    assert back[:, 4].min() >= -180 and back[:, 4].max() < 180


def test_rotated_anchor_generator_equals_jax():
    """The C4 defaults (sizes 32-512, ratios 0.5/1/2, angles -90/0/90: 45
    anchors a cell) on a 3 x 5 grid at stride 16, and two levels of their
    own lists."""
    for args in (([[32, 64, 128, 256, 512]], [[0.5, 1.0, 2.0]], [[-90, 0, 90]], [16]),
                 ([[32], [64]], [[1.0, 2.0]], [[-60, 0, 60], [30]], [8, 16])):
        got, want = RotatedAnchorGenerator(*args), JaxRotatedAnchors(*args)
        assert got.num_anchors == want.num_anchors
        grids = [(3, 5), (2, 3)][:len(args[3])]
        for g, w in zip(got.grid_anchors(grids), want.grid_anchors(grids)):
            np.testing.assert_array_equal(g, w)
    assert RotatedAnchorGenerator([[32, 64, 128, 256, 512]], [[0.5, 1, 2]], [[-90, 0, 90]], [16]).num_anchors == [45]


# -- R1 and R2's plain versions ------------------------------------------------------------------


@pytest.mark.parametrize("case", ["random", "degenerate", "batched"])
def test_plain_rotated_iou_equals_jax(case):
    """The plain clip (``pairwise_iou_rotated`` on CPU tensors) against
    ``pairwise_iou_rotated_jnp`` within 1e-5: 40 x 60 random pairs; the
    degenerate pairs both ways round (but for the clip by a zero-size box,
    whose edges clip nothing, so JAX's union is f32 rounding and its IoU
    noise: the subject of zero size gives 0); a batch of 3 images against
    one broadcast set (the RRPN's gt against its anchors). The float64 host
    version (the evaluator's) agrees within 1e-4; small chunks, so a call
    crosses several, change nothing."""
    rng = np.random.RandomState(3)
    if case == "batched":
        a, b = np.stack([_rboxes(rng, 5) for _ in range(3)]), _rboxes(rng, 70)
        got = rot.pairwise_iou_rotated_plain(torch.from_numpy(a), torch.from_numpy(b), chunk=256).numpy()
        want = np.stack([np.asarray(jax_iou(jnp.asarray(x), jnp.asarray(b))) for x in a])
        assert got.shape == (3, 5, 70)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        return
    if case == "random":
        a, b = _rboxes(rng, 40), _rboxes(rng, 60)
        keep = np.ones((40, 60), bool)
    else:
        x, y = _degenerate()
        a, b = np.concatenate([x, y]), np.concatenate([y, x])
        keep = np.eye(len(a), dtype=bool) & (b[:, 2] * b[:, 3] > 0)[None, :]
    got = rot.pairwise_iou_rotated(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jax_iou(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got[keep], want[keep], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[keep], host_rot.pairwise_iou_rotated(a, b)[keep], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(rot.pairwise_iou_rotated_plain(torch.from_numpy(a), torch.from_numpy(b),
                                                                 chunk=97).numpy(), got)
    assert np.isfinite(got[keep]).all() and got[keep].min() >= 0 and got[keep].max() <= 1 + 1e-6
    if case == "degenerate":
        n = len(_degenerate()[0])
        diag = got[np.arange(n), np.arange(n)]
        assert abs(diag[0] - 1) < 1e-5 and abs(diag[4] - 36 / 84) < 1e-5 and abs(diag[5] - 1) < 1e-5
        assert diag[1] == 0 and diag[10] == 0 and diag[11] == 0 and abs(diag[8] - 1) < 1e-5
        assert abs(diag[2] - 1 / 3) < 1e-5 and abs(diag[3] - 8 / 60) < 1e-5 and abs(diag[7] - 1e-3 / 60) < 1e-6


def _separated(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """A float32 mirror of the kernels' reject ``csrc/iou_rotated.cuh::
    separated``: (P,) whether an edge normal of either box splits the pair
    by ``far_apart``'s margin, both boxes' sides at least 2e-2."""
    def halves(b):  # half the width and height vectors, rotated, from the corners as the kernels make them
        x, y = rot._corners(b)
        return (0.5 * (x[:, 0] - x[:, 1]), 0.5 * (y[:, 0] - y[:, 1])), (0.5 * (x[:, 0] - x[:, 3]), 0.5 * (y[:, 0] - y[:, 3]))
    (up, vp), (uq, vq) = halves(p), halves(q)
    tx, ty = q[:, 0] - p[:, 0], q[:, 1] - p[:, 1]
    diag = lambda b: torch.sqrt(b[:, 2] * b[:, 2] + b[:, 3] * b[:, 3])  # noqa: E731
    margin = 1e-3 * (0.5 * (diag(p) + diag(q))) + 1e-4 * ((p[:, 0].abs() + p[:, 1].abs() + q[:, 0].abs())
                                                        + q[:, 1].abs()) + 1e-3
    out = torch.zeros(len(p), dtype=torch.bool)
    for (ax, ay), length in ((up, p[:, 2] / 2), (vp, p[:, 3] / 2), (uq, q[:, 2] / 2), (vq, q[:, 3] / 2)):
        reach = sum((ax * bx + ay * by).abs() for bx, by in (up, vp, uq, vq))
        out |= (ax * tx + ay * ty).abs() > reach + margin * length
    return out & (p[:, 2:4] >= 2e-2).all(1) & (q[:, 2:4] >= 2e-2).all(1)


def test_plain_iou_is_zero_where_an_edge_normal_separates():
    """The kernels skip the clip of a pair that an edge normal of either box
    separates by ``far_apart``'s margin (``separated``), taking its IoU as 0:
    the plain clip gives exactly 0 for every such pair, both ways round, on
    pairs of rotated boxes 150 px apart about, of sides 0.02-300 px (one of
    each pair's boxes thin), centred anywhere in ±3000 px; and the reject
    takes a good share of the pairs whose circles overlap."""
    rng = np.random.RandomState(19)
    n = 12000
    centre = rng.uniform(-3000, 3000, (n, 2))
    p = np.concatenate([centre, rng.uniform(0.02, 300, (n, 2)), rng.uniform(-180, 180, (n, 1))], 1)
    q = np.concatenate([centre + rng.normal(0, 150, (n, 2)), rng.uniform(0.02, 300, (n, 1)),
                        rng.uniform(0.02, 0.5, (n, 1)), rng.uniform(-180, 180, (n, 1))], 1)
    p, q = torch.from_numpy(p.astype(np.float32)), torch.from_numpy(q.astype(np.float32))
    r = 0.5 * (torch.sqrt(p[:, 2] ** 2 + p[:, 3] ** 2) + torch.sqrt(q[:, 2] ** 2 + q[:, 3] ** 2))
    near = (p[:, 0] - q[:, 0]) ** 2 + (p[:, 1] - q[:, 1]) ** 2 <= r * r
    sep = _separated(p, q)
    assert int((sep & near).sum()) > 0.2 * int(near.sum())
    assert float(rot._pair_iou(p[sep], q[sep]).abs().max()) == 0.0
    assert float(rot._pair_iou(q[sep], p[sep]).abs().max()) == 0.0


def _nms_rows(rng, rows, cands, dead=0.15):
    """Rows of clustered rotated boxes (about 8 clusters, so many IoUs lie
    above and below 0.5-0.7) with scores, a share dead (-inf)."""
    centres = rng.uniform(10, 54, (rows, 8, 2))
    pick = rng.randint(0, 8, (rows, cands))
    xy = np.take_along_axis(centres, pick[..., None].repeat(2, -1), 1) + rng.normal(0, 3, (rows, cands, 2))
    wh = rng.uniform(6, 20, (rows, cands, 2))
    ang = rng.uniform(-60, 60, (rows, cands, 1))
    boxes = np.concatenate([xy, wh, ang], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (rows, cands)).astype(np.float32)
    scores[rng.uniform(size=(rows, cands)) < dead] = -np.inf
    return boxes, scores


@pytest.mark.parametrize("with_classes", [False, True])
def test_plain_rotated_nms_equals_jax(with_classes):
    """Four rows of 120 clustered candidates (a row all dead among them),
    each with its own pick count; with classes (3), suppression only within
    the pick's class. Every row's picks equal JAX's ``nms_rotated_fixed`` at
    its count, index for index and validity for validity (slots past the
    count (0, invalid)), but for rows whose first difference is a tie at
    the threshold (``nms_pick_ties``; none here)."""
    rng = np.random.RandomState(4 + with_classes)
    boxes, scores = _nms_rows(rng, 4, 120)
    scores[2] = -np.inf
    classes = rng.randint(0, 3, scores.shape).astype(np.int64) if with_classes else None
    counts, thr = [40, 5, 30, 120], 0.5
    got = rot.nms_rotated(torch.from_numpy(boxes), torch.from_numpy(scores), thr, counts,
                          None if classes is None else torch.from_numpy(classes))
    keep, valid = got[0].numpy(), got[1].numpy()
    want_keep = np.zeros_like(keep)
    want_valid = np.zeros_like(valid)
    fn = jax.jit(jax_rot.nms_rotated_fixed, static_argnames=("max_out",))
    for r, k in enumerate(counts):
        kw = {} if classes is None else {"classes": jnp.asarray(classes[r])}
        wk, wv = fn(jnp.asarray(boxes[r]), jnp.asarray(scores[r]), thr, max_out=k, **kw)
        want_keep[r, :k] = np.where(np.asarray(wv), np.asarray(wk), 0)
        want_valid[r, :k] = np.asarray(wv)
    ties = rot.nms_pick_ties(torch.from_numpy(boxes), torch.from_numpy(scores), thr, got,
                             (torch.from_numpy(want_keep), torch.from_numpy(want_valid)),
                             None if classes is None else torch.from_numpy(classes))
    assert ties["not_ties"] == 0 and ties["ties"] <= 0.001 * ties["picks"], ties
    if ties["differing_rows"] == 0:
        np.testing.assert_array_equal(keep, want_keep)
        np.testing.assert_array_equal(valid, want_valid)
    assert valid[0].sum() > 5 and not valid[2].any() and valid[1].sum() == 5


def test_nms_pick_ties_counts_a_decision_at_the_threshold():
    """Two boxes at IoU 0.5: at a threshold of exactly that IoU one side
    keeps both and the other suppresses the second. The check calls it a
    tie; the same difference at a threshold far from it is not one."""
    boxes = torch.tensor([[[20.0, 20, 10, 10, 0], [25, 20, 10, 10, 0], [50, 50, 4, 4, 0]]])
    scores = torch.tensor([[0.9, 0.8, 0.7]])
    iou = float(rot.pairwise_iou_rotated_plain(boxes[0, :1], boxes[0, 1:2]))
    both = (torch.tensor([[0, 1, 2]]), torch.tensor([[True, True, True]]))
    one = (torch.tensor([[0, 2, 0]]), torch.tensor([[True, True, False]]))
    tie = rot.nms_pick_ties(boxes, scores, iou, both, one)
    assert tie == {"rows": 1, "differing_rows": 1, "ties": 1, "not_ties": 0, "picks": 2}
    assert rot.nms_pick_ties(boxes, scores, 0.1, both, one)["not_ties"] == 1
    assert rot.nms_pick_ties(boxes, scores, 0.1, one, one)["differing_rows"] == 0


def test_roi_align_rotated_equals_jax():
    """Two 9 x 11 maps of 6 channels, 20 rotated rois (some past the edge,
    some tiny) at scale 1/2, 4² bins of 2² samples: within 1e-5 of scale;
    the features' gradient flows (the boxes get none)."""
    rng = np.random.RandomState(6)
    feats = rng.randn(2, 9, 11, 6).astype(np.float32)
    boxes = _rboxes(rng, 20, -4.0, 26.0, (0.5, 16.0))
    idx = rng.randint(0, 2, 20).astype(np.int32)
    want = np.asarray(jax_rot.roi_align_rotated(jnp.asarray(feats), jnp.asarray(boxes), jnp.asarray(idx), 0.5, 4, 2))
    f = torch.from_numpy(np.ascontiguousarray(feats.transpose(0, 3, 1, 2))).requires_grad_()
    got = rot.roi_align_rotated(f, torch.from_numpy(boxes), torch.from_numpy(idx), 0.5, 4, 2)
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    got.sum().backward()
    assert f.grad is not None and f.grad.abs().sum() > 0


# -- the RRPN ------------------------------------------------------------------------------------


def _gt(rng, n, m):
    gt = np.stack([_rboxes(rng, m, 10, 54, (8, 30)) for _ in range(n)])
    gt[..., 4] = rng.uniform(-45, 45, (n, m))
    valid = np.ones((n, m), bool)
    valid[-1, -2:] = False
    return gt, valid


def _rpn_draws(key, n, anchors):
    """The RRPN sampler's uniforms from ``key``, as JAX's ``rrpn_losses``
    splits it (one key an image)."""
    return np.stack([np.asarray(jax.random.uniform(k, (anchors,))) for k in jax.random.split(key, n)])


@pytest.mark.parametrize("beta", [0.0, 0.3])
def test_rrpn_losses_equal_jax(beta):
    """Two images of 4 rotated gts (two slots empty) against 270 anchors
    (6 x 5 cells of 9), 32 samples a half positive, on JAX's draws: both
    losses within 1e-5 relative; the logits' and deltas' gradients flow."""
    rng = np.random.RandomState(7)
    anchors = RotatedAnchorGenerator([[16, 32, 48]], [[1.0]], [[-60, 0, 60]], [8])([(6, 5)])
    gt, valid = _gt(rng, 2, 4)
    logits = rng.randn(2, len(anchors)).astype(np.float32)
    deltas = (rng.randn(2, len(anchors), 5) * 0.2).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jm, b2b = JaxMatcher([0.3, 0.7], [0, -1, 1], allow_low_quality_matches=True), JaxB2BRot()
    want = jax.jit(jax_rrpn.rrpn_losses, static_argnums=(6, 7, 8, 9, 10))(
        jnp.asarray(anchors), jnp.asarray(logits), jnp.asarray(deltas), jnp.asarray(gt), jnp.asarray(valid), key, jm,
        b2b, 32, 0.5, beta)
    lg, dl = torch.from_numpy(logits).requires_grad_(), torch.from_numpy(deltas).requires_grad_()
    got = rrpn.rrpn_losses(torch.from_numpy(anchors), lg, dl, torch.from_numpy(gt), torch.from_numpy(valid),
                           torch.from_numpy(_rpn_draws(key, 2, len(anchors))),
                           Matcher([0.3, 0.7], [0, -1, 1], allow_low_quality_matches=True),
                           Box2BoxTransformRotated(), 32, 0.5, beta)
    for k in ("loss_rpn_cls", "loss_rpn_loc"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, err_msg=k)
    sum(got.values()).backward()
    assert lg.grad.abs().sum() > 0 and dl.grad.abs().sum() > 0


@pytest.mark.parametrize("mode", ["test", "train"])
def test_find_top_rrpn_proposals_equal_jax(mode):
    """Two levels (6 x 5 and 3 x 3 cells of 3 anchors) of two images, top
    40 / 15 per level at NMS 0.7 (test) or 60 / 30 (train): boxes (clipped
    near-horizontal ones included), scores and validity slot for slot."""
    rng = np.random.RandomState(8 + (mode == "train"))
    gen = RotatedAnchorGenerator([[16], [40]], [[1.0]], [[-30, 0, 30]], [8, 16])
    anchors = gen.grid_anchors([(6, 5), (3, 3)])
    anchors[0][::5, 4] = 0.5  # near-horizontal: clipped
    logits = [rng.randn(2, len(a)).astype(np.float32) for a in anchors]
    deltas = [(rng.randn(2, len(a), 5) * 0.3).astype(np.float32) for a in anchors]
    pre, post = (40, 15) if mode == "test" else (60, 30)
    want = jax.jit(jax_rrpn.find_top_rrpn_proposals, static_argnums=(3, 4, 5, 6, 7))(
        [jnp.asarray(x) for x in logits], [jnp.asarray(x) for x in deltas], [jnp.asarray(a) for a in anchors], (40, 48),
        JaxB2BRot(), 0.7, pre, post)
    got = rrpn.find_top_rrpn_proposals([torch.from_numpy(x) for x in logits], [torch.from_numpy(x) for x in deltas],
                                       [torch.from_numpy(a) for a in anchors], (40, 48), Box2BoxTransformRotated(),
                                       0.7, pre, post)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    v = got[2].numpy()
    np.testing.assert_allclose(got[0].numpy()[v], np.asarray(want[0])[v], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)
    assert v.sum() > 10


def test_clip_and_normalize_equal_jax():
    rng = np.random.RandomState(10)
    b = _rboxes(rng, 50, -30, 90, (1, 60))
    b[::3, 4] = rng.uniform(-1.2, 1.2, 17)
    b[1::7, 4] += 540
    np.testing.assert_allclose(rrpn.clip_rotated_boxes(torch.from_numpy(b), (50, 70)).numpy(),
                               np.asarray(jax_rrpn.clip_rotated_boxes(jnp.asarray(b), (50, 70))), rtol=0, atol=1e-5)
    np.testing.assert_allclose(rrpn.normalize_angles(torch.from_numpy(b)).numpy(),
                               np.asarray(jax_rrpn.normalize_angles(jnp.asarray(b))), rtol=0, atol=1e-5)


# -- the whole model ---------------------------------------------------------------------------


def _cfgs(extra=()):
    jcfg, pcfg = jax_get_cfg(), get_cfg()
    for cfg in (jcfg, pcfg):
        cfg.merge_from_list(NARROW + list(extra))
    pcfg.MODEL.DEVICE = "cpu"
    return jcfg, pcfg


@pytest.fixture(scope="module")
def pair():
    jcfg, pcfg = _cfgs()
    jm = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), (SIZE, SIZE)))
    variables = _random_variables(shapes, 11)
    pm = build_model(pcfg)
    pm.model.load_state_dict(state_dict_from_jax(variables))
    return jm, variables, pm


def test_routing_and_every_leaf_crosses_once(pair):
    """A GeneralizedRCNN config naming RRPN / RROIHeads builds a
    ``RotatedRCNN`` in both packages; every JAX leaf (the trunk, the RPN
    head's 5-d ``anchor_deltas``, the one-fc box head, the class-agnostic
    5-d predictor) maps to one port key of its shape and back."""
    jm, variables, pm = pair
    assert type(jm).__name__ == type(pm).__name__ == "RotatedRCNN" and isinstance(pm, RotatedRCNN)
    leaves = {"/".join(p) for p in flatten_dict(variables)}
    own = {k for k in pm.model.state_dict() if not k.endswith("num_batches_tracked")}
    assert sorted(canonical_key(k, trunk="") for k in own) == sorted(leaves)
    assert {torch_key(p) for p in leaves} == own
    sd = pm.model.state_dict()
    assert sd["proposal_generator.rpn_head.anchor_deltas.weight"].shape[0] == 6 * 5
    assert sd["roi_heads.box_predictor.bbox_pred.weight"].shape[0] == 5
    assert torch_key("params/rpn_head/anchor_deltas/kernel") == "proposal_generator.rpn_head.anchor_deltas.weight"
    for extra in (["MODEL.ROI_HEADS.NAME", "StandardROIHeads"], ["MODEL.PROPOSAL_GENERATOR.NAME", "RPN"]):
        assert type(build_model(_cfgs(extra)[1])).__name__ == "RotatedRCNN"


def _images(n, seed):
    return np.random.RandomState(seed).uniform(0, 255, (n, SIZE, SIZE, 3)).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def test_predict_fn_equals_jax(pair):
    """Two images: the detections (rotated boxes, scores, classes) slot for
    slot, boxes within 1e-5 relative (the random model's reach far past the
    image), their angles within 1e-3 modulo 360, scores within 1e-5."""
    jm, variables, pm = pair
    pm.score_threshold = jm.score_threshold = 0.0  # every class a candidate: the grid and the NMS at work
    try:
        images = _images(2, 12)
        want = jax.tree_util.tree_map(np.asarray, jax.jit(jm.predict_fn)(variables, jnp.asarray(images)))
        got = {k: v.numpy() for k, v in pm.predict_fn(_nchw(images)).items()}
    finally:
        pm.score_threshold = jm.score_threshold = 0.05
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=1e-5)
    ok = want["scores"] > 0
    np.testing.assert_allclose(got["boxes"][ok][:, :4], want["boxes"][ok][:, :4], rtol=1e-5, atol=1e-4)
    assert np.abs((got["boxes"][ok][:, 4] - want["boxes"][ok][:, 4] + 180) % 360 - 180).max() < 1e-3
    assert ok.sum() > 4


def _train_batch(seed, n=2, m=4):
    rng = np.random.RandomState(seed)
    gt, valid = _gt(rng, n, m)
    return {"image": _images(n, seed + 1), "gt_boxes": gt, "gt_valid": valid,
            "gt_classes": rng.randint(0, 3, (n, m)).astype(np.int32)}


def _jax_rotated_draws(key, n, anchors, slots):
    """The uniforms JAX's ``RotatedRCNN.loss_fn`` draws from ``batch["rng"]``
    (split in two: the RRPN's per image, the ROI sampler's per image, which
    its tie-breaker draws again from the same key)."""
    k_rpn, k_roi = jax.random.split(key)
    roi = np.stack([np.asarray(jax.random.uniform(k, (slots,))) for k in jax.random.split(k_roi, n)])
    return {"rpn": torch.from_numpy(_rpn_draws(k_rpn, n, anchors)), "roi": torch.from_numpy(roi)}


def test_loss_and_every_gradient_equal_jax(pair):
    """Two images of 4 rotated gts on JAX's draws: the four losses within
    1e-5 relative and every parameter's gradient within 1e-4 of its own
    largest value (the frozen stem and res2 get 0 on both sides)."""
    jm, variables, pm = pair
    batch, key = _train_batch(13), jax.random.PRNGKey(4)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch["rng"] = key
    stats = variables["batch_stats"]
    (_, (jloss, _)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, stats, jbatch), has_aux=True))(variables["params"])
    anchors = sum(a.shape[0] for a in pm.anchors_per_level((SIZE, SIZE)))
    pb = {"image": _nchw(batch["image"]), "gt_boxes": torch.from_numpy(batch["gt_boxes"]),
          "gt_classes": torch.from_numpy(batch["gt_classes"]), "gt_valid": torch.from_numpy(batch["gt_valid"]),
          "draws": _jax_rotated_draws(key, 2, anchors, 30 + 4)}
    for p in pm.model.parameters():
        p.grad = torch.zeros_like(p)
    pm.model.train()
    try:
        total, losses = pm.loss_fn(pb)
        total.backward()
    finally:
        pm.model.eval()
    assert set(losses) == set(jloss) == {"loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg"}
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), float(jloss[k]), rtol=1e-5, err_msg=k)
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    grads = {k: p.grad for k, p in pm.model.named_parameters()}
    assert set(want) == set(grads)
    for k, g in grads.items():
        w = want[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * max(np.abs(w).max(), 1e-6), err_msg=k)


def test_loss_raises_on_the_mappers_xyxy_boxes(pair):
    """The train mapper's (N, M, 4) boxes: the JAX package clamps index 4 to
    3 and trains on other targets; the port raises naming the reason."""
    _, _, pm = pair
    b = _train_batch(14)
    pb = {"image": _nchw(b["image"]), "gt_boxes": torch.from_numpy(b["gt_boxes"][..., :4]),
          "gt_classes": torch.from_numpy(b["gt_classes"]), "gt_valid": torch.from_numpy(b["gt_valid"]),
          "generator": torch.Generator().manual_seed(0)}
    with pytest.raises(ValueError, match=r"\(N, M, 5\) rotated gt boxes"):
        pm.loss_fn(pb)


def test_simple_trainer_steps_on_rotated_batches(pair):
    """``SimpleTrainer.run_step`` on (N, M, 5) batches (the generator's
    draws): two steps, finite losses, the weights move."""
    _, _, pm = pair
    state = {k: v.clone() for k, v in pm.model.state_dict().items()}
    batches = [{k: (v.astype(np.uint8) if k == "image" else v) for k, v in _train_batch(s).items()} for s in (15, 16)]
    opt = torch.optim.SGD(pm.model.parameters(), lr=1e-3)
    trainer = SimpleTrainer(pm, iter(batches), opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda i: 1.0))
    try:
        trainer.train(0, 2)
        hist = trainer.storage.history("total_loss").values()
        assert len(hist) == 2 and all(math.isfinite(v) for v, _ in hist)
        moved = pm.model.state_dict()["roi_heads.box_predictor.cls_score.weight"]
        assert not torch.equal(moved, state["roi_heads.box_predictor.cls_score.weight"])
    finally:
        pm.model.load_state_dict(state)
        pm.model.eval()


@pytest.mark.parametrize("mirror", [False, True])
def test_postprocess_unwarps_as_jax(pair, mirror):
    """An isotropic letterbox-like warp (scale 0.5, offsets; mirrored in x):
    the kept detections' centres mapped back, sizes divided by the scale,
    the angle flipped by a mirror, clipped as ``RotatedBoxes``; equal to
    JAX's."""
    jm, _, pm = pair
    rng = np.random.RandomState(17)
    dets = {"boxes": _rboxes(rng, 16).reshape(2, 8, 5), "scores": rng.uniform(0, 1, (2, 8)).astype(np.float32),
            "classes": rng.randint(0, 3, (2, 8))}
    sx = -0.5 if mirror else 0.5
    warps = [np.array([[sx, 0, 60.0 if mirror else 3.0], [0, 0.5, 5.0]]), np.array([[0.5, 0, 0], [0, 0.5, 2.0]])]
    got = pm.postprocess(dets, warps, [(100, 120), (90, 128)])
    want = jm.postprocess(dets, warps, [(100, 120), (90, 128)])
    for g, w in zip(got, want):
        gi, wi = g["instances"], w["instances"]
        assert isinstance(gi, Instances) and isinstance(gi.pred_boxes, RotatedBoxes) and isinstance(wi, JaxInstances)
        np.testing.assert_allclose(gi.pred_boxes.tensor, wi.pred_boxes.tensor, rtol=1e-6, atol=1e-4)
        np.testing.assert_array_equal(gi.scores, wi.scores)
        np.testing.assert_array_equal(gi.pred_classes, wi.pred_classes)


# -- the rotated COCO evaluation -------------------------------------------------------------------


def test_rotated_coco_evaluator_equals_jax():
    """Six images of rotated and axis-aligned (XYWH, angle 0) gts, detections
    near them with angle noise, duplicates and misses: AP, AP50 and AP75 of
    ``RotatedCOCOEvaluator`` within 1e-9 of JAX's; also through
    ``inference_on_dataset``."""
    rng = np.random.RandomState(18)
    records, outputs = [], []
    for i in range(6):
        anns = []
        for j in range(5):
            cls = int(rng.randint(0, 2))
            if j % 2:
                x, y, w, h = rng.uniform(5, 40), rng.uniform(5, 40), rng.uniform(8, 20), rng.uniform(8, 20)
                anns.append({"bbox": [x, y, w, h], "bbox_mode": 1, "category_id": cls, "iscrowd": 0})
            else:
                anns.append({"bbox": [float(v) for v in _rboxes(rng, 1)[0]], "bbox_mode": 4, "category_id": cls,
                             "iscrowd": 0})
        records.append({"image_id": i, "file_name": f"{i}.png", "height": 64, "width": 64, "annotations": anns})
        boxes, scores, classes = [], [], []
        for a in anns:  # two detections near each gt, a fifth of them of the other class
            b = np.asarray(a["bbox"], np.float64)
            b = np.array([b[0] + b[2] / 2, b[1] + b[3] / 2, b[2], b[3], 0.0]) if len(b) == 4 else b.copy()
            for _ in range(2):
                noisy = b + np.concatenate([rng.normal(0, 1.5, 4), rng.normal(0, 6, 1)])
                boxes.append(noisy)
                scores.append(rng.uniform(0.1, 1))
                classes.append(a["category_id"] if rng.uniform() < 0.8 else 1 - a["category_id"])
        outputs.append((np.asarray(boxes, np.float32), np.asarray(scores, np.float32), np.asarray(classes)))
    k = max(len(o[1]) for o in outputs)
    pad = lambda a: np.concatenate([a, np.zeros((k - len(a),) + a.shape[1:], a.dtype)])  # noqa: E731
    dets = {"boxes": np.stack([pad(o[0]) for o in outputs]), "scores": np.stack([pad(o[1]) for o in outputs]),
            "classes": np.stack([pad(o[2]) for o in outputs])}
    warps, sizes = [np.array([[1.0, 0, 0], [0, 1.0, 0]])] * 6, [(64, 64)] * 6

    class Host:  # postprocess reads the score threshold alone
        score_threshold = 0.05

    name = "_test_torch_rotated_eval"
    for catalog in (DatasetCatalog, JaxDatasetCatalog):
        if name in catalog:
            catalog.remove(name)
        catalog.register(name, lambda: records)
    try:
        results = []
        for ev_cls, post in ((RotatedCOCOEvaluator, RotatedRCNN.postprocess),
                             (JaxRotatedEvaluator, jax_rotated_rcnn.RotatedRCNN.postprocess)):
            ev = ev_cls(name)
            ev.reset()
            ev.process([{"image_id": i} for i in range(6)], post(Host(), dets, warps, sizes))
            results.append(ev.evaluate()["bbox"])
        for key in ("AP", "AP50", "AP75"):
            assert abs(results[0][key] - results[1][key]) <= 1e-9, (key, results)
        assert 0 < results[0]["AP50"] < 100

        def predict_fn(images):  # image i's detections: its first pixel says which
            idx = images[:, 0, 0, 0].long().tolist()
            return {key: torch.from_numpy(v[idx]) for key, v in dets.items()}

        loader = [{"image": np.full((1, 8, 8, 3), i, np.uint8), "image_id": [i], "warp": warps[:1],
                   "height": np.array([64]), "width": np.array([64])} for i in range(6)]
        via = inference_on_dataset(predict_fn, loader, RotatedCOCOEvaluator(name),
                                   postprocess=lambda d, w, s: RotatedRCNN.postprocess(Host(), d, w, s), device="cpu")
    finally:
        for catalog in (DatasetCatalog, JaxDatasetCatalog):
            catalog.remove(name)
    assert via["bbox"] == results[0]
