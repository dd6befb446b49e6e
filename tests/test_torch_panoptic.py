"""The port's Panoptic FPN against the JAX package on the CPU, at a small
size (``test_torch_rcnn``'s Mask R-CNN: ResNet-18 with RES2 16 and a stem
of 8, FPN 32, FC_DIM 64, 5 classes, a mask head of 32; a sem-seg head of 16
and 7 classes; 64² inputs, f32): the loss dict and every gradient (an image
without instances among them, and a batch without ``sem_seg``), which the
port computes on one backbone pass where JAX runs two (ROADMAP C23);
``predict_fn``'s detections, masks and sem-seg logits; the host boundary
and the panoptic merge (exact: tied scores, overlaps, small stuff); Panoptic
Quality; the evaluators ``train_net`` builds; a GroupNorm
``DeformBottleneckBlock`` (the dconv Cascade GN config's); and the entry
points.

Tolerances: 1e-5 relative for the losses, 1e-4 of each gradient's own max
for the gradients, 2e-3 for the mask probabilities (their boxes agree to
1e-2 px), 1e-5 of the scale for the sem-seg logits and the GN block, exact
for the merge and the postprocessed outputs at the identity warp, 1e-9 for
PQ.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from detectron2_centernet_tpu.config import get_cfg as jax_get_cfg
from detectron2_centernet_tpu.evaluation import panoptic_evaluation as jax_pq
from detectron2_centernet_tpu.models.backbones import resnet as jax_resnet
from detectron2_centernet_tpu.models.build import build_model as jax_build_model
from detectron2_centernet_tpu.models.meta_arch import panoptic_fpn as jax_panoptic
from detectron2_centernet_tpu.structures import Instances as JaxInstances
from detectron2_centernet_tpu_torch.checkpoint import state_dict_from_jax
from detectron2_centernet_tpu_torch.config import get_cfg
from detectron2_centernet_tpu_torch.data import DatasetCatalog, MetadataCatalog
from detectron2_centernet_tpu_torch.data.datasets import ensure_synthetic_datasets, register_synthetic_instances
from detectron2_centernet_tpu_torch.evaluation import PanopticEvaluator, pq_compute_single_image
from detectron2_centernet_tpu_torch.models import build_model
from detectron2_centernet_tpu_torch.models.backbones import resnet
from detectron2_centernet_tpu_torch.models.meta_arch import combine_semantic_and_instance_outputs
from detectron2_centernet_tpu_torch.tools import bench, train_net

from test_torch_dconv import _assert_close, _block_state, _nhwc
from test_torch_dconv import _random_variables as _dconv_variables
from test_torch_mask import MASK, _mask_batch
from test_torch_rcnn import SIZE, SMALL, _anchor_count, _close, _images, _jax_draws, _nchw, _port_batch
from test_torch_rcnn import _random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PANOPTIC = MASK + ["MODEL.META_ARCHITECTURE", "PanopticFPN", "MODEL.SEM_SEG_HEAD.CONVS_DIM", 16,
                   "MODEL.SEM_SEG_HEAD.NUM_CLASSES", 7, "MODEL.SEM_SEG_HEAD.IN_FEATURES", ["p2", "p3", "p4", "p5"],
                   "MODEL.SEM_SEG_HEAD.LOSS_WEIGHT", 0.5, "MODEL.PANOPTIC_FPN.INSTANCE_LOSS_WEIGHT", 0.7,
                   "MODEL.PANOPTIC_FPN.COMBINE.STUFF_AREA_LIMIT", 60]


def _cfgs(extra=()):
    jcfg, pcfg = jax_get_cfg(), get_cfg()
    jcfg.merge_from_list(SMALL + PANOPTIC + list(extra))
    pcfg.merge_from_list(SMALL + PANOPTIC + list(extra) + ["MODEL.DEVICE", "cpu"])
    return jcfg, pcfg


@pytest.fixture(scope="module")
def pair():
    """(JAX PanopticFPN, its random variables with the separate
    ``sem_seg_head`` tree, the port's with them)."""
    jcfg, pcfg = _cfgs()
    jm = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), (SIZE, SIZE)))
    variables = _random_variables(shapes, 0)
    pm = build_model(pcfg)
    pm.model.load_state_dict(state_dict_from_jax(variables))
    return jm, variables, pm


@pytest.fixture(scope="module")
def jax_predict(pair):
    return jax.jit(pair[0].predict_fn)


def test_every_jax_leaf_crosses_to_one_port_key(pair):
    """``state_dict_from_jax`` of the whole tree gives the port's keys, the
    sem-seg head's at the network's top level (``sem_seg_head.p5.4.norm``)."""
    _, variables, pm = pair
    got = {k for k in state_dict_from_jax(variables) if not k.endswith("num_batches_tracked")}
    own = set(pm.model.state_dict())
    assert got == own
    heads = {k for k in own if k.startswith("sem_seg_head.")}
    assert "sem_seg_head.p5.4.norm.weight" in heads and "sem_seg_head.predictor.bias" in heads
    assert len(heads) == 3 * (1 + 1 + 2 + 3) + 2
    assert len(heads) == sum(1 for k in flatten_dict(variables["params"]) if k[0] == "sem_seg_head")


def _panoptic_batch(seed, sem_seg=True, empty_image=False):
    b = _mask_batch(seed)
    if empty_image:
        b["gt_valid"][1] = False
    if sem_seg:
        rng = np.random.RandomState(seed + 70)
        lab = rng.randint(0, 7, (2, SIZE, SIZE)).astype(np.int32)
        lab[rng.rand(2, SIZE, SIZE) < 0.1] = 255
        b["sem_seg"] = lab
    return b


@pytest.mark.parametrize("sem_seg, empty_image", [(True, True), (False, False)],
                         ids=["an_image_without_instances", "no_sem_seg"])
def test_one_backbone_pass_gives_jax_losses_and_every_gradient(pair, sem_seg, empty_image):
    """The loss dict on JAX's draws: the RPN's unweighted, the ROI heads'
    × 0.7, ``loss_sem_seg`` × 0.5 (0 for a batch without ``sem_seg``), each
    within 1e-5 relative of JAX's, which runs the backbone a second time
    for the sem-seg head; every parameter's gradient (the trunk's and the
    FPN's get both heads' parts through one pass here) within 1e-4 of its
    own max. One batch has an image without instances (all its gt slots
    invalid, as ``FILTER_EMPTY_ANNOTATIONS False`` lets through)."""
    jm, variables, pm = pair
    batch, key = _panoptic_batch(3, sem_seg, empty_image), jax.random.PRNGKey(6)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch["rng"] = key
    stats = variables["batch_stats"]
    (_, (jloss, _)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, stats, jbatch), has_aux=True))(variables["params"])
    pb = _port_batch(batch, _jax_draws(key, 2, _anchor_count(pm), max(100 + 6, 64)))
    pb["gt_masks"] = torch.from_numpy(batch["gt_masks"])
    if sem_seg:
        pb["sem_seg"] = torch.from_numpy(batch["sem_seg"]).long()
    for p in pm.model.parameters():
        p.grad = torch.zeros_like(p)
    pm.model.train()
    try:
        total, losses = pm.loss_fn(pb)
        total.backward()
    finally:
        pm.model.eval()
    assert set(losses) == set(jloss) == {"loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "loss_mask",
                                         "loss_sem_seg"}
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), float(jloss[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(total.item(), sum(float(v) for v in jloss.values()), rtol=1e-5)
    assert (losses["loss_sem_seg"].item() > 0) == sem_seg
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    grads = {k: p.grad for k, p in pm.model.named_parameters()}
    assert set(want) == set(grads)
    for k, g in grads.items():
        w = want[k].numpy()
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max(), k
    assert (grads["sem_seg_head.p5.4.weight"].abs().max() > 0) == sem_seg
    assert grads["backbone.fpn_output2.weight"].abs().max() > 0


def test_predict_fn_detections_masks_and_sem_seg_logits_match_jax(pair, jax_predict):
    """Two 64² images: the 100 detection slots' classes equal, the masks
    within 2e-3 (as Mask R-CNN's), and ``sem_seg`` (N, 7, 64, 64) within
    1e-5 of its scale of JAX's (N, 64, 64, 7) on the same backbone maps."""
    _, variables, pm = pair
    x = _images(2, seed=12)
    want = jax_predict(variables, jnp.asarray(x))
    got = pm.predict_fn(_nchw(x))
    np.testing.assert_array_equal(got["classes"].numpy(), np.asarray(want["classes"]))
    np.testing.assert_allclose(got["masks"].numpy(), np.asarray(want["masks"]), rtol=0, atol=2e-3)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), rtol=0, atol=1e-2)
    sem = np.asarray(want["sem_seg"]).transpose(0, 3, 1, 2)
    assert tuple(got["sem_seg"].shape) == sem.shape == (2, 7, SIZE, SIZE)
    _close(got["sem_seg"].numpy(), sem, 1e-5, "sem_seg logits")


def test_postprocess_gives_jax_instances_labels_and_panoptic_segments(pair, jax_predict):
    """JAX's own ``predict_fn`` output (the boxes replaced by random ones in
    the frame, the scores by draws from five values, so ties cross the
    merge's 0.5 threshold) through both host boundaries at the identity
    warp: the instances, the sem-seg label maps and the panoptic segment
    ids and ``segments_info`` equal."""
    jm, variables, pm = pair
    x = _images(2, seed=13)
    dets = {k: np.asarray(v) for k, v in jax_predict(variables, jnp.asarray(x)).items()}
    rng = np.random.RandomState(13)
    xy = rng.uniform(-4, 50, (2, 100, 2))
    dets["boxes"] = np.concatenate([xy, xy + rng.uniform(4, 30, (2, 100, 2))], -1).astype(np.float32)
    dets["scores"] = rng.choice(np.array([0.3, 0.55, 0.7, 0.7, 0.9], np.float32), (2, 100))
    warps = [np.eye(2, 3, dtype=np.float32)] * 2
    sizes = [(SIZE, SIZE)] * 2
    want = jm.postprocess(dets, warps, sizes)
    logits = torch.from_numpy(np.ascontiguousarray(dets["sem_seg"].transpose(0, 3, 1, 2)))
    port_dets = dict(dets, sem_seg=pm.device_postprocess({"sem_seg": logits}, warps, sizes)["sem_seg"].numpy())
    got = pm.postprocess(port_dets, warps, sizes)
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"instances", "sem_seg", "panoptic_seg"}
        gi, wi = g["instances"], w["instances"]
        assert len(gi) == len(wi) > 10
        np.testing.assert_array_equal(gi.scores, wi.scores)
        np.testing.assert_array_equal(gi.pred_masks, wi.pred_masks)
        np.testing.assert_array_equal(g["sem_seg"], w["sem_seg"])
        assert g["sem_seg"].dtype == np.int64
        np.testing.assert_array_equal(g["panoptic_seg"][0], w["panoptic_seg"][0])
        assert g["panoptic_seg"][0].dtype == np.int32
        assert g["panoptic_seg"][1] == w["panoptic_seg"][1]
        assert any(s["isthing"] for s in g["panoptic_seg"][1]) and any(not s["isthing"] for s in g["panoptic_seg"][1])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_panoptic_merge_equals_jax_exactly(seed):
    """``combine_semantic_and_instance_outputs`` on 40 random masks with
    scores from five values (numpy's quicksort orders ties other than a
    stable sort does, and the port takes numpy's order), overlaps above
    ``OVERLAP_THRESH`` 0.5, and stuff labels some of which keep fewer free
    pixels than the limit: the segment ids bit for bit and the
    ``segments_info`` list equal to JAX's; an empty mask is skipped."""
    rng = np.random.RandomState(seed)
    h, w, n = 48, 56, 40
    scores = rng.choice(np.array([0.95, 0.8, 0.8, 0.6, 0.45], np.float32), n)
    masks = np.zeros((n, h, w), bool)
    for i in range(n):
        y0, x0 = rng.randint(0, h - 4), rng.randint(0, w - 4)
        masks[i, y0:y0 + rng.randint(3, 20), x0:x0 + rng.randint(3, 20)] = True
    masks[5] = False
    classes = rng.randint(0, 80, n).astype(np.int64)
    sem = rng.randint(0, 9, (h // 8, w // 8)).repeat(8, 0).repeat(8, 1).astype(np.int64)
    inst = JaxInstances((h, w))
    inst.scores, inst.pred_masks, inst.pred_classes = scores, masks, classes
    want_pan, want_info = jax_panoptic.combine_semantic_and_instance_outputs(inst, sem, 0.5, 100, 0.5)
    got_pan, got_info = combine_semantic_and_instance_outputs(scores, classes, torch.from_numpy(masks),
                                                              torch.from_numpy(sem), 0.5, 100, 0.5, 9)
    np.testing.assert_array_equal(got_pan, want_pan)
    assert got_info == want_info
    assert not np.array_equal(np.argsort(-scores), np.argsort(-scores, kind="stable"))
    things = [s for s in want_info if s["isthing"]]
    assert 3 < len(things) < int((scores >= 0.5).sum()) - 1  # some skipped for overlap
    assert 5 not in [s["instance_id"] for s in things]
    free = np.bincount(sem[want_pan == 0], minlength=9) if (want_pan == 0).any() else np.zeros(9)
    assert any(0 < free[k] < 100 for k in range(1, 9))  # a stuff label under the limit, left out


def test_panoptic_merge_settles_when_kept_and_dropped_instances_alternate():
    """A chain of 12 boxes, each covering 60% of the one before: kept and
    dropped alternate down the chain (a dropped box frees what the next
    one overlaps), the merge's worst case for its passes; the ids and
    ``segments_info`` equal JAX's."""
    h, w, n = 20, 120, 12
    masks = np.zeros((n, h, w), bool)
    for i in range(n):
        masks[i, :, 4 * i:4 * i + 10] = True
    scores = np.linspace(0.99, 0.6, n).astype(np.float32)
    classes = np.arange(n)
    sem = np.zeros((h, w), np.int64)
    inst = JaxInstances((h, w))
    inst.scores, inst.pred_masks, inst.pred_classes = scores, masks, classes
    want_pan, want_info = jax_panoptic.combine_semantic_and_instance_outputs(inst, sem, 0.5, 10, 0.5)
    got_pan, got_info = combine_semantic_and_instance_outputs(scores, classes, torch.from_numpy(masks),
                                                              torch.from_numpy(sem), 0.5, 10, 0.5, 1)
    np.testing.assert_array_equal(got_pan, want_pan)
    assert got_info == want_info
    assert [s["instance_id"] for s in want_info] == list(range(0, n, 2))


def test_panoptic_merge_without_masks_keeps_stuff_only():
    """A model without masks (None): no thing segments, the stuff as JAX
    fills it (JAX skips every instance of such a model)."""
    sem = np.repeat(np.arange(4), 400).reshape(40, 40)
    inst = JaxInstances((40, 40))
    inst.scores, inst.pred_classes = np.array([0.9], np.float32), np.array([3])
    want = jax_panoptic.combine_semantic_and_instance_outputs(inst, sem, 0.5, 50, 0.5)
    got = combine_semantic_and_instance_outputs(inst.scores, inst.pred_classes, None, torch.from_numpy(sem), 0.5, 50,
                                                0.5)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and len(got[1]) == 3


def _pq_case(rng, h=40, w=50):
    """A ground truth of 6 segments (one crowd), void at 0, and a
    prediction that moves some, merges two and invents one."""
    gt = np.zeros((h, w), np.int32)
    segs = []
    for i in range(1, 7):
        y0, x0 = rng.randint(0, h - 10), rng.randint(0, w - 10)
        gt[y0:y0 + rng.randint(5, 15), x0:x0 + rng.randint(5, 15)] = i
        segs.append({"id": i, "category_id": int(rng.randint(0, 3)), "iscrowd": int(i == 6)})
    pred = np.roll(gt, rng.randint(-2, 3), axis=1) * (rng.rand(h, w) < 0.97)
    pred[pred == 2] = 3
    pred[rng.randint(0, h - 6):, :6] = 9
    pred_segs = [{"id": s["id"], "category_id": s["category_id"] if rng.rand() < 0.8 else 2} for s in segs if
                 s["id"] != 2] + [{"id": 9, "category_id": 1}]
    return gt, segs, pred.astype(np.int32), pred_segs


def test_panoptic_quality_equals_jax():
    """Per-image stats and the summary (PQ, SQ, RQ) over five random images
    within 1e-9 of JAX's."""
    rng = np.random.RandomState(21)
    got, want = PanopticEvaluator(), jax_pq.PanopticEvaluator()
    for ev in (got, want):
        ev.reset()
    for _ in range(5):
        case = _pq_case(rng)
        g, w = pq_compute_single_image(*case), jax_pq.pq_compute_single_image(*case)
        assert g.keys() == w.keys()
        for cat in g:
            for k in ("tp", "fp", "fn", "iou_sum"):
                assert abs(g[cat][k] - w[cat][k]) <= 1e-9
        got.update(g)
        want.update(w)
    gs, ws = got.summarize(), want.summarize()
    assert set(gs) == set(ws) == {"PQ", "SQ", "RQ"}
    for k in gs:
        assert math.isfinite(gs[k]) and abs(gs[k] - ws[k]) <= 1e-9
    assert 0 < gs["PQ"] < 100


# -- the GN deformable block (the dconv Cascade GN config's trunk) --------------------------------------


@pytest.mark.parametrize("train", [False, True])
def test_gn_deform_bottleneck_block_matches_jax(train):
    """A stride-2 GN block (32 → 64 channels, bottleneck 32, the 3x3 taking
    the stride as with ``STRIDE_IN_1X1`` False, DCNv1) on a 2 × 32 × 15 ×
    17 map, weights crossed by ``state_dict_from_jax`` (``conv1_norm/gn``
    → ``conv1.norm``): the output within 1e-5 of its scale and, in train,
    the gradients of every parameter and the input within 1e-4 of theirs."""
    rng = np.random.RandomState(9)
    x = rng.randn(2, 15, 17, 32).astype(np.float32)
    jb = jax_resnet.DeformBottleneckBlock(64, 32, stride=2, stride_in_1x1=False, norm="GN", deform_modulated=False)
    variables = _dconv_variables(jax.eval_shape(lambda: jb.init(jax.random.PRNGKey(0), jnp.asarray(x))), 10)
    assert ("gn", "scale") in flatten_dict(variables["params"]["conv1_norm"])
    pb = resnet.DeformBottleneckBlock(32, 64, 32, 2, False, 1, "GN", False)
    pb.load_state_dict(_block_state(variables))
    assert isinstance(pb.conv1.norm, torch.nn.GroupNorm) and pb.conv1.norm.num_groups == 32
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    if not train:
        with torch.no_grad():
            got = pb.eval()(xt)
        _assert_close(_nhwc(got), np.asarray(jb.apply(variables, jnp.asarray(x))), 1e-5, "output")
        return
    cot = rng.randn(2, 8, 9, 64).astype(np.float32)
    loss = lambda p, xi: (jb.apply({**variables, "params": p}, xi, True) * cot).sum()
    jgp, jgx = jax.grad(loss, argnums=(0, 1))(variables["params"], jnp.asarray(x))
    xt.requires_grad_(True)
    out = pb.train()(xt)
    (out * torch.from_numpy(cot.transpose(0, 3, 1, 2).copy())).sum().backward()
    _assert_close(_nhwc(out), np.asarray(jb.apply(variables, jnp.asarray(x), True)), 1e-5, "output")
    _assert_close(_nhwc(xt.grad), np.asarray(jgx), 1e-4, "d input")
    want = _block_state({"params": jax.tree_util.tree_map(np.asarray, jgp)})
    grads = {k: p.grad for k, p in pb.named_parameters()}
    assert set(grads) == set(want)
    for k, g in grads.items():
        _assert_close(g.numpy(), want[k].numpy(), 1e-4, k)


# -- the entry points -----------------------------------------------------------------------------------


def test_train_net_trains_panoptic_fpn_with_an_empty_image_then_evaluates_three_tasks(tmp_path):
    """``tools/train_net`` on ``panoptic_fpn_R_50_1x.yaml`` cut in width
    (ResNet-18, RES2 16, FPN 32, FC_DIM 64, mask convs of 32, a sem-seg head
    of 16) and size (64², top-ks 200/100 and 100/50, 64 rois), 2 SGD steps at
    batch 2 on panoptic stand-ins whose first image has no instance left
    (``FILTER_EMPTY_ANNOTATIONS`` False, as ``Base-Panoptic-FPN.yaml`` sets
    it, keeps it; its ``sem_seg`` still trains the head), then
    ``--eval-only --resume``:
    finite losses with ``loss_sem_seg``, and bbox, segm and sem_seg dicts,
    the same in both runs."""
    from detectron2_centernet_tpu_torch.engine import default_argument_parser, launch

    name = "test_torch_panoptic_train"
    if name not in DatasetCatalog:
        register_synthetic_instances("test_torch_panoptic_source", num_images=2, image_size=(64, 64), panoptic=True)

        def load():
            dicts = [dict(d) for d in DatasetCatalog.get("test_torch_panoptic_source")]
            dicts[0]["annotations"] = []
            return dicts

        DatasetCatalog.register(name, load)
        MetadataCatalog.get(name).set(**MetadataCatalog.get("test_torch_panoptic_source").as_dict())
    argv = [str(a) for a in [
        "--config-file", os.path.join(REPO, "configs", "COCO-PanopticSegmentation", "panoptic_fpn_R_50_1x.yaml"),
        "MODEL.DEVICE", "cpu", "MODEL.WEIGHTS", "", "MODEL.RESNETS.DEPTH", 18, "MODEL.RESNETS.RES2_OUT_CHANNELS", 16,
        "MODEL.RESNETS.STEM_OUT_CHANNELS", 8, "MODEL.FPN.OUT_CHANNELS", 32, "MODEL.ROI_BOX_HEAD.FC_DIM", 64,
        "MODEL.ROI_MASK_HEAD.CONV_DIM", 32, "MODEL.SEM_SEG_HEAD.CONVS_DIM", 16, "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE",
        64, "MODEL.ROI_HEADS.SCORE_THRESH_TEST", 0.0, "MODEL.RPN.PRE_NMS_TOPK_TRAIN", 200,
        "MODEL.RPN.POST_NMS_TOPK_TRAIN", 100, "MODEL.RPN.PRE_NMS_TOPK_TEST", 100, "MODEL.RPN.POST_NMS_TOPK_TEST", 50,
        "TEST.DETECTIONS_PER_IMAGE", 20, "INPUT.TRAIN_SIZE", f"({SIZE}, {SIZE})", "INPUT.TEST_SIZE",
        f"({SIZE}, {SIZE})", "SOLVER.IMS_PER_BATCH", 2, "SOLVER.MAX_ITER", 2, "SOLVER.BASE_LR", 0.002,
        "TEST.BATCH_SIZE", 2, "DATALOADER.NUM_WORKERS", 1, "OUTPUT_DIR", str(tmp_path), "TPU.DTYPE", "float32",
        "DATASETS.TRAIN", f"('{name}',)", "DATALOADER.FILTER_EMPTY_ANNOTATIONS", False]]
    args = default_argument_parser().parse_args(argv)
    cfg = train_net.setup(args)
    assert not cfg.DATALOADER.FILTER_EMPTY_ANNOTATIONS
    ensure_synthetic_datasets(list(cfg.DATASETS.TEST))
    trained = launch(train_net.main, args=(args,))
    evaluated = launch(train_net.main, args=(default_argument_parser().parse_args(["--eval-only", "--resume"] + argv),))
    assert set(trained) == {"bbox", "segm", "sem_seg"}
    assert all(math.isfinite(trained[t][k]) for t in ("bbox", "segm") for k in ("AP", "AP50"))
    assert all(math.isfinite(v) for k, v in trained["sem_seg"].items() if k != "mIoU")
    assert json.dumps(trained, sort_keys=True) == json.dumps(evaluated, sort_keys=True)
    rows = [json.loads(line) for line in open(tmp_path / "metrics.json") if "loss_sem_seg" in line]
    assert len(rows) == 1 and all(math.isfinite(rows[0][k]) for k in ("loss_sem_seg", "loss_mask", "total_loss"))


def test_bench_names_the_panoptic_configs():
    """tools/bench calls PanopticFPN ``panoptic_fpn`` against 1 / 0.053 img/s
    (MODEL_ZOO's Panoptic FPN R50, BASELINE.md:19), and the dconv Cascade
    GN R101 ``cascade_panoptic_fpn`` with no baseline."""
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "COCO-PanopticSegmentation", "panoptic_fpn_R_50_1x.yaml"))
    assert bench.metric_name(cfg) == "panoptic_fpn_res50_fpn_800_infer_throughput"
    assert bench.baseline_img_s(cfg) == pytest.approx(1 / 0.053)
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "Misc", "panoptic_fpn_R_101_dconv_cascade_gn_3x.yaml"))
    assert bench.metric_name(cfg) == "cascade_panoptic_fpn_res101_fpn_800_infer_throughput"
    assert bench.baseline_img_s(cfg) is None


@pytest.mark.parametrize("kind", ["panoptic", "semantic", "panoptic_dconv"])
def test_chip_smoke_reads_the_segmentation_configs_as_the_jax_package_does(kind):
    """``chip_smoke.py``'s phase 20 reads its three YAML files with the
    port's reader, the run's dtype, output directory and seed over them and
    no weights file: key for key the JAX package's config of the same file
    and overrides, at full width (54 stuff classes, a head of 128; the
    dconv config's R101 GN trunk with 30 deformable blocks, batch 32)."""
    import sys

    from test_torch_rcnn import _flat

    sys.path.insert(0, REPO)
    import chip_smoke

    _, folder, name = chip_smoke.SEGMENTATION[kind]
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        got = chip_smoke.rcnn_cfg(name, "bfloat16", folder)
    finally:
        os.chdir(cwd)
    want = jax_get_cfg()
    want.merge_from_file(os.path.join(REPO, "configs", folder, name + ".yaml"))
    want.merge_from_list(["TPU.DTYPE", "bfloat16", "OUTPUT_DIR", "output/chip_smoke", "SEED", 0,
                          "MODEL.WEIGHTS", ""])
    assert _flat(got) == _flat(want)
    s = got.MODEL.SEM_SEG_HEAD
    assert (s.NUM_CLASSES, s.CONVS_DIM, got.MODEL.FPN.OUT_CHANNELS) == (54, 128, 256)
    if kind == "panoptic_dconv":
        r = got.MODEL.RESNETS
        assert (r.DEPTH, r.NORM, list(r.DEFORM_ON_PER_STAGE)) == (101, "GN", [False, True, True, True])
        assert got.SOLVER.IMS_PER_BATCH == 32 and chip_smoke.R101_DEFORM_BLOCKS == 30
        model_cfg = got.clone()
        model_cfg.merge_from_list(["MODEL.DEVICE", "cpu"])
        from detectron2_centernet_tpu_torch.models.backbones.fpn import build_resnet_fpn_backbone

        trunk = build_resnet_fpn_backbone(model_cfg).bottom_up
        assert sum(isinstance(b, resnet.DeformBottleneckBlock) for b in trunk.modules()) == 30
