"""Fast R-CNN (``MODEL.LOAD_PROPOSALS``) of the port on the CPU, held against
the JAX package: ``load_proposals_into_dataset`` on pickles the test writes
(Detectron1 key names, an XYWH ``bbox_mode``, an image missing from the
file), the mapper's proposal slots in train and eval (the backfill of a
top-K box the warp makes degenerate), the loss with its RPN head idle and
every gradient, ``predict_fn`` on the batch's proposals, the evaluation
through ``inference_on_dataset`` (``DefaultTrainer.test``), and the entry
points around it: ``train_net`` trains and evaluates on a proposal file,
``DefaultPredictor`` raises.

The model is the Faster R-CNN of ``tests/test_torch_rcnn.py`` cut to size
(ResNet-18 with RES2 16, FPN 32, FC_DIM 64, f32) with random weights made
with numpy from a seed, crossed to the port by ``state_dict_from_jax``; the
ROI sampler gets the uniforms JAX draws from the same key."""

import copy
import json
import math
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from detectron2_centernet_tpu.config import get_cfg as jax_get_cfg
from detectron2_centernet_tpu.data import DatasetCatalog as JaxCatalog
from detectron2_centernet_tpu.data.build import load_proposals_into_dataset as jax_load_proposals
from detectron2_centernet_tpu.data.dataset_mapper import DatasetMapper as JaxMapper
from detectron2_centernet_tpu.data.datasets.synthetic import ensure_synthetic_datasets as jax_ensure
from detectron2_centernet_tpu.engine import DefaultTrainer as JaxTrainer
from detectron2_centernet_tpu.models.build import build_model as jax_build_model
from detectron2_centernet_tpu_torch.checkpoint import state_dict_from_jax
from detectron2_centernet_tpu_torch.config import get_cfg
from detectron2_centernet_tpu_torch.data import DatasetCatalog, DatasetMapper
from detectron2_centernet_tpu_torch.data.build import get_detection_dataset_dicts, load_proposals_into_dataset
from detectron2_centernet_tpu_torch.data.datasets import ensure_synthetic_datasets
from detectron2_centernet_tpu_torch.engine import DefaultPredictor, DefaultTrainer
from detectron2_centernet_tpu_torch.models import build_model
from detectron2_centernet_tpu_torch.tools import train_net

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64
LEARNABLE = "synth_learnable"  # 24 images of 128², 3 classes
TOPK_TRAIN, TOPK_TEST = 40, 30
SMALL = ["MODEL.META_ARCHITECTURE", "GeneralizedRCNN", "MODEL.BACKBONE.NAME", "build_resnet_fpn_backbone",
         "MODEL.RESNETS.DEPTH", 18, "MODEL.RESNETS.RES2_OUT_CHANNELS", 16, "MODEL.RESNETS.STEM_OUT_CHANNELS", 8,
         "MODEL.RESNETS.OUT_FEATURES", ["res2", "res3", "res4", "res5"],
         "MODEL.FPN.IN_FEATURES", ["res2", "res3", "res4", "res5"], "MODEL.FPN.OUT_CHANNELS", 32,
         "MODEL.RPN.IN_FEATURES", ["p2", "p3", "p4", "p5", "p6"],
         "MODEL.ANCHOR_GENERATOR.SIZES", [[32], [64], [128], [256], [512]],
         "MODEL.ROI_HEADS.NAME", "StandardROIHeads", "MODEL.ROI_HEADS.NUM_CLASSES", 5,
         "MODEL.ROI_HEADS.IN_FEATURES", ["p2", "p3", "p4", "p5"], "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 64,
         "MODEL.ROI_BOX_HEAD.NUM_FC", 2, "MODEL.ROI_BOX_HEAD.FC_DIM", 64,
         "MODEL.LOAD_PROPOSALS", True, "MODEL.PROPOSAL_GENERATOR.NAME", "PrecomputedProposals",
         "DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN", TOPK_TRAIN, "DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST", TOPK_TEST,
         "INPUT.TRAIN_SIZE", (SIZE, SIZE), "INPUT.TEST_SIZE", (SIZE, SIZE), "TPU.DTYPE", "float32",
         "TEST.EXACT_MODE", True, "INPUT.COLOR_JITTER", False, "DATASETS.TRAIN", ()]


def _cfgs(extra=()):
    jcfg, pcfg = jax_get_cfg(), get_cfg()
    jcfg.merge_from_list(SMALL + list(extra))
    pcfg.merge_from_list(SMALL + list(extra) + ["MODEL.DEVICE", "cpu"])
    return jcfg, pcfg


def _random_variables(shapes, seed):
    """Kernels N(0, 1/fan_in) (the predictors' scaled down, as in
    tests/test_torch_rcnn.py), norm scales and variances in [0.5, 1.5],
    biases and means N(0, 0.1²)."""
    scale = {"cls_score": 0.02, "bbox_pred": 0.005, "objectness_logits": 0.05, "anchor_deltas": 0.1}
    rng = np.random.RandomState(seed)
    out = {}
    for path, v in flatten_dict(shapes).items():
        if path[-1] == "kernel":
            a = rng.randn(*v.shape) / np.sqrt(np.prod(v.shape[:-1])) * scale.get(path[-2], 1.0)
        elif path[-1] in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, v.shape)
        else:
            a = rng.randn(*v.shape) * 0.1
        out[path] = a.astype(np.float32)
    return unflatten_dict(out)


def _pair(extra=(), seed=0, size=SIZE):
    jcfg, pcfg = _cfgs(extra)
    jm = jax_build_model(jcfg)
    variables = _random_variables(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), (size, size))), seed)
    pm = build_model(pcfg)
    pm.model.load_state_dict(state_dict_from_jax(variables))
    return jcfg, jm, variables, pcfg, pm


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.fixture(scope="module")
def jax_loss_grad(pair):
    """JAX's loss, its terms and its gradient as one jitted function of
    (params, batch), compiled once for the loss and SGD tests (their
    batches have the same shapes)."""
    _, jm, variables, _, _ = pair
    stats = variables["batch_stats"]
    return jax.jit(jax.value_and_grad(lambda p, b: jm.loss_fn(p, stats, b), has_aux=True))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _boxes(rng, n, lo=0.0, hi=SIZE, size=(4.0, 40.0)):
    xy = rng.uniform(lo, hi, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(*size, (n, 2))], -1).astype(np.float32)


def _proposal_file(path, dicts, seed, per_image=60, xywh=False, detectron1=False, skip=()):
    """A proposal pickle for ``dicts``: per image ``per_image`` boxes
    around its annotations and at random, with logits; XYWH with a
    ``bbox_mode`` of 1, or XYXY without one; Detectron1's ``indexes`` and
    ``scores`` names; the images of ``skip`` left out."""
    rng = np.random.RandomState(seed)
    ids, boxes, logits = [], [], []
    for d in dicts:
        if d["image_id"] in skip:
            continue
        h, w = d["height"], d["width"]
        gt = [np.asarray(a["bbox"], np.float32) for a in d.get("annotations", [])]
        near = [g + rng.uniform(-3, 3, 4) for g in gt for _ in range(4)]
        rand = _boxes(rng, per_image - len(near), 0, max(h, w) * 0.9, (3.0, max(h, w) * 0.5))
        b = np.concatenate([np.asarray(near, np.float32).reshape(-1, 4), rand]).astype(np.float32)
        if xywh:
            b[:, 2:] -= b[:, :2]
        ids.append(d["image_id"])
        boxes.append(b)
        logits.append(rng.randn(len(b)).astype(np.float32))
    data = {"indexes" if detectron1 else "ids": ids, "boxes": boxes,
            "scores" if detectron1 else "objectness_logits": logits}
    if xywh:
        data["bbox_mode"] = 1
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return data


def _dicts(name):
    ensure_synthetic_datasets([name])
    jax_ensure([name])
    return DatasetCatalog.get(name), JaxCatalog.get(name)


# -- proposal files and the mapper ------------------------------------------------------------


@pytest.mark.parametrize("xywh, detectron1", [(False, False), (True, False), (False, True), (True, True)])
def test_load_proposals_into_dataset_equals_jax(xywh, detectron1, tmp_path):
    """A file with Detectron1's key names or the reference's, XYWH (with a
    ``bbox_mode``) or XYXY (without one), that leaves out two images: every
    record carries JAX's ``proposal_boxes`` (XYXY, f32), logits and mode,
    the two left-out images carry none."""
    dicts, jdicts = _dicts(LEARNABLE)
    path = tmp_path / "proposals.pkl"
    _proposal_file(path, dicts, seed=1, xywh=xywh, detectron1=detectron1, skip=(3, 7))
    got = load_proposals_into_dataset(copy.deepcopy(dicts), str(path))
    want = jax_load_proposals(copy.deepcopy(jdicts), str(path))
    for g, w in zip(got, want):
        assert ("proposal_boxes" in g) == ("proposal_boxes" in w) == (g["image_id"] not in (3, 7))
        if "proposal_boxes" not in w:
            continue
        assert g["proposal_boxes"].dtype == np.float32
        np.testing.assert_array_equal(g["proposal_boxes"], np.asarray(w["proposal_boxes"], np.float32))
        np.testing.assert_array_equal(g["proposal_objectness_logits"], w["proposal_objectness_logits"])
        assert int(g["proposal_bbox_mode"]) == int(w["proposal_bbox_mode"]) == 0
    assert len(get_detection_dataset_dicts([LEARNABLE], False, [str(path)])) == len(dicts)
    with pytest.raises(ValueError, match="proposal files"):
        get_detection_dataset_dicts([LEARNABLE], False, [str(path), str(path)])


def _degenerate_first(d, out_of_image):
    """The dict's proposals with a top-scoring box that the warp and the
    clip make degenerate (beyond the image's right edge), so the slots must
    be backfilled from rank K + 1."""
    d = copy.deepcopy(d)
    boxes = np.asarray(d["proposal_boxes"], np.float32).copy()
    logits = np.asarray(d["proposal_objectness_logits"], np.float32).copy()
    boxes[0] = [out_of_image + 5, 10, out_of_image + 40, 30]
    logits[0] = logits.max() + 5
    d["proposal_boxes"], d["proposal_objectness_logits"] = boxes, logits
    return d


@pytest.mark.parametrize("is_train", [True, False])
def test_mapper_proposal_slots_equal_jax(is_train, tmp_path):
    """The same dicts and RandomStates through both mappers (train: the
    random warp; eval: the letterbox, the fast one too): the warp and the
    K proposal slots (boxes, logits, valid) equal JAX's, with a top-ranked
    box beyond the image in every other dict; at eval it is dropped and the
    slots backfilled; an image without proposals in the file has no valid
    slot."""
    dicts, _ = _dicts(LEARNABLE)
    path = tmp_path / "proposals.pkl"
    _proposal_file(path, dicts, seed=2, per_image=35, skip=(5,))
    dicts = load_proposals_into_dataset(copy.deepcopy(dicts), str(path))
    extra = ["INPUT.TRAIN_SIZE", (96, 96), "INPUT.TEST_SIZE", (96, 112)]
    jcfg, pcfg = _cfgs(extra)
    k = TOPK_TRAIN if is_train else TOPK_TEST
    backfilled = 0
    for fast in ((False,) if is_train else (False, True)):
        for c in (jcfg, pcfg):
            c.INPUT.FAST_LETTERBOX, c.TEST.EXACT_MODE = fast, not fast
        for i, d in enumerate(dicts[:8]):
            if "proposal_boxes" in d and i % 2 == 0:
                d = _degenerate_first(d, d["width"])
            rng = lambda: np.random.RandomState(i) if is_train else None
            want = JaxMapper(jcfg, is_train=is_train)(copy.deepcopy(d), rng=rng())
            got = DatasetMapper(pcfg, is_train=is_train)(copy.deepcopy(d), rng=rng())
            np.testing.assert_array_equal(got["warp"], want["warp"])
            for key in ("proposal_boxes", "proposal_objectness_logits", "proposal_valid"):
                assert got[key].shape[0] == k
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
            if "proposal_boxes" not in d:
                assert not got["proposal_valid"].any()
            elif i % 2 == 0 and not is_train:  # of 35 proposals the top one drops, the 31st fills slot 30
                assert got["proposal_valid"].all()
                backfilled += int(got["proposal_objectness_logits"][0] < d["proposal_objectness_logits"][0])
    assert backfilled >= 3 or is_train


# -- the loss, its gradients and inference ----------------------------------------------------


def _batch(seed, n=2, m=6, k=TOPK_TRAIN):
    rng = np.random.RandomState(seed)
    gt = np.stack([_boxes(rng, m, 0, 40, (8, 24)) for _ in range(n)])
    valid = np.ones((n, m), bool)
    valid[1, 4:] = False
    props = np.stack([np.concatenate([gt[i] + rng.uniform(-4, 4, (m, 4)), _boxes(rng, k - m, 0, 50, (4, 30))])
                      for i in range(n)]).astype(np.float32)
    pvalid = rng.uniform(size=(n, k)) > 0.15
    pvalid[1, -10:] = False
    return {"image": rng.uniform(0, 255, (n, SIZE, SIZE, 3)).astype(np.float32), "gt_boxes": gt,
            "gt_classes": rng.randint(0, 5, (n, m)).astype(np.int32), "gt_valid": valid,
            "proposal_boxes": props, "proposal_valid": pvalid}


def _roi_draws(key, n, slots):
    """The ROI sampler's uniforms JAX's loss draws from ``batch["rng"]``
    (split in three: RPN, ROI, point; the ROI key split by image, then in
    two)."""
    _, k_roi, _ = jax.random.split(key, 3)
    draws = []
    for k in jax.random.split(k_roi, n):
        k_sub, k_tie = jax.random.split(k)
        draws.append((np.asarray(jax.random.uniform(k_sub, (slots,))), np.asarray(jax.random.uniform(k_tie, (slots,)))))
    return {"roi_sub": torch.from_numpy(np.stack([d[0] for d in draws])),
            "roi_tie": torch.from_numpy(np.stack([d[1] for d in draws]))}


def test_loss_with_the_rpn_head_idle_and_every_gradient_match_jax(pair, jax_loss_grad):
    """The batch's 40 proposals per image (some invalid) with the gt
    appended, 64 rois sampled on JAX's draws: ``loss_cls`` and
    ``loss_box_reg`` within 1e-5 relative and no RPN loss, as in JAX; every
    parameter's gradient within 1e-4 of its own max |value|, the RPN head's
    0 on both sides (JAX runs it and gets 0; the port skips it, and its
    parameters keep their zero gradients)."""
    _, jm, variables, _, pm = pair
    batch, key = _batch(3), jax.random.PRNGKey(11)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch["rng"] = key
    (_, (jloss, _)), jgrads = jax_loss_grad(variables["params"], jbatch)
    pb = {k: torch.from_numpy(v) for k, v in batch.items()}
    pb["image"] = _nchw(batch["image"])
    pb["draws"] = _roi_draws(key, 2, max(TOPK_TRAIN + 6, 64))
    for p in pm.model.parameters():
        p.grad = torch.zeros_like(p)
    pm.model.train()
    total, losses = pm.loss_fn(pb)
    total.backward()
    assert set(losses) == set(jloss) == {"loss_cls", "loss_box_reg"}
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), float(jloss[k]), rtol=1e-5, err_msg=k)
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    grads = {k: p.grad for k, p in pm.model.named_parameters()}
    assert set(want) == set(grads)
    for k, g in grads.items():
        w = want[k].numpy()
        assert np.abs(g.numpy() - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-12), k
    rpn = [k for k in grads if k.startswith("proposal_generator.")]
    assert rpn and all(not grads[k].any() and not want[k].any() for k in rpn)
    assert grads["roi_heads.box_head.fc1.weight"].abs().max() > 0


def test_three_sgd_steps_move_the_idle_rpn_head_as_jax(pair, jax_loss_grad):
    """Three SGD steps (momentum, weight decay, warmup) of both packages on
    three batches and JAX's draws: every parameter within 1e-6 of its scale
    plus 1e-2 of BASE_LR times its largest gradient (the bound of
    ``tests/test_torch_dconv.py``'s steps), and the RPN head, whose
    gradient is 0 on both sides, moved by weight decay alone, as optax
    moves JAX's."""
    from detectron2_centernet_tpu.solver import build_optimizer as jax_build_optimizer
    from detectron2_centernet_tpu_torch.solver import build_optimizer

    jcfg, _, variables, pcfg, _ = pair
    extra = ["SOLVER.BASE_LR", 0.01, "SOLVER.WARMUP_ITERS", 2, "SOLVER.WEIGHT_DECAY", 0.01]
    jcfg, pcfg = jcfg.clone(), pcfg.clone()
    jcfg.merge_from_list(extra)
    pcfg.merge_from_list(extra)
    params = variables["params"]
    tx = jax_build_optimizer(jcfg, params)
    opt_state = jax.jit(tx.init)(params)

    @jax.jit
    def sgd(g, opt_state, params):
        updates, opt_state = tx.update(g, opt_state, params)
        return jax.tree_util.tree_map(lambda p, u: p + u, params, updates), opt_state

    batches = [(_batch(20 + i), jax.random.PRNGKey(30 + i)) for i in range(3)]
    gmax = {}
    for b, key in batches:
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        jb["rng"] = key
        _, g = jax_loss_grad(params, jb)
        for k, v in state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, g)}).items():
            gmax[k] = max(gmax.get(k, 0.0), float(v.abs().max()))
        params, opt_state = sgd(g, opt_state, params)
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, params)})
    start = state_dict_from_jax(variables)
    pm = build_model(pcfg)
    pm.model.load_state_dict(start)
    opt, sched = build_optimizer(pcfg, pm.model)
    for p in pm.model.parameters():  # as SimpleTrainer: every gradient exists and starts at 0
        p.grad = torch.zeros_like(p)
    pm.model.train()
    for b, key in batches:
        pb = {k: torch.from_numpy(v) for k, v in b.items()}
        pb["image"] = _nchw(b["image"])
        pb["draws"] = _roi_draws(key, 2, max(TOPK_TRAIN + 6, 64))
        total, _ = pm.loss_fn(pb)
        opt.zero_grad(set_to_none=False)
        total.backward()
        opt.step()
        sched.step()
    for k, p in pm.model.named_parameters():
        w = want[k].numpy()
        tol = 1e-6 * max(np.abs(w).max(), 1.0) + 1e-2 * 0.01 * gmax[k]
        assert np.abs(p.detach().numpy() - w).max() <= tol, k
        if k.startswith("proposal_generator."):
            assert gmax[k] == 0.0 and not torch.equal(p.detach(), start[k]), k


def test_predict_fn_on_the_batch_proposals_matches_jax(pair):
    """Two 64² images with 30 proposals each (some invalid): the 100
    detection slots equal JAX's (validity and classes exactly, scores within
    1e-4, boxes within 1e-2 px: ``tests/test_torch_rcnn.py``'s tolerances);
    without proposals both raise."""
    _, jm, variables, _, pm = pair
    batch = _batch(4, k=TOPK_TEST)
    x, props, valid = batch["image"], batch["proposal_boxes"], batch["proposal_valid"]
    want = jax.jit(jm.predict_fn)(variables, jnp.asarray(x), jnp.asarray(props), jnp.asarray(valid))
    pm.model.eval()
    got = pm.predict_fn(_nchw(x), torch.from_numpy(props), torch.from_numpy(valid))
    live = np.asarray(want["scores"]) > 0.05
    assert got["boxes"].shape == (2, 100, 4) and live.sum(1).min() >= 5
    np.testing.assert_array_equal(got["scores"].numpy() > 0.05, live)
    np.testing.assert_array_equal(got["classes"].numpy()[live], np.asarray(want["classes"])[live])
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), rtol=0, atol=1e-2)
    with pytest.raises(ValueError, match="proposal_boxes"):
        pm.predict_fn(_nchw(x))
    with pytest.raises(AssertionError):
        jm.predict_fn(variables, jnp.asarray(x))


def test_cascade_with_precomputed_proposals_matches_jax():
    """Cascade R-CNN on the batch's proposals: the three stages' losses on
    JAX's draws within 1e-5 relative, and the detections' scores within
    1e-4."""
    extra = ["MODEL.ROI_HEADS.NAME", "CascadeROIHeads", "MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG", True]
    _, jm, variables, _, pm = _pair(extra, seed=1)
    batch, key = _batch(5), jax.random.PRNGKey(12)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch["rng"] = key
    _, (jloss, _) = jax.jit(jm.loss_fn)(variables["params"], variables["batch_stats"], jbatch)
    pb = {k: torch.from_numpy(v) for k, v in batch.items()}
    pb["image"] = _nchw(batch["image"])
    pb["draws"] = _roi_draws(key, 2, max(TOPK_TRAIN + 6, 64))
    pm.model.train()
    with torch.no_grad():
        _, losses = pm.loss_fn(pb)
    assert set(losses) == set(jloss) and len(losses) == 6
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), float(jloss[k]), rtol=1e-5, err_msg=k)
    pm.model.eval()
    want = jax.jit(jm.predict_fn)(variables, jnp.asarray(batch["image"]), jnp.asarray(batch["proposal_boxes"]),
                                  jnp.asarray(batch["proposal_valid"]))
    got = pm.predict_fn(_nchw(batch["image"]), torch.from_numpy(batch["proposal_boxes"]),
                        torch.from_numpy(batch["proposal_valid"]))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), rtol=0, atol=1e-4)


# -- evaluation and the entry points ----------------------------------------------------------


def test_inference_on_dataset_with_proposal_files_matches_jax(tmp_path):
    """``DefaultTrainer.test`` on synth_learnable (24 images of 128², 3
    classes) with a proposal file for its 30 slots: every image's
    detections are JAX's, detection for detection (class, score within
    1e-5, box within 1e-2 px), and the COCO numbers are equal."""
    dicts, _ = _dicts(LEARNABLE)
    path = tmp_path / "val_proposals.pkl"
    _proposal_file(path, dicts, seed=3)
    extra = ["MODEL.ROI_HEADS.NUM_CLASSES", 3, "INPUT.TEST_SIZE", (128, 128), "INPUT.TRAIN_SIZE", (128, 128),
             "DATASETS.TEST", (LEARNABLE,), "DATASETS.PROPOSAL_FILES_TEST", (str(path),), "TEST.BATCH_SIZE", 12,
             "MODEL.ROI_HEADS.SCORE_THRESH_TEST", 0.2]
    jcfg, jm, variables, pcfg, pm = _pair(extra, seed=2, size=128)
    jm.variables = variables
    for cfg, sub in ((jcfg, "jax"), (pcfg, "port")):
        cfg.OUTPUT_DIR = str(tmp_path / sub)
    want = JaxTrainer.test(jcfg, jm)
    got = DefaultTrainer.test(pcfg, pm)
    dets = {sub: json.loads((tmp_path / sub / "coco_instances_results.json").read_text()) for sub in ("jax", "port")}
    assert len(dets["port"]) == len(dets["jax"]) > 24
    for image_id in {d["image_id"] for d in dets["jax"]}:
        ref = [d for d in dets["jax"] if d["image_id"] == image_id]
        for g in (d for d in dets["port"] if d["image_id"] == image_id):
            match = next((i for i, w in enumerate(ref) if w["category_id"] == g["category_id"]
                          and abs(w["score"] - g["score"]) <= 1e-5 * abs(w["score"]) + 1e-6
                          and np.abs(np.subtract(w["bbox"], g["bbox"])).max() <= 1e-2), None)
            assert match is not None, g
            ref.pop(match)
        assert not ref, ref
    assert got["bbox"] == pytest.approx(want["bbox"], abs=1e-9)


def test_train_net_trains_and_evaluates_fast_rcnn_from_proposal_files(tmp_path):
    """``fast_rcnn_R_50_FPN_1x.yaml`` cut in width and size, on the
    synthetic stand-ins with proposal files written by hand: ``train_net``
    takes 2 SGD steps (finite losses, no RPN loss), evaluates, and
    ``--eval-only --resume`` evaluates the final checkpoint to the same
    numbers; ``DefaultPredictor`` raises under ``LOAD_PROPOSALS``."""
    train, val = "test_torch_fast_rcnn_train", "test_torch_fast_rcnn_val"
    ensure_synthetic_datasets([train, val])
    files = []
    for name in (train, val):
        files.append(str(tmp_path / f"{name}.pkl"))
        _proposal_file(files[-1], DatasetCatalog.get(name), seed=len(files), per_image=50)
    args = ["--config-file", os.path.join(REPO, "configs", "COCO-Detection", "fast_rcnn_R_50_FPN_1x.yaml"),
            "MODEL.DEVICE", "cpu", "MODEL.WEIGHTS", "", "MODEL.RESNETS.DEPTH", 18,
            "MODEL.RESNETS.RES2_OUT_CHANNELS", 16, "MODEL.RESNETS.STEM_OUT_CHANNELS", 8, "MODEL.FPN.OUT_CHANNELS", 32,
            "MODEL.ROI_BOX_HEAD.FC_DIM", 64, "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 64,
            "DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN", TOPK_TRAIN, "DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST", TOPK_TEST,
            "INPUT.TRAIN_SIZE", (SIZE, SIZE), "INPUT.TEST_SIZE", (SIZE, SIZE), "SOLVER.BASE_LR", 0.002,
            "SOLVER.IMS_PER_BATCH", 2, "SOLVER.MAX_ITER", 2, "TEST.BATCH_SIZE", 2, "DATALOADER.NUM_WORKERS", 1,
            "DATASETS.TRAIN", (train,), "DATASETS.TEST", (val,), "DATASETS.PROPOSAL_FILES_TRAIN", (files[0],),
            "DATASETS.PROPOSAL_FILES_TEST", (files[1],), "OUTPUT_DIR", str(tmp_path / "out"), "TPU.DTYPE", "float32"]
    args = [str(a) for a in args]
    trained = train_net.main(train_net.default_argument_parser().parse_args(args))
    metrics = [json.loads(line) for line in (tmp_path / "out" / "metrics.json").read_text().splitlines()]
    losses = [m for m in metrics if "total_loss" in m]
    assert losses and losses[-1]["iteration"] == 1 and all(math.isfinite(m["total_loss"]) for m in losses)
    assert not any(k.startswith("loss_rpn") for m in losses for k in m)
    evaluated = train_net.main(train_net.default_argument_parser().parse_args(["--eval-only", "--resume"] + args))
    keys = ("AP", "AP50", "AP75")
    assert all(evaluated["bbox"][k] == trained["bbox"][k] and math.isfinite(trained["bbox"][k]) for k in keys)
    cfg = get_cfg()
    cfg.merge_from_list(SMALL + ["MODEL.DEVICE", "cpu"])
    with pytest.raises(ValueError, match="LOAD_PROPOSALS"):
        DefaultPredictor(cfg)


def test_bench_training_steps_fast_rcnn_on_a_proposal_file(tmp_path, monkeypatch):
    """``tools/bench``'s training part on ``fast_rcnn_R_50_FPN_1x.yaml`` cut
    in width and size: the trainer reads the train proposal file through
    the mapper's slots and takes its timed steps, with finite losses and no
    RPN loss (``chip_smoke.py`` phase 17c runs it at full width)."""
    from detectron2_centernet_tpu_torch.tools import bench

    for name, value in (("TRAIN_WARMUP", 1), ("TRAIN_STEPS", 1)):
        monkeypatch.setattr(bench, name, value)
    train = "test_torch_fast_rcnn_train"
    ensure_synthetic_datasets([train])
    path = str(tmp_path / "train.pkl")
    _proposal_file(path, DatasetCatalog.get(train), seed=3, per_image=50)
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "COCO-Detection", "fast_rcnn_R_50_FPN_1x.yaml"))
    cfg.merge_from_list([
        "MODEL.DEVICE", "cpu", "MODEL.WEIGHTS", "", "MODEL.RESNETS.DEPTH", 18, "MODEL.RESNETS.RES2_OUT_CHANNELS", 16,
        "MODEL.RESNETS.STEM_OUT_CHANNELS", 8, "MODEL.FPN.OUT_CHANNELS", 32, "MODEL.ROI_BOX_HEAD.FC_DIM", 64,
        "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 64, "DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN", TOPK_TRAIN,
        "INPUT.TRAIN_SIZE", (SIZE, SIZE), "INPUT.TEST_SIZE", (SIZE, SIZE), "SOLVER.IMS_PER_BATCH", 2,
        "DATALOADER.NUM_WORKERS", 1, "DATASETS.TRAIN", (train,), "DATASETS.PROPOSAL_FILES_TRAIN", (path,),
        "TPU.DTYPE", "float32", "SEED", 0])
    entries, trainer, clock = bench.bench_training(cfg)
    steps = bench.TRAIN_WARMUP + bench.TRAIN_STEPS + 1
    assert entries["train_batch"] == 2 and entries["train_step_ms"] > 0 and len(clock.times) == steps - 1
    assert entries["train_busy_share"] is None and entries["peak_memory_gib"] is None  # no card
    histories = trainer.storage.histories()
    assert {"loss_cls", "loss_box_reg", "total_loss"} <= set(histories)
    assert not any(k.startswith("loss_rpn") for k in histories)
    totals = [v for v, _ in trainer.storage.history("total_loss").values()]
    assert len(totals) == steps and all(math.isfinite(v) for v in totals)


def test_chip_smoke_reads_the_fast_rcnn_config_as_the_jax_package_does(tmp_path):
    """``chip_smoke.py``'s phase 17 reads ``fast_rcnn_R_50_FPN_1x.yaml`` with
    the port's reader, the proposal files and its batch over it: key for key
    the JAX package's config of the same file and overrides, at full width,
    the top 2000 / 1000 proposals."""
    import sys

    sys.path.insert(0, REPO)
    import chip_smoke

    extra = ("DATASETS.PROPOSAL_FILES_TRAIN", repr((str(tmp_path / "t.pkl"),)), "DATASETS.PROPOSAL_FILES_TEST",
             repr((str(tmp_path / "v.pkl"),)), "TEST.BATCH_SIZE", "16")
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        got = chip_smoke.rcnn_cfg(chip_smoke.FAST, "bfloat16", extra=extra)
    finally:
        os.chdir(cwd)
    want = jax_get_cfg()
    want.merge_from_file(os.path.join(REPO, "configs", "COCO-Detection", chip_smoke.FAST + ".yaml"))
    want.merge_from_list(list(extra) + ["TPU.DTYPE", "bfloat16", "OUTPUT_DIR", "output/chip_smoke", "SEED", 0,
                                        "MODEL.WEIGHTS", ""])
    assert json.dumps(got, sort_keys=True, default=str) == json.dumps(want, sort_keys=True, default=str)
    assert got.MODEL.LOAD_PROPOSALS and got.MODEL.PROPOSAL_GENERATOR.NAME == "PrecomputedProposals"
    assert (got.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN, got.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST) == (2000, 1000)
    assert got.DATASETS.PROPOSAL_FILES_TEST == (str(tmp_path / "v.pkl"),)
