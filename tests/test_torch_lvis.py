"""The port's LVIS slice against the JAX package on the CPU, inputs made from
a seed with numpy:

* ``load_lvis_json`` (``coco_url`` file names, ``neg_category_ids``,
  ``not_exhaustive_category_ids``, 1-indexed ids to 0-indexed, the
  frequency buckets) record for record and in its metadata;
* ``RepeatFactorTrainingSampler``: its repeat factors against a numpy
  recount, its first 2000 indices equal to JAX's for a seed, and the train
  loader's batches in that order (an unknown sampler name raises);
* ``LVISEvaluator`` (the federated rule, APr/APc/APf) equal to JAX's to
  1e-9 on the same predictions;
* the class-offset trick of ``batched_nms_fixed`` at 1203 classes on an
  ~1334 px frame (offsets to ~1.6e6, where f32 spacing is 0.125 px): the
  picks equal JAX's on boxes of 1-3 px;
* a narrow LVIS Mask R-CNN (ResNet-18 with RES2 16, FPN 32, FC_DIM 64, a
  mask head of 4 convs of 16 on 7² rois, 64² inputs) at LVIS's width where
  it counts:
  1203 classes, 300 detections an image, a score threshold of 1e-4, 20
  proposals an image (P·C = 24 060 candidates a row): ``predict_fn``'s
  boxes within 1e-4 of their value, classes equal, scores within 1e-5; the
  masks (the chosen class's sigmoid) within 2e-3 and pasted equal; the
  chosen-class mask logits equal to JAX's whole (R, 1203, 14, 14) tensor's
  rows within 1e-5 of their scale; one train step's loss terms within 1e-5
  relative and every gradient within 1e-4 of its own max |value|.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from detectron2_centernet_tpu.data import DatasetCatalog as JaxDatasetCatalog
from detectron2_centernet_tpu.data import MetadataCatalog as JaxMetadataCatalog
from detectron2_centernet_tpu.data.datasets import lvis as jax_lvis
from detectron2_centernet_tpu.data.samplers import RepeatFactorTrainingSampler as JaxRepeatFactorSampler
from detectron2_centernet_tpu.evaluation import LVISEvaluator as JaxLVISEvaluator
from detectron2_centernet_tpu.ops import nms as jax_nms
from detectron2_centernet_tpu.structures import Boxes as JaxBoxes
from detectron2_centernet_tpu.structures import Instances as JaxInstances
from detectron2_centernet_tpu_torch.checkpoint import state_dict_from_jax
from detectron2_centernet_tpu_torch.config import get_cfg
from detectron2_centernet_tpu_torch.data import (DatasetCatalog, MetadataCatalog, RepeatFactorTrainingSampler,
                                                 build_detection_train_loader)
from detectron2_centernet_tpu_torch.data.datasets import load_lvis_json, register_lvis_instances
from detectron2_centernet_tpu_torch.evaluation import LVISEvaluator
from detectron2_centernet_tpu_torch.ops import nms
from detectron2_centernet_tpu_torch.structures import Boxes, Instances

from test_torch_rcnn import SIZE, _anchor_count, _images, _jax_draws, _nchw, _pair, _port_batch

LVIS_CLASSES = 1203
# LVIS v1 Mask R-CNN's ROI_HEADS and TEST over test_torch_mask.py's narrow model (its mask head at 16
# channels on 7² rois: JAX computes all 1203 classes' masks, most of its work), 20 proposals an image
LVIS = ["MODEL.MASK_ON", True, "MODEL.ROI_MASK_HEAD.CONV_DIM", 16, "MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION", 7,
        "INPUT.MASK_RASTER", 16,
        "MODEL.ROI_HEADS.NUM_CLASSES", LVIS_CLASSES, "MODEL.ROI_HEADS.SCORE_THRESH_TEST", 1e-4,
        "TEST.DETECTIONS_PER_IMAGE", 300, "MODEL.RPN.POST_NMS_TOPK_TEST", 20]


def write_lvis(path, seed=0, images=6, cats=12):
    """An LVIS v1 json: category ids 1..cats with synonyms and r/c/f
    frequencies, images named by ``coco_url`` (one by ``file_name``), each
    with ``neg_category_ids`` and ``not_exhaustive_category_ids``, and
    annotations whose categories are skewed (rare ones on few images)."""
    rng = np.random.RandomState(seed)
    categories = [{"id": c, "name": f"cat_{c}", "synonyms": [f"syn_{c}", f"alt_{c}"],
                   "frequency": "rcf"[c % 3]} for c in range(1, cats + 1)]
    imgs, anns = [], []
    for i in range(images):
        img = {"id": 100 + 3 * i, "height": 48, "width": 64,
               "coco_url": f"http://images.cocodataset.org/{'train' if i % 2 else 'val'}2017/{100 + 3 * i:012d}.jpg",
               "neg_category_ids": sorted(rng.choice(np.arange(1, cats + 1), 2, replace=False).tolist()),
               "not_exhaustive_category_ids": [int(rng.randint(1, cats + 1))]}
        if i == 0:
            img["file_name"] = "own_name.jpg"
        imgs.append(img)
        for _ in range(rng.randint(1, 5)):
            c = int(min(rng.geometric(0.35), cats))
            anns.append({"id": len(anns) + 1, "image_id": img["id"], "category_id": c,
                         "bbox": rng.uniform(2, 30, 4).round(2).tolist(),
                         "segmentation": [rng.uniform(0, 40, 8).round(2).tolist()], "area": 10.0})
    with open(path, "w") as f:
        json.dump({"images": imgs, "annotations": anns, "categories": categories}, f)


def test_load_lvis_json_matches_jax(tmp_path):
    path = str(tmp_path / "lvis_v1_val.json")
    write_lvis(path)
    name = "test_torch_lvis_loader"
    for catalog in (DatasetCatalog, MetadataCatalog, JaxMetadataCatalog):
        if name in catalog:
            catalog.remove(name)
    register_lvis_instances(name, {}, path, str(tmp_path / "coco"))
    assert MetadataCatalog.get(name).evaluator_type == "lvis"
    got = DatasetCatalog.get(name)
    want = jax_lvis.load_lvis_json(path, str(tmp_path / "coco"), name)
    assert got == want
    assert got[0]["file_name"].endswith("own_name.jpg") and got[1]["file_name"].endswith("train2017/000000000103.jpg")
    assert min(a["category_id"] for r in got for a in r["annotations"]) == 0
    for k in ("thing_classes", "class_frequencies", "json_file", "image_root"):
        assert MetadataCatalog.get(name).get(k) == JaxMetadataCatalog.get(name).get(k), k
    assert MetadataCatalog.get(name).thing_classes[0] == "syn_1"


# -- RepeatFactorTrainingSampler ------------------------------------------------------------------


def _skewed_dicts(seed, n=60, cats=30):
    """Images with 0-4 instances of skewed categories (some images none)."""
    rng = np.random.RandomState(seed)
    return [{"image_id": i, "annotations": [{"category_id": int(min(rng.geometric(0.3), cats))}
                                            for _ in range(rng.randint(0, 5))]} for i in range(n)]


@pytest.mark.parametrize("seed, thresh", [(0, 0.3), (7, 0.05), (2026, 1.0)])
def test_repeat_factor_sampler_matches_jax(seed, thresh):
    """Per image max over its categories of max(1, sqrt(t / f)) (1 without
    any), as a numpy recount gives it; the first 2000 indices equal JAX's
    for the same seed."""
    dicts = _skewed_dicts(seed)
    got = RepeatFactorTrainingSampler(dicts, thresh, seed=seed)
    cats = [np.unique([a["category_id"] for a in d["annotations"]]) for d in dicts]
    freq = {c: np.mean([c in cs for cs in cats]) for c in np.unique(np.concatenate(cats))}
    recount = [max([max(1.0, np.sqrt(thresh / freq[c])) for c in cs], default=1.0) for cs in cats]
    np.testing.assert_allclose(got.repeat_factors, recount, rtol=1e-12)
    assert got.repeat_factors.max() > 1.0
    want = JaxRepeatFactorSampler(dicts, thresh, seed=seed)
    take = 2000
    assert list(zip(range(take), got)) == list(zip(range(take), want))


def test_train_loader_draws_from_the_repeat_factor_sampler(tmp_path):
    """``DATALOADER.SAMPLER_TRAIN RepeatFactorTrainingSampler``: the train
    loader's first batches hold the images of JAX's index stream for
    ``cfg.SEED``, in order; an unknown sampler name raises ``ValueError``."""
    path = str(tmp_path / "lvis.json")
    write_lvis(path, seed=1, images=8)
    dicts = load_lvis_json(path, str(tmp_path))
    images = {r["image_id"]: np.random.RandomState(r["image_id"]).randint(0, 256, (48, 64, 3)).astype(np.uint8)
              for r in dicts}
    name = "test_torch_lvis_train"
    if name not in DatasetCatalog:  # the records with their pixels (no image files)
        DatasetCatalog.register(name, lambda: [dict(r, image=images[r["image_id"]]) for r in dicts])
    cfg = get_cfg()
    cfg.merge_from_list(["MODEL.DEVICE", "cpu", "DATASETS.TRAIN", (name,), "INPUT.TRAIN_SIZE", (64, 64),
                         "SOLVER.IMS_PER_BATCH", 4, "DATALOADER.SAMPLER_TRAIN", "RepeatFactorTrainingSampler",
                         "DATALOADER.REPEAT_THRESHOLD", 0.3, "SEED", 5, "DATALOADER.NUM_WORKERS", 1])
    loader = build_detection_train_loader(cfg)
    try:
        ids = [i for _ in range(5) for i in next(loader)["image_id"]]
    finally:
        loader.close()
    order = [dicts[i]["image_id"] for _, i in zip(range(20), JaxRepeatFactorSampler(dicts, 0.3, seed=5))]
    assert ids == order and len(set(ids)) < len(ids)
    cfg.DATALOADER.SAMPLER_TRAIN = "NoSuchSampler"
    with pytest.raises(ValueError, match="NoSuchSampler"):
        build_detection_train_loader(cfg)


# -- LVISEvaluator ------------------------------------------------------------------------------


def _lvis_records(seed, n=8, cats=10):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        anns = []
        for _ in range(rng.randint(0, 4)):
            xy = rng.uniform(0, 60, 2)
            anns.append({"category_id": int(min(rng.geometric(0.3), cats) - 1), "bbox_mode": 1, "iscrowd": 0,
                         "bbox": [float(xy[0]), float(xy[1]), float(rng.uniform(8, 40)), float(rng.uniform(8, 40))]})
        out.append({"image_id": 10 + i, "height": 100, "width": 100, "annotations": anns,
                    "neg_category_ids": sorted(rng.choice(np.arange(1, cats + 1), 2, replace=False).tolist())})
    return out


def _predictions(records, seed, cats=10):
    """Near copies of the ground truth (some relabelled) and random boxes of
    random categories (allowed on the image or not)."""
    rng = np.random.RandomState(seed)
    out = []
    for r in records:
        boxes = [[a["bbox"][0], a["bbox"][1], a["bbox"][0] + a["bbox"][2], a["bbox"][1] + a["bbox"][3]]
                 for a in r["annotations"]]
        boxes = [list(np.asarray(b) + rng.uniform(-3, 3, 4)) for b in boxes]
        classes = [a["category_id"] if rng.rand() < 0.8 else int(rng.randint(cats)) for a in r["annotations"]]
        for _ in range(4):
            xy = rng.uniform(0, 60, 2)
            boxes.append([xy[0], xy[1], xy[0] + rng.uniform(8, 40), xy[1] + rng.uniform(8, 40)])
            classes.append(int(rng.randint(cats)))
        out.append((np.asarray(boxes, np.float32), rng.rand(len(boxes)).astype(np.float32), classes))
    return out


def _instances(cls, boxes, scores, classes):
    inst = cls((100, 100))
    inst.pred_boxes = (Boxes if cls is Instances else JaxBoxes)(boxes)
    inst.scores = scores
    inst.pred_classes = np.asarray(classes, np.int64)
    return inst


@pytest.mark.parametrize("seed", [0, 1])
def test_lvis_evaluator_matches_jax(seed):
    """Both evaluators on the same registered records and predictions:
    AP, AP50, AP75, APs, APm, APl, APr, APc and APf equal to 1e-9; the
    federated rule leaves out detections of categories neither annotated nor
    listed negative on their image (checked: the AP moves when the rule's
    sets are emptied)."""
    records = _lvis_records(seed)
    name = f"test_torch_lvis_eval_{seed}"
    for dc, mc in ((DatasetCatalog, MetadataCatalog), (JaxDatasetCatalog, JaxMetadataCatalog)):
        for catalog in (dc, mc):
            if name in catalog:
                catalog.remove(name)
        dc.register(name, lambda: records)
        mc.get(name).set(thing_classes=[f"c{i}" for i in range(10)], class_frequencies=list("rcfrcfrcfr"),
                         evaluator_type="lvis")
    got_ev, want_ev = LVISEvaluator(name), JaxLVISEvaluator(name)
    for r, (b, s, c) in zip(records, _predictions(records, seed)):
        got_ev.process([{"image_id": r["image_id"]}], [{"instances": _instances(Instances, b, s, c)}])
        want_ev.process([{"image_id": r["image_id"]}], [{"instances": _instances(JaxInstances, b, s, c)}])
    got, want = got_ev.evaluate()["bbox"], want_ev.evaluate()["bbox"]
    assert set(got) == set(want) == {"AP", "AP50", "AP75", "APs", "APm", "APl", "APr", "APc", "APf"}
    for k in got:
        assert got[k] == pytest.approx(want[k], abs=1e-9, nan_ok=True), k
    assert got["AP50"] > 5
    DatasetCatalog.remove(name)  # every category negative on every image: every detection counts
    DatasetCatalog.register(name, lambda: [dict(r, neg_category_ids=list(range(1, 11))) for r in records])
    assert got_ev.evaluate()["bbox"]["AP"] != got["AP"]


def test_lvis_federated_rule_as_in_jax():
    """JAX's own case: a detection of a category neither annotated nor
    negative on its image is left out (AP stays 100), one of a negative
    category counts."""
    records = [{"image_id": 1, "height": 100, "width": 100, "neg_category_ids": [2],
                "annotations": [{"category_id": 0, "bbox": [10, 10, 30, 30], "bbox_mode": 1, "iscrowd": 0}]}]
    name = "test_torch_lvis_federated"
    if name not in DatasetCatalog:
        DatasetCatalog.register(name, lambda: records)
        MetadataCatalog.get(name).set(thing_classes=["a", "b", "c"], class_frequencies=["r", "c", "f"])
    ev = LVISEvaluator(name)
    ev.process([{"image_id": 1}], [{"instances": _instances(
        Instances, np.array([[10, 10, 40, 40], [50, 50, 80, 80]], np.float32), np.array([0.9, 0.95], np.float32),
        [0, 2])}])
    res = ev.evaluate()["bbox"]
    assert res["AP"] == pytest.approx(100.0, abs=1e-6) and res["APr"] == pytest.approx(100.0, abs=1e-6)
    ev.reset()
    ev.process([{"image_id": 1}], [{"instances": _instances(
        Instances, np.array([[10, 10, 40, 40], [50, 50, 80, 80]], np.float32), np.array([0.9, 0.95], np.float32),
        [0, 1])}])
    assert ev.evaluate()["bbox"]["AP"] == pytest.approx(100.0, abs=1e-6)  # category 1 has no gt: not averaged


# -- the class-offset NMS at 1203 classes --------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_class_offsets_at_1203_classes_pick_as_jax(seed):
    """One image's 6000 candidates on an 800x1334 frame, classes up to 1202,
    many boxes of 1-3 px stacked near each other: offsets reach
    1202 · 1335 ≈ 1.6e6, where f32 spacing is 0.125 px, so the shifted
    boxes round; both packages round them the same way and pick the same
    300 indices with the same validity."""
    rng = np.random.RandomState(seed)
    n = 6000
    xy = np.concatenate([rng.uniform(0, 1330, (n // 2, 2)), rng.uniform(600, 603, (n // 2, 2))])
    boxes = np.concatenate([xy, xy + rng.uniform(1, 3, (n, 2))], 1).astype(np.float32)
    boxes[:, 1::2] *= 0.6
    scores = rng.uniform(1e-4, 1e-3, n).astype(np.float32)
    classes = rng.randint(0, LVIS_CLASSES, n)
    classes[n // 2:] = LVIS_CLASSES - 1 - rng.randint(0, 3, n // 2)  # the crowded boxes in the last classes
    keep, valid = nms.batched_nms_fixed(torch.from_numpy(boxes)[None], torch.from_numpy(scores)[None],
                                        torch.from_numpy(classes)[None], 0.5, 300)
    want_keep, want_valid = jax_nms.batched_nms_fixed(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes),
                                                      0.5, max_out=300)
    np.testing.assert_array_equal(keep[0].numpy(), np.asarray(want_keep))
    np.testing.assert_array_equal(valid[0].numpy(), np.asarray(want_valid))
    assert valid.all()


# -- the narrow LVIS Mask R-CNN -------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    return _pair(LVIS)


def _lvis_batch(seed, n=2, m=6):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 40, (n, m, 2))
    gt = np.concatenate([xy, xy + rng.uniform(8, 24, (n, m, 2))], -1).astype(np.float32)
    valid = np.ones((n, m), bool)
    valid[1, 4:] = False
    return {"image": _images(n, seed + 100), "gt_boxes": gt, "gt_valid": valid,
            "gt_classes": rng.randint(0, LVIS_CLASSES, (n, m)).astype(np.int32),
            "gt_masks": (rng.rand(n, m, 16, 16) > 0.4).astype(np.uint8)}


def test_lvis_predict_fn_matches_jax(pair):
    """A 64² image, 300 slots from a row of 20 · 1203 candidates,
    all above 1e-4 (the softmax of 1204 near-equal logits): the same
    classes, scores within 1e-5, boxes within 1e-4 of their value (measured
    8.5e-6, 3.4e-4 px: f32 rounding of the trunk through the RPN's and the
    box head's deltas, as in tests/test_torch_rcnn.py); the masks, pooled on
    those boxes, within test_torch_mask.py's 2e-3 (measured 4.8e-4); and
    JAX's 300 masks an image pasted by both host boundaries equal."""
    jm, variables, pm = pair
    x = _images(1, seed=8)
    want = {k: np.asarray(v) for k, v in jax.jit(jm.predict_fn)(variables, jnp.asarray(x)).items()}
    pm.model.eval()
    got = {k: v.numpy() for k, v in pm.predict_fn(_nchw(x)).items()}
    assert got["boxes"].shape == (1, 300, 4) and got["masks"].shape == (1, 300, 14, 14)
    assert (want["scores"] > 1e-4).all()
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["masks"], want["masks"], rtol=0, atol=2e-3)
    # JAX's 300 masks an image through both host boundaries, on random boxes (the random model's
    # lie flat on the border), as tests/test_torch_mask.py pastes them
    xy = np.random.RandomState(8).uniform(-8, 60, (1, 300, 2))
    want["boxes"] = np.concatenate([xy, xy + np.random.RandomState(9).uniform(0.5, 40, (1, 300, 2))], -1)
    warps, sizes = [np.eye(2, 3, dtype=np.float32)], [(SIZE, SIZE)]
    for g, w in zip(pm.postprocess(want, warps, sizes), jm.postprocess(want, warps, sizes)):
        assert len(g["instances"]) == len(w["instances"]) > 250  # boxes left wholly outside drop
        np.testing.assert_array_equal(g["instances"].pred_masks, w["instances"].pred_masks)
        assert g["instances"].pred_masks.any()


def test_chosen_class_mask_logits_equal_jax_whole_tensor(pair):
    """The port computes only each roi's class's mask logits; JAX computes
    all 1203 and gathers. On the same 40 pooled rois (the port's pool of
    random boxes, fed to both heads), the chosen rows equal JAX's whole
    (40, 14, 14, 1203) tensor's within 1e-5 of their scale, and the port's
    own whole tensor's too."""
    jm, variables, pm = pair
    rng = np.random.RandomState(3)
    xy = rng.uniform(0, 40, (40, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 24, (40, 2))], 1).astype(np.float32)
    cls = torch.from_numpy(rng.randint(0, LVIS_CLASSES, 40))
    with torch.no_grad():
        feats = pm.model(pm.normalize(_nchw(_images(1, seed=3))))[0]
        pooled = pm.pool(feats, torch.from_numpy(boxes), 40, pm.mask_pooler_resolution)
        got = pm.model.mask_predict(pooled, cls)
        own = pm.model.mask_predict(pooled)[torch.arange(40), cls]
    net = type(jm.module)
    whole = np.asarray(jm.module.apply(variables, jnp.asarray(pooled.numpy().transpose(0, 2, 3, 1)), False,
                                       method=net.mask_predict))
    assert whole.shape == (40, 14, 14, LVIS_CLASSES)
    want = whole[np.arange(40), :, :, cls.numpy()]
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got.numpy(), own.numpy(), rtol=0, atol=1e-5 * scale)


def test_lvis_loss_and_every_gradient_match_jax(pair):
    """One train step on JAX's draws with gt classes among the 1203: the
    five losses within 1e-5 relative, every parameter's gradient within 1e-4
    of its own max |value|; the mask predictor's gradient reaches only the
    rows of the foreground rois' classes, as JAX's."""
    jm, variables, pm = pair
    batch, key = _lvis_batch(1), jax.random.PRNGKey(5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch["rng"] = key
    stats = variables["batch_stats"]
    (_, (jloss, _)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, stats, jbatch), has_aux=True))(variables["params"])
    pb = _port_batch(batch, _jax_draws(key, 2, _anchor_count(pm), max(100 + 6, 64)))
    pb["gt_masks"] = torch.from_numpy(batch["gt_masks"])
    for p in pm.model.parameters():
        p.grad = torch.zeros_like(p)
    pm.model.train()
    total, losses = pm.loss_fn(pb)
    total.backward()
    pm.model.eval()
    assert set(losses) == set(jloss) == {"loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "loss_mask"}
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), float(jloss[k]), rtol=1e-5, err_msg=k)
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    grads = {k: p.grad for k, p in pm.model.named_parameters()}
    assert set(want) == set(grads)
    for k, g in grads.items():
        w = want[k].numpy()
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max(), k
    rows = grads["roi_heads.mask_head.predictor.weight"].flatten(1).abs().sum(1) > 0
    assert 0 < int(rows.sum()) <= 12
    np.testing.assert_array_equal(rows.numpy(), np.abs(want["roi_heads.mask_head.predictor.weight"].numpy())
                                  .reshape(LVIS_CLASSES, -1).sum(1) > 0)
