"""The port's Semantic FPN against the JAX package on the CPU, at a small
size (ResNet-18 with RES2 16 and a stem of 8, FPN 32, a sem-seg head of 16,
7 classes, 64² inputs, f32): the bilinear resizes, ``SemSegFPNHead`` on
crossed weights, ``sem_seg_loss`` (ignore label, top-k) and its gradient,
``SemanticSegmentor``'s loss, every gradient and one SGD step, its
``predict_fn`` and the postprocessed label maps, ``SemSegEvaluator``, the
synthetic sem-seg scenes, the mapper's ``sem_seg``, the evaluators
``train_net`` builds, and the entry points.

One random variables tree, made with numpy from a seed, goes to both: as it
is to the JAX model, through ``state_dict_from_jax`` to the port.
Tolerances: 1e-5 of the output's scale for the head and the logits, 1e-5
relative for the losses, 1e-4 of each gradient's own max for the
gradients, 1e-9 for the evaluator's numbers, exact for the scenes and the
mapper's labels (cv2's fixed-point nearest warp, ROADMAP C2).
"""

import copy
import json
import math
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import cv2
import jax
import jax.numpy as jnp

from detectron2_centernet_tpu.config import get_cfg as jax_get_cfg
from detectron2_centernet_tpu.data import DatasetCatalog as JaxDatasetCatalog
from detectron2_centernet_tpu.data import MetadataCatalog as JaxMetadataCatalog
from detectron2_centernet_tpu.data.dataset_mapper import DatasetMapper as JaxMapper
from detectron2_centernet_tpu.data.datasets import synthetic as jax_synthetic
from detectron2_centernet_tpu.evaluation.sem_seg_evaluation import SemSegEvaluator as JaxSemSegEvaluator
from detectron2_centernet_tpu.models.build import build_model as jax_build_model
from detectron2_centernet_tpu.models.meta_arch import semantic_seg as jax_semseg
from detectron2_centernet_tpu.solver import build_optimizer as jax_build_optimizer
from detectron2_centernet_tpu_torch.checkpoint import state_dict_from_jax
from detectron2_centernet_tpu_torch.config import get_cfg
from detectron2_centernet_tpu_torch.data import DatasetCatalog, DatasetMapper, MetadataCatalog, letterbox_transform
from detectron2_centernet_tpu_torch.data import warp_image
from detectron2_centernet_tpu_torch.data.datasets import ensure_synthetic_datasets, synthetic
from detectron2_centernet_tpu_torch.engine import DefaultPredictor
from detectron2_centernet_tpu_torch.evaluation import DatasetEvaluators, SemSegEvaluator
from detectron2_centernet_tpu_torch.models import build_model
from detectron2_centernet_tpu_torch.models.meta_arch import semantic_seg
from detectron2_centernet_tpu_torch.solver import build_optimizer
from detectron2_centernet_tpu_torch.tools import bench, train_acc, train_net

from test_torch_rcnn import SIZE, SMALL, _close, _images, _nchw, _random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEM = ["MODEL.META_ARCHITECTURE", "SemanticSegmentor", "MODEL.SEM_SEG_HEAD.CONVS_DIM", 16,
       "MODEL.SEM_SEG_HEAD.NUM_CLASSES", 7, "MODEL.SEM_SEG_HEAD.IN_FEATURES", ["p2", "p3", "p4", "p5"]]


def _cfgs(extra=()):
    jcfg, pcfg = jax_get_cfg(), get_cfg()
    jcfg.merge_from_list(SMALL + SEM + list(extra))
    pcfg.merge_from_list(SMALL + SEM + list(extra) + ["MODEL.DEVICE", "cpu"])
    return jcfg, pcfg


def _pair(extra=(), seed=0):
    """(JAX SemanticSegmentor, its random variables, the port's with them)."""
    jcfg, pcfg = _cfgs(extra)
    jm = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), (SIZE, SIZE)))
    variables = _random_variables(shapes, seed)
    pm = build_model(pcfg)
    pm.model.load_state_dict(state_dict_from_jax(variables))
    return jm, variables, pm


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _labels(seed, n=2, classes=7, ignore_share=0.2, size=SIZE):
    rng = np.random.RandomState(seed)
    lab = rng.randint(0, classes, (n, size, size)).astype(np.int32)
    lab[rng.rand(n, size, size) < ignore_share] = 255
    return lab


# -- the resizes and the head ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale", [2, 4])
@pytest.mark.parametrize("hw", [(5, 7), (16, 16)])
def test_bilinear_upsample_equals_jax_image_resize(scale, hw):
    """``F.interpolate(mode="bilinear", align_corners=False)`` by an integer
    factor equals ``jax.image.resize(method="bilinear")``, the border rows
    and columns included, within 1e-6 of the map's scale."""
    x = np.random.RandomState(scale + hw[0]).randn(2, *hw, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, hw[0] * scale, hw[1] * scale, 3), method="bilinear"))
    got = F.interpolate(_nchw(x), scale_factor=scale, mode="bilinear", align_corners=False)
    got = got.numpy().transpose(0, 2, 3, 1)
    _close(got, want, 1e-6, "resize")
    _close(got[:, [0, -1]], want[:, [0, -1]], 1e-6, "border rows")


def test_sem_seg_fpn_head_on_crossed_weights_matches_jax():
    """The head alone on random p2-p5 maps (32 channels, 16² at p2), random
    weights crossed from JAX (the towers' GroupNorm of min(32, 16) groups):
    logits (N, 7, 64, 64) within 1e-5 of their scale."""
    rng = np.random.RandomState(3)
    feats = {f"p{i}": rng.randn(2, 16 >> (i - 2), 16 >> (i - 2), 32).astype(np.float32) for i in range(2, 6)}
    jhead = jax_semseg.SemSegFPNHead(in_features=("p2", "p3", "p4", "p5"), strides=(4, 8, 16, 32), num_classes=7,
                                     convs_dim=16, common_stride=4)
    shapes = jax.eval_shape(lambda: jhead.init(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in feats.items()}))
    variables = _random_variables(shapes, 4)
    want = np.asarray(jhead.apply(variables, {k: jnp.asarray(v) for k, v in feats.items()})).transpose(0, 3, 1, 2)
    head = semantic_seg.SemSegFPNHead(("p2", "p3", "p4", "p5"), 32, 7, 16, 4)
    state = state_dict_from_jax({"params": {"sem_seg_head": variables["params"]}})
    head.load_state_dict({k.removeprefix("sem_seg_head."): v for k, v in state.items()})
    assert head.p5[1].__class__.__name__ == "Upsample" and len(head.p5) == 6 and len(head.p2) == 1
    with torch.no_grad():
        got = head({k: _nchw(v) for k, v in feats.items()}).numpy()
    assert got.shape == want.shape == (2, 7, 64, 64)
    _close(got, want, 1e-5, "logits")


@pytest.mark.parametrize("top_k", [1.0, 0.2])
def test_sem_seg_loss_and_its_gradient_match_jax(top_k):
    """Cross-entropy over (N, H, W) labels with a fifth ignored (255): the
    mean over the kept pixels, or DeepLab's top 20% of the per-pixel
    losses; the value within 1e-6 relative, the logits' gradient within
    1e-6 of its max."""
    logits = np.random.RandomState(5).randn(2, 24, 20, 7).astype(np.float32) * 3
    targets = _labels(6, size=24)[:, :, :20]
    loss_fn = lambda lg: jax_semseg.sem_seg_loss(lg, jnp.asarray(targets), 255, top_k)
    want, want_grad = jax.value_and_grad(loss_fn)(jnp.asarray(logits))
    x = _nchw(logits).requires_grad_(True)
    got = semantic_seg.sem_seg_loss(x, torch.from_numpy(targets).long(), 255, top_k)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    _close(x.grad.numpy().transpose(0, 2, 3, 1), want_grad, 1e-6, "d logits")
    # every pixel ignored: 0, as JAX's
    none = semantic_seg.sem_seg_loss(x, torch.full(targets.shape, 255), 255)
    assert none.item() == 0.0 == float(jax_semseg.sem_seg_loss(jnp.asarray(logits), jnp.full(targets.shape, 255)))


# -- the meta-architecture ------------------------------------------------------------------------------


def _sem_batch(seed):
    return {"image": _images(2, seed), "sem_seg": _labels(seed + 1)}


def test_loss_every_gradient_and_one_sgd_step_match_jax():
    """``loss_sem_seg`` (× LOSS_WEIGHT 0.5) within 1e-5 relative, every
    parameter's gradient within 1e-4 of its own max |value| (FrozenBN: the
    stem and res2 get 0 on both sides), and one SGD step of the config's
    optimizer (LR 0.01, momentum 0.9, weight decay 1e-4, none on norms):
    every parameter's move within 1e-4 of its scale of JAX's (and two f32
    steps of the parameter: the moves are differences of stored values), but the
    sem-seg head's GroupNorm biases, which the port decays as norm
    parameters (0) and JAX as biases (its labels go by name, and
    ``p{l}_gn{k}/bias`` is no norm's there; ROADMAP C24): their moves
    differ by JAX's decay term, LR · 1e-4 · the bias, and by nothing else."""
    extra = ["MODEL.SEM_SEG_HEAD.LOSS_WEIGHT", 0.5, "SOLVER.BASE_LR", 0.01, "SOLVER.WARMUP_ITERS", 0]
    jm, variables, pm = _pair(extra, seed=1)
    jcfg, pcfg = _cfgs(extra)
    batch = _sem_batch(2)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params, stats = variables["params"], variables["batch_stats"]
    (_, (jloss, _)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, stats, jbatch), has_aux=True))(params)
    opt, _ = build_optimizer(pcfg, pm.model)
    for p in pm.model.parameters():
        p.grad = torch.zeros_like(p)
    pm.model.train()
    total, losses = pm.loss_fn({"image": _nchw(batch["image"]), "sem_seg": torch.from_numpy(batch["sem_seg"])})
    total.backward()
    pm.model.eval()
    assert set(losses) == set(jloss) == {"loss_sem_seg"}
    np.testing.assert_allclose(losses["loss_sem_seg"].item(), float(jloss["loss_sem_seg"]), rtol=1e-5)
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    grads = {k: p.grad for k, p in pm.model.named_parameters()}
    assert set(want) == set(grads)
    for k, g in grads.items():
        w = want[k].numpy()
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max(), k
    assert not grads["backbone.bottom_up.stem.conv1.weight"].any()
    assert grads["sem_seg_head.p5.4.weight"].abs().max() > 0

    tx = jax_build_optimizer(jcfg, params)
    updates, _ = tx.update(jgrads, tx.init(params), params)
    jax_moves = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, updates)})
    before = {k: p.detach().clone() for k, p in pm.model.named_parameters()}
    opt.step()
    gn_biases = 0
    for k, p in pm.model.named_parameters():
        move, w = (p.detach() - before[k]).numpy(), jax_moves[k].numpy()
        if k.startswith("sem_seg_head.") and k.endswith(".norm.bias"):
            w = w + 0.01 * 1e-4 * before[k].numpy()  # JAX's decay of a bias, which the port does not apply
            gn_biases += 1
        # beside 1e-4 of the move, two f32 steps of the parameter itself: the moves are differences of stored values
        assert np.abs(move - w).max() <= 1e-4 * np.abs(w).max() + 2 * np.spacing(np.float32(before[k].abs().max())), k
    assert gn_biases == 7  # p2 one, p3 one, p4 two, p5 three


def test_predict_fn_logits_match_jax(pair):
    """``predict_fn`` on two 64² images: (N, 7, 64, 64) f32 logits within
    1e-5 of their scale of JAX's (N, 64, 64, 7)."""
    jm, variables, pm = pair
    x = _images(2, seed=8)
    want = np.asarray(jax.jit(jm.predict_fn)(variables, jnp.asarray(x))["sem_seg"]).transpose(0, 3, 1, 2)
    got = pm.predict_fn(_nchw(x))["sem_seg"]
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2, 7, SIZE, SIZE)
    _close(got.numpy(), want, 1e-5, "sem_seg logits")


def _top2_gap(lg):
    top = np.sort(lg, axis=-1)
    return top[..., -1] - top[..., -2]


def test_postprocessed_label_maps_agree_with_jax_where_the_logits_do_not_tie(pair):
    """JAX's logits of two images through both host boundaries, with the
    identity warp and a letterbox from 80x96 (JAX: cv2's fixed-point
    bilinear warp, the port: ``warp_image`` on the device, then the
    argmax): every pixel whose top-2 logit gap in JAX's warped logits
    exceeds twice the largest difference of the two warps' logits gets the
    same label; the others (near ties) are counted: 661 of the 11 776
    pixels here (5.6%), all in the letterboxed image, bounded at 10%."""
    jm, variables, pm = pair
    x = _images(2, seed=9)
    dets = {"sem_seg": np.asarray(jax.jit(jm.predict_fn)(variables, jnp.asarray(x))["sem_seg"])}
    warps = [np.eye(2, 3, dtype=np.float32), letterbox_transform(80, 96, (SIZE, SIZE)).astype(np.float32)]
    sizes = [(64, 64), (80, 96)]
    want = jm.postprocess(dets, warps, sizes)
    nchw = {"sem_seg": torch.from_numpy(np.ascontiguousarray(dets["sem_seg"].transpose(0, 3, 1, 2)))}
    labels = pm.device_postprocess(nchw, warps, sizes)
    assert labels["sem_seg"].dtype == torch.uint8 and tuple(labels["sem_seg"].shape) == (2, 80, 96)
    got = pm.postprocess({"sem_seg": labels["sem_seg"].numpy()}, warps, sizes)
    undecided = 0
    for i, (h, w) in enumerate(sizes):
        g, wnt = got[i]["sem_seg"], want[i]["sem_seg"]
        assert g.shape == wnt.shape == (h, w) and g.dtype == np.int64
        minv = cv2.invertAffineTransform(np.asarray(warps[i], np.float64))
        cv_logits = cv2.warpAffine(dets["sem_seg"][i], minv, (w, h), flags=cv2.INTER_LINEAR)
        port_logits = warp_image(nchw["sem_seg"][i].permute(1, 2, 0),
                                 np.linalg.inv(np.vstack([warps[i], [0, 0, 1]]))[:2], (h, w)).numpy()
        diff = np.abs(cv_logits - port_logits).max()
        decided = _top2_gap(cv_logits) > 2 * diff
        np.testing.assert_array_equal(g[decided], wnt[decided])
        undecided += int((~decided).sum())
        if i == 0:
            assert diff < 1e-5 and decided.all()  # the identity warp: no interpolation at all
    assert undecided < 0.1 * sum(h * w for h, w in sizes)


def test_label_maps_of_a_warp_that_is_not_axis_aligned_raise():
    """The test-time warps are letterboxes: ``sem_seg_labels`` un-warps
    axis-aligned warps only and raises on a rotation."""
    logits = torch.from_numpy(np.random.RandomState(3).randn(1, 7, 16, 16).astype(np.float32))
    c, s = math.cos(0.3), math.sin(0.3)
    with pytest.raises(ValueError, match="axis-aligned"):
        semantic_seg.sem_seg_labels(logits, [np.array([[c, -s, 2.0], [s, c, 1.0]], np.float32)], [(16, 16)])


def test_default_predictor_returns_the_label_map():
    """``DefaultPredictor`` on a 50x70 BGR image at a 64² test size: {"sem_seg":
    (50, 70) int64} with labels of the 7 classes."""
    _, pcfg = _cfgs()
    out = DefaultPredictor(pcfg)(np.random.RandomState(0).randint(0, 256, (50, 70, 3)).astype(np.uint8))
    assert set(out) == {"sem_seg"} and out["sem_seg"].shape == (50, 70) and out["sem_seg"].dtype == np.int64
    assert 0 <= out["sem_seg"].min() and out["sem_seg"].max() < 7


# -- evaluation and data ---------------------------------------------------------------------------------


def _register_both(name, dicts, stuff):
    for cat, meta in ((DatasetCatalog, MetadataCatalog), (JaxDatasetCatalog, JaxMetadataCatalog)):
        if name not in cat:
            cat.register(name, lambda d=dicts: d)
            meta.get(name).set(stuff_classes=stuff, ignore_label=255, evaluator_type="sem_seg")


@pytest.mark.parametrize("source", ["arrays", "png"])
def test_sem_seg_evaluator_equals_jax(source, tmp_path):
    """Five images of 5 classes with an ignored band, predictions partly
    right: mIoU, fwIoU, mACC and pACC within 1e-9 of JAX's, the ground truth
    from the records' arrays or from PNG files; a class never in the ground
    truth is NaN on both sides (``nanmean`` skips it)."""
    from PIL import Image

    rng = np.random.RandomState(11)
    dicts, outputs = [], []
    for i in range(5):
        gt = rng.randint(0, 4, (20, 30)).astype(np.uint8)  # class 4 never in the ground truth
        gt[:3] = 255
        d = {"image_id": i, "height": 20, "width": 30}
        if source == "png":
            d["sem_seg_file_name"] = str(tmp_path / f"{i}.png")
            Image.fromarray(gt).save(d["sem_seg_file_name"])
        else:
            d["sem_seg"] = gt
        dicts.append(d)
        pred = np.where(rng.rand(20, 30) < 0.6, np.minimum(gt, 4), rng.randint(0, 5, (20, 30)))
        outputs.append({"sem_seg": pred.astype(np.int64)})
    name = f"test_torch_semseg_eval_{source}"
    _register_both(name, dicts, [f"c{k}" for k in range(5)])
    results = []
    for evaluator in (SemSegEvaluator(name), JaxSemSegEvaluator(name)):
        evaluator.reset()
        for d, o in zip(dicts, outputs):
            evaluator.process([{"image_id": d["image_id"]}], [o])
        results.append(evaluator.evaluate()["sem_seg"])
    got, want = results
    assert set(got) == set(want) == {"mIoU", "fwIoU", "mACC", "pACC"}
    for k in got:
        assert math.isfinite(got[k]) and abs(got[k] - want[k]) <= 1e-9, k


def test_synthetic_sem_seg_scenes_equal_jax():
    """The learnable sem-seg scenes (``synth_learnable_semseg``), a
    ``stuffonly`` stand-in's labels and a ``panoptic_separated`` one's
    segment ids and ``segments_info`` against the JAX package's from the
    same draws (the JAX stand-ins seed with ``hash(name)``, ROADMAP C7:
    JAX's ``_scene`` is drawn here on the port's seed), with their
    metadata."""
    ensure_synthetic_datasets(["synth_learnable_semseg"])
    jax_synthetic.register_learnable_instances("test_torch_semseg_jax_learnable", sem_seg=True)
    got, want = DatasetCatalog.get("synth_learnable_semseg"), JaxDatasetCatalog.get("test_torch_semseg_jax_learnable")
    assert len(got) == len(want) == 24
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["sem_seg"], w["sem_seg"])
        assert g["sem_seg"].dtype == np.uint8 and set(np.unique(g["sem_seg"])) <= {0, 1, 2, 3}
    meta = MetadataCatalog.get("synth_learnable_semseg")
    assert meta.evaluator_type == "sem_seg" and meta.stuff_classes == ["background", "color_0", "color_1", "color_2"]
    assert meta.ignore_label == 255

    ensure_synthetic_datasets(["coco_2017_val_panoptic_stuffonly"])
    stuff = DatasetCatalog.get("coco_2017_val_panoptic_stuffonly")
    rng = np.random.RandomState(synthetic.zlib.crc32(b"coco_2017_val_panoptic_stuffonly") % (2 ** 31))
    for d in stuff:
        _, annos = jax_synthetic._scene(rng, 96, 128, 4)
        want = np.zeros((96, 128), np.uint8)
        for j, a in enumerate(annos):
            x0, y0, bw, bh = (int(v) for v in a["bbox"])
            want[y0:y0 + bh, x0:x0 + bw] = j % 53 + 1
        np.testing.assert_array_equal(d["sem_seg"], want)
        assert "pan_seg" not in d
    meta = MetadataCatalog.get("coco_2017_val_panoptic_stuffonly")
    assert meta.evaluator_type == "sem_seg" and len(meta.stuff_classes) == 54

    name = "coco_2017_val_panoptic_separated"
    ensure_synthetic_datasets([name])
    rng = np.random.RandomState(synthetic.zlib.crc32(name.encode()) % (2 ** 31))
    for d in DatasetCatalog.get(name):
        _, annos = jax_synthetic._scene(rng, 96, 128, 4)
        pan = np.zeros((96, 128), np.int32)
        for j, a in enumerate(annos):
            x0, y0, bw, bh = (int(v) for v in a["bbox"])
            pan[y0:y0 + bh, x0:x0 + bw] = j + 1
        np.testing.assert_array_equal(d["pan_seg"], pan)
        assert d["segments_info"] == [{"id": j + 1, "category_id": a["category_id"], "isthing": True, "iscrowd": 0}
                                      for j, a in enumerate(annos)]
        assert d["sem_seg"].shape == (96, 128) and d["annotations"] == annos
    meta = MetadataCatalog.get(name)
    assert meta.evaluator_type == "coco_panoptic_seg" and len(meta.stuff_classes) == 54 and meta.ignore_label == 255


def test_train_mapper_sem_seg_equals_jax_with_rotation_crop_and_extent(tmp_path):
    """The train mapper's ``sem_seg`` of learnable scenes through the
    rotation with the crop (its category constraint read from a PNG this
    test writes), and through the extent, on one ``RandomState`` each:
    the matrix and the int32 labels (255 off the source) equal JAX's cv2
    ``INTER_NEAREST`` warp pixel for pixel."""
    from PIL import Image

    ensure_synthetic_datasets(["synth_learnable_semseg"])
    dicts = copy.deepcopy(DatasetCatalog.get("synth_learnable_semseg")[:4])
    for i, d in enumerate(dicts):
        d["sem_seg_file_name"] = str(tmp_path / f"{i}.png")
        Image.fromarray(d.pop("sem_seg")).save(d["sem_seg_file_name"])
    common = ["INPUT.TRAIN_SIZE", (96, 80), "INPUT.COLOR_JITTER", False, "DATASETS.TRAIN", ()]
    for extra in (["INPUT.ROTATION.ENABLED", True, "INPUT.ROTATION.ANGLE", [-30.0, 30.0],
                   "INPUT.CROP.ENABLED", True, "INPUT.CROP.TYPE", "absolute", "INPUT.CROP.SIZE", [64, 64],
                   "INPUT.CROP.SINGLE_CATEGORY_MAX_AREA", 0.5],
                  ["INPUT.CROP.ENABLED", True, "INPUT.CROP.TYPE", "relative_range", "INPUT.CROP.SIZE", [0.5, 0.7],
                   "INPUT.CROP.SINGLE_CATEGORY_MAX_AREA", 0.5],
                  ["INPUT.EXTENT.ENABLED", True, "INPUT.EXTENT.SCALE_RANGE", (0.6, 1.5),
                   "INPUT.EXTENT.SHIFT_RANGE", (0.4, 0.4)]):
        jcfg, pcfg = jax_get_cfg(), get_cfg()
        jcfg.merge_from_list(common + extra)
        pcfg.merge_from_list(common + extra + ["MODEL.DEVICE", "cpu"])
        jmap, pmap = JaxMapper(jcfg, is_train=True), DatasetMapper(pcfg, is_train=True)
        for seed in range(6):
            d = dicts[seed % 4]
            want = jmap(copy.deepcopy(d), rng=np.random.RandomState(seed))
            got = pmap(copy.deepcopy(d), rng=np.random.RandomState(seed))
            np.testing.assert_array_equal(got["warp"], want["warp"])
            assert got["sem_seg"].dtype == np.int32 and got["sem_seg"].shape == (96, 80)
            np.testing.assert_array_equal(got["sem_seg"], want["sem_seg"])


def test_warp_labels_nearest_equals_cv2_on_random_affines():
    """``warp_labels_nearest`` against ``cv2.warpAffine(INTER_NEAREST,
    borderValue=255)`` on 40 random affines (rotation, scale, shear,
    mirror, shift): equal pixel for pixel, where rounding the exact source
    position would move labels on the regions' borders."""
    from detectron2_centernet_tpu_torch.data.detection_utils import warp_labels_nearest

    rng = np.random.RandomState(12)
    naive_moved = 0
    for _ in range(40):
        h, w = rng.randint(20, 90, 2)
        labels = rng.randint(0, 40, (h, w)).astype(np.float64)
        m = np.array([[rng.uniform(-2, 2), rng.uniform(-1, 1), rng.uniform(-30, 30)],
                      [rng.uniform(-1, 1), rng.uniform(-2, 2), rng.uniform(-30, 30)]])
        oh, ow = rng.randint(20, 90, 2)
        want = cv2.warpAffine(labels, m, (int(ow), int(oh)), flags=cv2.INTER_NEAREST, borderValue=255)
        np.testing.assert_array_equal(warp_labels_nearest(labels, m, (oh, ow)), want.astype(np.int32))
        inv = cv2.invertAffineTransform(m)
        ys, xs = np.mgrid[:oh, :ow]
        sx = np.floor(inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2] + 0.5).astype(int)
        sy = np.floor(inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2] + 0.5).astype(int)
        ok = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
        naive = np.full((oh, ow), 255.0)
        naive[ok] = labels[sy[ok], sx[ok]]
        naive_moved += int((naive != want).sum())
    assert naive_moved > 0


# -- the entry points -----------------------------------------------------------------------------------


def test_train_net_builds_the_segmentation_evaluators():
    """``train_net``'s ``build_evaluator``: ``sem_seg`` gets
    ``SemSegEvaluator``; ``coco_panoptic_seg`` COCO's and the sem-seg one
    together; ``cityscapes_sem_seg`` raises naming A15.2."""
    ensure_synthetic_datasets(["synth_learnable_semseg", "coco_2017_val_panoptic_separated"])
    cfg = get_cfg()
    assert isinstance(train_net.Trainer.build_evaluator(cfg, "synth_learnable_semseg"), SemSegEvaluator)
    both = train_net.Trainer.build_evaluator(cfg, "coco_2017_val_panoptic_separated")
    assert isinstance(both, DatasetEvaluators)
    assert [type(e).__name__ for e in both._evaluators] == ["COCOEvaluator", "SemSegEvaluator"]
    name = "test_torch_semseg_cityscapes"
    if name not in DatasetCatalog:
        DatasetCatalog.register(name, lambda: [])
        MetadataCatalog.get(name).set(evaluator_type="cityscapes_sem_seg")
    with pytest.raises(RuntimeError, match="A15.2"):
        train_net.Trainer.build_evaluator(cfg, name)


@pytest.mark.parametrize("extra, item", [
    (["MODEL.SEM_SEG_HEAD.NAME", "DeepLabV3Head"], "A15.2"),
    (["MODEL.SEM_SEG_HEAD.NAME", "DeepLabV3PlusHead"], "A15.2"),
    (["MODEL.SEM_SEG_HEAD.NAME", "PointRendSemSegHead"], "A15.3"),
    (["MODEL.RESNETS.RES4_DILATION", 2], "A15.2"),
    (["MODEL.BACKBONE.NAME", "build_resnet_deeplab_backbone"], "A15.2"),
])
def test_deeplab_and_pointrend_raise_naming_their_items(extra, item):
    _, pcfg = _cfgs(extra)
    with pytest.raises(NotImplementedError, match=item):
        build_model(pcfg)


def test_train_net_trains_two_steps_then_evaluates_sem_seg(tmp_path):
    """``tools/train_net`` on ``semantic_R_50_FPN_1x.yaml`` cut in width
    (ResNet-18, RES2 16, FPN 32, a head of 16) and size (64²) on the
    synthetic ``stuffonly`` stand-ins: 2 SGD steps at batch 2 (the batches'
    ``sem_seg`` feed the loss), then the evaluation: finite losses and a
    finite sem_seg dict."""
    from detectron2_centernet_tpu_torch.engine import default_argument_parser

    argv = [str(a) for a in ["--config-file", os.path.join(REPO, "configs", "Misc", "semantic_R_50_FPN_1x.yaml"),
            "MODEL.DEVICE", "cpu", "MODEL.WEIGHTS", "", "MODEL.RESNETS.DEPTH", 18,
            "MODEL.RESNETS.RES2_OUT_CHANNELS", 16, "MODEL.RESNETS.STEM_OUT_CHANNELS", 8, "MODEL.FPN.OUT_CHANNELS", 32,
            "MODEL.SEM_SEG_HEAD.CONVS_DIM", 16, "INPUT.TRAIN_SIZE", f"({SIZE}, {SIZE})",
            "INPUT.TEST_SIZE", f"({SIZE}, {SIZE})", "SOLVER.IMS_PER_BATCH", 2, "SOLVER.MAX_ITER", 2,
            "SOLVER.BASE_LR", 0.002, "TEST.BATCH_SIZE", 2, "DATALOADER.NUM_WORKERS", 1, "OUTPUT_DIR", str(tmp_path),
            "TPU.DTYPE", "float32"]]
    args = default_argument_parser().parse_args(argv)
    cfg = train_net.setup(args)
    ensure_synthetic_datasets(list(cfg.DATASETS.TRAIN) + list(cfg.DATASETS.TEST))
    results = train_net.main(args)
    assert set(results) == {"sem_seg"}
    assert all(math.isfinite(v) for k, v in results["sem_seg"].items() if k != "mIoU")
    metrics = [line for line in open(tmp_path / "metrics.json") if "loss_sem_seg" in line]
    assert len(metrics) == 1 and math.isfinite(json.loads(metrics[0])["loss_sem_seg"])


def test_bench_and_train_acc_read_the_semantic_configs():
    """tools/bench calls SemanticSegmentor ``semantic_fpn`` (no baseline);
    ``tools/train_acc`` reads ``semantic_synth_training_acc_test.yaml`` with
    its mIoU band, key for key as the JAX package does."""
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "Misc", "semantic_R_50_FPN_1x.yaml"))
    assert bench.metric_name(cfg) == "semantic_fpn_res50_fpn_800_infer_throughput"
    assert bench.baseline_img_s(cfg) is None
    yaml_file = os.path.join(REPO, "configs", "quick_schedules", "semantic_synth_training_acc_test.yaml")
    got = train_acc.acc_cfg(yaml_file, seed=43, device="cpu")
    want = jax_get_cfg()
    want.merge_from_file(yaml_file)
    assert [list(e) for e in got.TEST.EXPECTED_RESULTS] == [["sem_seg", "mIoU", 94.9, 5.0]]
    for key in ("SEM_SEG_HEAD", "RESNETS", "FPN"):
        assert dict(got.MODEL[key]) == dict(want.MODEL[key]), key
    assert dict(got.SOLVER) == dict(want.SOLVER) and dict(got.INPUT) == dict(want.INPUT)
