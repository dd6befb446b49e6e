"""The port's evaluation against the JAX package on the CPU: the numpy and
the C++ COCO evaluators, ``convert_to_coco_dict``, ``instances_to_coco_json``,
``fast_letterbox``, the eval mapper, ``DefaultTrainer.test`` box for box on
``synth_learnable`` (small width, f32, ``TEST.EXACT_MODE``, the same weights
through ``from_jax``), ``PreciseBN``'s statistics, the hooks' schedules and
order, and the accuracy config that ``tools/train_acc.py`` builds in code.

Inputs are made with numpy from a seed. The JAX side keeps to one compiled
shape (one eval batch of 24 images at 128²; PreciseBN at one batch shape).
"""

import json
import os
import types

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from detectron2_centernet_tpu.config import get_cfg as jax_get_cfg
from detectron2_centernet_tpu.data.dataset_mapper import DatasetMapper as JaxMapper
from detectron2_centernet_tpu.data.datasets.coco import convert_to_coco_dict as jax_convert
from detectron2_centernet_tpu.data.datasets.synthetic import ensure_synthetic_datasets as jax_ensure
from detectron2_centernet_tpu.data.detection_utils import fast_letterbox as jax_fast_letterbox
from detectron2_centernet_tpu.engine import DefaultTrainer as JaxTrainer
from detectron2_centernet_tpu.engine import hooks as jax_hooks
from detectron2_centernet_tpu.evaluation import instances_to_coco_json as jax_to_json
from detectron2_centernet_tpu.evaluation.cocoeval_np import COCOEval as JaxCOCOEval
from detectron2_centernet_tpu.models.build import build_model as jax_build_model
from detectron2_centernet_tpu.models.layers import BN_MOMENTUM as JAX_BN_MOMENTUM
from detectron2_centernet_tpu.ops.fast_cocoeval import FastCOCOEval as JaxFastCOCOEval
from detectron2_centernet_tpu.structures import Boxes as JaxBoxes
from detectron2_centernet_tpu.structures import Instances as JaxInstances
from detectron2_centernet_tpu_torch.checkpoint import state_dict_from_jax
from detectron2_centernet_tpu_torch.config import get_cfg
from detectron2_centernet_tpu_torch.data import DatasetCatalog, DatasetMapper, fast_letterbox
from detectron2_centernet_tpu_torch.data.datasets import convert_to_coco_dict, ensure_synthetic_datasets
from detectron2_centernet_tpu_torch.engine import DefaultTrainer, hooks
from detectron2_centernet_tpu_torch.evaluation import COCOEval, instances_to_coco_json
from detectron2_centernet_tpu_torch.models import build_model
from detectron2_centernet_tpu_torch.models.layers import BatchNorm2d
from detectron2_centernet_tpu_torch.ops.fast_cocoeval import FastCOCOEval
from detectron2_centernet_tpu_torch.structures import Boxes, Instances
from detectron2_centernet_tpu_torch.tools.train_acc import YAML as ACC_YAML
from detectron2_centernet_tpu_torch.tools.train_acc import acc_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEARNABLE = "synth_learnable"
SIZE = 128  # synth_learnable's images are 128x128: the exact letterbox is the identity
SMALL = [
    "MODEL.META_ARCHITECTURE", "CenterNet", "MODEL.BACKBONE.NAME", "build_dla34_backbone",
    "MODEL.CENTERNET.CHANNELS", [8, 8, 16, 16, 32, 32], "MODEL.CENTERNET.HEAD_CONV", 16,
    "DATASETS.TRAIN", (LEARNABLE,), "DATASETS.TEST", (LEARNABLE,),
    "INPUT.TRAIN_SIZE", (SIZE, SIZE), "INPUT.TEST_SIZE", (SIZE, SIZE),
    "TPU.DTYPE", "float32", "TPU.DCN_IMPL", "exact", "TEST.EXACT_MODE", True,
    "TPU.NUM_DEVICES", 1, "TEST.BATCH_SIZE", 24, "INPUT.COLOR_JITTER", False,
]


def _cfgs(extra=()):
    jcfg, pcfg = jax_get_cfg(), get_cfg()
    jcfg.merge_from_list(SMALL + list(extra))
    pcfg.merge_from_list(SMALL + list(extra) + ["MODEL.DEVICE", "cpu"])
    for ensure, cfg in ((jax_ensure, jcfg), (ensure_synthetic_datasets, pcfg)):
        ensure(list(cfg.DATASETS.TRAIN) + list(cfg.DATASETS.TEST))
    return jcfg, pcfg


def _random_variables(shapes, seed):
    """Every leaf random: kernels N(0, 1/fan_in), the offset convs scaled so
    offsets reach a fraction of a pixel, BN away from identity, the hm bias
    near -2.19 (scores spread across the threshold)."""
    rng = np.random.RandomState(seed)
    out = {}
    for path, v in flatten_dict(shapes).items():
        leaf = path[-1]
        if leaf == "kernel":
            a = rng.randn(*v.shape) / np.sqrt(np.prod(v.shape[:-1]))
            if "conv_offset_mask" in path:
                a = a * 0.25
        elif leaf in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, v.shape)
        elif path[-2] == "hm_out":
            a = -2.19 + rng.randn(*v.shape) * 0.5
        else:
            a = rng.randn(*v.shape) * 0.1
        out[path] = a.astype(np.float32)
    return unflatten_dict(out)


@pytest.fixture(scope="module")
def models():
    """(JAX cfg, JAX CenterNet with its variables, port cfg, port CenterNet)
    sharing random weights, 3 classes (synth_learnable)."""
    jcfg, pcfg = _cfgs()
    jm = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), (SIZE, SIZE)))
    variables = _random_variables(shapes, seed=0)
    jm.variables = variables
    pm = build_model(pcfg)
    pm.model.load_state_dict(state_dict_from_jax(variables))
    assert pm.num_classes == 3
    return jcfg, jm, pcfg, pm


# -- the COCO evaluators ------------------------------------------------------

def _oracle_case():
    """The seeded scene of ``tests/evaluation/test_cocoeval_oracle.py``:
    crowds, explicit ignores, all three area ranges, duplicates, spurious
    detections, score ties."""
    import importlib.util

    path = os.path.join(REPO, "tests", "evaluation", "test_cocoeval_oracle.py")
    spec = importlib.util.spec_from_file_location("_cocoeval_oracle", path)
    oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle)
    return oracle._fixture()


def _random_case(seed):
    """Seeded random scenes: 6 images, categories (1, 2, 4, 7), ground truth
    of every size with crowds and ignores, and detections near and far from
    it, up to 130 in an image (beyond the largest maxDets)."""
    rng = np.random.RandomState(seed)
    img_ids, cat_ids = list(range(10, 16)), [1, 2, 4, 7]
    gts, dts = [], []
    for img in img_ids:
        for _ in range(rng.randint(0, 12)):
            s = rng.choice([6.0, 20.0, 40.0, 90.0, 150.0]) * rng.uniform(0.7, 1.3)
            g = {"image_id": img, "category_id": int(rng.choice(cat_ids)),
                 "bbox": [float(v) for v in (*rng.uniform(0, 400, 2), s, s * rng.uniform(0.5, 2.0))],
                 "iscrowd": int(rng.rand() < 0.15)}
            if rng.rand() < 0.1:
                g["ignore"] = 1
            gts.append(g)
        img_gts = [g for g in gts if g["image_id"] == img]
        for _ in range(rng.randint(0, 130)):
            if img_gts and rng.rand() < 0.6:
                g = img_gts[rng.randint(len(img_gts))]
                x, y, w, h = g["bbox"]
                j = rng.randn(4) * 0.1
                box, cat = [x + j[0] * w, y + j[1] * h, w * (1 + j[2]), h * (1 + j[3])], g["category_id"]
            else:
                s = rng.uniform(4, 160)
                box, cat = [*rng.uniform(0, 400, 2), s, s * rng.uniform(0.5, 2)], int(rng.choice(cat_ids))
            dts.append({"image_id": img, "category_id": cat, "bbox": [float(v) for v in box],
                        "score": float(np.round(rng.rand(), 3))})
    return gts, dts, img_ids, cat_ids


@pytest.mark.parametrize("impl", ["numpy", "fast"])
@pytest.mark.parametrize("case", ["oracle", "random0", "random1", "random2"])
def test_coco_evaluators_equal_jax(case, impl):
    """The port's COCOEval (or FastCOCOEval, its own C++ copy) against the
    JAX package's same evaluator: ``stats`` and every per-category AP equal
    exactly (the same algorithm on the same numbers)."""
    gts, dts, img_ids, cat_ids = _oracle_case() if case == "oracle" else _random_case(int(case[-1]))
    port, ref = (COCOEval, JaxCOCOEval) if impl == "numpy" else (FastCOCOEval, JaxFastCOCOEval)
    out = []
    for cls in (port, ref):
        ev = cls(gts, dts, img_ids, cat_ids)
        ev.evaluate()
        out.append((ev.summarize(), ev.per_category_ap()))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert (out[0][0] >= 0).any()
    np.testing.assert_array_equal(list(out[0][1].values()), list(out[1][1].values()))


def test_fast_and_numpy_evaluators_equal():
    """On the port's own pair: the C++ matcher gives the numpy evaluator's
    stats exactly on every case above."""
    for case in (_oracle_case(), _random_case(0), _random_case(1)):
        stats = []
        for cls in (COCOEval, FastCOCOEval):
            ev = cls(*case)
            ev.evaluate()
            stats.append(ev.summarize())
        np.testing.assert_array_equal(stats[0], stats[1])


def test_cocoeval_keypoints_equal_jax():
    """OKS keypoint evaluation, carried as plain numpy: the port's stats
    equal JAX's exactly on seeded person keypoints."""
    rng = np.random.RandomState(3)
    gts, dts = [], []
    for img in range(4):
        for _ in range(3):
            x, y = rng.uniform(0, 200, 2)
            kp = np.stack([x + rng.uniform(0, 60, 17), y + rng.uniform(0, 90, 17), np.full(17, 2.0)], 1)
            gts.append({"image_id": img, "category_id": 1, "bbox": [x, y, 60.0, 90.0], "area": 5400.0,
                        "iscrowd": 0, "keypoints": kp.reshape(-1).tolist(), "num_keypoints": 17})
            kp_d = kp.copy()
            kp_d[:, :2] += rng.randn(17, 2) * 3
            dts.append({"image_id": img, "category_id": 1, "bbox": [x, y, 60.0, 90.0],
                        "keypoints": kp_d.reshape(-1).tolist(), "score": float(rng.rand())})
    out = []
    for cls in (COCOEval, JaxCOCOEval):
        ev = cls(gts, dts, list(range(4)), [1], iou_type="keypoints")
        ev.evaluate()
        out.append(ev.summarize())
    np.testing.assert_array_equal(out[0], out[1])
    assert out[0][0] > 0


def test_cocoeval_segm_raises():
    """segm evaluation is ported (it raised naming A15 until then), and so is
    the rotated-box type (it raised naming A16): an empty one of each runs to
    the no-data stats; an unknown type still fails."""
    for iou_type in ("segm", "rotated_bbox"):
        ev = COCOEval([], [], [1], [1], iou_type=iou_type)
        ev.evaluate()
        ev.summarize()
        assert len(ev.stats) == 12 and all(v == -1 for v in ev.stats)
    with pytest.raises(AssertionError):
        COCOEval([], [], [1], [1], iou_type="obb")


# -- data -----------------------------------------------------------------------

def test_convert_to_coco_dict_matches_jax():
    """synth_learnable as COCO json, field by field: images, categories, and
    each annotation's id, image_id, bbox, area, category_id and iscrowd (the
    port's learnable scenes carry no segmentation)."""
    _cfgs()
    got, want = convert_to_coco_dict(LEARNABLE), jax_convert(LEARNABLE)
    assert got["images"] == want["images"] and got["categories"] == want["categories"]
    assert len(got["annotations"]) == len(want["annotations"]) > 24
    for g, w in zip(got["annotations"], want["annotations"]):
        for k in ("id", "image_id", "bbox", "area", "category_id", "iscrowd"):
            assert g[k] == w[k], k


def test_instances_to_coco_json_matches_jax():
    rng = np.random.RandomState(4)
    xy = rng.uniform(0, 100, (7, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(1, 50, (7, 2))], 1).astype(np.float32)
    scores = rng.rand(7).astype(np.float32)
    classes = rng.randint(0, 80, 7).astype(np.int64)
    port = Instances((120, 160), pred_boxes=Boxes(boxes), scores=scores, pred_classes=classes)
    ref = JaxInstances((120, 160), pred_boxes=JaxBoxes(boxes), scores=scores, pred_classes=classes)
    assert instances_to_coco_json(port, 5) == jax_to_json(ref, 5)
    assert instances_to_coco_json(port[:0], 5) == []


@pytest.mark.parametrize("shape", [(480, 640), (375, 500), (512, 512), (100, 37), (800, 600), (37, 100)])
def test_fast_letterbox_matches_jax(shape):
    """The resize-and-paste letterbox to 512²: the effective affine equals
    JAX's; the pixels within 1 of cv2's (cv2 rounds its uint8 resize weights
    to 11 bits), 0.1 on average."""
    img = np.random.RandomState(sum(shape)).randint(0, 256, shape + (3,)).astype(np.uint8)
    got, m = fast_letterbox(img, (512, 512))
    want, m_ref = jax_fast_letterbox(img, (512, 512))
    np.testing.assert_array_equal(m, m_ref)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape == (512, 512, 3)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and diff.mean() < 0.1, (diff.max(), diff.mean())


@pytest.mark.parametrize("exact", [False, True])
def test_eval_mapper_matches_jax(exact):
    """Both letterbox modes (resize and paste; TEST.EXACT_MODE's affine warp)
    on the same synthetic 96x128 scenes to 64²: the same keys, warp, height, width
    and image id; pixels as in ``test_fast_letterbox_matches_jax`` (resize)
    or ``test_train_mapper_matches_jax`` (the warp: mean |difference| below
    0.5 and 99% within 2)."""
    name = "test_torch_eval_mapper"
    jcfg, pcfg = jax_get_cfg(), get_cfg()
    for cfg in (jcfg, pcfg):
        cfg.merge_from_list(["INPUT.TEST_SIZE", (64, 64), "TEST.EXACT_MODE", exact])
    ensure_synthetic_datasets([name])
    for d in DatasetCatalog.get(name):
        got = DatasetMapper(pcfg, is_train=False)(d)
        want = JaxMapper(jcfg, is_train=False)(d)
        assert set(got) == set(want) == {"image", "warp", "height", "width", "image_id"}
        for k in ("warp", "height", "width", "image_id"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["image"].dtype == want["image"].dtype == np.uint8
        diff = np.abs(got["image"].astype(np.int32) - want["image"].astype(np.int32))
        if exact:
            assert diff.mean() < 0.5 and (diff <= 2).mean() > 0.99
        else:
            assert diff.max() <= 1 and diff.mean() < 0.1


# -- inference_on_dataset through DefaultTrainer.test ---------------------------

def test_trainer_test_matches_jax(models, tmp_path):
    """DefaultTrainer.test on synth_learnable (24 images, one batch): every
    image's detections are JAX's, detection for detection: the same class,
    the score within 1e-5 and the box within 1e-3 px (f32 through the whole
    network; two scores within 1e-7 of each other may come in either
    order); and the COCO numbers are equal."""
    jcfg, jm, pcfg, pm = models
    for cfg, sub in ((jcfg, "jax"), (pcfg, "port")):
        cfg.OUTPUT_DIR = str(tmp_path / sub)
    want = JaxTrainer.test(jcfg, jm)
    got = DefaultTrainer.test(pcfg, pm)
    dets = {sub: json.loads((tmp_path / sub / "coco_instances_results.json").read_text())
            for sub in ("jax", "port")}
    assert len(dets["port"]) == len(dets["jax"]) > 24
    for image_id in {d["image_id"] for d in dets["jax"]}:
        ref = [d for d in dets["jax"] if d["image_id"] == image_id]
        for g in (d for d in dets["port"] if d["image_id"] == image_id):
            match = next((i for i, w in enumerate(ref) if w["category_id"] == g["category_id"]
                          and abs(w["score"] - g["score"]) <= 1e-5 * abs(w["score"]) + 1e-6
                          and np.abs(np.subtract(w["bbox"], g["bbox"])).max() <= 1e-3), None)
            assert match is not None, g
            ref.pop(match)
        assert not ref, ref
    assert got == want
    assert set(got["bbox"]) >= {"AP", "AP50", "AP75", "APs", "APm", "APl"}


# -- PreciseBN --------------------------------------------------------------------

@flax.struct.dataclass
class _State:
    params: dict
    batch_stats: dict


def _bn_batches(n, seed):
    rng = np.random.RandomState(seed)
    return [{"image": rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)} for _ in range(n)]


@pytest.fixture(scope="module")
def precise_bn(models):
    """PreciseBN over the same 3 batches of 2 64² images (maps down to 2x2:
    8 values per channel at the deepest BatchNorms) on the same weights:
    JAX's (batch statistics recovered from the EMA update), the port's, and
    the naive torch route (``momentum=None``: a cumulative average of the
    unbiased variance)."""
    jcfg, jm, pcfg, pm = models
    batches = _bn_batches(3, seed=6)
    variables = jm.variables
    ref = jax_hooks.PreciseBN(0, batches, num_iter=3)
    ref.trainer = types.SimpleNamespace(model=jm, state=_State(variables["params"], variables["batch_stats"]))
    ref._update_stats()
    want = state_dict_from_jax({"batch_stats": jax.tree_util.tree_map(np.asarray, ref.trainer.state.batch_stats)})

    port = build_model(pcfg)
    port.model.load_state_dict(state_dict_from_jax(variables))
    hook = hooks.PreciseBN(0, lambda: batches, num_iter=3)
    hook.trainer = types.SimpleNamespace(model=port)
    before = {k: v.clone() for k, v in port.model.state_dict().items()}
    hook.update_stats()

    naive = build_model(pcfg)
    naive.model.load_state_dict(state_dict_from_jax(variables))
    bns = [m for m in naive.model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for bn in bns:
        bn.reset_running_stats()
        bn.momentum = None
    naive.model.train()
    with torch.no_grad():
        for b in batches:
            naive.model(naive.normalize(torch.from_numpy(b["image"]).permute(0, 3, 1, 2)))
    return want, port, naive, before


def _stats_close(model, want, rtol):
    """Each running mean and variance within ``rtol`` of JAX's, relative to
    that statistic's max |value| over its channels."""
    for k, v in model.model.state_dict().items():
        if "running" in k:
            w = want[k].numpy()
            if np.abs(v.numpy() - w).max() > rtol * np.abs(w).max():
                return False
    return True


def test_precise_bn_matches_jax(precise_bn):
    """Every BatchNorm of the small DLA-34: PreciseBN's mean and variance
    within 2e-4 of the statistic's scale of JAX's (measured 1.2e-4 at the
    deepest; the f32 rounding of 40 train-mode layers on 8 values per
    channel: each side differs from the port run in f64 by up to 3e-4, and
    JAX's recovery of each batch's statistics from its EMA update adds
    1.3e-5 at the first layer, where the port is within 5e-8 of f64).
    ``test_precise_bn_one_batchnorm_matches_jax`` holds the arithmetic to
    1e-6. The mode and ``num_batches_tracked`` are as before, and every
    variance moved."""
    want, port, _, before = precise_bn
    assert _stats_close(port, want, 2e-4)
    sd = port.model.state_dict()
    assert not port.model.training
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            assert torch.equal(v, before[k]), k
        elif "running_var" in k:
            assert not torch.equal(v, before[k]), k


def test_precise_bn_naive_momentum_none_differs(precise_bn):
    """The naive route (torch's ``momentum=None``, the unbiased variance)
    misses JAX's variances by 8/7 at the 2x2 maps: the tolerance above
    catches it, and 1e-2 would too."""
    want, _, naive, _ = precise_bn
    assert not _stats_close(naive, want, 2e-4)
    assert not _stats_close(naive, want, 1e-2)


class _OneBN(flax.linen.Module):
    @flax.linen.compact
    def __call__(self, x, train=False):
        return flax.linen.BatchNorm(use_running_average=not train, momentum=JAX_BN_MOMENTUM, epsilon=1e-5)(x)


def test_precise_bn_one_batchnorm_matches_jax():
    """The hooks' arithmetic on one BatchNorm fed the same numbers on both
    sides (4 batches of 2 3x3 images, 18 values per channel, the base
    statistics near the batches'): the port's mean and biased variance
    averaged with equal weight are within 1e-6 of JAX's relative to their
    scale (measured 6.4e-7: JAX's EMA recovery; the port is within 1e-7 of
    the float64 average). The naive ``momentum=None`` route misses by 18/17."""
    rng = np.random.RandomState(8)
    c = 5
    batches = [{"image": rng.randint(0, 256, (2, 3, 3, c)).astype(np.uint8)} for _ in range(4)]
    pixels = np.concatenate([b["image"] for b in batches]).astype(np.float32) / 255.0
    variables = {"params": {"BatchNorm_0": {"scale": np.ones(c, np.float32), "bias": np.zeros(c, np.float32)}},
                 "batch_stats": {"BatchNorm_0": {"mean": pixels.mean((0, 1, 2)), "var": pixels.var((0, 1, 2))}}}
    ref = jax_hooks.PreciseBN(0, batches, num_iter=4)
    jm = types.SimpleNamespace(module=_OneBN(), normalize=lambda im: im.astype(jnp.float32) / 255.0)
    ref.trainer = types.SimpleNamespace(model=jm, state=_State(variables["params"], variables["batch_stats"]))
    ref._update_stats()
    want = jax.tree_util.tree_map(np.asarray, ref.trainer.state.batch_stats)["BatchNorm_0"]
    exact = [np.mean([(b["image"] / 255.0).mean((0, 1, 2)) for b in batches], 0),
             np.mean([(b["image"] / 255.0).var((0, 1, 2)) for b in batches], 0)]
    rel = lambda a, b: np.abs(a - b).max() / np.abs(b).max()

    def port_stats(momentum_none):
        bn = BatchNorm2d(c)
        model = types.SimpleNamespace(model=bn, device=torch.device("cpu"), normalize=lambda im: im.float() / 255.0)
        if momentum_none:
            bn.momentum = None
            bn.train()
            with torch.no_grad():
                for b in batches:
                    bn(model.normalize(torch.from_numpy(b["image"]).permute(0, 3, 1, 2)))
        else:
            hook = hooks.PreciseBN(0, lambda: batches, num_iter=4)
            hook.trainer = types.SimpleNamespace(model=model)
            hook.update_stats()
        return bn.running_mean.numpy(), bn.running_var.numpy()

    mean, var = port_stats(False)
    assert rel(mean, want["mean"]) <= 1e-6 and rel(var, want["var"]) <= 1e-6
    assert rel(mean, exact[0]) <= 1e-6 and rel(var, exact[1]) <= 1e-6
    mean, var = port_stats(True)
    assert rel(mean, want["mean"]) <= 1e-6
    assert rel(var, want["var"]) > 1e-2


# -- the hooks ----------------------------------------------------------------------

@pytest.mark.parametrize("period", [0, 2, 3])
def test_eval_and_precise_bn_schedules_match_jax(period):
    """Over a 7-step run: the steps after which EvalHook and PreciseBN fire,
    and EvalHook's run after training, equal the JAX hooks' (EvalHook after
    the last step even at period 0; PreciseBN at the last step)."""
    from detectron2_centernet_tpu.utils.events import EventStorage as JaxStorage
    from detectron2_centernet_tpu_torch.utils.events import EventStorage

    def schedule(mod, storage_cls, update):
        fired = []
        trainer = types.SimpleNamespace(iter=0, max_iter=7)
        ev = mod.EvalHook(period, lambda: fired.append(("eval", trainer.iter)) or {})
        pbn = mod.PreciseBN(period, None, 1)
        setattr(pbn, update, lambda: fired.append(("precise_bn", trainer.iter)))
        ev.trainer = pbn.trainer = trainer
        with storage_cls(0):
            for trainer.iter in range(7):
                pbn.after_step()
                ev.after_step()
            trainer.iter += 1
            ev.after_train()
        return fired

    got = schedule(hooks, EventStorage, "update_stats")
    assert got == schedule(jax_hooks, JaxStorage, "_update_stats")
    assert got[-2:] == [("precise_bn", 6), ("eval", 7)]


def test_default_trainer_hook_order(tmp_path):
    """PreciseBN before the checkpointer, EvalHook after it and always
    registered: the JAX package's order (``engine/defaults.py:222-260``)."""
    _, pcfg = _cfgs(["TEST.PRECISE_BN.ENABLED", True, "OUTPUT_DIR", str(tmp_path)])
    trainer = DefaultTrainer(pcfg)
    try:
        names = [type(h).__name__ for h in trainer._hooks]
    finally:
        trainer.data_loader.close()
    assert names == ["IterationTimer", "LRSchedulerHook", "PreciseBN", "PeriodicCheckpointerHook",
                     "EvalHook", "PeriodicWriter"]


# -- the accuracy config ----------------------------------------------------------

def _flat(node, prefix=""):
    out = {}
    for key, val in node.items():
        if isinstance(val, dict):
            out.update(_flat(val, prefix + key + "."))
        else:
            out[prefix + key] = val
    return out


@pytest.mark.parametrize("yaml_file", [ACC_YAML, "configs/quick_schedules/ctdet_synth_training_acc_test.yaml"])
def test_train_acc_config_equals_yaml(yaml_file):
    """``tools/train_acc.py`` reads the accuracy YAML (DLA-34's, its default,
    and ResNet-18-deconv's) with ``merge_from_file`` and sets only the seed,
    the device, the output directory and, as a diagnostic, the dtype: key
    for key equal to ``merge_from_file`` of the YAML, in the port's config
    and in the JAX package's."""
    path = os.path.join(REPO, yaml_file)
    built = _flat(acc_cfg(path))
    for get in (get_cfg, jax_get_cfg):
        cfg = get()
        cfg.merge_from_file(path)
        assert built == _flat(cfg)
    assert built["SEED"] == 42 and built["TEST.PRECISE_BN.NUM_ITER"] == 20
    other = _flat(acc_cfg(path, 7, "cpu", "out", "float32"))
    assert (other["SEED"], other["MODEL.DEVICE"], other["OUTPUT_DIR"], other["TPU.DTYPE"]) == (7, "cpu", "out", "float32")
