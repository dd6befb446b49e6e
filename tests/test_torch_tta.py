"""The port's test-time augmentation against the JAX package on the CPU:
``letterbox_and_flip_variants`` (the matrices, and the images within C2's
1e-2 on 0..255), ``numpy_nms``, ``TTAPredictor`` and
``DefaultTrainer.test_with_TTA`` on a narrow ctdet DLA-34 (CHANNELS [8, 8,
16, 16, 32, 32], HEAD_CONV 16, 4 classes, sizes 64 and 96 with the flip),
the same weights through ``state_dict_from_jax``, f32 and
``TEST.EXACT_MODE`` on both sides, and ``tools/train_net --eval-only`` with
``TEST.AUG.ENABLED``.

Inputs are made with numpy from a seed. JAX's predictor is built once (one
compiled ``predict_fn`` per size) and handed to its ``test_with_TTA``.
"""

import os

import numpy as np
import pytest
import torch

import jax
from flax.traverse_util import flatten_dict, unflatten_dict

from detectron2_centernet_tpu.config import get_cfg as jax_get_cfg
from detectron2_centernet_tpu.data import DatasetCatalog as JaxDatasetCatalog
from detectron2_centernet_tpu.data import MetadataCatalog as JaxMetadataCatalog
from detectron2_centernet_tpu.data import detection_utils as jax_detection_utils
from detectron2_centernet_tpu.engine import DefaultTrainer as JaxTrainer
from detectron2_centernet_tpu.models.build import build_model as jax_build_model
from detectron2_centernet_tpu.models.test_time_augmentation import TTAPredictor as JaxTTAPredictor
from detectron2_centernet_tpu.models.test_time_augmentation import numpy_nms as jax_numpy_nms
from detectron2_centernet_tpu_torch.checkpoint import state_dict_from_jax
from detectron2_centernet_tpu_torch.config import get_cfg
from detectron2_centernet_tpu_torch.data import DatasetCatalog, MetadataCatalog, letterbox_and_flip_variants, warp_image
from detectron2_centernet_tpu_torch.engine import DefaultTrainer, default_argument_parser, launch
from detectron2_centernet_tpu_torch.models import build_model
from detectron2_centernet_tpu_torch.models.test_time_augmentation import GeneralizedRCNNWithTTA, TTAPredictor, numpy_nms
from detectron2_centernet_tpu_torch.tools import train_net

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "configs", "COCO-Detection", "ctdet_dla_34_1x.yaml")
SIZES, CLASSES = (64, 96), 4
SMALL = ["MODEL.CENTERNET.LEVELS", [1, 1, 1, 1, 1, 1], "MODEL.CENTERNET.CHANNELS", [8, 8, 16, 16, 32, 32], "MODEL.CENTERNET.HEAD_CONV", 16,
         "MODEL.CENTERNET.TASK.HM", CLASSES, "DATASETS.TRAIN", (), "TPU.DTYPE", "float32", "TEST.EXACT_MODE", True,
         "TEST.AUG.MIN_SIZES", SIZES, "TEST.AUG.FLIP", True]
DATASET = "test_torch_tta_scenes"
# TTA detections, port against JAX on the same warped inputs (the port's warp patched into JAX): f32 through
# the network, measured at most 3.0e-8 (scores) and 7.2e-6 px (boxes); 3.0e-8 and 7.6e-6 px with each
# package's own warp
SCORE_TOL, BOX_TOL = 1e-5, 1e-3
# the COCO numbers of test_with_TTA, each package with its own warp (cv2's in JAX, C2): measured equal
AP_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the narrow convolutions run faster alone than
    split across a shared machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs():
    jcfg, pcfg = jax_get_cfg(), get_cfg()
    for cfg in (jcfg, pcfg):
        cfg.merge_from_file(YAML)
        cfg.merge_from_list(SMALL)
    pcfg.MODEL.DEVICE = "cpu"
    return jcfg, pcfg


def _random_variables(shapes, seed):
    """Every leaf random: kernels N(0, 1/fan_in), the offset convs scaled so
    offsets reach a few pixels, BN away from identity, the hm bias near
    -2.19 (scores spread across the threshold)."""
    rng = np.random.RandomState(seed)
    out = {}
    for path, v in flatten_dict(shapes).items():
        leaf = path[-1]
        if leaf == "kernel":
            a = rng.randn(*v.shape) / np.sqrt(np.prod(v.shape[:-1]))
            if "conv_offset_mask" in path:
                a = a * 2.0
        elif leaf in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, v.shape)
        elif path[-2] == "hm_out":
            a = -2.19 + rng.randn(*v.shape) * 0.5
        else:
            a = rng.randn(*v.shape) * 0.1
        out[path] = a.astype(np.float32)
    return unflatten_dict(out)


def _scenes(seed):
    """Four uint8 images of other sizes and aspects (the letterboxes differ)."""
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for h, w in ((60, 100), (80, 72), (64, 64), (90, 50))]


@pytest.fixture(scope="module")
def models():
    """(JAX cfg, JAX CenterNet with ``.variables``, its TTA predictor, port
    cfg, port CenterNet) on one random variables tree."""
    jcfg, pcfg = _cfgs()
    jm = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), (SIZES[0], SIZES[0])))
    variables = _random_variables(shapes, seed=0)
    jm.variables = variables
    pm = build_model(pcfg)
    pm.model.load_state_dict(state_dict_from_jax(variables))
    return jcfg, jm, JaxTTAPredictor(jcfg, jm, variables), pcfg, pm


def _port_warp(img, m, size):
    return warp_image(img, m, size).numpy()


def test_variants_match_jax():
    """Two sizes and the flip: the same four variants, matrices equal to
    1e-12, the warped images within C2's 1e-2 on 0..255 (the port samples
    in PyTorch, JAX through cv2)."""
    img = _scenes(1)[0]
    want = list(jax_detection_utils.letterbox_and_flip_variants(img, list(SIZES), flip=True))
    got = list(letterbox_and_flip_variants(img, list(SIZES), flip=True))
    assert [(f, s) for _, _, f, s in got] == [(f, s) for _, _, f, s in want] == [
        (False, 64), (True, 64), (False, 96), (True, 96)]
    for (gi, gm, _, size), (wi, wm, _, _) in zip(got, want):
        np.testing.assert_allclose(gm, wm, rtol=0, atol=1e-12)
        assert gi.shape == wi.shape == (size, size, 3) and gi.dtype == torch.float32
        np.testing.assert_allclose(gi.numpy(), wi, rtol=0, atol=1e-2)
    assert got[1][1][0, 0] < 0  # the flip is in the matrix


@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7])
def test_numpy_nms_keeps_jax_indices(thresh):
    """Clustered seeded boxes: the kept indices are JAX's, in order."""
    rng = np.random.RandomState(int(thresh * 10))
    centers = rng.uniform(0, 200, (12, 2)).repeat(25, 0) + rng.randn(300, 2) * 4
    sizes = rng.uniform(10, 40, (300, 2))
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], 1)
    scores = rng.rand(300).astype(np.float32)
    got = numpy_nms(boxes, scores, thresh)
    want = jax_numpy_nms(boxes, scores, thresh)
    assert got.dtype == np.int64 and 12 <= len(got) < 300
    np.testing.assert_array_equal(got, want)


def test_tta_sizes_round_up_to_the_size_divisibility(models):
    _, _, jax_tta, pcfg, pm = models
    tta = TTAPredictor(pcfg, pm, sizes=[400, 500, 512, 1200])
    assert tta.sizes == [416, 512, 1216] and tta.flip and tta.max_detections == 100
    assert TTAPredictor(pcfg, pm).sizes == jax_tta.sizes == list(SIZES)
    assert GeneralizedRCNNWithTTA is TTAPredictor


def _close(got, want):
    """The same detections: each of the port's pairs with one of JAX's of
    the same class, its score within SCORE_TOL and its box within BOX_TOL
    px (two scores closer than that may come in either order)."""
    g, w = got["instances"], want["instances"]
    assert len(g) == len(w) > 0
    np.testing.assert_allclose(g.scores, w.scores, rtol=0, atol=SCORE_TOL)  # both sorted by score
    left = list(range(len(w)))
    for i in range(len(g)):
        match = next((j for j in left if w.pred_classes[j] == g.pred_classes[i]
                      and abs(w.scores[j] - g.scores[i]) <= SCORE_TOL
                      and np.abs(w.pred_boxes.tensor[j] - g.pred_boxes.tensor[i]).max() <= BOX_TOL), None)
        assert match is not None, (i, g.pred_classes[i], g.scores[i], g.pred_boxes.tensor[i])
        left.remove(match)


def test_tta_predictor_matches_jax(models, monkeypatch):
    """Every scene's merged detections are JAX's on the same warped inputs
    (the port's warp patched into JAX, so the two networks see the same
    pixels): classes, scores and boxes, detection for detection."""
    _, _, jax_tta, pcfg, pm = models
    monkeypatch.setattr(jax_detection_utils, "warp_image", _port_warp)
    tta = TTAPredictor(pcfg, pm)
    for img in _scenes(2):
        _close(tta(img), jax_tta(img))


@pytest.fixture()
def scenes_dataset(models):
    """``DATASET`` in both catalogs: the scenes, each annotated with the top
    three detections of JAX's TTA (so the AP is far from 0)."""
    _, _, jax_tta, _, _ = models
    dicts = []
    for i, img in enumerate(_scenes(3)):
        inst = jax_tta(img)["instances"]
        annos = [{"bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)], "bbox_mode": 1,
                  "category_id": int(c), "iscrowd": 0}
                 for (x0, y0, x1, y1), c in zip(inst.pred_boxes.tensor[:3], inst.pred_classes[:3])]
        dicts.append({"image": img, "image_id": i, "height": img.shape[0], "width": img.shape[1],
                      "file_name": f"scene{i}.png", "annotations": annos})
    for catalog, meta in ((JaxDatasetCatalog, JaxMetadataCatalog), (DatasetCatalog, MetadataCatalog)):
        catalog.register(DATASET, lambda: [dict(d) for d in dicts])
        meta.get(DATASET).set(thing_classes=[f"c{k}" for k in range(CLASSES)])
    yield
    for catalog, meta in ((JaxDatasetCatalog, JaxMetadataCatalog), (DatasetCatalog, MetadataCatalog)):
        catalog.remove(DATASET)
        meta.remove(DATASET)


def test_test_with_tta_ap_matches_jax(models, scenes_dataset, tmp_path, monkeypatch):
    """``DefaultTrainer.test_with_TTA`` on the four scenes with
    ``COCOEvaluator``, each package with its own warp: the bbox numbers equal
    JAX's within AP_TOL, the model handed back in its mode."""
    jcfg, jm, jax_tta, pcfg, pm = models
    for cfg, sub in ((jcfg, "jax"), (pcfg, "port")):
        cfg.DATASETS.TEST = (DATASET,)
        cfg.OUTPUT_DIR = str(tmp_path / sub)
    monkeypatch.setattr(JaxTrainer, "build_tta_predictor", classmethod(lambda cls, cfg, model, variables: jax_tta))
    want = JaxTrainer.test_with_TTA(jcfg, jm)
    pm.model.train()
    got = DefaultTrainer.test_with_TTA(pcfg, pm)
    assert pm.model.training
    pm.model.eval()
    assert set(got) == set(want) == {"bbox"}
    assert got["bbox"]["AP"] > 50
    for k, v in want["bbox"].items():
        assert abs(got["bbox"][k] - v) <= AP_TOL or (np.isnan(v) and np.isnan(got["bbox"][k])), k


def test_test_with_tta_builds_its_predictor_through_the_factory(models, scenes_dataset):
    """As the JAX package's: ``build_tta_predictor`` makes the predictor (a
    project's override swaps the merge), and each record reaches the
    evaluator with its id and size."""
    _, _, _, pcfg, pm = models
    calls = {}

    class Stub:
        def reset(self):
            calls["reset"] = True

        def process(self, inputs, outputs):
            calls.setdefault("processed", []).append((inputs[0]["image_id"], inputs[0]["height"], outputs[0]))

        def evaluate(self):
            return {"stub": {"metric": 1.0}}

    class Trainer(DefaultTrainer):
        @classmethod
        def build_evaluator(cls, cfg, dataset_name):
            return Stub()

        @classmethod
        def build_tta_predictor(cls, cfg, model):
            calls["factory"] = model
            return lambda image: {"instances": image.shape}

    cfg = pcfg.clone()
    cfg.DATASETS.TEST = (DATASET,)
    assert Trainer.test_with_TTA(cfg, pm) == {"stub": {"metric": 1.0}}
    assert calls["factory"] is pm and calls["reset"]
    assert calls["processed"] == [(i, img.shape[0], {"instances": img.shape}) for i, img in enumerate(_scenes(3))]


def test_train_net_evaluates_with_test_time_augmentation(tmp_path, monkeypatch):
    """``tools/train_net --eval-only`` with ``TEST.AUG.ENABLED True`` on a
    narrow ``ctdet_res_18_1x.yaml`` and synthetic datasets: the results
    gain ``bbox_TTA`` beside ``bbox``, a complete COCO dict."""
    monkeypatch.setenv("DETECTRON2_SYNTH_DATA", "1")
    argv = ["--eval-only", "--config-file", os.path.join(REPO, "configs", "COCO-Detection", "ctdet_res_18_1x.yaml"),
            "OUTPUT_DIR", str(tmp_path), "MODEL.DEVICE", "cpu", "MODEL.RESNETS.RES2_OUT_CHANNELS", "16",
            "MODEL.RESNETS.STEM_OUT_CHANNELS", "8", "MODEL.CENTERNET.HEAD_CONV", "8", "INPUT.TEST_SIZE", "(64, 64)",
            "TEST.BATCH_SIZE", "2", "DATALOADER.NUM_WORKERS", "1", "TEST.AUG.ENABLED", "True",
            "TEST.AUG.MIN_SIZES", "(64,)", "DATASETS.TRAIN", "('test_torch_tta_train',)",
            "DATASETS.TEST", "('test_torch_tta_val',)"]
    res = launch(train_net.main, args=(default_argument_parser().parse_args(argv),))
    assert set(res) == {"bbox", "bbox_TTA"}
    assert set(res["bbox_TTA"]) >= {"AP", "AP50", "AP75", "APs", "APm", "APl"}
