"""The port's Pascal VOC and Cityscapes-instance data and evaluation against
the JAX package on the CPU, on small files each test writes itself (VOC's
``Annotations/*.xml``, ``ImageSets/Main/*.txt`` and JPEGs; Cityscapes'
``gtFine/<city>/*_gtFine_polygons.json`` and PNGs; COCO json), made from a
seed with numpy:

* ``load_coco_json``, ``load_voc_instances`` and ``load_cityscapes_*``
  record for record equal to JAX's, the metadata too; the builtin names
  registered as JAX registers them; ``ensure_synthetic_datasets`` replacing
  a builtin name whose files are not here;
* ``voc_ap``, ``_voc_eval_class`` (11-point and all-point, difficult boxes,
  duplicate detections) and ``PascalVOCDetectionEvaluator`` equal to JAX's
  to 1e-9; ``CityscapesInstanceEvaluator`` on the hand-made cases of
  ``tests/evaluation/test_cityscapes_evaluation.py`` (their values, and
  JAX's to 1e-9) and on polygons loaded from the files;
* the string image ids (ROADMAP C22): JAX's mapper turns VOC's "000005"
  into 5, so its loop scores 0 AP, and raises on a Cityscapes file name; the
  port's loop gives the AP of the direct ``process()`` call;
* ``tools/train_net``'s ``build_evaluator`` by ``evaluator_type``.
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

from detectron2_centernet_tpu.config import get_cfg as jax_get_cfg
from detectron2_centernet_tpu.data import DatasetCatalog as JaxDatasetCatalog
from detectron2_centernet_tpu.data import MetadataCatalog as JaxMetadataCatalog
from detectron2_centernet_tpu.data.dataset_mapper import DatasetMapper as JaxMapper
from detectron2_centernet_tpu.data.datasets import builtin as jax_builtin
from detectron2_centernet_tpu.data.datasets import cityscapes as jax_cityscapes
from detectron2_centernet_tpu.data.datasets import coco as jax_coco
from detectron2_centernet_tpu.data.datasets import pascal_voc as jax_voc
from detectron2_centernet_tpu.evaluation import CityscapesInstanceEvaluator as JaxCityscapesEvaluator
from detectron2_centernet_tpu.evaluation import PascalVOCDetectionEvaluator as JaxVOCEvaluator
from detectron2_centernet_tpu.evaluation import evaluator as jax_loop
from detectron2_centernet_tpu.evaluation import pascal_voc_evaluation as jax_voc_eval
from detectron2_centernet_tpu.structures import Boxes as JaxBoxes
from detectron2_centernet_tpu.structures import Instances as JaxInstances
from detectron2_centernet_tpu_torch.config import get_cfg
from detectron2_centernet_tpu_torch.data import (DatasetCatalog, MetadataCatalog, build_detection_test_loader,
                                                 register_coco_instances)
from detectron2_centernet_tpu_torch.data.datasets import (ensure_synthetic_datasets, load_cityscapes_instances,
                                                          load_cityscapes_semantic, load_coco_json,
                                                          load_voc_instances, register_pascal_voc)
from detectron2_centernet_tpu_torch.evaluation import (CityscapesInstanceEvaluator, COCOEvaluator, LVISEvaluator,
                                                       PascalVOCDetectionEvaluator, inference_on_dataset)
from detectron2_centernet_tpu_torch.evaluation import pascal_voc_evaluation as voc_eval
from detectron2_centernet_tpu_torch.structures import Boxes, Instances
from detectron2_centernet_tpu_torch.tools import train_net

H, W = 48, 64  # the written images' size


def _register_both(name, port_load, jax_load, meta):
    """Register ``name`` in the port's catalogs (``port_load``) and JAX's
    (``jax_load``), afresh, with the metadata ``meta``."""
    for catalogs, load in (((DatasetCatalog, MetadataCatalog), port_load),
                           ((JaxDatasetCatalog, JaxMetadataCatalog), jax_load)):
        for catalog in catalogs:
            if name in catalog:
                catalog.remove(name)
        catalogs[0].register(name, load)
        catalogs[1].get(name).set(**meta)


# -- the files -----------------------------------------------------------------------------------


def _write_image(path, rng, fmt):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(rng.randint(0, 256, (H, W, 3)).astype(np.uint8)).save(path, format=fmt)


def _voc_boxes(rng, n):
    x0, y0 = rng.randint(1, W - 20, n), rng.randint(1, H - 16, n)
    return np.stack([x0, y0, x0 + rng.randint(6, 19, n), y0 + rng.randint(6, 15, n)], 1)


def write_voc(root, seed=0, n=4, split="test"):
    """A VOC2007-shaped tree of ``n`` images: file ids "000005", ...; each
    image a few objects, one difficult and one with no ``difficult`` tag,
    and one of a class VOC does not have. Returns {file id: [(class, box
    (4,) 1-based XYXY, difficult)]}."""
    rng = np.random.RandomState(seed)
    d = os.path.join(root, "VOC2007")
    os.makedirs(os.path.join(d, "Annotations"), exist_ok=True)
    os.makedirs(os.path.join(d, "ImageSets", "Main"), exist_ok=True)
    ids, truth = [f"{5 + 7 * i:06d}" for i in range(n)], {}
    for fid in ids:
        _write_image(os.path.join(d, "JPEGImages", fid + ".jpg"), rng, "JPEG")
        k = rng.randint(2, 5)
        names = [jax_voc.CLASS_NAMES[c] for c in rng.randint(0, 3, k)] + ["unicorn"]
        boxes = _voc_boxes(rng, k + 1)
        objs, truth[fid] = [], []
        for j, (name, b) in enumerate(zip(names, boxes)):
            diff = "" if j == 0 else f"<difficult>{int(j == 1)}</difficult>"
            objs.append(f"<object><name>{name}</name><pose>Left</pose>{diff}<bndbox><xmin>{b[0]}</xmin>"
                        f"<ymin>{b[1]}</ymin><xmax>{b[2]}</xmax><ymax>{b[3]}</ymax></bndbox></object>")
            if name != "unicorn":
                truth[fid].append((jax_voc.CLASS_NAMES.index(name), b, j == 1))
        with open(os.path.join(d, "Annotations", fid + ".xml"), "w") as f:
            f.write(f"<annotation><filename>{fid}.jpg</filename><size><width>{W}</width><height>{H}</height>"
                    f"<depth>3</depth></size>{''.join(objs)}</annotation>")
    with open(os.path.join(d, "ImageSets", "Main", split + ".txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    return d, truth


def _polygon(rng, cx, cy, r, k):
    t = np.sort(rng.uniform(0, 2 * np.pi, k))
    rad = r * rng.uniform(0.6, 1.0, k)
    return np.stack([np.clip(cx + rad * np.cos(t), 0, W - 1), np.clip(cy + rad * np.sin(t), 0, H - 1)], 1)


def write_cityscapes(root, seed=0, split="val"):
    """A Cityscapes-shaped tree of two cities, two images each: the thing
    classes, a ``cargroup`` crowd, a ``road`` (no thing) and a polygon of 2
    points (dropped). Returns the image and gtFine directories."""
    rng = np.random.RandomState(seed)
    image_dir = os.path.join(root, "cityscapes", "leftImg8bit", split)
    gt_dir = os.path.join(root, "cityscapes", "gtFine", split)
    for city in ("aachen", "bochum"):
        for i in range(2):
            base = f"{city}_{i:06d}_000019"
            _write_image(os.path.join(image_dir, city, base + "_leftImg8bit.png"), rng, "PNG")
            labels = ["car", "person", "car", "cargroup", "road", "rider", "bicycle"]
            objects = [{"label": lb, "polygon": _polygon(rng, rng.uniform(8, W - 8), rng.uniform(8, H - 8),
                                                          rng.uniform(4, 14), rng.randint(3, 9)).round(1).tolist()}
                       for lb in labels]
            objects.append({"label": "car", "polygon": [[1.0, 2.0], [10.0, 12.0]]})
            os.makedirs(os.path.join(gt_dir, city), exist_ok=True)
            with open(os.path.join(gt_dir, city, base + "_gtFine_polygons.json"), "w") as f:
                json.dump({"imgHeight": H, "imgWidth": W, "objects": objects}, f)
    return image_dir, gt_dir


def write_coco(path, seed=0):
    """A COCO json: non-contiguous category ids, polygons (one too short),
    an RLE, keypoints, a crowd, and an annotation of a missing image."""
    rng = np.random.RandomState(seed)
    images = [{"id": i, "file_name": f"{i:012d}.jpg", "height": H, "width": W} for i in (9, 3, 17)]
    cats = [{"id": c, "name": f"c{c}"} for c in (7, 1, 90)]
    anns = []
    for a in range(9):
        ann = {"id": a + 1, "image_id": images[a % 3]["id"], "category_id": cats[a % 3]["id"],
               "bbox": rng.uniform(1, 30, 4).round(2).tolist(), "iscrowd": int(a == 4), "area": 50.0}
        if a % 4 == 0:
            ann["segmentation"] = [rng.uniform(0, 40, 8).round(2).tolist(), [1.0, 2.0, 3.0, 4.0]]
        elif a % 4 == 1:
            ann["segmentation"] = {"size": [H, W], "counts": [5, 10, 3067]}
        elif a % 4 == 2:
            ann["segmentation"] = [[1.0, 2.0, 3.0, 4.0]]  # too short: the annotation goes
        if a % 3 == 0:
            ann["keypoints"] = rng.uniform(0, 40, 51).round(1).tolist()
        anns.append(ann)
    anns.append({"id": 99, "image_id": 1234, "category_id": 1, "bbox": [1, 2, 3, 4], "iscrowd": 0})
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": cats}, f)


# -- the loaders ---------------------------------------------------------------------------------


def test_load_coco_json_matches_jax(tmp_path):
    """Record for record equal to JAX's (images in id order, contiguous
    category ids, short polygons dropped, keypoints +0.5), and the metadata
    it sets."""
    path = str(tmp_path / "instances.json")
    write_coco(path)
    name = "test_torch_voc_cityscapes_coco"
    for catalog in (MetadataCatalog, JaxMetadataCatalog):
        if name in catalog:
            catalog.remove(name)
    got = load_coco_json(path, str(tmp_path), name)
    want = jax_coco.load_coco_json(path, str(tmp_path), name)
    assert got == want and len(got) == 3 and sum(len(r["annotations"]) for r in got) == 7
    for k in ("thing_classes", "thing_dataset_id_to_contiguous_id", "json_file", "image_root"):
        assert MetadataCatalog.get(name).get(k) == JaxMetadataCatalog.get(name).get(k), k


def test_load_voc_instances_matches_jax(tmp_path):
    """Record for record equal to JAX's: string file ids, the -1 origin on
    xmin and ymin, ``difficult`` (0 without the tag), the unknown class
    left out."""
    d, truth = write_voc(str(tmp_path))
    got, want = load_voc_instances(d, "test"), jax_voc.load_voc_instances(d, "test")
    assert got == want
    assert [r["image_id"] for r in got] == list(truth) and all(isinstance(r["image_id"], str) for r in got)
    first = got[0]["annotations"][0]
    assert first["bbox"] == [float(v) for v in truth[got[0]["image_id"]][0][1] - np.array([1, 1, 0, 0])]
    assert [a["difficult"] for a in got[0]["annotations"]] == [int(t[2]) for t in truth[got[0]["image_id"]]]


def test_load_cityscapes_matches_jax(tmp_path):
    """Instances and sem-seg records equal to JAX's: file-name ids, crowd
    ``*group`` labels, non-things and 2-point polygons dropped."""
    image_dir, gt_dir = write_cityscapes(str(tmp_path))
    got, want = load_cityscapes_instances(image_dir, gt_dir), jax_cityscapes.load_cityscapes_instances(image_dir, gt_dir)
    assert got == want and len(got) == 4
    assert got[0]["image_id"] == "aachen_000000_000019_leftImg8bit.png"
    assert [a["iscrowd"] for a in got[0]["annotations"]] == [0, 0, 0, 1, 0, 0]
    assert load_cityscapes_semantic(image_dir, gt_dir) == jax_cityscapes.load_cityscapes_semantic(image_dir, gt_dir)


def test_builtin_names_register_as_in_jax():
    """Every JAX builtin name is registered in the port, lazily, with the
    same metadata (evaluator type, roots, classes, year, ...); a name that
    an earlier test of the process replaced by a synthetic stand-in in
    either package is left out of the metadata check."""
    names = (list(jax_builtin._PREDEFINED_SPLITS_COCO) + list(jax_builtin._PREDEFINED_SPLITS_LISA)
             + list(jax_builtin._PREDEFINED_SPLITS_BULB) + list(jax_builtin._PREDEFINED_SPLITS_LVIS)
             + [v[0] for v in jax_builtin._PREDEFINED_VOC] + list(jax_builtin._PREDEFINED_PANOPTIC)
             + [f"cityscapes_fine_{t}_{s}" for t in ("instance_seg", "sem_seg") for s in ("train", "val", "test")])
    assert len(names) == 39
    compared = 0
    for name in names:
        assert name in DatasetCatalog, name
        got, want = MetadataCatalog.get(name).as_dict(), JaxMetadataCatalog.get(name).as_dict()
        if got.get("synthetic") or want.get("synthetic"):
            continue
        compared += 1
        for k in ("evaluator_type", "json_file", "image_root", "thing_classes", "stuff_classes", "year", "split",
                  "dirname", "sem_seg_root", "image_dir", "gt_dir", "thing_dataset_id_to_contiguous_id"):
            assert got.get(k) == want.get(k), (name, k)
    assert compared >= 30
    with pytest.raises(FileNotFoundError):
        DatasetCatalog.get("voc_2012_val")  # no file is read until then


def test_ensure_synthetic_replaces_a_builtin_whose_files_are_missing():
    """A builtin name that does not load gets the synthetic stand-in, its
    metadata replaced (no COCO json named any more), as in JAX."""
    name = "lisa_night_bulb_coco_val"
    assert MetadataCatalog.get(name).get("json_file")
    ensure_synthetic_datasets([name])
    assert len(DatasetCatalog.get(name)) == 8
    meta = MetadataCatalog.get(name)
    assert meta.get("synthetic") and meta.get("json_file") is None and len(meta.thing_classes) == 80


def test_register_pascal_voc_loads_lazily(tmp_path):
    name = "test_torch_voc_cityscapes_lazy"
    d, _ = write_voc(str(tmp_path), split="trainval")
    if name in DatasetCatalog:
        DatasetCatalog.remove(name)
        MetadataCatalog.remove(name)
    register_pascal_voc(name, d, "trainval", 2012)
    assert MetadataCatalog.get(name).evaluator_type == "pascal_voc"
    assert DatasetCatalog.get(name) == jax_voc.load_voc_instances(d, "trainval")


# -- Pascal VOC AP -------------------------------------------------------------------------------


@pytest.mark.parametrize("use_07", [True, False])
def test_voc_ap_matches_jax(use_07):
    rng = np.random.RandomState(int(use_07))
    for _ in range(20):
        n = rng.randint(1, 30)
        rec = np.sort(rng.uniform(0, 1, n))
        prec = rng.uniform(0, 1, n)
        assert voc_eval.voc_ap(rec, prec, use_07) == pytest.approx(jax_voc_eval.voc_ap(rec, prec, use_07), abs=1e-12)


def _voc_case(seed):
    """A class's ground truth over 5 string-id images (some difficult) and
    detections: near copies, duplicates of the same box, misses, and
    detections on an image without ground truth."""
    rng = np.random.RandomState(seed)
    gt, dets = {}, []
    for i in range(5):
        img = f"{i:06d}"
        boxes = _voc_boxes(rng, rng.randint(1, 4)).astype(np.float64)
        gt[img] = (boxes, rng.rand(len(boxes)) < 0.3)
        for b in boxes:
            for _ in range(rng.randint(0, 3)):  # 0-2 detections of the box, the second a duplicate
                dets.append((img, float(rng.rand()), b + rng.uniform(-2, 2, 4)))
    dets += [("000099", float(rng.rand()), _voc_boxes(rng, 1)[0].astype(np.float64)) for _ in range(3)]
    return gt, dets


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_voc_eval_class_matches_jax(seed):
    """11-point and all-point, at IoU 0.5 and 0.75, to 1e-9."""
    gt, dets = _voc_case(seed)
    for use_07 in (True, False):
        for thr in (0.5, 0.75):
            got = voc_eval._voc_eval_class(gt, dets, thr, use_07)
            assert got == pytest.approx(jax_voc_eval._voc_eval_class(gt, dets, thr, use_07), abs=1e-9)
    assert voc_eval._voc_eval_class(gt, [], 0.5, False) == 0.0 and np.isnan(voc_eval._voc_eval_class({}, [], 0.5, False))


def _instances(cls, h, w, boxes, scores, classes, masks=None):
    inst = cls((h, w))
    inst.pred_boxes = (Boxes if cls is Instances else JaxBoxes)(np.asarray(boxes, np.float32).reshape(-1, 4))
    inst.scores = np.asarray(scores, np.float32)
    inst.pred_classes = np.asarray(classes, np.int64)
    if masks is not None:
        inst.pred_masks = masks
    return inst


def _voc_predictions(records, seed):
    """Per record: detections near its boxes (and some elsewhere), classes
    mostly right."""
    rng = np.random.RandomState(seed)
    out = []
    for r in records:
        boxes = [np.asarray(a["bbox"]) + rng.uniform(-3, 3, 4) for a in r["annotations"]] + list(_voc_boxes(rng, 2))
        classes = [a["category_id"] if rng.rand() < 0.8 else 3 for a in r["annotations"]] + list(rng.randint(0, 3, 2))
        out.append((np.asarray(boxes, np.float32), rng.rand(len(boxes)).astype(np.float32), classes))
    return out


@pytest.mark.parametrize("year", [2007, 2012])
def test_pascal_voc_evaluator_matches_jax(tmp_path, year):
    """The evaluators on the same predictions through ``process()`` with the
    file ids: AP, AP50 and AP75 equal to 1e-9, and above 0."""
    d, _ = write_voc(str(tmp_path), seed=year)
    name = f"test_torch_voc_cityscapes_voc{year}"
    _register_both(name, lambda: load_voc_instances(d, "test"), lambda: jax_voc.load_voc_instances(d, "test"),
                   dict(thing_classes=list(jax_voc.CLASS_NAMES), year=year, evaluator_type="pascal_voc"))
    records = DatasetCatalog.get(name)
    preds = _voc_predictions(records, year)
    got_ev, want_ev = PascalVOCDetectionEvaluator(name), JaxVOCEvaluator(name)
    for r, (b, s, c) in zip(records, preds):
        got_ev.process([{"image_id": r["image_id"]}], [{"instances": _instances(Instances, H, W, b, s, c)}])
        want_ev.process([{"image_id": r["image_id"]}], [{"instances": _instances(JaxInstances, H, W, b, s, c)}])
    got, want = got_ev.evaluate()["bbox"], want_ev.evaluate()["bbox"]
    assert set(got) == set(want) == {"AP", "AP50", "AP75"}
    for k in got:
        assert got[k] == pytest.approx(want[k], abs=1e-9), k
    assert got["AP50"] > 10


# -- Cityscapes instance AP ----------------------------------------------------------------------


def _rect(rect, h=64, w=64):
    y0, y1, x0, x1 = rect
    m = np.zeros((h, w), bool)
    m[y0:y1, x0:x1] = True
    return m


GT, FAR, CROWD = (5, 37, 5, 37), (40, 60, 40, 60), (40, 64, 40, 64)
# name: (gt [(class, rect, iscrowd)], predictions [(class, score, rect)], min region, what AP / AP50 must be)
CITYSCAPES_CASES = {
    "perfect": ([(0, (5, 30, 5, 30), 0), (1, (35, 60, 35, 60), 0)],
                [(0, 0.9, (5, 30, 5, 30)), (1, 0.8, (35, 60, 35, 60))], 100, {"AP": 100.0, "AP50": 100.0}),
    "miss_and_false_positive": ([(0, GT, 0)], [(0, 0.9, GT), (0, 0.8, FAR)], 100, {"AP50": 100.0}),
    "false_positive_first": ([(0, GT, 0)], [(0, 0.95, FAR), (0, 0.8, GT)], 100, {"AP50": 50.0}),
    "crowd_void_rule": ([(0, GT, 0), (0, CROWD, 1)], [(0, 0.9, GT), (0, 0.8, (42, 62, 42, 62))], 100,
                        {"AP50": 100.0}),
    "min_region": ([(0, (0, 5, 0, 5), 0)], [], 100, {"AP": float("nan")}),
    "small_gt_absorbs": ([(0, GT, 0), (0, (40, 48, 40, 48), 0)], [(0, 0.9, GT), (0, 0.8, (40, 48, 40, 48))], 100,
                         {"AP": 100.0}),
    "crowd_absorption_is_class_restricted": ([(0, GT, 0), (1, CROWD, 1)],
                                             [(0, 0.95, (42, 62, 42, 62)), (0, 0.8, GT)], 100, {"AP50": 50.0}),
}


@pytest.mark.parametrize("case", list(CITYSCAPES_CASES))
def test_cityscapes_evaluator_cases_match_jax(case):
    """The cases of ``tests/evaluation/test_cityscapes_evaluation.py``
    (perfect, a miss and a false positive, the crowd void rule, the minimum
    region, a small ground truth absorbing a prediction, the crowd
    absorption restricted to its class): the port's numbers equal JAX's to
    1e-9 and the case's own."""
    gts, preds, min_region, expect = CITYSCAPES_CASES[case]
    name = f"test_torch_voc_cityscapes_cs_{case}"
    for catalog in (MetadataCatalog, JaxMetadataCatalog):
        catalog.get(name).set(thing_classes=["car", "person"])
    inputs = [{"image_id": "im0.png", "annotations": [{"category_id": c, "segmentation": _rect(r), "iscrowd": k}
                                                      for c, r, k in gts]}]
    masks = np.stack([_rect(r) for _, _, r in preds]) if preds else np.zeros((0, 64, 64), bool)
    boxes = [[r[2], r[0], r[3], r[1]] for _, _, r in preds]
    args = (64, 64, boxes, [s for _, s, _ in preds], [c for c, _, _ in preds], masks)
    got_ev, want_ev = CityscapesInstanceEvaluator(name, min_region), JaxCityscapesEvaluator(name, min_region)
    got_ev.process(inputs, [{"instances": _instances(Instances, *args)}])
    want_ev.process(inputs, [{"instances": _instances(JaxInstances, *args)}])
    got, want = got_ev.evaluate()["segm"], want_ev.evaluate()["segm"]
    assert set(got) == set(want)
    for k in got:
        assert got[k] == pytest.approx(want[k], abs=1e-9, nan_ok=True), k
    for k, v in expect.items():
        assert got[k] == pytest.approx(v, abs=1e-6, nan_ok=True), k


def _cityscapes_predictions(records, seed):
    """Per record: a mask near each ground-truth polygon's fill (shifted a
    pixel or two), a few random blobs, scores and classes mostly right."""
    from detectron2_centernet_tpu_torch.structures.masks import polygons_to_bitmask

    rng = np.random.RandomState(seed)
    out = []
    for r in records:
        masks, classes = [], []
        for a in r["annotations"]:
            m = polygons_to_bitmask(a["segmentation"], H, W)
            masks.append(np.roll(m, tuple(rng.randint(-2, 3, 2)), axis=(0, 1)))
            classes.append(a["category_id"] if rng.rand() < 0.85 else 0)
        for _ in range(3):
            masks.append(_rect((rng.randint(0, 30), rng.randint(31, H), rng.randint(0, 40), rng.randint(41, W)), H, W))
            classes.append(int(rng.randint(0, 8)))
        out.append((np.stack(masks), rng.rand(len(masks)).astype(np.float32), classes))
    return out


def test_cityscapes_evaluator_on_loaded_polygons_matches_jax(tmp_path):
    """The evaluators on the files' polygons (filled by each package's own
    fill) and the same predictions, through ``process()`` with the file-name
    ids and the ground truth from the registered dataset: every number equal
    to 1e-9, AP above 0."""
    image_dir, gt_dir = write_cityscapes(str(tmp_path), seed=3)
    name = "test_torch_voc_cityscapes_cs_files"
    _register_both(name, lambda: load_cityscapes_instances(image_dir, gt_dir),
                   lambda: jax_cityscapes.load_cityscapes_instances(image_dir, gt_dir),
                   dict(thing_classes=list(jax_cityscapes.CITYSCAPES_THING_CLASSES),
                        evaluator_type="cityscapes_instance"))
    records = DatasetCatalog.get(name)
    got_ev, want_ev = CityscapesInstanceEvaluator(name), JaxCityscapesEvaluator(name)
    for r, (m, s, c) in zip(records, _cityscapes_predictions(records, 3)):
        boxes = np.zeros((len(m), 4), np.float32)
        got_ev.process([{"image_id": r["image_id"]}], [{"instances": _instances(Instances, H, W, boxes, s, c, m)}])
        want_ev.process([{"image_id": r["image_id"]}], [{"instances": _instances(JaxInstances, H, W, boxes, s, c, m)}])
    got, want = got_ev.evaluate()["segm"], want_ev.evaluate()["segm"]
    assert set(got) == set(want) and len(got) == 10
    for k in got:
        assert got[k] == pytest.approx(want[k], abs=1e-9, nan_ok=True), k
    assert got["AP"] > 0


# -- C22: the image ids reach the evaluator as the dataset gave them ------------------------------


def _replay(outputs):
    """(predict_fn, postprocess) that hand the evaluator ``outputs`` in the
    loader's order, whatever the images."""
    it = iter(outputs)

    def predict_fn(images, *_):
        return {"n": images[:, 0, 0, 0] * 0}

    def postprocess(dets, warps, sizes):
        return [{"instances": next(it)} for _ in sizes]

    return predict_fn, postprocess


def _port_cfg(name):
    cfg = get_cfg()
    cfg.merge_from_list(["MODEL.DEVICE", "cpu", "DATASETS.TEST", (name,), "INPUT.TEST_SIZE", (64, 64),
                         "TEST.BATCH_SIZE", 3, "DATALOADER.NUM_WORKERS", 1])
    return cfg


def test_voc_string_ids_reach_the_evaluator(tmp_path):
    """JAX's mapper makes VOC's "000005" the int 5, so its loop hands the
    evaluator ids that match no ground truth: every AP 0. The port's test
    loader and loop carry "000005" through: the AP of the direct
    ``process()`` call on the same predictions, to 1e-9."""
    d, _ = write_voc(str(tmp_path), seed=5, n=5)
    name = "test_torch_voc_cityscapes_c22_voc"
    _register_both(name, lambda: load_voc_instances(d, "test"), lambda: jax_voc.load_voc_instances(d, "test"),
                   dict(thing_classes=list(jax_voc.CLASS_NAMES), year=2007, evaluator_type="pascal_voc"))
    records = DatasetCatalog.get(name)
    preds = _voc_predictions(records, 5)
    port_out = [_instances(Instances, H, W, *p) for p in preds]

    direct = PascalVOCDetectionEvaluator(name)
    direct.process([{"image_id": r["image_id"]} for r in records], [{"instances": o} for o in port_out])
    want = direct.evaluate()["bbox"]
    assert want["AP50"] > 10

    seen = []
    evaluator = PascalVOCDetectionEvaluator(name)
    process = evaluator.process
    evaluator.process = lambda inputs, outputs: seen.extend(i["image_id"] for i in inputs) or process(inputs, outputs)
    predict_fn, postprocess = _replay(port_out)
    got = inference_on_dataset(predict_fn, build_detection_test_loader(_port_cfg(name), name), evaluator,
                               postprocess, device="cpu")["bbox"]
    assert seen == [r["image_id"] for r in records] == ["000005", "000012", "000019", "000026", "000033"]
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-9), k

    jcfg = jax_get_cfg()
    jcfg.merge_from_list(["INPUT.TEST_SIZE", (64, 64)])
    mapped = [JaxMapper(jcfg, is_train=False)(r) for r in JaxDatasetCatalog.get(name)]
    assert [int(m["image_id"]) for m in mapped] == [5, 12, 19, 26, 33]
    batches = [{k: np.stack([m[k] for m in mapped[i:i + 3]]) for k in mapped[0]} for i in (0, 3)]
    predict_fn, postprocess = _replay([_instances(JaxInstances, H, W, *p) for p in preds])
    jax_res = jax_loop.inference_on_dataset(lambda x: {"n": x[:, 0, 0, 0] * 0}, batches, JaxVOCEvaluator(name),
                                            postprocess)["bbox"]
    assert jax_res == {"AP": 0.0, "AP50": 0.0, "AP75": 0.0}


def test_cityscapes_file_name_ids_reach_the_evaluator(tmp_path):
    """JAX's mapper raises on a Cityscapes id (``np.int64`` of a file name),
    and so does its loop's ``int()``. The port's loader and loop carry the
    file names through: the numbers of the direct ``process()`` call."""
    image_dir, gt_dir = write_cityscapes(str(tmp_path), seed=4)
    name = "test_torch_voc_cityscapes_c22_cs"
    _register_both(name, lambda: load_cityscapes_instances(image_dir, gt_dir),
                   lambda: jax_cityscapes.load_cityscapes_instances(image_dir, gt_dir),
                   dict(thing_classes=list(jax_cityscapes.CITYSCAPES_THING_CLASSES),
                        evaluator_type="cityscapes_instance"))
    records = DatasetCatalog.get(name)
    port_out = [_instances(Instances, H, W, np.zeros((len(m), 4)), s, c, m)
                for m, s, c in _cityscapes_predictions(records, 4)]
    direct = CityscapesInstanceEvaluator(name)
    direct.process([{"image_id": r["image_id"]} for r in records], [{"instances": o} for o in port_out])
    want = direct.evaluate()["segm"]

    seen = []
    evaluator = train_net.Trainer.build_evaluator(_port_cfg(name), name)
    assert isinstance(evaluator, CityscapesInstanceEvaluator)
    process = evaluator.process
    evaluator.process = lambda inputs, outputs: seen.extend(i["image_id"] for i in inputs) or process(inputs, outputs)
    predict_fn, postprocess = _replay(port_out)
    got = inference_on_dataset(predict_fn, build_detection_test_loader(_port_cfg(name), name), evaluator,
                               postprocess, device="cpu")["segm"]
    assert seen == [r["image_id"] for r in records] and seen[0].endswith("_leftImg8bit.png")
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-9, nan_ok=True), k

    jcfg = jax_get_cfg()
    jcfg.merge_from_list(["INPUT.TEST_SIZE", (64, 64)])
    with pytest.raises(ValueError):
        JaxMapper(jcfg, is_train=False)(JaxDatasetCatalog.get(name)[0])
    batch = {"image": np.zeros((1, 64, 64, 3), np.uint8), "warp": np.eye(2, 3, dtype=np.float32)[None],
             "height": np.array([H]), "width": np.array([W]), "image_id": np.array([records[0]["image_id"]])}
    with pytest.raises(ValueError):
        jax_loop.inference_on_dataset(lambda x: {"n": x[:, 0, 0, 0]}, [batch], JaxCityscapesEvaluator(name),
                                      _replay([None])[1])


# -- tools/train_net's evaluators ----------------------------------------------------------------


@pytest.mark.parametrize("evaluator_type, cls", [("coco", COCOEvaluator), ("lvis", LVISEvaluator),
                                                 ("pascal_voc", PascalVOCDetectionEvaluator),
                                                 ("cityscapes_instance", CityscapesInstanceEvaluator)])
def test_train_net_builds_the_evaluator_of_each_type(tmp_path, evaluator_type, cls):
    """As JAX ``tools/train_net.py:30-63``: each ported type builds its
    evaluator; the Cityscapes sem-seg type, which raised naming A15.2
    before DeepLab was ported, builds ``CityscapesSemSegEvaluator`` (the
    sem-seg and panoptic types build theirs since A15.1:
    ``test_torch_semseg.py``)."""
    name = f"test_torch_voc_cityscapes_type_{evaluator_type}"
    if name not in DatasetCatalog:
        write_coco(str(tmp_path / "c.json"))
        register_coco_instances(name, {}, str(tmp_path / "c.json"), str(tmp_path))
        MetadataCatalog.remove(name)
        MetadataCatalog.get(name).set(evaluator_type=evaluator_type, year=2007, json_file=str(tmp_path / "c.json"),
                                      thing_classes=["c1", "c7", "c90"])
    cfg = get_cfg()
    cfg.OUTPUT_DIR = str(tmp_path)
    assert type(train_net.Trainer.build_evaluator(cfg, name)) is cls
    assert not hasattr(train_net, "QUEUED_EVALUATORS")
    assert type(train_net.Trainer.build_evaluator(cfg, "cityscapes_fine_sem_seg_val")).__name__ == \
        "CityscapesSemSegEvaluator"
