"""The port's train geometry and host jitter (``data/transforms.py``,
``data/dataset_mapper.py::_train_geometry``) against the JAX package's
mapper: the same dicts through both train mappers on the same
``RandomState`` seed, for each of ``INPUT.ROTATION`` (expand on and off,
both sample styles), ``INPUT.CROP`` (each type, and the category-area
constraint on a ``sem_seg`` in the dict), ``INPUT.EXTENT``, the host
``PhotometricAug`` (``DATALOADER.DEVICE_PHOTOMETRIC`` off) and rotation,
crop and flip together.

The 2x3 ``warp`` matrix must be equal, bit for bit: one extra or missing
draw would move every later one. The image within 1 uint8 step: JAX warps
with ``cv2.warpAffine``, which places a sample up to 1/64 px away (it
quantizes positions to 1/32 px) and rounds its uint8 weights, the port
samples bilinearly in PyTorch (ROADMAP C2); the test image is smooth and 0
on its border, so neither its gradient nor the border's zero fill turns
those offsets into a full step. The boxes, the ``gt_masks`` rasters and the
``gt_keypoints`` within 1e-4 px.
"""

import copy

import numpy as np
import pytest

from detectron2_centernet_tpu.config import get_cfg as jax_get_cfg
from detectron2_centernet_tpu.data.dataset_mapper import DatasetMapper as JaxMapper
from detectron2_centernet_tpu.data.datasets.synthetic import ensure_synthetic_datasets as jax_ensure
from detectron2_centernet_tpu_torch.config import get_cfg
from detectron2_centernet_tpu_torch.data import DatasetMapper
from detectron2_centernet_tpu_torch.data.datasets import ensure_synthetic_datasets
from detectron2_centernet_tpu_torch.models import build_model

H, W = 72, 96
OUT = 64


def _smooth_image(rng):
    """(H, W, 3) uint8, 0 on the border rows and columns, slow inside."""
    y = np.sin(np.pi * np.arange(H) / (H - 1))[:, None]
    x = np.sin(np.pi * np.arange(W) / (W - 1))[None, :]
    phase = rng.uniform(0, 2 * np.pi, 3)
    img = [255 * y * x * (0.6 + 0.4 * np.cos(np.arange(W)[None, :] / 9.0 + p)) for p in phase]
    return np.stack(img, -1).round().astype(np.uint8)


def _dicts(seed, n=4):
    """Images with 2-4 instances each: a polygon, its extent as the box, and
    17 keypoints inside it (some invisible); and a sem-seg map of a few
    categories with an ignored (255) band."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        annos = []
        for _ in range(rng.randint(2, 5)):
            cx, cy = rng.uniform(15, W - 15), rng.uniform(12, H - 12)
            ang = np.sort(rng.uniform(0, 2 * np.pi, 6))
            rad = rng.uniform(4, 14, 6)
            poly = np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], 1)
            x0, y0 = poly.min(0)
            x1, y1 = poly.max(0)
            kp = np.stack([rng.uniform(x0, x1, 17), rng.uniform(y0, y1, 17), rng.choice([0, 1, 2], 17)], 1)
            annos.append({"bbox": [float(x0), float(y0), float(x1), float(y1)], "bbox_mode": 0,
                          "category_id": int(rng.randint(80)), "iscrowd": 0,
                          "segmentation": [poly.reshape(-1).tolist()], "keypoints": kp.reshape(-1).tolist()})
        sem = rng.randint(0, 4, (H // 8, W // 8)).repeat(8, 0).repeat(8, 1).astype(np.uint8)
        sem[: H // 6] = 255
        out.append({"image": _smooth_image(rng), "height": H, "width": W, "image_id": i, "annotations": annos,
                    "sem_seg": sem})
    return out


def _cfgs(extra):
    common = ["MODEL.MASK_ON", True, "MODEL.KEYPOINT_ON", True, "INPUT.MASK_RASTER", 28,
              "MODEL.CENTERNET.MAX_OBJS", 8, "INPUT.TRAIN_SIZE", (OUT, OUT), "INPUT.COLOR_JITTER", False,
              "DATASETS.TRAIN", ("synth_learnable_kp",)] + list(extra)
    jcfg, pcfg = jax_get_cfg(), get_cfg()
    jcfg.merge_from_list(common)
    pcfg.merge_from_list(common + ["MODEL.DEVICE", "cpu"])
    jax_ensure(["synth_learnable_kp"])
    ensure_synthetic_datasets(["synth_learnable_kp"])
    return jcfg, pcfg


def _compare(extra, seeds=range(8), dicts=None):
    """Every dict through both mappers at each seed; returns the port's outputs."""
    jcfg, pcfg = _cfgs(extra)
    jmap, pmap = JaxMapper(jcfg, is_train=True), DatasetMapper(pcfg, is_train=True)
    dicts = dicts or _dicts(0)
    outs = []
    for seed in seeds:
        d = dicts[seed % len(dicts)]
        want = jmap(copy.deepcopy(d), rng=np.random.RandomState(seed))
        got = pmap(copy.deepcopy(d), rng=np.random.RandomState(seed))
        np.testing.assert_array_equal(got["warp"], want["warp"], err_msg="warp")
        assert got["image"].shape == want["image"].shape and got["image"].dtype == want["image"].dtype
        np.testing.assert_allclose(got["image"].astype(np.float64), want["image"].astype(np.float64), rtol=0,
                                   atol=1.0, err_msg="image")
        np.testing.assert_array_equal(got["gt_valid"], want["gt_valid"])
        np.testing.assert_array_equal(got["gt_classes"], want["gt_classes"])
        np.testing.assert_allclose(got["gt_boxes"], want["gt_boxes"], rtol=0, atol=1e-4, err_msg="boxes")
        np.testing.assert_allclose(got["gt_masks"], want["gt_masks"], rtol=0, atol=1e-4, err_msg="gt_masks")
        np.testing.assert_allclose(got["gt_keypoints"], want["gt_keypoints"], rtol=0, atol=1e-4,
                                   err_msg="gt_keypoints")
        # the sem-seg labels through cv2's fixed-point nearest warp, pixel for pixel
        assert got["sem_seg"].dtype == want["sem_seg"].dtype == np.int32
        np.testing.assert_array_equal(got["sem_seg"], want["sem_seg"], err_msg="sem_seg")
        outs.append(got)
    return outs


def _mirrored(outs):
    """How many of the (unrotated) warps mirror x."""
    return sum(int(o["warp"][0, 0] < 0) for o in outs)


@pytest.mark.parametrize("expand", [True, False])
@pytest.mark.parametrize("style, angle", [("range", [-30.0, 30.0]), ("choice", [-90.0, 0.0, 45.0, 90.0])])
def test_rotation_matrix_image_and_targets_equal_jax(style, angle, expand):
    """``INPUT.ROTATION``: the rotation (about the image centre, the canvas
    grown to the rotated bound with ``EXPAND``) composed with the scale,
    shift and flip; with the choice style the draws include 0° (the
    identity) and the right angles."""
    outs = _compare(["INPUT.ROTATION.ENABLED", True, "INPUT.ROTATION.ANGLE", angle,
                     "INPUT.ROTATION.EXPAND", expand, "INPUT.ROTATION.SAMPLE_STYLE", style])
    rotated = [abs(o["warp"][0, 1]) > 1e-6 for o in outs]
    assert any(rotated) and (style == "range" or not all(rotated))
    assert sum(int(o["gt_valid"].sum()) for o in outs) >= 8


@pytest.mark.parametrize("crop_type, size", [("relative_range", [0.5, 0.6]), ("relative", [0.7, 0.5]),
                                             ("absolute", [40, 60]), ("absolute_range", [30, 70])])
def test_crop_matrix_image_and_targets_equal_jax(crop_type, size):
    """Each ``INPUT.CROP.TYPE``: the window drawn in the source, stretched
    onto the canvas, then the flip (about half the seeds mirror)."""
    outs = _compare(["INPUT.CROP.ENABLED", True, "INPUT.CROP.TYPE", crop_type, "INPUT.CROP.SIZE", size],
                    seeds=range(10))
    assert 0 < _mirrored(outs) < len(outs)
    assert len({tuple(o["warp"].reshape(-1)) for o in outs}) == len(outs) or crop_type == "absolute"


def test_crop_with_the_category_area_constraint_reads_sem_seg_as_jax():
    """``SINGLE_CATEGORY_MAX_AREA`` 0.4 and a ``sem_seg`` in the dict: the
    window is drawn again while one category fills 40% of it (255
    ignored), the same number of times on both sides, so the matrices
    stay equal; the constraint changes some windows against the
    unconstrained crop of the same seed."""
    crop = ["INPUT.CROP.ENABLED", True, "INPUT.CROP.TYPE", "absolute", "INPUT.CROP.SIZE", [24, 24]]
    outs = _compare(crop + ["INPUT.CROP.SINGLE_CATEGORY_MAX_AREA", 0.4], seeds=range(10))
    free = _compare(crop, seeds=range(10))
    assert sum(not np.array_equal(a["warp"], b["warp"]) for a, b in zip(outs, free)) >= 3


def test_crop_of_a_sem_seg_file_raises_naming_a15(tmp_path):
    """A dict with ``sem_seg_file_name`` and no ``sem_seg`` (it raised naming
    ROADMAP A15 until the port read sem-seg files): the PNG is read as the
    JAX mapper reads it, so the category constraint draws the same windows
    and the warped labels are JAX's, pixel for pixel."""
    from PIL import Image

    extra = ["INPUT.CROP.ENABLED", True, "INPUT.CROP.TYPE", "absolute", "INPUT.CROP.SIZE", [24, 24],
             "INPUT.CROP.SINGLE_CATEGORY_MAX_AREA", 0.4]
    dicts = _dicts(1)
    for i, d in enumerate(dicts):
        path = str(tmp_path / f"sem_seg_{i}.png")
        Image.fromarray(d.pop("sem_seg")).save(path)
        d["sem_seg_file_name"] = path
    outs = _compare(extra, seeds=range(6), dicts=dicts)
    assert all(o["sem_seg"].shape == (OUT, OUT) for o in outs)
    assert any((o["sem_seg"] == 255).any() for o in outs) and any((o["sem_seg"] < 4).any() for o in outs)


def test_extent_matrix_image_and_targets_equal_jax():
    """``INPUT.EXTENT``: a scaled and shifted rectangle around the centre,
    partly beyond the image (the warp fills 0 there), then the flip."""
    outs = _compare(["INPUT.EXTENT.ENABLED", True, "INPUT.EXTENT.SCALE_RANGE", (0.6, 1.5),
                     "INPUT.EXTENT.SHIFT_RANGE", (0.4, 0.4)], seeds=range(10))
    assert 0 < _mirrored(outs) < len(outs)
    assert any((o["image"][0] == 0).all() or (o["image"][:, 0] == 0).all() for o in outs)


def test_host_photometric_jitter_equals_jax():
    """``INPUT.COLOR_JITTER`` on, ``DATALOADER.DEVICE_PHOTOMETRIC`` off: the
    JAX mapper jitters on the host before the geometry; the port does too
    (a float32 image, the matrix still equal: the jitter draws come
    first), and ``build_model`` attaches no device jitter."""
    extra = ["INPUT.COLOR_JITTER", True, "DATALOADER.DEVICE_PHOTOMETRIC", False]
    outs = _compare(extra, seeds=range(10))
    assert all(o["image"].dtype == np.float32 for o in outs)
    plain = _compare([], seeds=range(10))
    assert sum(not np.array_equal(a["warp"], b["warp"]) for a, b in zip(outs, plain)) >= 8
    _, pcfg = _cfgs(extra + ["MODEL.META_ARCHITECTURE", "CenterNet", "MODEL.CENTERNET.CHANNELS",
                             [8, 8, 16, 16, 32, 32], "MODEL.CENTERNET.HEAD_CONV", 16])
    assert build_model(pcfg).device_augment is None


def test_rotation_crop_and_flip_together_equal_jax():
    """Rotation (expanded), then a relative-range crop of the rotated
    canvas (the category constraint off, as JAX does under a rotation),
    then the flip: one matrix, equal."""
    outs = _compare(["INPUT.ROTATION.ENABLED", True, "INPUT.ROTATION.ANGLE", [-20.0, 20.0],
                     "INPUT.CROP.ENABLED", True, "INPUT.CROP.SIZE", [0.6, 0.6],
                     "INPUT.CROP.SINGLE_CATEGORY_MAX_AREA", 0.4], seeds=range(10))
    assert all(abs(o["warp"][0, 1]) > 1e-6 for o in outs)
    assert 0 < _mirrored(outs) < len(outs)  # x still flips sign under ±20°
