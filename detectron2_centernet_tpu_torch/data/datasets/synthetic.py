"""Synthetic stand-ins for the benchmark datasets (counterpart of the JAX
package's ``data/datasets/synthetic.py``).

The repository ships no COCO, so a missing builtin name such as
``coco_2017_train`` gets deterministic random scenes with its schema: 80
classes, axis-aligned colored rectangles as the instances, each with its
rectangle as a polygon (``segmentation``) and 17 keypoints on a 4×5 grid in
it (``keypoints``), as the JAX package's. Names with ``keypoint`` in them
carry COCO's person-keypoint names and flip map; ``synth_learnable_kp``
gives the learnable scenes box-relative keypoints and one class. The JAX
package's sem-seg and panoptic flavors are not ported (no port model reads
them).

Two differences, each keeping the JAX package's draws in their order:
  * the JAX package seeds a scene set with ``hash(name)``, which Python
    randomizes per process; the port seeds it with ``zlib.crc32(name)``,
    so the scenes repeat from run to run;
  * a keypoint stand-in (``keypoints_coco_2017_train``, ...) puts every
    instance in class 0, person, as COCO's person keypoints are: the JAX
    package's keeps the 80 drawn classes, which a Keypoint R-CNN of one
    class cannot train on. The class is still drawn, so the images are
    the same.
"""

import logging
import zlib
from typing import Iterable, List, Tuple

import numpy as np

from ..catalog import DatasetCatalog, MetadataCatalog
from .builtin_meta import COCO_CATEGORIES, COCO_PERSON_KEYPOINT_FLIP_MAP, COCO_PERSON_KEYPOINT_NAMES

logger = logging.getLogger(__name__)

__all__ = [
    "ensure_synthetic_datasets",
    "register_synthetic_instances",
    "register_learnable_instances",
]

_NUM_KPTS = 17


def _rectangle(x0: int, y0: int, bw: int, bh: int) -> List[float]:
    """The box as an XY-interleaved polygon, clockwise from its top left."""
    return [float(x0), float(y0), float(x0 + bw), float(y0), float(x0 + bw), float(y0 + bh), float(x0),
            float(y0 + bh)]


def _grid_keypoints(x0: int, y0: int, bw: int, bh: int) -> List[float]:
    """17 visible keypoints at fixed fractions of the box (a 4×5 grid)."""
    kpts: List[float] = []
    for k in range(_NUM_KPTS):
        kpts += [float(x0 + (k % 4 + 1) * bw / 5.0), float(y0 + (k // 4 + 1) * bh / 6.0), 2.0]
    return kpts


def _scene(rng: np.random.RandomState, h: int, w: int, max_objs: int, person_only: bool = False):
    """One image of colored rectangles and its XYWH_ABS annotations (the
    JAX package's draws, in its order), every instance in class 0 when
    ``person_only``."""
    img = np.full((h, w, 3), 32, np.uint8)
    annos = []
    for _ in range(rng.randint(1, max_objs + 1)):
        bw, bh = int(rng.randint(12, w // 2)), int(rng.randint(12, h // 2))
        x0 = int(rng.randint(0, w - bw))
        y0 = int(rng.randint(0, h - bh))
        cat = int(rng.randint(0, 80))
        img[y0 : y0 + bh, x0 : x0 + bw] = rng.randint(64, 255, 3)
        annos.append({
            "bbox": [float(x0), float(y0), float(bw), float(bh)],
            "bbox_mode": 1,  # XYWH_ABS
            "category_id": 0 if person_only else cat,
            "iscrowd": 0,
            "segmentation": [_rectangle(x0, y0, bw, bh)],
            "keypoints": _grid_keypoints(x0, y0, bw, bh),
        })
    return img, annos


def _set_person_keypoints(meta) -> None:
    meta.set(keypoint_names=COCO_PERSON_KEYPOINT_NAMES, keypoint_flip_map=COCO_PERSON_KEYPOINT_FLIP_MAP)


def register_synthetic_instances(
    name: str, num_images: int = 8, image_size: Tuple[int, int] = (96, 128), max_objs: int = 4,
    keypoints: bool = False,
) -> None:
    """Register ``name`` with deterministic synthetic scenes of the 80 COCO
    classes (the category drawn independently of the appearance); with
    ``keypoints`` a person-keypoint set: every instance a person, the
    keypoint names and flip map in the metadata."""
    h, w = image_size

    def load():
        rng = np.random.RandomState(zlib.crc32(name.encode()) % (2 ** 31))
        dicts = []
        for i in range(num_images):
            img, annos = _scene(rng, h, w, max_objs, person_only=keypoints)
            dicts.append({"image": img, "file_name": f"synthetic://{name}/{i}.png",
                          "height": h, "width": w, "image_id": i, "annotations": annos})
        return dicts

    DatasetCatalog.register(name, load)
    meta = MetadataCatalog.get(name)
    meta.set(thing_classes=[n for _, n in COCO_CATEGORIES], evaluator_type="coco", synthetic=True)
    if keypoints:
        _set_person_keypoints(meta)


_LEARNABLE_COLORS = np.array(
    [[220, 40, 40], [40, 220, 40], [40, 40, 220]], np.uint8
)  # class identity IS the color: classification is learnable


def register_learnable_instances(
    name: str, num_images: int = 24, image_size: Tuple[int, int] = (128, 128),
    max_objs: int = 3, num_classes: int = 3, seed: int = 0, keypoints: bool = False,
) -> None:
    """Scenes a small detector can master: each class has a fixed color and
    boxes sit in distinct cells of a 2x2 grid, so they never overlap. Each
    instance has its rectangle as a polygon and, with ``keypoints``, 17
    keypoints at fixed fractions of its box (exactly learnable)."""
    h, w = image_size

    def load():
        rng = np.random.RandomState(seed)
        dicts = []
        for i in range(num_images):
            img = np.full((h, w, 3), 32, np.uint8)
            annos = []
            cell_w, cell_h = w // 2, h // 2
            cells = rng.permutation(4)[: rng.randint(1, max_objs + 1)]
            for j in cells:
                cat = int(rng.randint(0, num_classes))
                bw = int(rng.randint(int(cell_w * 0.4), int(cell_w * 0.9)))
                bh = int(rng.randint(int(cell_h * 0.4), int(cell_h * 0.9)))
                x0 = (int(j) % 2) * cell_w + int(rng.randint(0, cell_w - bw))
                y0 = (int(j) // 2) * cell_h + int(rng.randint(0, cell_h - bh))
                img[y0 : y0 + bh, x0 : x0 + bw] = _LEARNABLE_COLORS[cat]
                anno = {
                    "bbox": [float(x0), float(y0), float(bw), float(bh)],
                    "bbox_mode": 1,  # XYWH_ABS
                    "category_id": cat,
                    "iscrowd": 0,
                    "segmentation": [_rectangle(x0, y0, bw, bh)],
                }
                if keypoints:
                    anno["keypoints"] = _grid_keypoints(x0, y0, bw, bh)
                annos.append(anno)
            dicts.append({"image": img, "file_name": f"synthetic://{name}/{i}.png",
                          "height": h, "width": w, "image_id": i, "annotations": annos})
        return dicts

    DatasetCatalog.register(name, load)
    meta = MetadataCatalog.get(name)
    meta.set(thing_classes=[f"color_{i}" for i in range(num_classes)], evaluator_type="coco", synthetic=True)
    if keypoints:
        _set_person_keypoints(meta)


def ensure_synthetic_datasets(names: Iterable[str]) -> None:
    """Register a synthetic stand-in for every name that is not registered
    (``synth_learnable*`` names get the learnable scenes, with keypoints and
    one class when the name has ``_kp``; names with ``keypoint`` get the
    person-keypoint flavor)."""
    for name in names:
        if not name or name in DatasetCatalog:
            continue
        if name.startswith("synth_learnable"):
            if "_kp" in name:
                register_learnable_instances(name, keypoints=True, num_classes=1)
            else:
                register_learnable_instances(name)
            continue
        register_synthetic_instances(name, keypoints="keypoint" in name)
        logger.warning("registered synthetic stand-in for dataset '%s'", name)
