"""Synthetic stand-ins for the benchmark datasets (counterpart of the JAX
package's ``data/datasets/synthetic.py``, box annotations only).

The repository ships no COCO, so a missing builtin name such as
``coco_2017_train`` gets deterministic random scenes with its schema: 80
classes, axis-aligned colored rectangles as the instances. The JAX package's
keypoint, sem-seg and panoptic flavors are not ported (no port model reads
them).

One difference: the JAX package seeds a scene set with ``hash(name)``, which
Python randomizes per process; the port seeds it with ``zlib.crc32(name)``,
so the scenes repeat from run to run.
"""

import logging
import zlib
from typing import Iterable, Tuple

import numpy as np

from ..catalog import DatasetCatalog, MetadataCatalog
from .builtin_meta import COCO_CATEGORIES

logger = logging.getLogger(__name__)

__all__ = [
    "ensure_synthetic_datasets",
    "register_synthetic_instances",
    "register_learnable_instances",
]


def _scene(rng: np.random.RandomState, h: int, w: int, max_objs: int):
    """One image of colored rectangles and its XYWH_ABS annotations (the
    JAX package's draws, in its order; keypoints are drawn nowhere)."""
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
            "category_id": cat,
            "iscrowd": 0,
        })
    return img, annos


def register_synthetic_instances(
    name: str, num_images: int = 8, image_size: Tuple[int, int] = (96, 128), max_objs: int = 4,
) -> None:
    """Register ``name`` with deterministic synthetic scenes of the 80 COCO
    classes (the category drawn independently of the appearance)."""
    h, w = image_size

    def load():
        rng = np.random.RandomState(zlib.crc32(name.encode()) % (2 ** 31))
        dicts = []
        for i in range(num_images):
            img, annos = _scene(rng, h, w, max_objs)
            dicts.append({"image": img, "file_name": f"synthetic://{name}/{i}.png",
                          "height": h, "width": w, "image_id": i, "annotations": annos})
        return dicts

    DatasetCatalog.register(name, load)
    MetadataCatalog.get(name).set(
        thing_classes=[n for _, n in COCO_CATEGORIES], evaluator_type="coco", synthetic=True,
    )


_LEARNABLE_COLORS = np.array(
    [[220, 40, 40], [40, 220, 40], [40, 40, 220]], np.uint8
)  # class identity IS the color: classification is learnable


def register_learnable_instances(
    name: str, num_images: int = 24, image_size: Tuple[int, int] = (128, 128),
    max_objs: int = 3, num_classes: int = 3, seed: int = 0,
) -> None:
    """Scenes a small detector can master: each class has a fixed color and
    boxes sit in distinct cells of a 2x2 grid, so they never overlap."""
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
                annos.append({
                    "bbox": [float(x0), float(y0), float(bw), float(bh)],
                    "bbox_mode": 1,  # XYWH_ABS
                    "category_id": cat,
                    "iscrowd": 0,
                })
            dicts.append({"image": img, "file_name": f"synthetic://{name}/{i}.png",
                          "height": h, "width": w, "image_id": i, "annotations": annos})
        return dicts

    DatasetCatalog.register(name, load)
    MetadataCatalog.get(name).set(
        thing_classes=[f"color_{i}" for i in range(num_classes)], evaluator_type="coco",
        synthetic=True,
    )


def ensure_synthetic_datasets(names: Iterable[str]) -> None:
    """Register a synthetic stand-in for every name that is not registered
    (``synth_learnable*`` names get the learnable scenes)."""
    for name in names:
        if not name or name in DatasetCatalog:
            continue
        if name.startswith("synth_learnable"):
            register_learnable_instances(name)
            continue
        register_synthetic_instances(name)
        logger.warning("registered synthetic stand-in for dataset '%s'", name)
