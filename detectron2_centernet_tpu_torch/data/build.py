"""The train loader (counterpart of the JAX package's ``data/build.py``:
``get_detection_dataset_dicts``, the threaded prefetch iterator and
``build_detection_train_loader``).

Every mapped sample has the same shapes, so a batch is ``np.stack``. The
loader is a producer thread that maps the samples of each batch on a small
thread pool (the warp is PyTorch, which releases the GIL) and keeps
``DATALOADER.PREFETCH`` batches ready while the card computes.
"""

import itertools
import logging
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np

from ..config import CfgNode
from .catalog import DatasetCatalog
from .dataset_mapper import DatasetMapper
from .samplers import TrainingSampler

logger = logging.getLogger(__name__)

__all__ = ["build_detection_train_loader", "get_detection_dataset_dicts"]


def _has_annotations(d: dict) -> bool:
    return any(a.get("iscrowd", 0) == 0 for a in d.get("annotations", []))


def get_detection_dataset_dicts(dataset_names, filter_empty: bool = True) -> List[dict]:
    """Load and concatenate registered datasets, dropping images without a
    usable annotation when ``filter_empty``."""
    if isinstance(dataset_names, str):
        dataset_names = [dataset_names]
    if not dataset_names:
        raise ValueError("no dataset named")
    dataset_dicts = []
    for name in dataset_names:
        dicts = DatasetCatalog.get(name)
        if not dicts:
            raise ValueError(f"Dataset '{name}' is empty!")
        dataset_dicts.extend(dicts)
    if filter_empty and "annotations" in dataset_dicts[0]:
        before = len(dataset_dicts)
        dataset_dicts = [d for d in dataset_dicts if _has_annotations(d)]
        logger.info("Removed %d images with no usable annotations. %d images left.",
                    before - len(dataset_dicts), len(dataset_dicts))
    if not dataset_dicts:
        raise ValueError("No valid data found in " + ",".join(dataset_names))
    return dataset_dicts


def _stack_batch(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class PrefetchIterator:
    """Threaded map + batch + prefetch over an infinite index stream. Sample
    ``pos`` of the stream is mapped with ``RandomState(seed + pos)``, so the
    batches do not depend on the thread count. ``close()`` stops the
    producer; a mapper's exception comes out of ``next()``."""

    def __init__(self, dataset: List[dict], indices: Iterable[int], mapper: Callable,
                 batch_size: int, num_workers: int, prefetch: int, seed: int) -> None:
        self._dataset = dataset
        self._indices = iter(indices)
        self._mapper = mapper
        self._batch_size = batch_size
        self._num_workers = max(1, min(num_workers, os.cpu_count() or 1))
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
        self._seed = seed
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _map_one(self, pos_idx):
        pos, idx = pos_idx
        return self._mapper(self._dataset[idx], rng=np.random.RandomState((self._seed + pos) % (2 ** 31)))

    def _put(self, item) -> bool:
        """Queue ``item`` unless ``close()`` is called while the queue is full."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _producer(self) -> None:
        try:
            with ThreadPoolExecutor(self._num_workers) as pool:
                enumerated = enumerate(self._indices)
                while not self._stop.is_set():
                    chunk = list(itertools.islice(enumerated, self._batch_size))
                    if not self._put(_stack_batch(list(pool.map(self._map_one, chunk)))):
                        return
        except Exception as e:  # noqa: BLE001 - handed to the consumer, which raises it
            self._put(e)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        while True:
            try:
                item = self._queue.get(timeout=0.1)
                break
            except queue.Empty:
                if not self._thread.is_alive() and self._queue.empty():
                    raise StopIteration from None
        if isinstance(item, Exception):
            raise item
        return item

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=30)


def build_detection_train_loader(cfg: CfgNode, mapper: Optional[Callable] = None) -> PrefetchIterator:
    """Infinite train loader of ``SOLVER.IMS_PER_BATCH`` images per batch over
    ``DATASETS.TRAIN``, shuffled by a ``TrainingSampler`` seeded from
    ``cfg.SEED`` (2026 when it is not positive, as in JAX)."""
    dataset_dicts = get_detection_dataset_dicts(
        cfg.DATASETS.TRAIN, filter_empty=cfg.DATALOADER.FILTER_EMPTY_ANNOTATIONS)
    if cfg.DATALOADER.SAMPLER_TRAIN != "TrainingSampler":
        raise NotImplementedError(f"sampler {cfg.DATALOADER.SAMPLER_TRAIN} is not ported")
    seed = cfg.SEED if cfg.SEED > 0 else 2026
    return PrefetchIterator(
        dataset_dicts, TrainingSampler(len(dataset_dicts), seed=seed),
        mapper or DatasetMapper(cfg, is_train=True), int(cfg.SOLVER.IMS_PER_BATCH),
        num_workers=cfg.DATALOADER.NUM_WORKERS, prefetch=cfg.DATALOADER.PREFETCH, seed=seed,
    )
