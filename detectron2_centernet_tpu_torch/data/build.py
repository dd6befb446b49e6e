"""The train and test loaders (counterpart of the JAX package's
``data/build.py``: ``load_proposals_into_dataset``,
``get_detection_dataset_dicts``, the threaded prefetch iterator,
``build_detection_train_loader`` and ``build_detection_test_loader``).

Every mapped sample has the same shapes, so a batch is ``np.stack``. The
loader is a producer thread that maps the samples of each batch on a small
thread pool (the warp is PyTorch, which releases the GIL) and keeps
``DATALOADER.PREFETCH`` batches ready while the card computes. Over a
finite index stream (the test loader's) the last batch may be short, and
the iterator ends after it.
"""

import itertools
import logging
import os
import pickle
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np

from ..config import CfgNode
from ..structures import BoxMode
from .catalog import DatasetCatalog
from .dataset_mapper import DatasetMapper
from .samplers import InferenceSampler, RepeatFactorTrainingSampler, TrainingSampler

logger = logging.getLogger(__name__)

__all__ = ["build_detection_test_loader", "build_detection_train_loader", "get_detection_dataset_dicts",
           "load_proposals_into_dataset"]


def _has_annotations(d: dict) -> bool:
    return any(a.get("iscrowd", 0) == 0 for a in d.get("annotations", []))


def load_proposals_into_dataset(dataset_dicts: List[dict], proposal_file: str) -> List[dict]:
    """Attach precomputed proposals to the dataset dicts (JAX
    ``data/build.py:48-88``; reference ``build.py:102-155``).

    The pickle holds ``ids`` (image ids), ``boxes`` (a list of (N, 4)
    arrays), ``objectness_logits`` (a list of (N,) arrays) and optionally
    ``bbox_mode`` (XYXY_ABS when absent); Detectron1 files name the first and
    the third ``indexes`` and ``scores``. A record gains ``proposal_boxes``
    (XYXY_ABS, f32), ``proposal_objectness_logits`` (f32) and
    ``proposal_bbox_mode``; an image with no proposals in the file is left
    untouched (the mapper gives it no valid slot)."""
    logger.info("Loading proposals from: %s", proposal_file)
    with open(proposal_file, "rb") as f:
        proposals = pickle.load(f, encoding="latin1")
    for old, new in {"indexes": "ids", "scores": "objectness_logits"}.items():
        if old in proposals:
            proposals[new] = proposals.pop(old)
    img_ids = {str(record["image_id"]) for record in dataset_dicts}
    id_to_index = {str(pid): i for i, pid in enumerate(proposals["ids"]) if str(pid) in img_ids}
    bbox_mode = BoxMode(proposals["bbox_mode"]) if "bbox_mode" in proposals else BoxMode.XYXY_ABS
    for record in dataset_dicts:
        i = id_to_index.get(str(record["image_id"]))
        if i is None:
            continue
        boxes = np.asarray(proposals["boxes"][i], np.float32).reshape(-1, 4)
        record["proposal_boxes"] = BoxMode.convert(boxes, bbox_mode, BoxMode.XYXY_ABS).astype(np.float32)
        record["proposal_objectness_logits"] = np.asarray(proposals["objectness_logits"][i], np.float32)
        record["proposal_bbox_mode"] = BoxMode.XYXY_ABS
    return dataset_dicts


def get_detection_dataset_dicts(dataset_names, filter_empty: bool = True, proposal_files=None) -> List[dict]:
    """Load and concatenate registered datasets, dropping images without a
    usable annotation when ``filter_empty``. ``proposal_files`` (one per
    dataset) attaches precomputed proposals to each dataset first (the
    ``MODEL.LOAD_PROPOSALS`` workflow)."""
    if isinstance(dataset_names, str):
        dataset_names = [dataset_names]
    if not dataset_names:
        raise ValueError("no dataset named")
    if proposal_files and len(proposal_files) != len(dataset_names):
        raise ValueError(f"{len(proposal_files)} proposal files for {len(dataset_names)} datasets")
    dataset_dicts = []
    for i, name in enumerate(dataset_names):
        dicts = DatasetCatalog.get(name)
        if not dicts:
            raise ValueError(f"Dataset '{name}' is empty!")
        if proposal_files:
            dicts = load_proposals_into_dataset(dicts, proposal_files[i])
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
    """Arrays stacked; a host value (``image_id``, as the dataset gave it:
    an int, or a string such as VOC's "000005") as a list."""
    return {k: np.stack([s[k] for s in samples]) if isinstance(samples[0][k], (np.ndarray, np.generic))
            else [s[k] for s in samples] for k in samples[0]}


class PrefetchIterator:
    """Threaded map + batch + prefetch over an index stream. Sample ``pos``
    of the stream is mapped with ``RandomState(seed + pos)`` (a train
    mapper's; an eval mapper, ``is_train`` False, draws nothing and gets
    None), so the batches do not depend on the thread count. ``sampler`` is
    the index stream it was given. ``close()`` stops the producer; a
    mapper's exception comes out of ``next()``."""

    def __init__(self, dataset: List[dict], indices: Iterable[int], mapper: Callable,
                 batch_size: int, num_workers: int, prefetch: int, seed: int) -> None:
        self._dataset = dataset
        self.sampler = indices
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
        draws = getattr(self._mapper, "is_train", True)
        rng = np.random.RandomState((self._seed + pos) % (2 ** 31)) if draws else None
        return self._mapper(self._dataset[idx], rng=rng)

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
                    if not chunk:
                        return
                    if not self._put(_stack_batch(list(pool.map(self._map_one, chunk)))):
                        return
                    if len(chunk) < self._batch_size:
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
    ``DATASETS.TRAIN``, shuffled by ``DATALOADER.SAMPLER_TRAIN``
    (``TrainingSampler``, or ``RepeatFactorTrainingSampler`` at
    ``DATALOADER.REPEAT_THRESHOLD``) seeded from ``cfg.SEED`` (2026 when it
    is not positive, as in JAX), with the proposals of
    ``DATASETS.PROPOSAL_FILES_TRAIN`` under ``MODEL.LOAD_PROPOSALS``."""
    dataset_dicts = get_detection_dataset_dicts(
        cfg.DATASETS.TRAIN, filter_empty=cfg.DATALOADER.FILTER_EMPTY_ANNOTATIONS,
        proposal_files=cfg.DATASETS.PROPOSAL_FILES_TRAIN if cfg.MODEL.LOAD_PROPOSALS else None)
    seed = cfg.SEED if cfg.SEED > 0 else 2026
    sampler_name = cfg.DATALOADER.SAMPLER_TRAIN
    if sampler_name == "TrainingSampler":
        sampler = TrainingSampler(len(dataset_dicts), seed=seed)
    elif sampler_name == "RepeatFactorTrainingSampler":
        sampler = RepeatFactorTrainingSampler(dataset_dicts, cfg.DATALOADER.REPEAT_THRESHOLD, seed=seed)
    else:
        raise ValueError(f"Unknown training sampler: {sampler_name}")
    return PrefetchIterator(
        dataset_dicts, sampler,
        mapper or DatasetMapper(cfg, is_train=True), int(cfg.SOLVER.IMS_PER_BATCH),
        num_workers=cfg.DATALOADER.NUM_WORKERS, prefetch=cfg.DATALOADER.PREFETCH, seed=seed,
    )


def build_detection_test_loader(cfg: CfgNode, dataset_name: str,
                                mapper: Optional[Callable] = None) -> PrefetchIterator:
    """Finite eval loader over every image of ``dataset_name``, in order,
    ``TEST.BATCH_SIZE`` images per batch, the last batch as short as it
    comes (reference ``build.py:358-403``); images without annotations stay.
    Under ``MODEL.LOAD_PROPOSALS`` the dataset's file of
    ``DATASETS.PROPOSAL_FILES_TEST`` (its position in ``DATASETS.TEST``)
    gives the proposals."""
    proposal_files = None
    if cfg.MODEL.LOAD_PROPOSALS:
        proposal_files = [cfg.DATASETS.PROPOSAL_FILES_TEST[list(cfg.DATASETS.TEST).index(dataset_name)]]
    dataset_dicts = get_detection_dataset_dicts([dataset_name], filter_empty=False, proposal_files=proposal_files)
    return PrefetchIterator(
        dataset_dicts, InferenceSampler(len(dataset_dicts)),
        mapper or DatasetMapper(cfg, is_train=False), max(1, int(cfg.TEST.BATCH_SIZE)),
        num_workers=cfg.DATALOADER.NUM_WORKERS, prefetch=cfg.DATALOADER.PREFETCH, seed=0,
    )
