"""Index samplers (counterpart of the JAX package's ``data/samplers.py``,
the reference's contract): ``TrainingSampler``, an infinite stream of
shuffled indices sharded ``rank::world_size``; ``RepeatFactorTrainingSampler``,
the same stream with each image repeated by its rarest category's factor
(LVIS); and ``InferenceSampler``, every index once, in order, a contiguous
shard per rank. The port runs on one card, so rank and world size are
arguments (0 and 1 by default)."""

import itertools
import math
from collections import defaultdict
from typing import Iterator, List

import numpy as np


class TrainingSampler:
    def __init__(self, size: int, shuffle: bool = True, seed: int = 0,
                 rank: int = 0, world_size: int = 1) -> None:
        if size <= 0:
            raise ValueError(f"a sampler needs a non-empty dataset, got size {size}")
        self._size = size
        self._shuffle = shuffle
        self._seed = int(seed)
        self._rank = rank
        self._world_size = world_size

    def __iter__(self) -> Iterator[int]:
        yield from itertools.islice(self._infinite_indices(), self._rank, None, self._world_size)

    def _infinite_indices(self) -> Iterator[int]:
        rng = np.random.RandomState(self._seed)
        while True:
            if self._shuffle:
                yield from rng.permutation(self._size).tolist()
            else:
                yield from range(self._size)


class RepeatFactorTrainingSampler(TrainingSampler):
    """Repeat the images with rare categories (reference
    ``distributed_sampler.py:57-170``; JAX ``samplers.py:42-76``, draw for
    draw): a category in a fraction f of the images has the factor
    max(1, sqrt(``repeat_thresh`` / f)), an image its categories' largest (1
    without any). Each epoch an image appears trunc(r) times, once more with
    probability frac(r) (one uniform per image), and the epoch is shuffled;
    both draws come from one ``RandomState(seed)``."""

    def __init__(self, dataset_dicts: List[dict], repeat_thresh: float, shuffle: bool = True, seed: int = 0,
                 rank: int = 0, world_size: int = 1) -> None:
        category_freq: dict = defaultdict(int)
        for d in dataset_dicts:
            for c in {a["category_id"] for a in d.get("annotations", [])}:
                category_freq[c] += 1
        num_images = len(dataset_dicts)
        category_rep = {c: max(1.0, math.sqrt(repeat_thresh / (n / num_images))) for c, n in category_freq.items()}
        self.repeat_factors = np.asarray(
            [max({category_rep[a["category_id"]] for a in d.get("annotations", [])}, default=1.0)
             for d in dataset_dicts], np.float64)
        self._int_part = np.trunc(self.repeat_factors)
        self._frac_part = self.repeat_factors - self._int_part
        super().__init__(num_images, shuffle=shuffle, seed=seed, rank=rank, world_size=world_size)

    def _infinite_indices(self) -> Iterator[int]:
        rng = np.random.RandomState(self._seed)
        while True:
            rands = rng.rand(len(self._frac_part))
            rep = (self._int_part + (rands < self._frac_part)).astype(np.int64)
            indices = np.repeat(np.arange(len(rep)), rep)
            if self._shuffle:
                indices = rng.permutation(indices)
            yield from indices.tolist()


class InferenceSampler:
    """A contiguous shard of ``range(size)`` per rank covering every index
    once (reference ``samplers.py:173-200``)."""

    def __init__(self, size: int, rank: int = 0, world_size: int = 1) -> None:
        shard_size = (size - 1) // world_size + 1
        begin = min(shard_size * rank, size)
        end = min(shard_size * (rank + 1), size)
        self._local_indices = range(begin, end)

    def __iter__(self) -> Iterator[int]:
        yield from self._local_indices

    def __len__(self) -> int:
        return len(self._local_indices)
