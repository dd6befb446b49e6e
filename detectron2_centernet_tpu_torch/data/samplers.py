"""Index samplers (counterpart of the JAX package's ``data/samplers.py``,
the reference's contract): ``TrainingSampler``, an infinite stream of
shuffled indices sharded ``rank::world_size``, and ``InferenceSampler``,
every index once, in order, a contiguous shard per rank. The port runs on
one card, so rank and world size are arguments (0 and 1 by default)."""

import itertools
from typing import Iterator

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
