"""The training index sampler (counterpart of the JAX package's
``data/samplers.py::TrainingSampler``, the reference's contract): an infinite
stream of shuffled indices, sharded ``rank::world_size``. The port trains on
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
