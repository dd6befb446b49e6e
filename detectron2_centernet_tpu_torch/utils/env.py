"""Seeding (counterpart of the JAX package's ``utils/env.py``; the
reference's ``detectron2/utils/env.py``)."""

import datetime
import logging
import os
import random
from typing import Optional

import numpy as np
import torch

__all__ = ["seed_all_rng"]


def seed_all_rng(seed: Optional[int] = None) -> int:
    """Seed Python's ``random``, numpy's global generator and torch's
    (``torch.manual_seed``, every device); a seed made from the pid, the
    clock and the OS when ``seed`` is None. Returns the seed used."""
    if seed is None:
        seed = (os.getpid() + int(datetime.datetime.now().strftime("%S%f"))
                + int.from_bytes(os.urandom(2), "big"))
        logging.getLogger(__name__).info("Using a generated random seed %d", seed)
    np.random.seed(seed % 2 ** 31)
    random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return seed
