"""Out-of-memory resilience (counterpart of the JAX package's
``utils/memory.py``; reference ``detectron2/utils/memory.py``,
``retry_if_cuda_oom``).

``retry_if_oom`` is an opt-in decorator: a call that runs out of device
memory (``torch.cuda.OutOfMemoryError``) is retried once after
``torch.cuda.empty_cache()``, with a logged warning; a second
out-of-memory error is raised. Unlike the JAX package's and the
reference's, it never moves the call to the CPU: the port runs a kernel's
plain version only on tensors its caller put on the CPU. No entry point,
predictor, trainer or kernel wrapper of the port uses it.
"""

import functools
import logging
from typing import Callable

import torch

logger = logging.getLogger(__name__)

__all__ = ["retry_if_oom"]


def retry_if_oom(func: Callable) -> Callable:
    """``func``, retried once with the allocator's cache emptied after an
    out-of-memory error on the card."""

    @functools.wraps(func)
    def wrapped(*args, **kwargs):
        try:
            return func(*args, **kwargs)
        except torch.cuda.OutOfMemoryError:
            pass
        logger.warning("Out of device memory in %s; emptying the cache and retrying", func.__name__)
        torch.cuda.empty_cache()
        return func(*args, **kwargs)

    return wrapped
