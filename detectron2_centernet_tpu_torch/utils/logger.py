"""Logging setup (counterpart of the JAX package's ``utils/logger.py``; the
reference's ``detectron2/utils/logger.py``)."""

import functools
import logging
import os
import sys
from typing import Optional

__all__ = ["setup_logger"]


@functools.lru_cache()
def setup_logger(output: Optional[str] = None, distributed_rank: int = 0, *,
                 name: str = "detectron2_centernet_tpu_torch") -> logging.Logger:
    """The logger ``name`` at DEBUG, not propagating: on rank 0 a handler
    to stdout, and when ``output`` is given a file handler on
    ``output/log.txt`` (or ``output`` itself when it ends in .txt or .log;
    ``.rank{N}`` appended on rank N > 0). Cached: a second call with the
    same arguments returns the same logger and adds no handler."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    formatter = logging.Formatter("[%(asctime)s] %(name)s %(levelname)s: %(message)s",
                                  datefmt="%m/%d %H:%M:%S")
    if distributed_rank == 0:
        ch = logging.StreamHandler(stream=sys.stdout)
        ch.setLevel(logging.DEBUG)
        ch.setFormatter(formatter)
        logger.addHandler(ch)
    if output:
        filename = output if output.endswith((".txt", ".log")) else os.path.join(output, "log.txt")
        if distributed_rank > 0:
            filename = filename + f".rank{distributed_rank}"
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        fh = logging.FileHandler(filename)
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    return logger
