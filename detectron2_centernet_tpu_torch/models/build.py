"""Model factory (counterpart of the JAX package's ``models/build.py``)."""

import torch

from ..config import CfgNode
from .registry import META_ARCH_REGISTRY


def resolve_device(name: str) -> torch.device:
    """The device ``cfg.MODEL.DEVICE`` names. A CUDA device that is not there
    raises: the port never falls back to the CPU unless asked to."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"MODEL.DEVICE is {name!r} but no CUDA device is available; "
            "set MODEL.DEVICE=cpu to run on the CPU"
        )
    return device


def build_model(cfg: CfgNode):
    """Instantiate the meta-architecture named by ``MODEL.META_ARCHITECTURE``
    on ``cfg.MODEL.DEVICE``, with weights drawn from ``cfg.SEED`` (0 when
    negative)."""
    return META_ARCH_REGISTRY.get(cfg.MODEL.META_ARCHITECTURE)(cfg)
