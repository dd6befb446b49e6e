"""Model factory (counterpart of the JAX package's ``models/build.py``)."""

import torch

from ..config import CfgNode
from ..ops.photometric import device_color_aug_ssd, device_color_jitter
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
    negative), and attach the batch-level train augmentation of the step, as
    the JAX package's ``build_model`` does for every meta-architecture: when
    the model has none and ``DATALOADER.DEVICE_PHOTOMETRIC`` is on,
    ``INPUT.COLOR_AUG_SSD`` selects the SSD distortion, else
    ``INPUT.COLOR_JITTER`` the color jitter (the port has no host
    photometric pass: with the flag off there is none)."""
    model = META_ARCH_REGISTRY.get(cfg.MODEL.META_ARCHITECTURE)(cfg)
    if getattr(model, "device_augment", None) is None and cfg.DATALOADER.DEVICE_PHOTOMETRIC:
        if cfg.INPUT.COLOR_AUG_SSD:
            model.device_augment = device_color_aug_ssd
        elif cfg.INPUT.COLOR_JITTER:
            model.device_augment = device_color_jitter
    return model
