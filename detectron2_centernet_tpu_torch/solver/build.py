"""Optimizer and LR schedule from a config (counterpart of the JAX package's
``solver/build.py``; the reference's ``build_optimizer`` and
``maybe_add_gradient_clipping``).

Parameters fall into three groups, as in JAX: ``norm`` (the affine of a
normalization layer, decay ``WEIGHT_DECAY_NORM``), ``bias`` (decay
``WEIGHT_DECAY_BIAS``, LR times ``BIAS_LR_FACTOR``) and ``default``. JAX
groups by pytree path (a ``scale`` leaf, or a ``bn``/``norm`` parent); the
port groups by module type, since a BatchNorm here is ``….1.weight`` of a
Sequential. SGD with momentum, or Adam, both with L2 added to the gradient
before the update (torch's ``weight_decay``, optax's ``add_decayed_weights``
before ``sgd``/``adam``). Clipping (value or global norm) runs in a step
pre-hook of the optimizer, before the decay, as optax chains it first.
"""

from typing import Callable, Dict, List

import torch
import torch.nn as nn

from ..config import CfgNode
from .lr_scheduler import warmup_cosine_lr, warmup_multistep_lr, warmup_poly_lr

__all__ = ["build_lr_scheduler", "build_optimizer", "param_group_labels"]

_NORM_TYPES = (nn.modules.batchnorm._NormBase, nn.GroupNorm, nn.LayerNorm)


def param_group_labels(model: nn.Module) -> Dict[str, str]:
    """{parameter name: "norm" | "bias" | "default"} by the owning module's
    type and the parameter's name."""
    labels = {}
    for mod_name, module in model.named_modules():
        for name, _ in module.named_parameters(recurse=False):
            full = f"{mod_name}.{name}" if mod_name else name
            if isinstance(module, _NORM_TYPES):
                labels[full] = "norm"
            elif name == "bias":
                labels[full] = "bias"
            else:
                labels[full] = "default"
    return labels


def build_lr_scheduler(cfg: CfgNode) -> Callable[[int], float]:
    """The ``step -> lr`` schedule named by ``SOLVER.LR_SCHEDULER_NAME``."""
    s = cfg.SOLVER
    warmup = dict(warmup_factor=s.WARMUP_FACTOR, warmup_iters=s.WARMUP_ITERS,
                  warmup_method=s.WARMUP_METHOD)
    if s.LR_SCHEDULER_NAME == "WarmupMultiStepLR":
        return warmup_multistep_lr(s.BASE_LR, s.STEPS, gamma=s.GAMMA, **warmup)
    if s.LR_SCHEDULER_NAME == "WarmupCosineLR":
        return warmup_cosine_lr(s.BASE_LR, s.MAX_ITER, **warmup)
    if s.LR_SCHEDULER_NAME == "WarmupPolyLR":
        return warmup_poly_lr(s.BASE_LR, s.MAX_ITER, power=s.POLY_LR_POWER,
                              constant_ending=s.POLY_LR_CONSTANT_ENDING, **warmup)
    raise ValueError(f"Unknown LR scheduler: {s.LR_SCHEDULER_NAME}")


def _clipper(clip: CfgNode) -> Callable:
    """An optimizer step pre-hook clipping every gradient by value (each
    element into ±CLIP_VALUE, ``optax.clip``) or by global norm
    (``optax.clip_by_global_norm``: scaled by CLIP_VALUE / norm when the L2
    norm of all gradients exceeds CLIP_VALUE)."""
    if clip.CLIP_TYPE not in ("value", "norm"):
        raise ValueError(f"Unknown clip type: {clip.CLIP_TYPE}")
    limit = float(clip.CLIP_VALUE)

    def hook(optimizer, args, kwargs):
        grads = [p.grad for group in optimizer.param_groups for p in group["params"]
                 if p.grad is not None]
        if not grads:
            return
        if clip.CLIP_TYPE == "value":
            torch._foreach_clamp_min_(grads, -limit)
            torch._foreach_clamp_max_(grads, limit)
            return
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(norm < limit, torch.ones_like(norm), limit / norm)
        torch._foreach_mul_(grads, scale)

    return hook


def build_optimizer(cfg: CfgNode, model: nn.Module):
    """(optimizer, LambdaLR scheduler): per-group decay and LR factor,
    ``SOLVER.OPTIMIZER`` SGD (momentum, nesterov) or ADAM, gradient clipping
    when ``SOLVER.CLIP_GRADIENTS.ENABLED``. Step the scheduler once after
    every optimizer step: update ``t`` then uses ``schedule(t)``."""
    s = cfg.SOLVER
    labels = param_group_labels(model)
    named = dict(model.named_parameters())
    settings = {
        "default": (1.0, s.WEIGHT_DECAY),
        "norm": (1.0, s.WEIGHT_DECAY_NORM),
        "bias": (s.BIAS_LR_FACTOR, s.WEIGHT_DECAY_BIAS),
    }
    groups: List[dict] = []
    for label, (lr_factor, decay) in settings.items():
        params = [named[k] for k, v in labels.items() if v == label and named[k].requires_grad]
        if params:
            groups.append({"params": params, "lr": s.BASE_LR * lr_factor,
                           "weight_decay": decay, "name": label})
    if s.OPTIMIZER.upper() == "ADAM":
        optimizer = torch.optim.Adam(groups, lr=s.BASE_LR)
    else:
        optimizer = torch.optim.SGD(groups, lr=s.BASE_LR, momentum=s.MOMENTUM, nesterov=s.NESTEROV)
    if s.CLIP_GRADIENTS.ENABLED:
        optimizer.register_step_pre_hook(_clipper(s.CLIP_GRADIENTS))
    schedule = build_lr_scheduler(cfg)
    base = float(s.BASE_LR)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: schedule(step) / base if base else 0.0)
    return optimizer, scheduler
