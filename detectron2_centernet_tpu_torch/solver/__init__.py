from .build import build_lr_scheduler, build_optimizer, param_group_labels
from .lr_scheduler import warmup_cosine_lr, warmup_multistep_lr, warmup_poly_lr

__all__ = [
    "build_lr_scheduler",
    "build_optimizer",
    "param_group_labels",
    "warmup_cosine_lr",
    "warmup_multistep_lr",
    "warmup_poly_lr",
]
