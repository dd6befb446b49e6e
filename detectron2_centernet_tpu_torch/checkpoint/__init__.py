from .checkpointer import Checkpointer, PeriodicCheckpointer
from .from_jax import canonical_dla_key, canonical_key, state_dict_from_jax, torch_key

__all__ = [
    "Checkpointer",
    "PeriodicCheckpointer",
    "canonical_dla_key",
    "canonical_key",
    "state_dict_from_jax",
    "torch_key",
]
