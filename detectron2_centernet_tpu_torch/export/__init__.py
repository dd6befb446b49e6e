"""Deployment: the ``torch.export`` artifact and post-training int8
quantization (counterpart of the JAX package's ``export/``)."""

from .api import ExportedModel, custom_op_nodes, export_program, load_exported
from .quantization import calibrate_activations, dequantize_variables, quantization_error, quantize_variables

__all__ = [
    "ExportedModel",
    "calibrate_activations",
    "custom_op_nodes",
    "dequantize_variables",
    "export_program",
    "load_exported",
    "quantization_error",
    "quantize_variables",
]
