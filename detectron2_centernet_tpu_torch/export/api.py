"""Model export (counterpart of the JAX package's ``export/api.py``).

The JAX package serializes its jitted ``predict_fn`` to StableHLO with the
weights baked in. The port's artifact is a ``torch.export`` program: the
meta-architecture's ``predict_fn`` traced at a fixed batch and image size
(non-strict), written with ``torch.export.save`` into one ``.pt2`` file that
holds the graph, the network's parameters and buffers and the constants
(pixel mean and std, anchors). Two functions carry it:

  ``export_program(meta_arch, batch_size, image_size, path)``
  ``load_exported(path) -> ExportedModel`` (callable on (N, 3, H, W) images)

The hand-written kernels on the path are custom ops (``torch.ops.d2ct.dcn_fwd``
for K1, ``torch.ops.d2ct.greedy_nms`` for the NMS), so the program records
them as nodes and, loaded, launches the same kernels; importing this module
registers them, which is why ``load_exported`` works in a fresh process.
"""

import logging
import os
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..models.layers import ieee_f32
from ..ops import dcn as _dcn_ops  # noqa: F401  (registers torch.ops.d2ct.dcn_fwd)
from ..ops import nms as _nms_ops  # noqa: F401  (registers torch.ops.d2ct.greedy_nms)

logger = logging.getLogger(__name__)

__all__ = ["ExportedModel", "custom_op_nodes", "export_program", "load_exported"]


class PredictModule(torch.nn.Module):
    """``meta_arch.predict_fn`` as a module to trace: the network
    (``meta_arch.model``) is its submodule, so its parameters and buffers
    become the program's state. ``predict_fn`` runs without its
    ``inference_mode`` decorator, under ``no_grad``: export traces grad
    mode, not inference tensors."""

    def __init__(self, meta_arch) -> None:
        super().__init__()
        self.model = meta_arch.model
        self._meta_arch = (meta_arch,)  # a tuple: not registered as a submodule
        fn = type(meta_arch).predict_fn
        self._predict = getattr(fn, "__wrapped__", fn)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            return self._predict(self._meta_arch[0], images)


def export_program(
    meta_arch,
    batch_size: int = 1,
    image_size: Tuple[int, int] = (512, 512),
    path: Optional[str] = None,
) -> torch.export.ExportedProgram:
    """Trace ``meta_arch.predict_fn`` on (batch_size, 3, H, W) f32 images on
    the model's device with ``torch.export.export`` (non-strict), after one
    eager call on the same images, and, when
    ``path`` is given, write it there with ``torch.export.save``. The model
    must be in eval mode; the program keeps its weights."""
    if meta_arch.model.training:
        raise ValueError("export a model in eval mode")
    h, w = image_size
    images = torch.zeros((batch_size, 3, h, w), dtype=torch.float32, device=meta_arch.device)
    # one eager call first: what the meta-architecture caches per size (anchors) is then made of real
    # tensors, which the trace takes as constants; made during the trace, the cache would keep fake ones
    meta_arch.predict_fn(images)
    with torch.no_grad():
        program = torch.export.export(PredictModule(meta_arch), (images,), strict=False)
    program.example_inputs = None  # the artifact would carry the zero images: 50 MB at 16 x 512²
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        torch.export.save(program, path)
        logger.info("Exported a %d-byte torch.export program to %s", os.path.getsize(path), path)
    return program


class ExportedModel:
    """Callable over a loaded (or just exported) program: (N, 3, H, W)
    0..255 images, numpy or a tensor, at the exported batch and size, to
    the ``predict_fn`` dict on the program's device. It runs the program
    under ``no_grad`` and ``models/layers.py::ieee_f32``: cuDNN's flags are
    not graph ops, and without the context the program's f32 convolutions
    would take TF32."""

    def __init__(self, program: torch.export.ExportedProgram) -> None:
        self.program = program
        self._module = program.module()
        spec = program.graph_signature.user_inputs[0]
        example = next(n for n in program.graph.nodes if n.op == "placeholder" and n.name == spec)
        self.input_shape = tuple(example.meta["val"].shape)
        self.device = example.meta["val"].device

    def __call__(self, images: Union[np.ndarray, torch.Tensor]) -> Dict[str, torch.Tensor]:
        x = torch.as_tensor(images).to(self.device, torch.float32)
        if tuple(x.shape) != self.input_shape:
            raise ValueError(f"the program takes {self.input_shape} images, got {tuple(x.shape)}")
        with torch.no_grad(), ieee_f32():
            return self._module(x)


def load_exported(path_or_program: Union[str, os.PathLike, torch.export.ExportedProgram]) -> ExportedModel:
    """An ``ExportedModel`` of a ``.pt2`` file (``torch.export.load``) or of
    a program in memory."""
    if isinstance(path_or_program, torch.export.ExportedProgram):
        return ExportedModel(path_or_program)
    return ExportedModel(torch.export.load(os.fspath(path_or_program)))


def custom_op_nodes(program: torch.export.ExportedProgram) -> Dict[str, int]:
    """{custom op: its nodes} over the program's graph and the subgraphs of
    its higher-order ops (an autocast region is one): which of the port's
    kernels the program launches, and how often a call does."""
    counts: Dict[str, int] = {}

    def walk(gm: torch.fx.GraphModule) -> None:
        for node in gm.graph.nodes:
            name = str(node.target)
            if name.startswith("d2ct."):
                counts[name] = counts.get(name, 0) + 1
        for sub in gm.children():
            if isinstance(sub, torch.fx.GraphModule):
                walk(sub)

    walk(program.graph_module)
    return counts
