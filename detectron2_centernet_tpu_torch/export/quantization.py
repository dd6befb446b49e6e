"""Post-training quantization (counterpart of the JAX package's
``export/quantization.py``; the reference's TensorRT fp16 / int8
engines, ``detectron2/export/tensorrt.py``).

* **int8 weights** (``quantize_variables`` / ``dequantize_variables``):
  per-output-channel symmetric int8 of every conv and dense kernel of the
  network's state dict, the leaves the JAX package quantizes: a flax
  ``kernel`` or ``weight`` of 2 or more dimensions and at least 64 values
  (the deformable trunk's ``conv2_kernel`` is not one). The channel is the
  JAX leaf's last axis (``checkpoint/from_jax.py::jax_last_axis``: axis 0 of
  a conv, a dense layer or the depthwise ``up_*`` kernel, axis 1 of a
  transposed conv), so the int8 values and scales are JAX's key for key.
  Rounding is half to even, as numpy's ``rint``. Serving loads the
  dequantized weights into the network, which runs through the same
  kernels: there is no int8 compute kernel, in either package.
* **activation ranges** (``calibrate_activations``): every module's output
  |max| over a calibration batch, recorded with forward hooks (JAX: flax's
  ``capture_intermediates``), under the module's name.
* **the accuracy gate** (``quantization_error``): the largest deviation,
  relative to each map's |max|, of the raw maps the decode reads under the
  int8 weights against the original ones.
"""

import logging
from collections import OrderedDict
from typing import Any, Dict, Optional

import torch

from ..checkpoint.from_jax import canonical_key, jax_last_axis, key_options

logger = logging.getLogger(__name__)

__all__ = ["calibrate_activations", "dequantize_variables", "quantization_error", "quantize_variables"]

_MIN_QUANT_SIZE = 64  # leave tiny tensors (biases, norm parameters) untouched


def _quantized_keys(model: torch.nn.Module, state: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """{state-dict key: its channel axis} of the leaves the JAX package
    quantizes."""
    options = key_options(model)
    out = {}
    for key, t in state.items():
        path = canonical_key(key, **options)
        if (path is not None and path.split("/")[-1] in ("kernel", "weight") and t.dim() >= 2
                and t.numel() >= _MIN_QUANT_SIZE and t.is_floating_point()):
            out[key] = jax_last_axis(key, t.dim())
    return out


def quantize_variables(model: torch.nn.Module, state_dict: Optional[Dict[str, torch.Tensor]] = None
                       ) -> Dict[str, Any]:
    """Per-output-channel symmetric int8 quantization of the conv and dense
    kernels of ``model``'s state dict (or of ``state_dict``, the network's
    keys). Returns ``{"tree": OrderedDict}``: a quantized entry is
    ``{"q": int8 tensor, "scale": f32 (channels,), "axis": channel axis}``,
    every other entry passes through; all on the CPU."""
    state = model.state_dict() if state_dict is None else state_dict
    axes = _quantized_keys(model, state)
    tree = OrderedDict()
    for key, t in state.items():
        t = t.detach().cpu()
        if key not in axes:
            tree[key] = t.clone()
            continue
        axis = axes[key]
        flat = t.float().movedim(axis, 0).reshape(t.shape[axis], -1)  # (channels, the rest)
        scale = flat.abs().amax(dim=1) / 127.0
        scale = torch.where(scale == 0, torch.ones_like(scale), scale)
        q = torch.clamp(torch.round(flat / scale[:, None]), -127, 127).to(torch.int8)
        moved = list(t.shape)
        moved.insert(0, moved.pop(axis))
        tree[key] = {"q": q.reshape(moved).movedim(0, axis).contiguous(), "scale": scale, "axis": axis}
    logger.info("quantized %d kernels to int8", len(axes))
    return {"tree": tree}


def dequantize_variables(packed: Dict[str, Any], dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The inverse of ``quantize_variables``: a state dict with each
    quantized kernel ``q · scale`` in ``dtype`` (f32 by default)."""
    out = OrderedDict()
    for key, leaf in packed["tree"].items():
        if isinstance(leaf, dict):
            shape = [1] * leaf["q"].dim()
            shape[leaf["axis"]] = -1
            leaf = (leaf["q"].to(torch.float32) * leaf["scale"].view(shape)).to(dtype)
        out[key] = leaf
    return out


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def calibrate_activations(meta_arch, images) -> Dict[str, float]:
    """The TensorRT calibrator's counterpart: one forward of the network on
    ``images`` ((N, 3, H, W) 0..255), the largest |value| of every module's
    output (its tensors, through tuples, lists and dicts) under the module's
    name, "" for the network itself."""
    ranges: Dict[str, float] = {}

    def record(name):
        def hook(module, inputs, output):
            values = [float(t.detach().abs().max()) for t in _leaves(output) if t.numel()]
            if values:
                ranges[name] = max(ranges.get(name, 0.0), *values)
        return hook

    net = meta_arch.model
    handles = [m.register_forward_hook(record(name)) for name, m in net.named_modules()]
    try:
        with torch.no_grad():
            net(meta_arch.normalize(torch.as_tensor(images)))
    finally:
        for h in handles:
            h.remove()
    return ranges


def quantization_error(meta_arch, images) -> Dict[str, float]:
    """The deploy-time accuracy gate: the network's raw outputs on
    ``images`` (the maps the decode reads; decoded top-k outputs reorder
    under tiny changes) under the int8 weights against the original ones,
    ``{"output_max_rel_err": max over the output maps of max|a - b| /
    max|a|}``. The network gets its weights back."""
    net = meta_arch.model
    original = OrderedDict((k, v.detach().clone()) for k, v in net.state_dict().items())
    x = meta_arch.normalize(torch.as_tensor(images))
    with torch.no_grad():
        ref = [t.float().clone() for t in _leaves(net(x))]
        net.load_state_dict(dequantize_variables(quantize_variables(net, original)))
        try:
            got = [t.float() for t in _leaves(net(x))]
        finally:
            net.load_state_dict(original)
    worst = 0.0
    for a, b in zip(ref, got):
        denom = max(float(a.abs().max()), 1e-6)
        worst = max(worst, float((a - b).abs().max()) / denom)
    return {"output_max_rel_err": worst}
