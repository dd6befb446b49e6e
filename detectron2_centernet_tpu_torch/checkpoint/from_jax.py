"""Weights across from the JAX package: its flax variables tree → the port's
``state_dict``.

The port's module names are the reference fork's torch keys, so one name map
serves both a JAX tree and a reference ``.pth``. ``canonical_dla_key`` is a
copy of the JAX package's ``checkpoint/dla_import.py`` map (torch key → flax
path); ``torch_key`` is its inverse, and ``state_dict_from_jax`` checks every
key it makes against the copy.

Layouts (the rules of the JAX package's ``checkpoint/torch_import.py``, run
the other way):
  * conv kernel HWIO → OIHW;
  * BatchNorm ``scale``/``bias``/``mean``/``var`` → ``weight``/``bias``/
    ``running_mean``/``running_var``;
  * the depthwise ``up_*`` kernel (2f, 2f, 1, C) → (C, 1, 2f, 2f), flipped
    spatially: torch's transposed conv correlates with the reversed kernel.
"""

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

__all__ = ["canonical_dla_key", "state_dict_from_jax", "torch_key"]

_LEAF = {"weight": "kernel", "bias": "bias", "running_mean": "mean", "running_var": "var"}
_BN_LEAF = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}
_HEAD_TASKS = ("hm", "wh", "reg", "id", "dep", "rot", "dim", "amodel_offset")


def canonical_dla_key(key: str) -> Optional[str]:
    """Torch DLA(Seg)/ctdet state-dict key → flax variables path, or None when
    the key has no flax counterpart (``num_batches_tracked``, the ImageNet
    classifier)."""
    parts = key.split(".")
    if parts and parts[0] == "module":  # DataParallel prefix
        parts = parts[1:]
    if not parts:
        return None
    leaf = parts[-1]
    body = parts[:-1]
    if leaf == "num_batches_tracked" or "fc" in body:
        return None

    out = []
    is_bn = False
    i = 0
    while i < len(body):
        tok = body[i]
        nxt = body[i + 1] if i + 1 < len(body) else None
        if tok == "base_layer":
            out += ["base_layer", "conv" if nxt == "0" else "bn"]
            is_bn = nxt == "1"
            i += 2
            continue
        m = re.fullmatch(r"level([01])", tok)
        if m and nxt is not None and nxt.isdigit():
            idx = int(nxt)  # [conv, bn, relu] * reps
            out += [f"level{m.group(1)}_conv{idx // 3}", "conv" if idx % 3 == 0 else "bn"]
            is_bn = idx % 3 == 1
            i += 2
            continue
        m = re.fullmatch(r"(conv|bn)([12])", tok)
        if m:
            out += [f"conv{m.group(2)}", m.group(1)]
            is_bn = m.group(1) == "bn"
            i += 1
            continue
        if tok == "root" and nxt in ("conv", "bn"):
            out += ["root", "conv", nxt]
            is_bn = nxt == "bn"
            i += 2
            continue
        if tok == "project" and nxt in ("0", "1"):
            out += ["project", "conv" if nxt == "0" else "bn"]
            is_bn = nxt == "1"
            i += 2
            continue
        if re.fullmatch(r"(proj|node)_\d+", tok):
            out.append(tok)
            rest = body[i + 1:]
            # DCN wrapper: conv.conv_offset_mask.* → conv_offset_mask/*,
            # conv.weight/bias → kernel/bias, actf.0.* → bn/*
            if rest[:2] == ["conv", "conv_offset_mask"]:
                out.append("conv_offset_mask")
            elif rest[:2] == ["actf", "0"]:
                out.append("bn")
                is_bn = True
            return _finish(out, leaf, is_bn)
        if tok in _HEAD_TASKS and nxt is not None and nxt.isdigit():
            out += ["heads", f"{tok}_tower" if nxt == "0" else f"{tok}_out"]
            i += 2
            continue
        out.append(tok)
        i += 1
    return _finish(out, leaf, is_bn)


def _finish(out, leaf, is_bn) -> Optional[str]:
    table = _BN_LEAF if is_bn else _LEAF
    if leaf not in table:
        return None
    mapped = table[leaf]
    collection = "batch_stats" if mapped in ("mean", "var") and is_bn else "params"
    return "/".join([collection] + out + [mapped])


_FLAX_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight",
              "mean": "running_mean", "var": "running_var"}


def torch_key(path: str) -> str:
    """Flax variables path (``params/backbone/...``) → the port's key."""
    parts = path.split("/")[1:]  # drop the collection
    body, leaf = parts[:-1], parts[-1]
    out = []
    i = 0
    while i < len(body):
        tok = body[i]
        nxt = body[i + 1] if i + 1 < len(body) else None
        m = re.fullmatch(r"level([01])_conv(\d+)", tok)
        if tok in ("base_layer", "project") or m:
            head = f"level{m.group(1)}" if m else tok
            base = 3 * int(m.group(2)) if m else 0
            out += [head, str(base + (0 if nxt == "conv" else 1))]
            i += 2
        elif tok == "root":  # root/conv/{conv,bn}
            out += ["root", body[i + 2]]
            i += 3
        elif re.fullmatch(r"conv[12]", tok) and nxt in ("conv", "bn"):
            out.append(tok if nxt == "conv" else "bn" + tok[-1])
            i += 2
        elif re.fullmatch(r"(proj|node)_\d+", tok):
            out += [tok] + {None: ["conv"], "conv_offset_mask": ["conv", "conv_offset_mask"],
                            "bn": ["actf", "0"]}[nxt]
            i += 1 if nxt is None else 2
        elif tok == "heads":
            task, part = nxt.rsplit("_", 1)
            out += [task, "0" if part == "tower" else "2"]
            i += 2
        else:
            out.append(tok)
            i += 1
    return ".".join(out + [_FLAX_LEAF[leaf]])


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(_flatten(v, path))
        else:
            flat[path] = np.asarray(v)
    return flat


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX ``{'params', 'batch_stats'}`` tree (numpy leaves) as the
    port's ``state_dict``, f32, with ``num_batches_tracked`` = 0 for every
    BatchNorm. Raises if two leaves would share a key or a key does not map
    back to its leaf through ``canonical_dla_key``."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(variables).items():
        key = torch_key(path)
        if canonical_dla_key(key) != path:
            raise ValueError(f"{path} maps to {key}, which maps back to {canonical_dla_key(key)}")
        if key in out:
            raise ValueError(f"two leaves map to {key}")
        arr = np.array(arr, np.float32)  # a writable copy
        if arr.ndim == 4:
            if key.split(".")[-2].startswith("up_"):
                arr = arr[::-1, ::-1]
            arr = np.transpose(arr, (3, 2, 0, 1))  # HWIO → OIHW
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
        if key.endswith(".running_var"):
            out[key[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return out
