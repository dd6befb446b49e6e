"""``MODEL.WEIGHTS`` from a reference ``.pth`` or ``.pkl`` that is not the
port's own checkpoint: a copy of the JAX package's
``checkpoint/torch_import.py`` and ``checkpoint/dla_import.py`` (the
reference's ``align_and_update_state_dicts``), so that both packages pair
the same tensors with the same leaves.

The JAX package aligns the file's tensors, in its layout
(``convert_torch_tensor``; the fc after a flatten permuted to NHWC), with
its flax leaves by shape and name: DLA checkpoints through the exact name
map, the CenterNet deconv neck by position, the rest by the longest common
token suffix (letter/digit tokens, norm synonyms, Sequential indices
renumbered densely), then the shared tokens and, last, the leaves' relative
positions in the flax order. A leaf nothing matches keeps its init.

The port runs the same alignment over the flax names of its own keys
(``from_jax.canonical_key``) with each leaf's shape in the JAX layout,
listed in the JAX flatten's order (dict keys sorted at every level), then
brings each matched array back to its key's layout
(``from_jax.port_layout``): for a reference file that is the file's own
tensor, transposed and flipped twice. The JAX package aligns a
``TrainState``'s ``params`` and ``batch_stats`` separately (its trainer's
path, ``load_torch_weights`` :402-406) and a variables tree once, under
``params/`` and ``batch_stats/`` (its predictor's); ``load_torch_weights``
takes either (``per_collection``).
"""

import logging
import pickle
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .from_jax import canonical_dla_key, canonical_key, jax_shape, key_options, port_layout

logger = logging.getLogger(__name__)

__all__ = ["align_state_dicts", "convert_torch_tensor", "flax_leaves", "load_model_weights", "load_torch_state_dict",
           "load_torch_weights", "own_checkpoint", "read_checkpoint"]


def read_checkpoint(path: str):
    """A ``.pkl`` through pickle (latin-1, as Python 2's pickles need), any
    other file through ``torch.load``, as the JAX package reads them."""
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            return pickle.load(f, encoding="latin1")
    return torch.load(path, map_location="cpu", weights_only=False)


def load_torch_state_dict(path: str, data=None) -> Dict[str, np.ndarray]:
    """A ``.pth`` or ``.pkl`` (``read_checkpoint``; ``data`` if it was read
    already) as {name: ndarray}, unwrapped from "model", then "state_dict"
    (JAX ``:33-52``); entries that are not arrays are dropped."""
    if data is None:
        data = read_checkpoint(path)
    if isinstance(data, dict) and "model" in data:
        data = data["model"]
    if isinstance(data, dict) and "state_dict" in data:
        data = data["state_dict"]
    out = {}
    for k, v in data.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        if isinstance(v, np.ndarray):
            out[k] = v
    return out


def convert_torch_tensor(name: str, arr: np.ndarray) -> np.ndarray:
    """Torch layout → the JAX package's, keyed on the name (JAX ``:55-87``):
    a depthwise ``up*``/``deconv`` kernel (C, 1, kh, kw) and a dense
    ``deconv`` (I, O, kh, kw) flipped and to (kh, kw, 1, C) / (kh, kw, I, O);
    any other 4-d OIHW → HWIO; 2-d transposed."""
    if arr.ndim == 4:
        d0, d1 = arr.shape[:2]
        segs = name.split(".")
        owner = segs[-2] if len(segs) >= 2 else ""
        if name.endswith("weight"):
            if ("deconv" in name or owner.startswith("up")) and d1 == 1 and d0 > 1:
                return np.ascontiguousarray(np.transpose(arr[:, :, ::-1, ::-1], (2, 3, 1, 0)))
            if "deconv" in name:
                return np.ascontiguousarray(np.transpose(arr[:, :, ::-1, ::-1], (2, 3, 0, 1)))
        return np.transpose(arr, (2, 3, 1, 0))
    if arr.ndim == 2:
        return arr.T
    return arr


_SKIP_SUFFIXES = ("num_batches_tracked",)


def _flatten_boundary_channels(torch_sd: Dict[str, np.ndarray]) -> Dict[str, int]:
    """The fc weights that read a flattened conv map, found from the state
    dict's order, with that map's width (JAX ``:93-143``): the first 2-d
    weight after a 4-d one, its width the newest 4-d output count that makes
    its input a square, then its same-shaped siblings that differ only in
    numeric segments (Cascade's stages)."""
    out: Dict[str, int] = {}
    last_w_ndim = 0
    couts: List[int] = []
    for k, v in torch_sd.items():
        if not k.endswith("weight") or v.ndim not in (2, 4):
            continue
        if v.ndim == 2 and last_w_ndim == 4:
            for c in reversed(couts):
                hw = v.shape[1] // c if c and v.shape[1] % c == 0 else 0
                side = int(round(hw ** 0.5)) if hw else 0
                if side and side * side == hw:
                    out[k] = c
                    break
        if v.ndim == 4:
            segs = k.split(".")
            owner = segs[-2] if len(segs) >= 2 else ""
            couts.append(v.shape[1] if "deconv" in k or owner.startswith("up") else v.shape[0])
        last_w_ndim = v.ndim

    def depattern(key: str) -> str:
        return re.sub(r"(^|\.)\d+(\.|$)", r"\1#\2", key)

    flagged = {depattern(k): (c, torch_sd[k].shape) for k, c in out.items()}
    for k, v in torch_sd.items():
        if k in out or not k.endswith("weight") or v.ndim != 2:
            continue
        hit = flagged.get(depattern(k))
        if hit is not None and hit[1] == v.shape:
            out[k] = hit[0]
    return out


def _permute_flattened_fc_t(arr_oi: np.ndarray, c: int) -> np.ndarray:
    """A torch (O, C·H·W) fc weight → the JAX kernel (H·W·C, O)."""
    o, i = arr_oi.shape
    side = int(round((i // c) ** 0.5))
    return arr_oi.reshape(o, c, side, side).transpose(0, 2, 3, 1).reshape(o, i).T


_TOKEN_SYNONYMS = {"kernel": "weight", "scale": "weight", "running": "", "bn": "norm"}


def _token_seq(name: str) -> List[str]:
    """A name's tokens for suffix matching: letters and digits split apart,
    synonyms applied, a repeated word collapsed (JAX ``:179-191``)."""
    out = []
    for t in re.findall(r"[a-z]+|\d+", name.lower()):
        t = _TOKEN_SYNONYMS.get(t, t)
        if t and (not out or out[-1] != t or t.isdigit()):
            out.append(t)
    return out


def _renumber_sequential(keys: List[str]) -> Dict[str, str]:
    """Each key with its numeric segments renumbered densely per parent
    (``subnet.{0,2,4}`` → ``subnet.{0,1,2}``; JAX ``:194-220``)."""
    children = defaultdict(set)
    for k in keys:
        parts = k.split(".")
        for i, p in enumerate(parts):
            if p.isdigit():
                children[".".join(parts[:i])].add(int(p))
    rank = {parent: {v: r for r, v in enumerate(sorted(vals))} for parent, vals in children.items()}
    out = {}
    for k in keys:
        parts = k.split(".")
        out[k] = ".".join(str(rank[".".join(parts[:i])][int(p)]) if p.isdigit() else p for i, p in enumerate(parts))
    return out


def _suffix_len(a: List[str], b: List[str]) -> int:
    n = 0
    while n < len(a) and n < len(b) and a[-1 - n] == b[-1 - n]:
        n += 1
    return n


def _looks_like_dla(torch_sd: Dict) -> bool:
    keys = list(torch_sd)
    return any(k.startswith(("base.base_layer", "base_layer")) for k in keys) or any(
        ".ida_0.proj_1." in k for k in keys)


_BN_LEAF = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}


def align_state_dicts(torch_sd: Dict[str, np.ndarray],
                      flax_leaves: List[Tuple[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """{flax name: the file's array in the JAX layout} for every leaf that
    a tensor matches (JAX ``:230-382``, line for line): the DLA name map,
    the deconv neck by position, then shape-checked pairs taken best first
    by (renumbered token suffix, raw suffix, renumbered shared tokens, raw
    shared tokens, relative position), each tensor and leaf used once; a
    pair with no name similarity at all is never made. ``flax_leaves`` are
    (name, array) in the JAX flatten's order; only their shapes are read.
    Logs the match table, the unmatched leaves and the unused tensors."""
    result: Dict[str, np.ndarray] = {}
    used_torch_keys = set()
    if _looks_like_dla(torch_sd):
        canon = {}
        for k, v in torch_sd.items():
            ck = canonical_dla_key(k)
            if ck is not None:
                canon[ck] = (k, v)
        flax_by_name = dict(flax_leaves)
        for ck, (tk, tv) in canon.items():
            coll, body = ck.split("/", 1)
            cands = [fn for fn in flax_by_name if fn == ck or (fn.startswith(coll + "/") and fn.endswith("/" + body))]
            if len(cands) != 1:
                continue
            arr = convert_torch_tensor(tk, tv)
            if arr.shape == flax_by_name[cands[0]].shape:
                result[cands[0]] = arr
                used_torch_keys.add(tk)
        if result:
            logger.info("deterministic DLA name map matched %d/%d leaves", len(result), len(flax_leaves))

    # the CenterNet deconv neck, Sequential [deconv, BN, ReLU] × N, by position
    flax_by_name = dict(flax_leaves)
    for tk, tv in torch_sd.items():
        if tk in used_torch_keys or not tk.startswith("deconv_layers."):
            continue
        parts = tk.split(".")
        stage, role = divmod(int(parts[1]), 3)
        leaf = parts[2]
        if role == 0 and leaf == "weight":
            suffix = f"deconv{stage}/kernel"
        elif role == 1 and leaf in _BN_LEAF:
            suffix = f"deconv{stage}_bn/{_BN_LEAF[leaf]}"
        else:
            continue
        cands = [fn for fn in flax_by_name if fn.endswith("/" + suffix) or fn == suffix]
        if len(cands) != 1 or cands[0] in result:
            continue
        arr = convert_torch_tensor(tk, tv)
        if arr.shape == flax_by_name[cands[0]].shape:
            result[cands[0]] = arr
            used_torch_keys.add(tk)

    remaining = {k: v for k, v in torch_sd.items() if not k.endswith(_SKIP_SUFFIXES) and k not in used_torch_keys}
    renumbered = _renumber_sequential(list(remaining))
    boundary = _flatten_boundary_channels(torch_sd)
    torch_items = [(k, _permute_flattened_fc_t(v, boundary[k]) if k in boundary else convert_torch_tensor(k, v),
                    _token_seq(k), _token_seq(renumbered[k])) for k, v in remaining.items()]
    fl = [(fname, farr, _token_seq(fname)) for fname, farr in flax_leaves if fname not in result]

    pairs = []
    for fi, (fname, farr, fseq) in enumerate(fl):
        for ti, (tname, tarr, tseq, tseq_rn) in enumerate(torch_items):
            if tarr.shape != farr.shape:
                continue
            suf = _suffix_len(fseq, tseq_rn)
            suf_raw = _suffix_len(fseq, tseq)
            overlap = len(set(fseq) & set(tseq_rn))
            overlap_raw = len(set(fseq) & set(tseq))
            if suf == 0 and suf_raw == 0 and max(overlap, overlap_raw) == 0:
                continue
            pos = abs(fi / max(len(fl), 1) - ti / max(len(torch_items), 1))
            pairs.append((-suf, -suf_raw, -overlap, -overlap_raw, pos, fi, ti))
    pairs.sort()

    used_t = [False] * len(torch_items)
    used_f = [False] * len(fl)
    table = []
    for nsuf, _, _, _, _, fi, ti in pairs:
        if used_f[fi] or used_t[ti]:
            continue
        used_f[fi] = used_t[ti] = True
        fname, farr, _ = fl[fi]
        tname, tarr, _, _ = torch_items[ti]
        result[fname] = tarr
        table.append((fname, tname, farr.shape, -nsuf))
    for fname, farr, _ in fl:
        if fname not in result:
            logger.warning("No torch weight matches %s %s", fname, farr.shape)
    for ti, (tn, _, _, _) in enumerate(torch_items):
        if not used_t[ti]:
            logger.info("Torch weight %s unused", tn)
    if table:
        width = max(len(f) for f, *_ in table)
        logger.info("weight match table:\n%s", "\n".join(
            f"  {f:<{width}} <- {t}  {tuple(s)} (suffix {n})" for f, t, s, n in table))
    logger.info("Aligned %d/%d flax leaves from torch checkpoint", len(result), len(flax_leaves))
    return result


def flax_leaves(model: torch.nn.Module) -> List[Tuple[str, str, tuple]]:
    """(flax path, the port's key, the shape in the JAX layout) of every key
    of ``model``'s state dict that the JAX package has as a leaf, in the JAX
    flatten's order: the paths sorted segment by segment."""
    opts = key_options(model)
    out = []
    for key, value in model.state_dict().items():
        path = canonical_key(key, **opts)
        if path is not None:
            out.append((path, key, jax_shape(key, tuple(value.shape))))
    return sorted(out, key=lambda leaf: leaf[0].split("/"))


def load_torch_weights(model: torch.nn.Module, path: str, per_collection: bool, data=None) -> None:
    """Load the matched tensors of ``path`` into ``model`` as the JAX
    package's ``load_torch_weights`` pairs them; every other entry keeps its
    value. ``per_collection``: align ``params`` and ``batch_stats`` apart,
    as JAX does for a ``TrainState`` (the trainer), else the whole tree once
    (the predictor). ``data``: the file's contents, if read already."""
    torch_sd = load_torch_state_dict(path, data)
    leaves = flax_leaves(model)
    shapes = {p: s for p, _, s in leaves}
    zero = np.zeros((), np.float32)
    if per_collection:  # the leaves' names without their collection, as a TrainState's trees flatten
        aligned = {}
        for coll in ("params", "batch_stats"):
            names = [(p.split("/", 1)[1], np.broadcast_to(zero, s)) for p, _, s in leaves
                     if p.startswith(coll + "/")]
            aligned.update({f"{coll}/{n}": a for n, a in align_state_dicts(torch_sd, names).items()})
    else:
        aligned = align_state_dicts(torch_sd, [(p, np.broadcast_to(zero, s)) for p, _, s in leaves])
    state = model.state_dict()
    for p, key, _ in leaves:
        if p in aligned:
            arr = np.ascontiguousarray(port_layout(key, aligned[p], shapes))
            state[key] = torch.from_numpy(arr).reshape(state[key].shape).to(state[key].dtype)
    model.load_state_dict(state)


def _without_counters(keys) -> set:
    return {k for k in keys if not k.endswith("num_batches_tracked")}


def own_checkpoint(model: torch.nn.Module, data) -> Optional[Dict[str, torch.Tensor]]:
    """The state dict in ``data`` (bare, or under "model" or "state_dict";
    a DataParallel "module." prefix dropped) when its keys are exactly
    ``model``'s, counters aside: the port's own checkpoint, or a reference
    file of the same network, which loads strictly. None otherwise."""
    state = data
    for wrapper in ("model", "state_dict"):
        if isinstance(state, dict) and wrapper in state:
            state = state[wrapper]
            break
    if not isinstance(state, dict) or not all(isinstance(v, torch.Tensor) for v in state.values()):
        return None
    state = {k.removeprefix("module."): v for k, v in state.items()}
    return state if _without_counters(state) == _without_counters(model.state_dict()) else None


def load_model_weights(model: torch.nn.Module, path: str, per_collection: bool):
    """``MODEL.WEIGHTS`` into ``model``: a file whose keys are exactly the
    model's loads strictly (``own_checkpoint``); any other ``.pth`` or
    ``.pkl`` through ``load_torch_weights``. Returns the file's contents."""
    data = read_checkpoint(path)
    state = own_checkpoint(model, data)
    if state is not None:
        model.load_state_dict(state)
    else:
        logger.info("%s is not a checkpoint of this network: aligning its tensors by shape and name", path)
        load_torch_weights(model, path, per_collection, data)
    return data
