"""A yacs-compatible configuration node, implemented from scratch.

The reference builds its config system on yacs (``detectron2/config/config.py``):
an attribute-accessible, freezable tree of typed values, merged from YAML files
that may inherit from each other through a ``_BASE_`` key, plus "KEY VALUE"
command-line override pairs.  This module reimplements that contract without a
yacs dependency so reference YAML configs (e.g. ``ctdet_dla_34_1x.yaml``) load
unmodified.

YAML files are read and written by the port's own ``yaml_io`` (the subset of
YAML that configs use), never by PyYAML, so a config file loads wherever the
port runs.
"""

import copy
import os
from ast import literal_eval
from typing import Any, Dict, List

from .yaml_io import dump_yaml, load_yaml

BASE_KEY = "_BASE_"


class CfgNode(dict):
    """Attribute-accessible config tree with freeze semantics.

    Matches the yacs surface the reference relies on: ``clone``, ``freeze``,
    ``defrost``, ``is_frozen``, ``merge_from_file``, ``merge_from_other_cfg``,
    ``merge_from_list``, ``dump``, and ``_BASE_`` file inheritance
    (reference: detectron2/config/config.py:24-66).
    """

    IMMUTABLE = "__immutable__"
    NEW_ALLOWED = "__new_allowed__"

    def __init__(
        self, init_dict: Dict[str, Any] = None, new_allowed: bool = False
    ) -> None:
        init_dict = {} if init_dict is None else init_dict
        super().__init__()
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        # yacs semantics: a new_allowed node accepts unknown keys at merge
        # time (reference DensePose's DATASETS.CATEGORY_MAPS etc.)
        object.__setattr__(self, CfgNode.NEW_ALLOWED, new_allowed)
        for k, v in init_dict.items():
            if isinstance(v, dict) and not isinstance(v, CfgNode):
                v = CfgNode(v)
            super().__setitem__(k, v)

    def is_new_allowed(self) -> bool:
        try:
            return object.__getattribute__(self, CfgNode.NEW_ALLOWED)
        except AttributeError:  # nodes deserialized without the slot
            return False

    # -- attribute access ---------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(
            f"Non-existent config key: {name}. Available: {sorted(self.keys())}"
        )

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(
                f"Attempted to set '{name}' to '{value}', but CfgNode is immutable"
            )
        self[name] = value

    def __setitem__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(
                f"Attempted to set '{name}' to '{value}', but CfgNode is immutable"
            )
        super().__setitem__(name, value)

    # -- freeze semantics ---------------------------------------------------
    def freeze(self) -> None:
        self._set_immutable(True)

    def defrost(self) -> None:
        self._set_immutable(False)

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, CfgNode.IMMUTABLE)

    def _set_immutable(self, flag: bool) -> None:
        object.__setattr__(self, CfgNode.IMMUTABLE, flag)
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(flag)

    # -- cloning / serialization --------------------------------------------
    def clone(self) -> "CfgNode":
        cloned = copy.deepcopy(self)
        cloned._set_immutable(False)
        return cloned

    def __deepcopy__(self, memo) -> "CfgNode":
        cls = self.__class__
        result = cls.__new__(cls)
        object.__setattr__(result, CfgNode.IMMUTABLE, False)
        object.__setattr__(result, CfgNode.NEW_ALLOWED, self.is_new_allowed())
        memo[id(self)] = result
        for k, v in self.items():
            dict.__setitem__(result, copy.deepcopy(k, memo), copy.deepcopy(v, memo))
        object.__setattr__(
            result, CfgNode.IMMUTABLE, object.__getattribute__(self, CfgNode.IMMUTABLE)
        )
        return result

    def _as_plain_dict(self) -> Dict[str, Any]:
        out = {}
        for k, v in self.items():
            out[k] = v._as_plain_dict() if isinstance(v, CfgNode) else v
        return out

    def dump(self) -> str:
        """Serialize to a YAML string (tuples written as lists) that
        ``merge_from_file`` reads back into the same config."""
        return dump_yaml(self._as_plain_dict())

    def __str__(self) -> str:
        def _indent(s, n):
            pad = " " * n
            return "\n".join(pad + line if line else line for line in s.split("\n"))

        lines = []
        for k, v in sorted(self.items()):
            if isinstance(v, CfgNode):
                lines.append(f"{k}:")
                lines.append(_indent(str(v), 2))
            else:
                lines.append(f"{k}: {v}")
        return "\n".join(lines)

    def __repr__(self) -> str:
        return f"CfgNode({super().__repr__()})"

    # -- merging -------------------------------------------------------------
    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        _merge_into(other, self, [])

    def merge_from_file(self, cfg_filename: str, allow_unsafe: bool = True) -> None:
        """Merge a YAML file, resolving ``_BASE_`` inheritance recursively."""
        loaded = _load_yaml_with_base(cfg_filename)
        loaded = CfgNode(loaded)
        # Auto-upgrade old configs, mirroring the reference's merge_from_file
        # (detectron2/config/config.py:36-66) + compat.py converters.
        from .compat import guess_version, upgrade_config

        version = loaded.pop("VERSION", None)
        if version is None:
            version = guess_version(loaded, cfg_filename)
        if version < 2:
            loaded["VERSION"] = version
            loaded = upgrade_config(loaded)
            loaded.pop("VERSION", None)
        _merge_into(loaded, self, [])

    def merge_from_list(self, cfg_list: List[str]) -> None:
        """Merge ``["KEY", "VALUE", ...]`` pairs (CLI ``opts``)."""
        if len(cfg_list) % 2 != 0:
            raise ValueError(f"Override list has odd length: {cfg_list}")
        for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
            keys = full_key.split(".")
            node = self
            for sub in keys[:-1]:
                if sub not in node:
                    raise KeyError(f"Non-existent key: {full_key}")
                node = node[sub]
            last = keys[-1]
            if last not in node:
                raise KeyError(f"Non-existent key: {full_key}")
            value = _decode_value(v)
            node[last] = _coerce_type(value, node[last], full_key)


def _decode_value(v: Any) -> Any:
    """Parse a CLI string into a python literal when possible."""
    if not isinstance(v, str):
        return v
    try:
        return literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def _coerce_type(value: Any, existing: Any, full_key: str) -> Any:
    """Permit the same type casts yacs allows (int→float, list↔tuple, ...)."""
    if existing is None or value is None:
        return value
    te, tv = type(existing), type(value)
    if te is tv:
        return value
    if te is float and tv is int:
        return float(value)
    if te is tuple and tv is list:
        return tuple(value)
    if te is list and tv is tuple:
        return list(value)
    if te is str:
        return str(value)
    raise ValueError(
        f"Type mismatch ({te} vs {tv}) for config key {full_key}: "
        f"{existing} vs {value}"
    )


def _merge_into(src: CfgNode, dst: CfgNode, key_path: List[str]) -> None:
    for k, v in src.items():
        full_key = ".".join(key_path + [k])
        if k not in dst:
            if dst.is_new_allowed():
                dst[k] = CfgNode(v) if isinstance(v, dict) else v
                continue
            raise KeyError(f"Non-existent config key: {full_key}")
        if isinstance(v, CfgNode) or isinstance(v, dict):
            if not isinstance(dst[k], CfgNode):
                raise ValueError(f"Cannot merge dict into non-dict key {full_key}")
            _merge_into(CfgNode(v) if not isinstance(v, CfgNode) else v, dst[k], key_path + [k])
        else:
            dst[k] = _coerce_type(_decode_value(v), dst[k], full_key)


def _load_yaml_with_base(filename: str) -> Dict[str, Any]:
    """Load YAML, recursively applying ``_BASE_`` parent files.

    Same semantics as the reference's CfgNode.load_yaml_with_base: a relative
    ``_BASE_`` path is resolved against the including file's directory, the
    base is loaded first, and the child's keys override it. The one tag
    configs use, ``!!python/object/apply:eval ["<expr>"]`` (the anchor sizes
    of Base-RetinaNet.yaml), is evaluated with builtins stripped: arithmetic
    and comprehensions, no imports or IO.
    """
    with open(filename, "r") as f:
        cfg = load_yaml(f.read(), filename)
    if cfg is None:
        cfg = {}
    if not isinstance(cfg, dict):
        raise ValueError(f"{filename}: a config file holds a mapping, got {type(cfg).__name__}")
    if BASE_KEY in cfg:
        base_filename = cfg.pop(BASE_KEY)
        if base_filename.startswith("~"):
            base_filename = os.path.expanduser(base_filename)
        if not base_filename.startswith("/"):
            base_filename = os.path.join(os.path.dirname(filename), base_filename)
        base_cfg = _load_yaml_with_base(base_filename)
        _merge_dicts(cfg, base_cfg)
        return base_cfg
    return cfg


def _merge_dicts(overrides: Dict[str, Any], base: Dict[str, Any]) -> None:
    """In-place merge of raw dicts (child overrides parent), for _BASE_."""
    for k, v in overrides.items():
        if isinstance(v, dict) and k in base and isinstance(base[k], dict):
            _merge_dicts(v, base[k])
        else:
            base[k] = v
