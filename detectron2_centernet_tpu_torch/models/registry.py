"""Name → builder registries, so a config picks its meta-architecture and
backbone by string (counterpart of the JAX package's ``models/registry.py``)."""

from typing import Any, Dict, Optional


class Registry:
    """Name → callable or class, filled by decorator registration."""

    def __init__(self, name: str) -> None:
        self._name = name
        self._obj_map: Dict[str, Any] = {}

    def register(self, obj: Any = None, *, name: Optional[str] = None) -> Any:
        if obj is None:
            return lambda o: self.register(o, name=name)
        key = name or obj.__name__
        if key in self._obj_map:
            raise KeyError(f"'{key}' is already registered in the {self._name} registry")
        self._obj_map[key] = obj
        return obj

    def get(self, name: str) -> Any:
        if name not in self._obj_map:
            raise KeyError(
                f"no '{name}' in the {self._name} registry; the port has {sorted(self._obj_map)}"
            )
        return self._obj_map[name]

    def __contains__(self, name: str) -> bool:
        return name in self._obj_map


META_ARCH_REGISTRY = Registry("META_ARCH")
BACKBONE_REGISTRY = Registry("BACKBONE")
