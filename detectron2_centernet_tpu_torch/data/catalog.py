"""Dataset and metadata catalogs (a copy of the JAX package's
``data/catalog.py``, the reference's contract).

``DatasetCatalog`` maps a dataset name to a zero-argument loader returning
``list[dict]``; ``MetadataCatalog`` maps a name to a ``Metadata`` namespace
whose attributes are write-once (``thing_classes``, ...). CenterNet reads
``MetadataCatalog.get(DATASETS.TRAIN[0]).thing_classes`` to size its
heatmap head.
"""

import copy
import types
from typing import Any, Callable, Dict, List


class _DatasetCatalog:
    def __init__(self) -> None:
        self._registry: Dict[str, Callable[[], List[dict]]] = {}

    def register(self, name: str, func: Callable[[], List[dict]]) -> None:
        if not callable(func):
            raise TypeError("You must register a function with DatasetCatalog.register!")
        if name in self._registry:
            raise KeyError(f"Dataset '{name}' is already registered!")
        self._registry[name] = func

    def get(self, name: str) -> List[dict]:
        try:
            f = self._registry[name]
        except KeyError as e:
            raise KeyError(
                f"Dataset '{name}' is not registered! "
                f"Available datasets are: {', '.join(sorted(self._registry))}"
            ) from e
        return f()

    def list(self) -> List[str]:
        return sorted(self._registry)

    def remove(self, name: str) -> None:
        self._registry.pop(name)

    def clear(self) -> None:
        self._registry.clear()

    def __contains__(self, name: str) -> bool:
        return name in self._registry


class Metadata(types.SimpleNamespace):
    """Write-once attribute namespace for dataset metadata."""

    name: str = "N/A"

    def __getattr__(self, key: str) -> Any:
        raise AttributeError(
            f"Attribute '{key}' does not exist in the metadata of dataset "
            f"'{self.name}'. Available keys are {sorted(self.__dict__)}."
        )

    def __setattr__(self, key: str, val: Any) -> None:
        existing = self.__dict__.get(key)
        if existing is not None and key != "name" and existing != val:
            raise ValueError(
                f"Attribute '{key}' in the metadata of '{self.name}' cannot be "
                f"set to a different value!\n{existing} != {val}"
            )
        super().__setattr__(key, val)

    def as_dict(self) -> Dict[str, Any]:
        return copy.copy(self.__dict__)

    def set(self, **kwargs: Any) -> "Metadata":
        for k, v in kwargs.items():
            setattr(self, k, v)
        return self

    def get(self, key: str, default: Any = None) -> Any:
        return self.__dict__.get(key, default)


class _MetadataCatalog:
    def __init__(self) -> None:
        self._registry: Dict[str, Metadata] = {}

    def get(self, name: str) -> Metadata:
        if not name:
            raise KeyError("a dataset name must not be empty")
        if name not in self._registry:
            self._registry[name] = Metadata(name=name)
        return self._registry[name]

    def list(self) -> List[str]:
        return sorted(self._registry)

    def remove(self, name: str) -> None:
        self._registry.pop(name)

    def clear(self) -> None:
        self._registry.clear()

    def __contains__(self, name: str) -> bool:
        return name in self._registry


DatasetCatalog = _DatasetCatalog()
MetadataCatalog = _MetadataCatalog()
