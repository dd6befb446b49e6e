"""Metric event storage and writers (a copy of the JAX package's
``utils/events.py``, the reference's ``detectron2/utils/events.py``
contract): ``EventStorage`` is a context-managed scalar store with
median-window smoothing; ``JSONWriter`` and ``CommonMetricPrinter`` flush it
periodically. TensorBoard, images and histograms are not copied.
"""

import datetime
import json
import logging
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

_CURRENT_STORAGE_STACK: List["EventStorage"] = []


def get_event_storage() -> "EventStorage":
    if not _CURRENT_STORAGE_STACK:
        raise RuntimeError(
            "get_event_storage() has to be called inside a 'with EventStorage(...)' context!"
        )
    return _CURRENT_STORAGE_STACK[-1]


class HistoryBuffer:
    """Ring buffer of (value, iteration) with windowed median/avg
    (fvcore HistoryBuffer semantics used by the reference)."""

    def __init__(self, max_length: int = 1000000) -> None:
        self._max_length = max_length
        self._data: List[Tuple[float, float]] = []
        self._count = 0
        self._global_avg = 0.0

    def update(self, value: float, iteration: Optional[float] = None) -> None:
        if iteration is None:
            iteration = self._count
        if len(self._data) == self._max_length:
            self._data.pop(0)
        self._data.append((value, iteration))
        self._count += 1
        self._global_avg += (value - self._global_avg) / self._count

    def latest(self) -> float:
        return self._data[-1][0]

    def median(self, window_size: int) -> float:
        return float(np.median([x[0] for x in self._data[-window_size:]]))

    def avg(self, window_size: int) -> float:
        return float(np.mean([x[0] for x in self._data[-window_size:]]))

    def global_avg(self) -> float:
        return self._global_avg

    def values(self) -> List[Tuple[float, float]]:
        return self._data


class EventStorage:
    """Per-iteration metric store (reference events.py:256-458)."""

    def __init__(self, start_iter: int = 0) -> None:
        self._history: Dict[str, HistoryBuffer] = defaultdict(HistoryBuffer)
        self._smoothing_hints: Dict[str, bool] = {}
        self._latest_scalars: Dict[str, Tuple[float, int]] = {}
        self._iter = start_iter

    # -- write API -----------------------------------------------------------
    def put_scalar(self, name: str, value, smoothing_hint: bool = True) -> None:
        value = float(value)
        self._history[name].update(value, self._iter)
        self._latest_scalars[name] = (value, self._iter)
        existing = self._smoothing_hints.get(name)
        if existing is not None and existing != smoothing_hint:
            raise ValueError(f"Scalar {name} was put with inconsistent smoothing_hint")
        if existing is None:
            self._smoothing_hints[name] = smoothing_hint

    # -- read API ------------------------------------------------------------
    def history(self, name: str) -> HistoryBuffer:
        ret = self._history.get(name)
        if ret is None:
            raise KeyError(f"No history metric available for {name}!")
        return ret

    def histories(self) -> Dict[str, HistoryBuffer]:
        return self._history

    def latest_with_smoothing_hint(self, window_size: int = 20) -> Dict[str, Tuple[float, int]]:
        result = {}
        for k, (v, it) in self._latest_scalars.items():
            result[k] = (
                self._history[k].median(window_size) if self._smoothing_hints[k] else v,
                it,
            )
        return result

    @property
    def iter(self) -> int:
        return self._iter

    def __enter__(self) -> "EventStorage":
        _CURRENT_STORAGE_STACK.append(self)
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        if _CURRENT_STORAGE_STACK[-1] is not self:
            raise RuntimeError("EventStorage contexts must nest")
        _CURRENT_STORAGE_STACK.pop()


class EventWriter:
    """Writer protocol (reference events.py:36-45)."""

    def write(self) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class JSONWriter(EventWriter):
    """Append latest smoothed scalars to a metrics.json-lines file
    (reference events.py:48-125)."""

    def __init__(self, json_file: str, window_size: int = 20) -> None:
        os.makedirs(os.path.dirname(json_file) or ".", exist_ok=True)
        self._file_handle = open(json_file, "a")
        self._window_size = window_size
        self._last_write = -1

    def write(self) -> None:
        storage = get_event_storage()
        to_save = defaultdict(dict)
        for k, (v, it) in storage.latest_with_smoothing_hint(self._window_size).items():
            if it <= self._last_write:
                continue
            to_save[it][k] = v
        if to_save:
            self._last_write = max(to_save)
        for it, scalars in sorted(to_save.items()):
            scalars["iteration"] = it
            self._file_handle.write(json.dumps(scalars, sort_keys=True) + "\n")
        self._file_handle.flush()
        try:
            os.fsync(self._file_handle.fileno())
        except OSError:
            pass

    def close(self) -> None:
        self._file_handle.close()


class CommonMetricPrinter(EventWriter):
    """The familiar console line: eta / iter / losses / lr / time
    (reference events.py:178-253)."""

    def __init__(self, max_iter: int) -> None:
        self.logger = logging.getLogger(__name__)
        self._max_iter = max_iter
        self._last_write: Optional[Tuple[int, float]] = None

    def write(self) -> None:
        storage = get_event_storage()
        iteration = storage.iter

        data_time, time_str, eta_string = None, "", "N/A"
        try:
            data_time = storage.history("data_time").avg(20)
        except KeyError:
            pass
        try:
            iter_time = storage.history("time").global_avg()
            time_str = f"time: {storage.history('time').median(20):.4f}  "
            eta_seconds = iter_time * (self._max_iter - iteration)
            eta_string = str(datetime.timedelta(seconds=int(eta_seconds)))
        except KeyError:
            if self._last_write is not None:
                estimate = (time.perf_counter() - self._last_write[1]) / max(
                    iteration - self._last_write[0], 1
                )
                eta_seconds = estimate * (self._max_iter - iteration)
                eta_string = str(datetime.timedelta(seconds=int(eta_seconds)))
            self._last_write = (iteration, time.perf_counter())

        try:
            lr = "{:.6g}".format(storage.history("lr").latest())
        except KeyError:
            lr = "N/A"

        losses = "  ".join(
            f"{k}: {v.median(20):.4g}"
            for k, v in storage.histories().items()
            if "loss" in k
        )
        self.logger.info(
            f"eta: {eta_string}  iter: {iteration}  {losses}  {time_str}"
            + (f"data_time: {data_time:.4f}  " if data_time is not None else "")
            + f"lr: {lr}"
        )
