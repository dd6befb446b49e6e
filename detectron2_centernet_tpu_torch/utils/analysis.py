"""Model analysis (counterpart of the JAX package's ``utils/analysis.py``;
reference ``detectron2/utils/analysis.py``, fvcore's counters).

Parameter counts come from the module's parameters (or a nested mapping of
arrays); FLOPs from ``torch.utils.flop_counter.FlopCounterMode`` over one
call: convolutions, matmuls and the other ops it has formulas for, and K1
(``torch.ops.d2ct.dcn_fwd``) through the formula ``ops/dcn.py`` registers
(its contraction and its bilinear sampling). Elementwise ops count 0 there,
where XLA's cost analysis, which the JAX package reads, counts them.
"""

from collections.abc import Mapping
from typing import Any, Callable, Dict, Iterator, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from ..ops import dcn as _dcn_ops  # noqa: F401  (K1's FLOP formula)

__all__ = ["flop_count", "parameter_count", "parameter_count_table"]


def _named_sizes(params: Any) -> Iterator[Tuple[str, int]]:
    if isinstance(params, torch.nn.Module):
        for name, p in params.named_parameters():
            yield name, p.numel()
        return
    for key, value in params.items():
        if isinstance(value, Mapping):
            for sub, n in _named_sizes(value):
                yield f"{key}.{sub}", n
        else:
            yield str(key), int(np.prod(value.shape)) if hasattr(value, "shape") else 0


def parameter_count(params: Any) -> Dict[str, int]:
    """{module path: parameters under it}, "" the total (fvcore's
    ``parameter_count``), of an ``nn.Module``'s parameters or of a nested
    mapping of arrays; paths joined by "."."""
    counts: Dict[str, int] = {}
    total = 0
    for name, n in _named_sizes(params):
        total += n
        keys = name.split(".")
        for depth in range(1, len(keys)):
            prefix = ".".join(keys[:depth])
            counts[prefix] = counts.get(prefix, 0) + n
    counts[""] = total
    return counts


def parameter_count_table(params: Any, max_depth: int = 3) -> str:
    """``parameter_count`` as a table, modules down to ``max_depth``."""
    counts = parameter_count(params)
    rows = [("model", counts[""])]
    for k in sorted(counts):
        if k and k.count(".") < max_depth:
            rows.append((" " + k, counts[k]))
    width = max(len(r[0]) for r in rows) + 2
    lines = [f"{'name':<{width}} #params", "-" * (width + 10)]
    for name, n in rows:
        human = f"{n / 1e6:.2f}M" if n >= 1e6 else (f"{n / 1e3:.1f}K" if n >= 1e3 else str(n))
        lines.append(f"{name:<{width}} {human}")
    return "\n".join(lines)


def flop_count(fn: Callable, *example_args) -> float:
    """The FLOPs of one call ``fn(*example_args)``, without gradients, as
    ``FlopCounterMode`` counts them (a multiply-add is 2)."""
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn(*example_args)
    return float(counter.get_total_flops())
