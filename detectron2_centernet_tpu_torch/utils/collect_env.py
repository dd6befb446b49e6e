"""Environment provenance (counterpart of the JAX package's
``utils/collect_env.py``; reference ``detectron2/utils/collect_env.py``):
Python, numpy, torch, its CUDA and cuDNN, ``nvcc``'s release and the card's
name and power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them."""

import os
import subprocess
import sys

__all__ = ["collect_env_info"]


def _run(argv, line: int = 0) -> str:
    """A line of the command's output (the first by default), or why there
    is none."""
    try:
        out = subprocess.run(argv, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not available ({type(e).__name__})"
    lines = [text for text in out.stdout.strip().splitlines() if text]
    return lines[line] if out.returncode == 0 and lines else f"not available (exit code {out.returncode})"


def collect_env_info() -> str:
    import numpy as np
    import torch

    from ..ops.cuda_lib import _nvcc

    nvcc = _nvcc()
    release = _run([nvcc, "--version"], line=-1) if os.path.exists(nvcc) else "not available"
    lines = [
        f"Python: {sys.version.split()[0]}",
        f"numpy: {np.__version__}",
        f"torch: {torch.__version__}",
        f"torch CUDA: {torch.version.cuda}",
        f"cuDNN: {torch.backends.cudnn.version() if torch.backends.cudnn.is_available() else None}",
        f"nvcc ({nvcc}): {release}",
        f"CUDA available: {torch.cuda.is_available()}, devices: {torch.cuda.device_count()}",
        f"card (name, power limit): {_run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'])}",
    ]
    return "\n".join(lines)
