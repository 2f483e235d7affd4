"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version, with per-kernel launch counters."""
from __future__ import annotations

from typing import Dict

from . import packed_matmul, quant_pack

_COUNTERS = (packed_matmul.LAUNCHES, quant_pack.LAUNCHES)


def launch_counts() -> Dict[str, int]:
    """{kernel wrapper name: CUDA launches so far in this process}."""
    out: Dict[str, int] = {}
    for c in _COUNTERS:
        out.update(c)
    return out


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        for k in c:
            c[k] = 0
