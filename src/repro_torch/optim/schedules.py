"""Learning-rate schedules (pure functions of the step, fp32 arithmetic
as the reference's). Counterpart of ``repro.optim.schedules``."""
from __future__ import annotations

import numpy as np

_F = np.float32


def warmup_cosine(step: int, *, base_lr: float = 1.0, warmup: int = 100,
                  total: int = 10000, final_frac: float = 0.1) -> float:
    step = _F(step)
    warm = np.minimum(step / _F(max(warmup, 1)), _F(1.0))
    prog = np.clip((step - _F(warmup)) / _F(max(total - warmup, 1)),
                   _F(0.0), _F(1.0))
    cos = _F(final_frac) + (_F(1.0) - _F(final_frac)) * _F(0.5) * (
        _F(1.0) + np.cos(_F(np.pi) * prog))
    return float(_F(base_lr) * warm * cos)


def two_phase(step: int, *, t1: int, warmup: int = 100, total: int = 10000,
              phase2_mult: float = 0.3) -> float:
    """SONIQ schedule: Phase I explores at the full rate; Phase II
    fine-tunes the frozen-precision network at a reduced rate."""
    lr = warmup_cosine(step, warmup=warmup, total=total)
    return lr if step < t1 else float(_F(lr) * _F(phase2_mult))
