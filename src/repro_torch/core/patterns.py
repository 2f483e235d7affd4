"""Channel reordering (paper Obs. 4). Counterpart of the two functions of
``repro.core.patterns`` that the deploy packing uses; the rest of that
module (PatternMatch, which needs scipy) comes with the training slice."""
from __future__ import annotations

import numpy as np

from .qtypes import GROUP_SIZE


def reorder_channels(pbits: np.ndarray) -> np.ndarray:
    """Group permutation making same-precision groups contiguous, sorted
    4 -> 2 -> 1 (stable within a precision)."""
    rank = {4: 0, 2: 1, 1: 2}
    keys = np.array([rank[int(p)] for p in np.asarray(pbits)])
    return np.argsort(keys, kind="stable")


def expand_group_perm(group_perm: np.ndarray,
                      group_size: int = GROUP_SIZE) -> np.ndarray:
    """Group-level permutation -> channel-level permutation."""
    base = np.asarray(group_perm)[:, None] * group_size \
        + np.arange(group_size)
    return base.reshape(-1)
