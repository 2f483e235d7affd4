"""Precision patterns: the paper's Table II, Problem 1 and PatternMatch.
Counterpart of ``repro.core.patterns`` (pure numpy and scipy).

A *pattern* assigns each of the 8 sixteen-channel groups of a 128-channel
block one precision from {1, 2, 4}, same-precision groups contiguous and
sorted 4 -> 2 -> 1 (paper Obs. 4). Counted in elements a pattern is
(n1, n2, n4) = (16a, 8b, 4c) with a + b + c = 8: the paper's 45 patterns.

Problem 1 (paper §IV-A): given N4 / N2 / N1 elements per precision, pick a
multiset of patterns with the fewest vectors under the promotion-aware
covering constraints
    sum n4_i >= N4
    sum (n4_i + n2_i) >= N4 + N2
    sum (n4_i + n2_i + n1_i) >= N4 + N2 + N1,
ties broken by the most capacity bits; solved exactly with scipy's MILP.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, List, Sequence, Tuple

import numpy as np
from scipy import optimize as sopt

from . import noise
from .qtypes import GROUP_SIZE, GROUPS_PER_BLOCK


def all_patterns() -> List[Tuple[int, int, int]]:
    """The 45 patterns as (n1, n2, n4) element counts, in the paper's Table II
    order (n1 ascending, then n2 ascending)."""
    pats = []
    for a in range(GROUPS_PER_BLOCK + 1):          # 1-bit groups
        for b in range(GROUPS_PER_BLOCK + 1 - a):  # 2-bit groups
            c = GROUPS_PER_BLOCK - a - b           # 4-bit groups
            pats.append((16 * a, 8 * b, 4 * c))
    return pats


PATTERNS = all_patterns()
assert len(PATTERNS) == 45
assert PATTERNS[0] == (0, 0, 32) and PATTERNS[8] == (0, 64, 0)
assert PATTERNS[9] == (16, 0, 28) and PATTERNS[44] == (128, 0, 0)

# Paper Table III: pattern indices (1-based) of each design point.
DESIGN_POINT_PATTERNS = {
    4: [1, 45, 9, 17],
    8: [1, 45, 9, 17, 16, 35, 38, 15],
    45: list(range(1, 46)),
}


def patterns_for(np_patterns: int) -> List[Tuple[int, int, int]]:
    idx = DESIGN_POINT_PATTERNS[np_patterns]
    return [PATTERNS[i - 1] for i in idx]


def pattern_avg_bits(pat: Tuple[int, int, int]) -> float:
    n1, n2, n4 = pat
    tot = n1 + n2 + n4
    return (n1 + 2 * n2 + 4 * n4) / tot if tot else 0.0


@dataclasses.dataclass
class PatternSolution:
    num_vectors: int
    counts: Dict[Tuple[int, int, int], int]     # pattern -> multiplicity
    capacity: Tuple[int, int, int]              # total (cap4, cap2, cap1) elems

    def element_budget(self) -> Tuple[int, int, int]:
        """(num4b, num2b, num1b) element slots, in priority order, as consumed
        by PatternMatch."""
        c4 = sum(m * p[2] for p, m in self.counts.items())
        c2 = sum(m * p[1] for p, m in self.counts.items())
        c1 = sum(m * p[0] for p, m in self.counts.items())
        return c4, c2, c1


def solve_problem1(n4: int, n2: int, n1: int,
                   allowed: Sequence[Tuple[int, int, int]] = PATTERNS,
                   ) -> PatternSolution:
    """Exact Problem-1 solve: min #vectors, then max total capacity bits."""
    allowed = list(allowed)
    m = len(allowed)
    a4 = np.array([p[2] for p in allowed], float)
    a2 = np.array([p[1] for p in allowed], float)
    a1 = np.array([p[0] for p in allowed], float)

    # Covering constraints (>=) as  -A x <= -b.
    A = np.stack([a4, a4 + a2, a4 + a2 + a1])
    b = np.array([n4, n4 + n2, n4 + n2 + n1], float)
    lc = sopt.LinearConstraint(A, lb=b, ub=np.inf)
    integrality = np.ones(m)
    bounds = sopt.Bounds(0, np.inf)

    res = sopt.milp(c=np.ones(m), constraints=lc, integrality=integrality,
                    bounds=bounds)
    if not res.success:  # pragma: no cover - covering is always feasible
        raise RuntimeError(f"Problem 1 infeasible: {res.message}")
    p_star = int(round(res.fun))

    # Tie-break: among solutions with exactly p_star vectors, maximize total
    # capacity bits (highest average precision heuristic, paper §IV-A).
    bits = 4 * a4 + 2 * a2 + 1 * a1
    eq = sopt.LinearConstraint(np.ones((1, m)), lb=p_star, ub=p_star)
    res2 = sopt.milp(c=-bits, constraints=[lc, eq], integrality=integrality,
                     bounds=bounds)
    x = np.round(res2.x if res2.success else res.x).astype(int)
    counts = {allowed[i]: int(x[i]) for i in range(m) if x[i] > 0}
    cap = (int(x @ a4), int(x @ a2), int(x @ a1))
    return PatternSolution(num_vectors=p_star, counts=counts, capacity=cap)


def histogram_from_s(s: np.ndarray, group_size: int = GROUP_SIZE
                     ) -> Tuple[int, int, int]:
    """(N4, N2, N1) element counts from a per-group s vector (system-aware:
    every channel in a group shares its s)."""
    s = np.asarray(s)
    # Same banding as noise.snap_124 applied to the raw readout.
    raw = 1.0 + np.log2(1.0 + np.exp(-s.astype(np.float64)))
    p = np.where(raw >= 2.5, 4, np.where(raw >= 1.5, 2, 1))
    n4 = int((p == 4).sum()) * group_size
    n2 = int((p == 2).sum()) * group_size
    n1 = int((p == 1).sum()) * group_size
    return n4, n2, n1


def pattern_match(s: np.ndarray, solution: PatternSolution,
                  group_size: int = GROUP_SIZE) -> np.ndarray:
    """Paper Alg. 3 PatternMatch: rank channel-groups by importance (lower s
    = more important), give the num4b most important groups 4 bits, the next
    num2b 2 bits, the rest 1 bit — all consistent with the solved pattern
    multiset. Returns the transformed s vector."""
    s = np.asarray(s, np.float64)
    c4, c2, c1 = solution.element_budget()
    g4, g2 = c4 // group_size, c2 // group_size
    order = np.argsort(s, kind="stable")     # ascending: most important first
    s_new = np.empty_like(s)
    s_new[order[:g4]] = noise.S_4B
    s_new[order[g4:g4 + g2]] = noise.S_2B
    s_new[order[g4 + g2:]] = noise.S_1B
    return s_new


def precisions_from_matched_s(s_matched: np.ndarray) -> np.ndarray:
    """Per-group {1,2,4} precisions after PatternMatch."""
    raw = 1.0 + np.log2(1.0 + np.exp(-np.asarray(s_matched, np.float64)))
    return np.where(raw >= 2.5, 4, np.where(raw >= 1.5, 2, 1)).astype(np.int8)


def reorder_channels(pbits: np.ndarray) -> np.ndarray:
    """Permutation making same-precision groups contiguous, sorted 4->2->1
    (paper Obs. 4). Returns group-level permutation indices (stable, so the
    within-precision order is preserved), one row per row of a stacked
    [..., K // G] ``pbits``."""
    pbits = np.asarray(pbits)
    keys = np.select([pbits == 4, pbits == 2, pbits == 1], [0, 1, 2], -1)
    if np.any(keys < 0):
        raise ValueError("pbits must be in {1, 2, 4}")
    return np.argsort(keys, axis=-1, kind="stable")


def expand_group_perm(group_perm: np.ndarray, group_size: int = GROUP_SIZE
                      ) -> np.ndarray:
    """Group-level permutation -> channel-level permutation (per row of a
    stacked [..., K // G] permutation)."""
    base = np.asarray(group_perm)[..., None] * group_size + np.arange(
        group_size)
    return base.reshape(base.shape[:-2] + (-1,))


def select_hardware_subset(layer_histograms: Sequence[Tuple[int, int, int]],
                           np_patterns: int) -> List[Tuple[int, int, int]]:
    """Paper §V-A: run Problem 1 per representative layer with ALL patterns
    allowed, tally which patterns get used, and keep the np most frequent
    (always including the uniform patterns that anchor the table)."""
    if np_patterns >= len(PATTERNS):
        return list(PATTERNS)
    tally: Counter = Counter()
    for (n4, n2, n1) in layer_histograms:
        sol = solve_problem1(n4, n2, n1)
        for pat, mult in sol.counts.items():
            tally[pat] += mult
    ranked = [p for p, _ in tally.most_common()]
    for anchor in ((0, 0, 32), (128, 0, 0), (0, 64, 0)):  # paper's P4 anchors
        if anchor not in ranked:
            ranked.append(anchor)
    out = ranked[:np_patterns]
    i = 0
    while len(out) < np_patterns:
        if PATTERNS[i] not in out:
            out.append(PATTERNS[i])
        i += 1
    return out


def metadata_ints(pbits: np.ndarray) -> Tuple[int, int, int]:
    """Per-layer metadata: just 3 ints (paper Obs. 1-4) — the number of
    channel-groups at each precision."""
    p = np.asarray(pbits)
    return int((p == 4).sum()), int((p == 2).sum()), int((p == 1).sum())
