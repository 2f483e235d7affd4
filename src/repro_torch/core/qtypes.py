"""Configuration dataclass for the SONIQ quantization stack.

Counterpart of ``repro.core.qtypes``. Terminology:
  * group   — 16 consecutive input channels, the precision-control unit.
  * block   — 8 groups = 128 channels, one vector that a precision
              pattern covers.
  * segment — after channel reordering the K (input channel) dim of a
              weight splits into contiguous runs [K4 | K2 | K1] of uniform
              precision.

The lifecycle phase is a plain mode string inside ("fp", "noise", "qat",
"serve"); ``QuantConfig(mode=...)`` and ``with_mode`` also take a
``core.phases.Phase`` object, and ``QuantConfig.phase`` gives it back.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .phases import Phase, PhaseSpec

GROUP_SIZE = 16          # channels per precision group (paper Obs. 5)
GROUPS_PER_BLOCK = 8     # groups per 128-channel block (one pattern)
BLOCK_SIZE = GROUP_SIZE * GROUPS_PER_BLOCK
ALLOWED_BITS = (1, 2, 4)  # paper Obs. 2
MODES = ("fp", "noise", "qat", "serve")


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """How SONIQ is applied to the linear layers of a model."""

    # "fp" full precision; "noise" Phase I (trainable per-group logits s);
    # "qat" Phase II, frozen (w, pbits) leaves; "serve" packed.
    mode: str = "fp"
    group_size: int = GROUP_SIZE
    # Fraction of input-channel groups held at 4 / 2 / 1 bits.
    mix: Tuple[float, float, float] = (0.5, 0.375, 0.125)
    # "none" (values on the ±2 grid) or "per_group" (one scale per group).
    scale_mode: str = "per_group"
    quantize_activations: bool = True
    # "per_tensor", "per_token" (row-independent: what serving needs) or
    # "none" (pre-scaled activations).
    act_scale_mode: str = "per_tensor"
    # Fused activation quantization in the segment-GEMM prologue. False
    # selects the two-pass form (whole-K fake-quant, then plain segment
    # GEMMs), which the port carries only as a CPU reference so far.
    fuse_act_quant: bool = True
    # Self-speculative draft forward: None runs the full packed mix; an
    # allowed precision makes every serve-mode packed matmul read only the
    # segments at or below it (the [K2|K1] slice of the same carriers at
    # 2). Verification always runs the full mix.
    draft_slice_bits: Optional[int] = None
    # The QAT rule takes ``w`` as already on the grid: the hoisted training
    # step fake-quantizes every weight once a step
    # (``smol.prequantize_tree``), not once a microbatch and recompute.
    prequantized: bool = False

    # Phase-I hyperparameters: the precision every group starts from and
    # the weight lambda of the bit-count regularizer.
    p_init: int = 4
    lam: float = 1e-7
    # Number of hardware-supported patterns (the paper's design knob:
    # 4 / 8 / 45) the Phase I -> II boundary may use.
    num_patterns: int = 4
    # Layers never quantized (the paper excludes the first and last).
    skip: Tuple[str, ...] = ("embed", "lm_head", "router", "frontend")

    def __post_init__(self):
        if isinstance(self.mode, PhaseSpec):   # QuantConfig(mode=Phase.QAT)
            object.__setattr__(self, "mode", self.mode.name)
        if self.mode not in MODES:
            raise ValueError(f"mode {self.mode!r} not in {MODES}")
        if self.scale_mode not in ("none", "per_group"):
            raise ValueError(f"scale_mode {self.scale_mode!r}")
        if self.act_scale_mode not in ("none", "per_tensor", "per_token"):
            raise ValueError(f"act_scale_mode {self.act_scale_mode!r}")
        if abs(sum(self.mix) - 1.0) >= 1e-6:
            raise ValueError(f"mix {self.mix} must sum to 1")
        if self.group_size % 2:
            raise ValueError(f"group_size {self.group_size} must be even")
        if self.draft_slice_bits is not None \
                and self.draft_slice_bits not in ALLOWED_BITS:
            raise ValueError(f"draft_slice_bits {self.draft_slice_bits} "
                             f"not in {ALLOWED_BITS}")

    @property
    def phase(self) -> PhaseSpec:
        """The lifecycle phase this config selects (``Phase.FP`` ...)."""
        return Phase.from_mode(self.mode)

    def with_mode(self, mode) -> "QuantConfig":
        """Copy in another phase (a mode string or a Phase object)."""
        return dataclasses.replace(self, mode=Phase.from_mode(mode).name)

    # --------------------------------------------------- group geometry ----
    def eff_group_size(self, k: int) -> int:
        """A layer narrower than ``group_size`` forms one whole group."""
        return k if k < self.group_size else self.group_size

    def num_groups(self, k: int) -> int:
        g = self.eff_group_size(k)
        if k % g:
            raise ValueError(f"K={k} not a multiple of group size {g}")
        return k // g

    def group_counts(self, k: int) -> Tuple[int, int, int]:
        """(#4-bit, #2-bit, #1-bit) groups implementing ``mix`` over the
        groups of a K-dim; a layer narrower than a group is one 4-bit
        group."""
        if k < self.group_size:
            return 1, 0, 0
        n = self.num_groups(k)
        g4 = min(int(round(self.mix[0] * n)), n)
        g2 = min(int(round(self.mix[1] * n)), n - g4)
        return g4, g2, n - g4 - g2

    def group_pbits(self, k: int) -> np.ndarray:
        """Static per-group precisions implementing ``mix``, sorted
        4 -> 2 -> 1."""
        g4, g2, g1 = self.group_counts(k)
        return np.array([4] * g4 + [2] * g2 + [1] * g1, np.int8)

    def segments(self, k: int) -> Tuple[int, int, int]:
        """(K4, K2, K1) contiguous runs of uniform precision, summing to
        ``k``."""
        g = self.eff_group_size(k)
        g4, g2, g1 = self.group_counts(k)
        return g4 * g, g2 * g, g1 * g


# The paper's design points: full precision, uniform 4 and 2 bits, and the
# default mix under 4, 8 or 45 hardware patterns.
FP32 = QuantConfig(mode="fp")
U4 = QuantConfig(mode="qat", mix=(1.0, 0.0, 0.0))
U2 = QuantConfig(mode="qat", mix=(0.0, 1.0, 0.0))
P4 = QuantConfig(mode="qat", mix=(0.5, 0.375, 0.125), num_patterns=4)
P8 = QuantConfig(mode="qat", mix=(0.5, 0.375, 0.125), num_patterns=8)
P45 = QuantConfig(mode="qat", mix=(0.5, 0.375, 0.125), num_patterns=45)
