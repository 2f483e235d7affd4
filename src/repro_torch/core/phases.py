"""Typed SONIQ lifecycle phases. Counterpart of ``repro.core.phases``.

The paper's pipeline is a lifecycle:

    FP ──► NOISE ──► QAT ──► SERVE
    (baseline)  Phase I     Phase II    packed deployment

Each :class:`PhaseSpec` singleton on :class:`Phase` carries its param
schema (which tensors a quantized linear leaf holds in that phase, as
``(shape, torch.dtype)`` pairs), its lifecycle metadata (``trainable``,
``needs_rng``, ``next``) and the leaf test ``owns_leaf``.

The port keeps ``QuantConfig.mode`` a string inside: ``Phase.X.name`` is
that string, a phase compares equal to it, and ``QuantConfig.with_mode`` /
``ArchConfig.with_quant_mode`` take either. The reference's apply-rule
registry (``defrule`` / ``rule``) is internal dispatch there; the port
dispatches on the mode in ``core.smol.linear_apply`` and
``models.cnn.conv_apply`` and has no registry.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class PhaseSpec:
    """One lifecycle phase. Singletons live on :class:`Phase`."""

    name: str                      # the QuantConfig.mode string
    index: int                     # position in the lifecycle (FP=0 .. SERVE=3)
    trainable: bool                # does the phase support a backward pass?
    needs_rng: bool                # does apply() consume noise draws?
    # Keys (beyond "w"/"b") that mark a quantized linear leaf as belonging
    # to this phase.
    learned_keys: Tuple[str, ...]

    def __repr__(self) -> str:
        return f"Phase.{self.name.upper()}"

    def __eq__(self, other) -> bool:
        # Singletons, but a phase also equals its mode string.
        if isinstance(other, str):
            return self.name == other
        return self is other

    def __hash__(self) -> int:
        return hash(self.name)      # consistent with the string equality

    def param_schema(self, k: int, n: int, qcfg, *, use_bias: bool = False,
                     dtype: torch.dtype = torch.float32) -> Dict:
        """{leaf name: (shape, dtype)} of a [K, N] quantized linear in this
        phase (no allocation); ``wscale`` is None without scales. The
        group geometry comes from ``qcfg``."""
        out: Dict = {}
        if self.name != "serve":
            out["w"] = ((k, n), dtype)
        if self.name == "noise":
            out["s"] = ((qcfg.num_groups(k),), torch.float32)
        elif self.name == "qat":
            out["pbits"] = ((qcfg.num_groups(k),), torch.int8)
        elif self.name == "serve":
            k4, k2, k1 = qcfg.segments(k)
            ng = qcfg.num_groups(k)
            out.update({
                "w4": ((k4 // 2, n), torch.uint8),
                "w2": ((k2 // 4, n), torch.uint8),
                "w1": ((k1 // 8, n), torch.uint8),
                "perm": ((k,), torch.int32),
                "pbits_sorted": ((ng,), torch.int8),
                "wscale": None if qcfg.scale_mode == "none"
                          else ((ng,), torch.float32),
            })
        if use_bias:
            out["b"] = ((n,), dtype)
        return out

    def owns_leaf(self, leaf) -> bool:
        """Does this leaf dict look like a quantized linear of this phase?
        (FP matches a plain-weight leaf with no learned quant state.)"""
        if not isinstance(leaf, dict):
            return False
        if self.name == "fp":
            return "w" in leaf and not any(
                k in leaf for p in Phase.ALL for k in p.learned_keys)
        return all(k in leaf for k in self.learned_keys)

    @property
    def next(self) -> Optional["PhaseSpec"]:
        """The legal forward transition, or None for the terminal phase."""
        order = Phase.ALL
        return order[self.index + 1] if self.index + 1 < len(order) else None


class Phase:
    """Namespace of the four lifecycle phase singletons."""

    FP = PhaseSpec("fp", 0, trainable=True, needs_rng=False,
                   learned_keys=())
    NOISE = PhaseSpec("noise", 1, trainable=True, needs_rng=True,
                      learned_keys=("s",))
    QAT = PhaseSpec("qat", 2, trainable=True, needs_rng=False,
                    learned_keys=("pbits",))
    SERVE = PhaseSpec("serve", 3, trainable=False, needs_rng=False,
                      learned_keys=("w4", "w2", "w1", "perm",
                                    "pbits_sorted"))

    ALL: Tuple[PhaseSpec, ...] = ()        # filled below

    @staticmethod
    def from_mode(mode) -> PhaseSpec:
        """A mode string (or a PhaseSpec, passed through) -> the phase
        singleton."""
        if isinstance(mode, PhaseSpec):
            return mode
        try:
            return _BY_NAME[mode]
        except KeyError:
            raise ValueError(
                f"unknown phase {mode!r}; expected one of "
                f"{sorted(_BY_NAME)}") from None


Phase.ALL = (Phase.FP, Phase.NOISE, Phase.QAT, Phase.SERVE)
_BY_NAME = {p.name: p for p in Phase.ALL}
