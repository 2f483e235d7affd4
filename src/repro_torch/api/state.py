"""Typed lifecycle state of the ``soniq`` façade. Counterpart of
``repro.api.state``.

A :class:`SoniqState` holds a model module (a ``SmolLinear``, a
``models.cnn.CNN`` or a ``models.lm.LM``), the phase it is in and the
config that interprets it. The reference's state is an immutable pytree
whose transforms return new trees; the port's transforms change the module
in place (a copy would double a full-width model on the card), so the
state they consume is marked and raises on any later use, naming the
phase its module became.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.core.phases import Phase, PhaseSpec
from repro_torch.core.qtypes import QuantConfig


@dataclasses.dataclass(frozen=True)
class LinearSpec:
    """Model config of the single-SmolLinear case (quickstart, unit
    tests): one [K, N] quantized matmul."""
    k: int
    n: int
    use_bias: bool = False
    quant: QuantConfig = dataclasses.field(default_factory=QuantConfig)


@dataclasses.dataclass
class SoniqState:
    """The model, the phase that interprets it and its config
    (``ArchConfig``, ``CNNConfig`` or :class:`LinearSpec`)."""
    phase: PhaseSpec
    model: Any
    model_cfg: Any
    # Set by the transform that took this state's module into another
    # phase (its name and that phase); the state is then spent.
    consumed_by: Optional[tuple] = dataclasses.field(default=None,
                                                     repr=False)

    @property
    def qcfg(self) -> QuantConfig:
        """The QuantConfig with this state's phase applied."""
        return self.model_cfg.quant.with_mode(self.phase)

    @property
    def forward_cfg(self):
        """The model config with this state's phase applied to its quant
        field: what the model libraries read."""
        return dataclasses.replace(self.model_cfg, quant=self.qcfg)

    @property
    def params(self):
        """The model's tensors as a nested dict (shared, not copied): a
        linear's leaf, or the model's ``tree()``."""
        return self.model.tree() if hasattr(self.model, "tree") \
            else self.model.leaf()

    def check_live(self, what: str) -> None:
        """Raise if a transform has consumed this state."""
        if self.consumed_by is not None:
            by, phase = self.consumed_by
            raise ValueError(
                f"{what}: this {self.phase!r} state was consumed by {by}, "
                f"which changed its model in place into {phase!r}; use the "
                f"state {by} returned")

    def replace(self, **kw) -> "SoniqState":
        if "phase" in kw:
            kw["phase"] = Phase.from_mode(kw["phase"])
        return dataclasses.replace(self, **kw)

    def __repr__(self) -> str:
        name = getattr(self.model_cfg, "name", type(self.model_cfg).__name__)
        return f"SoniqState({self.phase!r}, model={name})"
