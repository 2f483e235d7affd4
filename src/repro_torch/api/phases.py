"""Re-export of the typed lifecycle phases at the façade level:

    from repro_torch import soniq
    soniq.Phase.QAT
"""
from repro_torch.core.phases import Phase, PhaseSpec  # noqa: F401

__all__ = ["Phase", "PhaseSpec"]
