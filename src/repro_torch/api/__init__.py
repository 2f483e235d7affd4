"""``soniq``: the public façade of the port over the SONIQ lifecycle.
Counterpart of ``repro.api``.

    from repro_torch import soniq

    state = soniq.init(model_cfg, soniq.QuantConfig(mode="noise"), seed=0)
    logits = soniq.apply(state, tokens, noise=key)     # Phase I forward
    qat, report = soniq.to_qat(state)                  # freeze precisions
    packed = soniq.to_serve(qat)                       # reorder + bit-pack
    y = soniq.apply(packed, tokens)                    # packed forward

The transforms change the model in place (``repro_torch.api.transforms``):
a state they consumed raises on later use. Serving runs through
``soniq.DecodeEngine``.

The port has no kernel-backend registry: the device of a tensor picks the
kernel (``repro_torch.backend.base``). CUDA tensors launch the
hand-written Hopper kernels and CPU tensors run their plain PyTorch
versions, and no switch sends a CUDA tensor to a plain version, so the
reference's ``use_backend``, ``current_backend`` and
``available_backends`` have no counterpart here.
"""
from repro_torch.core.noise import bit_penalty                 # noqa: F401
from repro_torch.core.qtypes import (ALLOWED_BITS, BLOCK_SIZE,  # noqa: F401
                                     FP32, GROUP_SIZE, GROUPS_PER_BLOCK, P4,
                                     P8, P45, U2, U4, QuantConfig)
from repro_torch.core.smol import bit_penalty_of_params        # noqa: F401

from .phases import Phase, PhaseSpec                           # noqa: F401
from .state import LinearSpec, SoniqState                      # noqa: F401
from . import transforms                                       # noqa: F401
from .transforms import (apply, average_bpp, convert_linear,   # noqa: F401
                         convert_tree, freeze_qat, init, init_linear,
                         pack_conv, pack_linear, rebudget_pbits, to_qat,
                         to_serve, tree_map_layers, with_phase)

__all__ = [
    # configs & phases
    "ALLOWED_BITS", "BLOCK_SIZE", "GROUP_SIZE", "GROUPS_PER_BLOCK",
    "FP32", "P4", "P8", "P45", "U2", "U4", "QuantConfig",
    "Phase", "PhaseSpec", "LinearSpec", "SoniqState", "with_phase",
    # lifecycle
    "init", "init_linear", "apply", "to_qat", "to_serve",
    # tree-level building blocks
    "freeze_qat", "rebudget_pbits", "pack_linear", "pack_conv",
    "convert_linear", "convert_tree", "tree_map_layers",
    # losses / reports
    "bit_penalty", "bit_penalty_of_params", "average_bpp",
    # serving (lazy: see __getattr__)
    "DecodeEngine", "LockstepEngine", "EngineConfig", "Request",
    "Completion", "Scheduler", "packed_bytes", "transforms",
]

_SERVE_EXPORTS = {"DecodeEngine": "DecodeEngine",
                  "LockstepEngine": "LockstepEngine",
                  "EngineConfig": "EngineConfig",
                  "Request": "Request",
                  "Completion": "Completion",
                  "Scheduler": "Scheduler",
                  "packed_bytes": "packed_model_bytes"}


def __getattr__(name):
    # The decode engine imports the transforms; the serve names load only
    # when asked for, keeping the dependency one-way at import time.
    if name in _SERVE_EXPORTS:
        from repro_torch.serve import engine, scheduler
        mod = scheduler if hasattr(scheduler, _SERVE_EXPORTS[name]) \
            else engine
        return getattr(mod, _SERVE_EXPORTS[name])
    raise AttributeError(f"module 'repro_torch.api' has no attribute "
                         f"{name!r}")
