"""PyTorch/CUDA port of SONIQ for the H100 (``sm_90a``): training (Phase I
noise search, the pattern freeze, Phase II QAT) and serving of packed
models, for a single linear, the paper's CNN family and the decoder LMs.
Public API: ``from repro_torch import soniq``.

Mirrors the module layout of the JAX package ``repro`` so each counterpart
is easy to find; imports ``torch`` and numpy only. The hot ops (the
segment GEMMs, deploy packing, decode attention over the 4-bit KV cache,
noise injection and fake quantization with their backward passes) run as
hand-written CUDA kernels (``repro_torch/csrc``) on CUDA tensors and as
their plain PyTorch versions on CPU tensors.
"""
from .device import resolve_device

__all__ = ["resolve_device", "soniq"]


def __getattr__(name):
    # Lazy: `from repro_torch import soniq` loads the façade (and with it
    # the model libraries) only when asked for.
    if name in ("soniq", "api"):
        import importlib
        return importlib.import_module(".api", __name__)
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
