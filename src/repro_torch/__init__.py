"""PyTorch/CUDA port of the SONIQ serve path (H100, ``sm_90a``).

Mirrors the module layout of the JAX package ``repro`` so each counterpart
is easy to find; imports ``torch`` and numpy only. The packed-GEMM and
quantize-pack hot ops run as hand-written CUDA kernels
(``repro_torch/csrc``) on CUDA tensors and as their plain PyTorch versions
on CPU tensors.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
