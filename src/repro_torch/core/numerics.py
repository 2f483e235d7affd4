"""The port's one rule for row reductions.

Every sum along a row that feeds the model's activations (the RMS mean,
attention scores and the value contraction, the plain GEMM of the segment
kernels) is taken in float64 and rounded once to fp32. The result of a row
then does not depend on how many rows share the call: on the card a
kernel's fp32 reduction order changes with the batch and chunk shape, and
continuous batching must stay token-identical to lockstep decoding. The
reference sums these in fp32; the float64 sum is within fp32 rounding of
it. (The CUDA segment GEMM keeps its own fixed per-element fp32 order.)
"""
from __future__ import annotations

import torch


def sum_fp64(equation: str, *operands: torch.Tensor,
             divisor: float = 1.0) -> torch.Tensor:
    """``einsum(equation, *operands) / divisor`` in float64, rounded once
    to fp32."""
    out = torch.einsum(equation, *(t.double() for t in operands))
    if divisor != 1.0:
        out = out / divisor
    return out.float()
