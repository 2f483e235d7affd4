"""The port's one rule for row reductions.

Every sum along a row that feeds the model's activations (the RMS mean,
attention scores and the value contraction, the plain GEMM of the segment
kernels) is taken in float64 and rounded once to fp32. The result of a row
then does not depend on how many rows share the call: on the card a
kernel's fp32 reduction order changes with the batch and chunk shape, and
continuous batching must stay token-identical to lockstep decoding. The
reference sums these in fp32; the float64 sum is within fp32 rounding of
it. (The CUDA segment GEMM keeps its own fixed per-element fp32 order.)

The fp products of serving (the readout and the MoE router, full-width
GEMMs where a float64 copy of the weight would cost more than the step)
keep fp32 but run in blocks of a fixed number of rows
(:func:`row_block_matmul`): every call is then the same GEMM shape, so
cuBLAS and the CPU's BLAS, which pick their kernel and with it the order
of the sum by shape, give a row the same bits whether it shares the call
with 4 rows of a decode step or 16 of a speculative verify.
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


ROW_BLOCK = 16


def row_block_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 ``x [..., K] @ w [K, N]`` over blocks of ``ROW_BLOCK`` rows,
    the last block padded with zero rows: one GEMM shape for any number of
    rows."""
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k).float()
    m = x2.shape[0]
    rows = -(-max(m, 1) // ROW_BLOCK) * ROW_BLOCK
    if rows != m:
        x2 = torch.nn.functional.pad(x2, (0, 0, 0, rows - m))
    wf = w.float()
    out = torch.empty((rows, w.shape[-1]), dtype=torch.float32,
                      device=x.device)
    for i in range(0, rows, ROW_BLOCK):
        torch.mm(x2[i:i + ROW_BLOCK], wf, out=out[i:i + ROW_BLOCK])
    return out[:m].reshape(lead + (w.shape[-1],))
