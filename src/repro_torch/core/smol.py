"""SmolLinear — the quantized linear primitive (FP and SERVE rules).

Counterpart of ``repro.core.smol``. A linear leaf is a dict of tensors:

  FP     {"w" [K, N], "b"?}                       y = x @ W
  QAT    {"w", "pbits" [K // G], "b"?}            trained, packed by
                                                  ``api.transforms``
  SERVE  {"w4", "w2", "w1" uint8, "perm", "pbits_sorted", "wscale", "b"?}
                                                  y = q(x) @ unpack(W)

:class:`SmolLinear` holds one leaf as module buffers. The QAT forward
(fake-quant, kernel B8) comes with the training slice.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.backend import base as backend
from .qtypes import QuantConfig


def linear_init(k: int, n: int, qcfg: QuantConfig, *,
                generator: torch.Generator, device: torch.device,
                use_bias: bool = False, dtype=torch.float32,
                quantized: bool = True, scale: float = 1.0) -> Dict:
    """Random FP or QAT leaf (``quantized=False`` for skip layers). The
    weights come from the port's own seeded generator, not JAX's RNG."""
    std = scale / np.sqrt(k)
    w = torch.randn((k, n), generator=generator, device=device,
                    dtype=torch.float32) * std
    leaf: Dict = {"w": w.to(dtype)}
    if use_bias:
        leaf["b"] = torch.zeros((n,), dtype=dtype, device=device)
    if not quantized or qcfg.mode == "fp":
        return leaf
    if qcfg.mode == "qat":
        leaf["pbits"] = torch.as_tensor(qcfg.group_pbits(k), device=device)
        return leaf
    raise ValueError("serve leaves are made by packing trained ones "
                     "(repro_torch.api.transforms.pack_linear)")


def _matmul(x: torch.Tensor, w: torch.Tensor,
            b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """fp32-accumulated product cast back to x's dtype, then the bias."""
    y = torch.matmul(x.float(), w.float()).to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def linear_apply(leaf: Dict, x: torch.Tensor, qcfg: QuantConfig
                 ) -> torch.Tensor:
    """x [..., K] -> [..., N] under the leaf's rule. A leaf holding only a
    plain weight (skip layer) always runs the FP rule."""
    if "w4" in leaf:
        if qcfg.mode != "serve":
            raise ValueError(f"packed leaf under mode {qcfg.mode!r}")
        return backend.packed_matmul(leaf, x, qcfg)
    if "pbits" in leaf and qcfg.mode == "serve":
        raise ValueError(
            "serve-mode linear got an unconverted leaf (keys "
            f"{sorted(leaf)}); run repro_torch.api.transforms.convert_tree")
    if "pbits" in leaf and qcfg.mode == "qat":
        raise NotImplementedError(
            "the QAT forward (fake_quant, kernel B8) is part of the "
            "training slice of the port")
    return _matmul(x, leaf["w"], leaf.get("b"))


class SmolLinear(nn.Module):
    """One linear leaf held as buffers (packed carriers stay uint8)."""

    def __init__(self, leaf: Dict):
        super().__init__()
        self._names = tuple(leaf)
        for name, t in leaf.items():
            self.register_buffer(name, t)

    def leaf(self) -> Dict:
        return {name: getattr(self, name) for name in self._names}

    def forward(self, x: torch.Tensor, qcfg: QuantConfig) -> torch.Tensor:
        return linear_apply(self.leaf(), x, qcfg)
