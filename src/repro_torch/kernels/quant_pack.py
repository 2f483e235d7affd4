"""SMOL quantize + bit-pack (B7) and its plain version.

Counterpart of ``repro.kernels.quant_pack``: w [K, N] fp32, optionally
divided by per-group scales, -> SMOL codes packed 8/p per byte along K,
little-endian -> uint8 [K*p//8, N]. Bit-exact with the reference. On CUDA
tensors the wrapper launches ``csrc/quant_pack.cu`` or raises; on CPU
tensors it runs the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.core import pack, quant
from repro_torch.core.qtypes import GROUP_SIZE

from . import _build

SOURCE = "quant_pack.cu"

# Launches of the CUDA kernel in this process (plain-version calls do not
# count); reset by whoever reads it.
LAUNCHES: Dict[str, int] = {"quantize_pack": 0}


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.soniq_quant_pack
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int


def quantize_pack_plain(w: torch.Tensor, scales: Optional[torch.Tensor] = None,
                        *, p: int, group_size: int = GROUP_SIZE
                        ) -> torch.Tensor:
    """Plain version: divide by the group scales, round to codes, pack."""
    k = w.shape[0]
    ws = w.float()
    if scales is not None:
        ws = ws / quant.expand_groups(scales.float(), k, group_size)[:, None]
    return pack.pack_codes(quant.quantize_to_int(ws, p), p)


def quantize_pack(w: torch.Tensor, scales: Optional[torch.Tensor] = None, *,
                  p: int, group_size: int = GROUP_SIZE) -> torch.Tensor:
    """w [K, N] fp32 -> uint8 [K*p//8, N] SMOL codes (packed along K)."""
    if w.dim() != 2:
        raise ValueError(f"w must be 2-D, got {tuple(w.shape)}")
    k, n = w.shape
    if p not in (1, 2, 4) or k % (8 // p):
        raise ValueError(f"K={k} does not pack at p={p}")
    if w.device.type == "cpu":
        return quantize_pack_plain(w, scales, p=p, group_size=group_size)
    if w.device.type != "cuda":
        raise ValueError(f"unsupported device {w.device}")
    if w.dtype != torch.float32 or not w.is_contiguous():
        raise ValueError("w must be contiguous fp32")
    if scales is not None and (scales.dtype != torch.float32
                               or scales.device != w.device
                               or not scales.is_contiguous()
                               or scales.numel() * group_size < k):
        raise ValueError("scales must be contiguous fp32 [K // group] on "
                         "w's device")
    out = torch.empty((k * p // 8, n), dtype=torch.uint8, device=w.device)
    if out.numel() == 0:
        return out
    lib = _build.library(SOURCE, _bind)
    code = _build.launch(
        w.device, lib.soniq_quant_pack, w.data_ptr(),
        None if scales is None else scales.data_ptr(), out.data_ptr(), k, n,
        p, group_size)
    _build.check(code, "soniq_quant_pack")
    LAUNCHES["quantize_pack"] += 1
    return out
