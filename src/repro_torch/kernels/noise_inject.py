"""Phase-I fused perturbation (B9) and its plain version.

Counterpart of ``repro.kernels.noise_inject``:

    out = clip(w + sig * eps, -(2 - sig), 2 - sig)

with w [K, N] fp32 (the group-normalized weight), ``sig`` = sigmoid(s) per
16-row group of K, and eps ~ U[-1, 1) from the counter hash of the global
element index ``k * N + n`` and a uint32 seed (``kernels.prng``): no noise
tensor ever reaches device memory. sigmoid(s) is computed once per group
by the wrapper (K / 16 values) and handed to both the kernel and the plain
version, so the two agree bit for bit by construction; the product and the
sum round separately, as the reference's ``noise_inject_jnp`` does.

The seed is a one-element int64 tensor on the weight's device (drawn there
from a ``torch.Generator``), which the kernel reads itself: no host sync.
On CUDA tensors the wrapper launches ``csrc/noise_inject.cu`` or raises;
on CPU tensors it runs the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Union

import torch

from repro_torch.core import quant
from repro_torch.core.qtypes import GROUP_SIZE

from . import _build, prng

SOURCE = "noise_inject.cu"

# Launches of the CUDA kernel in this process (plain-version calls do not
# count); reset by whoever reads it.
LAUNCHES: Dict[str, int] = {"noise_inject": 0}

SeedLike = Union[int, torch.Tensor]


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.soniq_noise_inject
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int


def seed_tensor(seed: SeedLike, device) -> torch.Tensor:
    """A uint32 seed as the one-element int64 tensor the kernel reads."""
    t = torch.as_tensor(seed, dtype=torch.int64, device=device).reshape(1)
    return t & prng.MASK


def group_sigma(s: torch.Tensor) -> torch.Tensor:
    """sigmoid(s) per group, fp32: the one sigmoid both versions use."""
    return torch.sigmoid(s.float())


def hash_eps(k: int, n: int, seed: SeedLike, device) -> torch.Tensor:
    """eps [K, N] fp32 of the global element index and the seed."""
    return prng.uniform_pm1(prng.element_index(k, n, device),
                            seed_tensor(seed, device))


def noise_inject_plain(w: torch.Tensor, sig: torch.Tensor, seed: SeedLike,
                       group_size: int = GROUP_SIZE) -> torch.Tensor:
    """Plain version: ``sig`` [K // group_size] is sigmoid(s) per group."""
    k, n = w.shape
    sg = quant.expand_groups(sig.float(), k, group_size)[:, None]
    out = w.float() + sg * hash_eps(k, n, seed, w.device)
    lim = 2.0 - sg
    return torch.minimum(torch.maximum(out, -lim), lim).to(w.dtype)


def noise_inject(w: torch.Tensor, s: torch.Tensor, seed: SeedLike,
                 group_size: int = GROUP_SIZE) -> torch.Tensor:
    """w [K, N] fp32, s [K // group_size] logits -> clip(w + sig*eps,
    +-(2 - sig)), fp32 [K, N]."""
    if w.dim() != 2:
        raise ValueError(f"w must be 2-D, got {tuple(w.shape)}")
    k, n = w.shape
    if k % group_size or s.numel() * group_size != k:
        raise ValueError(f"s {tuple(s.shape)} does not cover K={k} in "
                         f"groups of {group_size}")
    sig = group_sigma(s)
    if w.device.type == "cpu":
        return noise_inject_plain(w, sig, seed, group_size)
    if w.device.type != "cuda":
        raise ValueError(f"unsupported device {w.device}")
    if w.dtype != torch.float32 or not w.is_contiguous():
        raise ValueError("w must be contiguous fp32")
    if k * n >= 1 << 32:
        raise ValueError(f"[{k}, {n}] overflows the uint32 element index")
    seed_t = seed_tensor(seed, w.device)
    sig = sig.contiguous()
    if sig.device != w.device:
        raise ValueError("s must lie on w's device")
    out = torch.empty_like(w)
    if out.numel() == 0:
        return out
    lib = _build.library(SOURCE, _bind)
    code = _build.launch(w.device, lib.soniq_noise_inject, w.data_ptr(),
                         sig.data_ptr(), seed_t.data_ptr(), out.data_ptr(),
                         k, n, group_size)
    _build.check(code, "soniq_noise_inject")
    LAUNCHES["noise_inject"] += 1
    return out
