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

``noise_inject_bwd`` is the backward, the reference's custom VJP
(``repro.backend.base._noise_inject_bwd``): dw = g inside the clip and 0
at it; ds sums g * (eps inside, -sign(z) at the clip) over each group and
chains through sigma' = sigma (1 - sigma). The kernel rebuilds eps from the
same hash in registers and folds each group's sum in a fixed order inside
the launch (dw bitwise the plain version, ds up to the order of its fp32
sum: ``DS_RTOL``).

Expert banks: w [E, K, N] with s [E, K // 16] and seeds [E] (an int64
tensor of uint32 values) go through the same wrappers in one launch each
way. Expert e's eps is the hash of the index within its own [K, N] and
its own seed, as the reference's ``vmap`` over a bank draws it, so a bank
is bitwise E single-weight calls, in the kernel and in the plain version.

On CUDA tensors the wrappers launch ``csrc/noise_inject.cu`` or raise; on
CPU tensors they run the plain versions.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple, Union

import torch

from repro_torch.core import quant
from repro_torch.core.qtypes import GROUP_SIZE

from . import _build, prng

SOURCE = "noise_inject.cu"

# Launches of the CUDA kernel in this process (plain-version calls do not
# count); reset by whoever reads it.
LAUNCHES: Dict[str, int] = {"noise_inject": 0, "noise_inject_bwd": 0}

# |ds_kernel - ds_plain| <= DS_RTOL * sig (1 - sig) * sum |g * dsig| over
# the group: the two fp32 sums of the same terms in different orders (the
# kernel's runs ~N / 1,024 * G + 13 additions deep).
DS_RTOL = 2e-5

SeedLike = Union[int, torch.Tensor]


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.soniq_noise_inject.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32,
                                       i32, ptr]
    lib.soniq_noise_inject_bwd.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32,
                                           i32, i32, i32, ptr]
    lib.soniq_noise_inject.restype = i32
    lib.soniq_noise_inject_bwd.restype = i32


def seed_tensor(seed: SeedLike, device) -> torch.Tensor:
    """uint32 seeds as the int64 tensor the kernel reads: one element for a
    single weight, E for a bank."""
    t = torch.as_tensor(seed, dtype=torch.int64, device=device).reshape(-1)
    return t & prng.MASK


def group_sigma(s: torch.Tensor) -> torch.Tensor:
    """sigmoid(s) per group, fp32: the one sigmoid both versions use."""
    return torch.sigmoid(s.float())


def hash_eps(k: int, n: int, seed: SeedLike, device,
             row0: int = 0) -> torch.Tensor:
    """eps fp32 of the element index within a [K, N] weight and the seed:
    [K, N] for one seed, [E, K, N] for E seeds (a bank: each expert's
    index restarts at 0); with ``row0``, of rows row0 .. row0 + K - 1 of a
    taller weight."""
    idx = prng.element_index(k, n, device, row0)
    seeds = seed_tensor(seed, device)
    if seeds.numel() == 1:
        return prng.uniform_pm1(idx, seeds)
    return prng.uniform_pm1(idx[None], seeds[:, None, None])


def _sigma_rows(sig: torch.Tensor, k: int, group_size: int) -> torch.Tensor:
    """Per-group values [..., K // G] -> [..., K, 1] over a weight's rows."""
    return quant.expand_groups(sig.float(), k, group_size)[..., None]


# Rows a band of the plain versions on the CPU: there a band's int64 hash
# temporaries stay in the caches, several times faster than whole-weight
# temporaries, and every element is computed alone, so the result is the
# same bit for bit. On the card the plain versions take the whole weight.
CPU_BAND_ROWS = 64


def _row_bands(w: torch.Tensor, group_size: int):
    """(rows, their groups, the first row) of each band of w's rows."""
    k = w.shape[-2]
    step = CPU_BAND_ROWS if w.device.type == "cpu" \
        and CPU_BAND_ROWS % group_size == 0 else k
    return [(slice(r, r + step), slice(r // group_size,
                                        (r + step) // group_size), r)
            for r in range(0, k, step)]


def noise_inject_plain(w: torch.Tensor, sig: torch.Tensor, seed: SeedLike,
                       group_size: int = GROUP_SIZE,
                       row0: int = 0) -> torch.Tensor:
    """Plain version: ``sig`` [K // group_size] is sigmoid(s) per group (a
    bank w [E, K, N]: sig [E, K // group_size], seeds [E]). ``row0``: w
    (and sig) are the band of rows from row0 (a multiple of the group) of
    a taller weight, whose element index the noise takes: the plain
    version of a large weight, a band at a time."""
    n = w.shape[-1]
    out = torch.empty(w.shape, dtype=w.dtype, device=w.device)
    for rows, groups, r in _row_bands(w, group_size):
        wb = w[..., rows, :]
        sg = _sigma_rows(sig[..., groups], wb.shape[-2], group_size)
        z = wb.float() + sg * hash_eps(wb.shape[-2], n, seed, w.device,
                                       row0 + r)
        lim = 2.0 - sg
        out[..., rows, :] = torch.minimum(torch.maximum(z, -lim), lim)
    return out


def noise_inject_bwd_plain(w: torch.Tensor, s: torch.Tensor,
                           seed: SeedLike, g: torch.Tensor,
                           group_size: int = GROUP_SIZE, row0: int = 0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain backward: (dw [..., K, N] in w's dtype, ds [..., K //
    group_size] in s's dtype) for the cotangent g of w's shape (``row0``:
    a band of a taller weight, as in :func:`noise_inject_plain`)."""
    n = w.shape[-1]
    sig_g = group_sigma(s)
    dw = torch.empty(w.shape, dtype=w.dtype, device=w.device)
    per_k = torch.empty(w.shape[:-1], dtype=torch.float32, device=w.device)
    for rows, groups, r in _row_bands(w, group_size):
        wb = w[..., rows, :]
        sig = _sigma_rows(sig_g[..., groups], wb.shape[-2], group_size)
        eps = hash_eps(wb.shape[-2], n, seed, w.device, row0 + r)
        z = wb.float() + sig * eps
        inside = z.abs() <= 2.0 - sig
        g32 = g[..., rows, :].float()
        dw[..., rows, :] = torch.where(inside, g32, torch.zeros_like(g32))
        # d out / d sigma: eps inside the clip; at the clamp the limit
        # +-(2 - sigma) itself moves with sigma (d/dsigma = -+1).
        dsig = torch.where(inside, eps, -torch.sign(z))
        per_k[..., rows] = torch.sum(g32 * dsig, dim=-1)
    # Chain through sigma'(s) = sigma (1 - sigma) and sum each group's
    # block (fixed-order reductions: no atomics).
    per_group = per_k.reshape(sig_g.shape + (group_size,)).sum(dim=-1)
    ds = (per_group * sig_g * (1.0 - sig_g)).to(s.dtype)
    return dw, ds


def ds_bound(w: torch.Tensor, s: torch.Tensor, seed: SeedLike,
             g: torch.Tensor, group_size: int = GROUP_SIZE,
             row0: int = 0) -> torch.Tensor:
    """The bound [..., K // group_size] a kernel's ds is held to against
    the plain version's: ``DS_RTOL`` * sig (1 - sig) * the group's sum of
    |g * d out / d sig| (``row0``: a band of a taller weight)."""
    k, n = w.shape[-2:]
    sig_g = group_sigma(s)
    sig = _sigma_rows(sig_g, k, group_size)
    eps = hash_eps(k, n, seed, w.device, row0)
    inside = (w.float() + sig * eps).abs() <= 2.0 - sig
    mag = g.float().abs() * torch.where(inside, eps.abs(), 1.0)
    per_group = mag.sum(dim=-1).reshape(sig_g.shape + (group_size,)).sum(
        dim=-1)
    return DS_RTOL * per_group * sig_g * (1.0 - sig_g)


def _shape(w: torch.Tensor, s: torch.Tensor, seed: SeedLike,
           group_size: int) -> Tuple[int, int, int]:
    """(E, K, N) of a weight [K, N] (E = 1) or a bank [E, K, N], once s
    and the seeds cover it."""
    if w.dim() not in (2, 3):
        raise ValueError(f"w must be [K, N] or a bank [E, K, N], got "
                         f"{tuple(w.shape)}")
    e = w.shape[0] if w.dim() == 3 else 1
    k, n = w.shape[-2:]
    lead = tuple(w.shape[:-2])
    covers = s.numel() * group_size == k if not lead else \
        tuple(s.shape) == lead + (k // group_size,)
    if k % group_size or not covers:
        raise ValueError(f"s {tuple(s.shape)} does not cover w "
                         f"{tuple(w.shape)} in groups of {group_size}")
    seeds = torch.as_tensor(seed).numel()
    if seeds != e:
        raise ValueError(f"{seeds} seeds for {e} weight(s)")
    if k * n >= 1 << 32:
        raise ValueError(f"[{k}, {n}] overflows the uint32 element index")
    return e, k, n


def noise_inject(w: torch.Tensor, s: torch.Tensor, seed: SeedLike,
                 group_size: int = GROUP_SIZE) -> torch.Tensor:
    """w [K, N] fp32, s [K // group_size] logits, one seed -> clip(w +
    sig*eps, +-(2 - sig)), fp32 [K, N]; a bank w [E, K, N] with s [E, K //
    group_size] and E seeds in one launch."""
    e, k, n = _shape(w, s, seed, group_size)
    sig = group_sigma(s)
    if w.device.type == "cpu":
        return noise_inject_plain(w, sig, seed, group_size)
    if w.device.type != "cuda":
        raise ValueError(f"unsupported device {w.device}")
    if w.dtype != torch.float32 or not w.is_contiguous():
        raise ValueError("w must be contiguous fp32")
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
                         e, k, n, group_size)
    _build.check(code, "soniq_noise_inject")
    LAUNCHES["noise_inject"] += 1
    return out


def noise_inject_bwd(w: torch.Tensor, s: torch.Tensor, seed: SeedLike,
                     g: torch.Tensor, group_size: int = GROUP_SIZE
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward of :func:`noise_inject` at (w, s, seed) for the
    cotangent g of w's shape: (dw fp32 of w's shape, ds of s's shape and
    dtype); a bank in one launch. On CUDA, w and g must be contiguous fp32
    on one device; the seeds are read on the device (ints, or the int64
    tensor the forward took)."""
    e, k, n = _shape(w, s, seed, group_size)
    if w.device.type == "cpu":
        return noise_inject_bwd_plain(w, s, seed, g, group_size)
    if w.device.type != "cuda":
        raise ValueError(f"unsupported device {w.device}")
    if not (isinstance(seed, torch.Tensor) and seed.dtype == torch.int64
            and seed.dim() == 1):
        seed = seed_tensor(seed, w.device)
    sig = group_sigma(s)
    f32 = torch.float32
    for t, dt in ((w, f32), (g, f32), (sig, f32), (seed, torch.int64)):
        if t.device != w.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"operand {tuple(t.shape)} {t.dtype} on "
                             f"{t.device} must be contiguous {dt} on "
                             f"{w.device}")
    if g.shape != w.shape:
        raise ValueError(f"g {tuple(g.shape)} is not w's {tuple(w.shape)}")
    dw = torch.empty_like(w)
    if dw.numel() == 0:
        return dw, torch.zeros_like(s)
    ds = torch.empty(s.shape, dtype=torch.float32, device=w.device)
    lib = _build.library(SOURCE, _bind)
    code = _build.launch(w.device, lib.soniq_noise_inject_bwd, w.data_ptr(),
                         sig.data_ptr(), seed.data_ptr(), g.data_ptr(),
                         dw.data_ptr(), ds.data_ptr(), e, k, n, group_size)
    _build.check(code, "soniq_noise_inject_bwd")
    LAUNCHES["noise_inject_bwd"] += 1
    return dw, ds.to(s.dtype)
