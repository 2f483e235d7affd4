"""Decode attention over the packed 4-bit KV cache, ring (B4) and paged
(B5), and their plain versions.

Counterpart of ``repro.kernels.attn_decode``: q [B, S, Hk, G, D] (RoPE
applied) attends over 4-bit K/V codes [.., Hk, D // 2] (channel 2j in the
low nibble) with one fp16 scale per (entry, head), under the causal-by-
position mask with an optional sliding window; entries with ``pos < 0``
are empty, query lanes with ``q_pos < 0`` are masked (their row is the
uniform average, as the reference's softmax over an all-masked row).

* ``qkv_attn_decode`` (B4) reads a ring [B, T, Hk, ..] and takes an exact
  softmax over the full row.
* ``qkv_attn_decode_paged`` (B5) walks ``page_table`` [B, NP] over the
  page pool [P, page_size, Hk, ..] with an online softmax; unmapped pages
  read the null page 0 and are masked.

On CUDA tensors the wrappers launch ``csrc/attn_decode.cu`` or raise: one
flash-decode body for both layouts, split over the cache by
``split_entries`` (chunks fixed by the entry count alone, each an online
softmax, folded left in chunk order inside the launch), so B5 equals B4
bitwise on the same content laid out as a ring. On CPU tensors they run
the plain versions: the reference's oracle
(``repro.backend.base.qkv_attn_jnp``) over the dequantized ring or the
gathered pages. Both follow the port's row-reduction rule
(``core.numerics``): every sum and the softmax in float64, one rounding
to fp32 at the end, so a row does not depend on the batch or on the
layout, and a kernel agrees with its plain version within fp32 rounding:
|kernel - plain| <= 1e-6 * (P @ |V|) + 1e-12 (``TOLERANCE``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.serve import kv_pool, kv_quant

from . import _build

SOURCE = "attn_decode.cu"
NEG_INF = -1e30
# |kernel - plain| <= RTOL * (P @ |V|) + ATOL, P the plain softmax.
TOLERANCE = dict(rtol=1e-6, atol=1e-12)
MAX_HEAD_DIM = 128       # the kernels' register and shared-memory tiles
TILE = 32                # entries a warp takes per step (one a lane)
MAX_CHUNKS = 64          # chunks a row is split into at most

# Launches of each CUDA kernel in this process (plain-version calls do not
# count); reset by whoever reads them.
LAUNCHES: Dict[str, int] = {"qkv_attn_decode": 0,
                            "qkv_attn_decode_paged": 0}


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.soniq_qkv_attn_decode.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        i32, i32, i32, i32, i32, i32, i32, i32, ptr]
    lib.soniq_qkv_attn_decode_paged.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, ptr]
    lib.soniq_qkv_attn_decode.restype = i32
    lib.soniq_qkv_attn_decode_paged.restype = i32


# ------------------------------------------------------------ plain ops ----
def attention_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                   window: Optional[int]) -> torch.Tensor:
    """[B, S], [B, T] -> bool [B, S, T]: causal by position, entries with
    pos < 0 dropped, optional sliding window."""
    qp = q_pos.long()[:, :, None]
    kp = k_pos.long()[:, None, :]
    m = (qp >= kp) & (kp >= 0)
    if window is not None:
        m &= (qp - kp) < window
    return m


def qkv_attn_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 k_pos: torch.Tensor, q_pos: torch.Tensor,
                 window: Optional[int] = None) -> torch.Tensor:
    """Masked GQA attention, the oracle both kernels are held to. q
    [B, S, Hk, G, D], k/v [B, T, Hk, D] (dequantized), k_pos [B, T], q_pos
    [B, S] -> [B, S, Hk, G, D] fp32. Scores (multiplied by 1/sqrt(D) after
    the dot), the -1e30 mask fill, the exact softmax and the value
    contraction in float64, rounded once."""
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q.double(), k.double())
    scores = scores * (1.0 / math.sqrt(q.shape[-1]))
    mask = attention_mask(q_pos, k_pos, window)
    scores = torch.where(mask[:, None, None], scores,
                         torch.full((), NEG_INF, dtype=torch.float64,
                                    device=scores.device))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v.double()).float()


def error_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                k_pos: torch.Tensor, q_pos: torch.Tensor,
                window: Optional[int] = None) -> torch.Tensor:
    """The elementwise bound a kernel is held to against its plain
    version: ``rtol * (P @ |V|) + atol`` (``TOLERANCE``), P the plain
    softmax. The kernel's one fp32 rounding of a float64 value sits far
    inside it."""
    mag = qkv_attn_ref(q, k, v.abs(), k_pos, q_pos, window)
    return TOLERANCE["rtol"] * mag.double() + TOLERANCE["atol"]


def qkv_attn_decode_plain(q, k_codes, v_codes, k_scale, v_scale, kv_pos,
                          q_pos, *, window: Optional[int] = None
                          ) -> torch.Tensor:
    """Plain B4: the oracle over the dequantized ring."""
    k = kv_quant.dequantize_kv(k_codes, k_scale, torch.float32)
    v = kv_quant.dequantize_kv(v_codes, v_scale, torch.float32)
    return qkv_attn_ref(q, k, v, kv_pos, q_pos, window)


def qkv_attn_decode_paged_plain(q, k_codes, v_codes, k_scale, v_scale,
                                pool_pos, page_table, q_pos, *,
                                window: Optional[int] = None
                                ) -> torch.Tensor:
    """Plain B5: the oracle over the pages gathered into a dense ring."""
    k, v, k_pos = kv_pool.gather_paged(
        {"k_codes": k_codes, "v_codes": v_codes, "k_scale": k_scale,
         "v_scale": v_scale, "pos": pool_pos, "page_table": page_table},
        torch.float32)
    return qkv_attn_ref(q, k, v, k_pos, q_pos, window)


# ------------------------------------------------------------- wrappers ----
def split_entries(n: int) -> Tuple[int, int]:
    """The kernels' split of a row's ``n`` cache entries (T for the ring,
    NP * page_size for the pool): ``(chunk, count)``, chunks of ``chunk``
    entries (a multiple of ``TILE``; the last one shorter) and at most
    ``MAX_CHUNKS`` of them. It depends on ``n`` alone, never on the batch,
    the query rows or the card, so the order of every sum in a row is fixed
    by the cache size (``csrc/attn_decode.cu``: each chunk an online
    softmax, the chunks folded left in order)."""
    if n <= 0:
        raise ValueError(f"a row needs entries, got {n}")
    chunk = TILE * -(-n // (TILE * MAX_CHUNKS))
    return chunk, -(-n // chunk)


_RING_DTYPES = (torch.uint8, torch.uint8, torch.float16, torch.float16,
                torch.int32, torch.int32)
_PAGED_DTYPES = _RING_DTYPES + (torch.int32,)


def _check_operands(q, ops, dtypes, shapes):
    """One pass over the kernel's operands: each on q's device, of its
    dtype, contiguous, of its shape; the codes 4-byte aligned."""
    d = q.shape[-1]
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} must be a multiple of 8 and <= "
                         f"{MAX_HEAD_DIM}")
    dev = q.device
    for t, dt, shape in zip(ops, dtypes, shapes):
        if t.device != dev or t.dtype != dt or not t.is_contiguous() \
                or t.shape != shape:
            raise ValueError(
                f"operand {tuple(t.shape)} {t.dtype} on {t.device} must be "
                f"contiguous {dt} {shape} on {dev}")
    if (ops[0].data_ptr() | ops[1].data_ptr()) % 4:
        raise ValueError("the K/V codes must be 4-byte aligned")


def _window_arg(window: Optional[int]) -> int:
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    return -1 if window is None else int(window)


def qkv_attn_decode(q: torch.Tensor, k_codes: torch.Tensor,
                    v_codes: torch.Tensor, k_scale: torch.Tensor,
                    v_scale: torch.Tensor, kv_pos: torch.Tensor,
                    q_pos: torch.Tensor, *,
                    window: Optional[int] = None) -> torch.Tensor:
    """B4: attention over the packed 4-bit ring. q [B, S, Hk, G, D] (any
    float dtype, read as fp32); k_codes/v_codes [B, T, Hk, D // 2] uint8;
    k_scale/v_scale [B, T, Hk, 1] f16; kv_pos [B, T], q_pos [B, S] int32.
    -> [B, S, Hk, G, D] fp32."""
    if q.dim() != 5 or k_codes.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)} must be [B,S,Hk,G,D] and the "
                         f"codes {tuple(k_codes.shape)} [B,T,Hk,D/2]")
    if q.device.type == "cpu":
        return qkv_attn_decode_plain(q, k_codes, v_codes, k_scale, v_scale,
                                     kv_pos, q_pos, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, s, hk, g, d = q.shape
    t = k_codes.shape[1]
    if t == 0:
        raise ValueError("the ring must be non-empty")
    codes, scales = (b, t, hk, d // 2), (b, t, hk, 1)
    _check_operands(q, (k_codes, v_codes, k_scale, v_scale, kv_pos, q_pos),
                    _RING_DTYPES,
                    (codes, codes, scales, scales, (b, t), (b, s)))
    q = q.float().contiguous()
    out = torch.empty((b, s, hk, g, d), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    lib = _build.library(SOURCE, _bind)
    code = _build.launch(
        q.device, lib.soniq_qkv_attn_decode, q.data_ptr(),
        k_codes.data_ptr(), v_codes.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), kv_pos.data_ptr(), q_pos.data_ptr(),
        out.data_ptr(), b, s, hk, g, d, t, split_entries(t)[0],
        _window_arg(window))
    _build.check(code, "soniq_qkv_attn_decode")
    LAUNCHES["qkv_attn_decode"] += 1
    return out


def qkv_attn_decode_paged(q: torch.Tensor, k_codes: torch.Tensor,
                          v_codes: torch.Tensor, k_scale: torch.Tensor,
                          v_scale: torch.Tensor, pool_pos: torch.Tensor,
                          page_table: torch.Tensor, q_pos: torch.Tensor, *,
                          window: Optional[int] = None) -> torch.Tensor:
    """B5: attention over the packed 4-bit page pool through the per-slot
    page table. k_codes/v_codes [P, ps, Hk, D // 2] uint8; k_scale/v_scale
    [P, ps, Hk, 1] f16; pool_pos [P, ps], page_table [B, NP] (< 0 =
    unmapped), q_pos [B, S] int32. -> [B, S, Hk, G, D] fp32."""
    if q.dim() != 5 or k_codes.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)} must be [B,S,Hk,G,D] and the "
                         f"codes {tuple(k_codes.shape)} [P,ps,Hk,D/2]")
    if q.device.type == "cpu":
        return qkv_attn_decode_paged_plain(
            q, k_codes, v_codes, k_scale, v_scale, pool_pos, page_table,
            q_pos, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, s, hk, g, d = q.shape
    npages, ps = pool_pos.shape
    npg = page_table.shape[-1]
    codes, scales = (npages, ps, hk, d // 2), (npages, ps, hk, 1)
    _check_operands(q, (k_codes, v_codes, k_scale, v_scale, pool_pos, q_pos,
                        page_table), _PAGED_DTYPES,
                    (codes, codes, scales, scales, (npages, ps), (b, s),
                     (b, npg)))
    q = q.float().contiguous()
    out = torch.empty((b, s, hk, g, d), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    if npg == 0 or ps == 0:
        raise ValueError("the page table and the pages must be non-empty")
    lib = _build.library(SOURCE, _bind)
    code = _build.launch(
        q.device, lib.soniq_qkv_attn_decode_paged, q.data_ptr(),
        k_codes.data_ptr(), v_codes.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), pool_pos.data_ptr(), page_table.data_ptr(),
        q_pos.data_ptr(), out.data_ptr(), b, s, hk, g, d, npages, ps, npg,
        split_entries(npg * ps)[0], _window_arg(window))
    _build.check(code, "soniq_qkv_attn_decode_paged")
    LAUNCHES["qkv_attn_decode_paged"] += 1
    return out
