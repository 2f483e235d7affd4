"""The port's kernel-backed ops. Counterpart of ``repro.backend.base``:
the serve-mode linear drivers (``packed_matmul``, the grouped
``packed_matmul_grouped`` over a stacked expert bank,
``quantize_pack_mixed``),
decode attention over the packed KV cache, and the two training ops with
their backward passes (``noise_inject``, ``fake_quant``).

There is no backend registry in the port yet: the driver picks the kernel
by the device of its tensors. CUDA tensors launch the hand-written kernels
of ``repro_torch.kernels``; CPU tensors run their plain versions; any
other device raises.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import pack as pack_lib
from repro_torch.core import quant
from repro_torch.core.qtypes import GROUP_SIZE
from repro_torch.kernels import attn_decode as ad
from repro_torch.kernels import fake_quant as fq
from repro_torch.kernels import noise_inject as ni
from repro_torch.kernels import packed_matmul as pm
from repro_torch.kernels import quant_pack as qp

ACT_SCALE_EPS = quant.ACT_SCALE_EPS

# Serve-mode packed matmuls run in draft mode (``qcfg.draft_slice_bits``
# set) in this process: the check that the speculative draft took the
# low-slice path. Counted per driver call.
_DRAFT_MATMUL_CALLS = 0


def draft_matmul_call_count() -> int:
    """How many packed matmuls ran in draft mode, the high-bit carriers
    skipped per ``QuantConfig.draft_slice_bits``."""
    return _DRAFT_MATMUL_CALLS


def act_scale(x: torch.Tensor, act_scale_mode: str,
              eps: float = ACT_SCALE_EPS) -> torch.Tensor:
    """Dynamic activation scale: ``per_token`` reduces over the last dim
    (row-independent), ``per_tensor`` over the whole tensor, ``none`` is
    1. The abs-max is clamped at ``eps`` (all-zero rows stay finite)."""
    if act_scale_mode == "none":
        return torch.ones((), dtype=torch.float32, device=x.device)
    if act_scale_mode == "per_token":
        return quant.abs_max_scale(x, dim=-1, eps=eps)
    return quant.abs_max_scale(x, eps=eps)


def _segments(bufs: Dict, g: int, expert: bool):
    """The non-empty segments of a packed leaf's carriers; a stacked
    bank's geometry is expert 0's (identical across E: ``convert_tree``
    rebudgets every expert onto one [K4|K2|K1] split)."""
    if expert:
        bufs = {name: t[0] for name, t in bufs.items()}
    return list(pack_lib.iter_packed_segments(bufs, g))


def draft_segments(segs, bits, bits_of=lambda seg: seg[1]):
    """The segments a draft reads: those whose precision (``bits_of``; a
    ``pack_lib.iter_packed_segments`` tuple by default) is at most
    ``bits``. A layer with no such segment keeps its full mix (it has no
    cheap slice)."""
    return [s for s in segs if bits_of(s) <= bits] or segs


def _draft_slice(segs, qcfg):
    """The segments a matmul reads: :func:`draft_segments` of
    ``qcfg.draft_slice_bits`` in draft mode (counted), else all of
    them."""
    bits = qcfg.draft_slice_bits
    if bits is None:
        return segs
    global _DRAFT_MATMUL_CALLS
    _DRAFT_MATMUL_CALLS += 1
    return draft_segments(segs, bits)


def _sorted_pbits(serve_params: Dict, segs, device) -> torch.Tensor:
    """The sorted per-group precisions of the (first expert's) packed
    leaf; legacy dicts without the leaf rebuild them from the
    segments."""
    pbits = serve_params.get("pbits_sorted")
    if pbits is None:
        return torch.as_tensor(np.concatenate(
            [np.full(ng, p, np.float32)
             for _n, p, _o, _kp, _go, ng in segs]), device=device)
    return (pbits[0] if pbits.dim() == 2 else pbits).float()


def packed_matmul(serve_params: Dict, x: torch.Tensor, qcfg) -> torch.Tensor:
    """Serve-mode SmolLinear over a packed leaf, in the reference's order:
    channel perm; per-token scale on the permuted row; the self-scale gate
    (per_token mode and one segment spanning K); the GEMMs of the
    non-empty [K4|K2|K1] segments in one launch, accumulated in fp32 one
    segment after the other; bias; cast to x's dtype.

    The fused form (``qcfg.fuse_act_quant``) quantizes the activations in
    the segment kernels' prologue (B1, B2). The two-pass form runs one
    whole-K ``fake_quant`` (B8), then the plain segment GEMM (B3), which
    also serves ``quantize_activations=False`` directly; both forms give
    bitwise the same output.

    Draft mode (``qcfg.draft_slice_bits``, self-speculative decoding)
    drops the segments above the bound before the self-scale gate, so a
    filtered segment that no longer spans K takes the driver scale; the
    scale and the two-pass ``fake_quant`` still cover the full row."""
    bufs = {name: serve_params[name] for name, _p, _v in pack_lib.SEGMENTS}
    k = sum(bufs[name].shape[0] * v for name, _p, v in pack_lib.SEGMENTS)
    g = qcfg.eff_group_size(k)
    every = _segments(bufs, g, expert=False)
    segs = _draft_slice(every, qcfg)
    x = x.index_select(-1, serve_params["perm"])
    fused = self_scale = False
    sx = None
    if qcfg.quantize_activations:
        fused = qcfg.fuse_act_quant
        self_scale = (fused and qcfg.act_scale_mode == "per_token"
                      and len(segs) == 1 and segs[0][3] == k)
        if not self_scale:
            sx = act_scale(x, qcfg.act_scale_mode)
        if not fused:
            x = fake_quant(x, _sorted_pbits(serve_params, every, x.device),
                           sx, g)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    sx2 = None
    if fused and not self_scale:
        # One [M, 1] scale operand for every segment kernel (per_tensor /
        # "none" broadcast one value to each row).
        sx2 = torch.broadcast_to(sx.float().reshape(-1, 1),
                                 (m, 1)).contiguous()
    wscale = serve_params.get("wscale")
    n = max(bufs[name].shape[1] for name, _p, _v in pack_lib.SEGMENTS)
    y = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    ops = [(bufs[name], None if wscale is None else wscale[goff:goff + ng],
            p, off) for name, p, off, _kp, goff, ng in segs]
    pm.segments_matmul(x2, ops, sx=sx2, self_scale=self_scale,
                       group_size=g, out=y)
    b = serve_params.get("b")
    if b is not None:
        y = y + b.float()
    return y.reshape(lead + (n,)).to(x.dtype)


def packed_matmul_grouped(serve_params: Dict, x: torch.Tensor, qcfg,
                          rows: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Serve-mode SmolLinear over a stacked packed expert bank ([E, ...]
    leaves from ``convert_tree``), x [E, M, K] -> [E, M, N] in x's dtype:
    the reference's ``Backend.packed_matmul_grouped`` step by step.
    Per-expert channel perm; the activation scale (``per_tensor`` reduces
    each expert's slice); one whole-K ``fake_quant`` (B8) over [E, M, K];
    one grouped GEMM launch (B6) over the non-empty segments into one fp32
    [E, M, N] accumulator; bias; cast. It always takes the two-pass form,
    as the reference does, so expert e's output is bitwise the dense
    two-pass ``packed_matmul`` on expert e's leaf. ``rows`` [E] int32 (on
    x's device): the live rows of each expert (0..rows[e]-1, the layout
    of the MoE dispatch buffer); B6 leaves the others out, and they come
    back as the bias alone. None: every row is live, the reference's
    semantics. Draft mode drops segments as :func:`packed_matmul` does."""
    bufs = {name: serve_params[name] for name, _p, _v in pack_lib.SEGMENTS}
    e = x.shape[0]
    k = sum(bufs[name].shape[1] * v for name, _p, v in pack_lib.SEGMENTS)
    g = qcfg.eff_group_size(k)
    every = _segments(bufs, g, expert=True)
    segs = _draft_slice(every, qcfg)
    perm = serve_params["perm"].long()                      # [E, K]
    x = torch.gather(x, -1, perm[:, None, :].expand(x.shape))
    if qcfg.quantize_activations:
        if qcfg.act_scale_mode == "none":
            sx = torch.ones((), dtype=torch.float32, device=x.device)
        elif qcfg.act_scale_mode == "per_token":
            sx = quant.abs_max_scale(x, dim=-1)
        else:
            # per_tensor: each expert's slice, as the reference's vmap
            # oracle reduces it.
            sx = quant.abs_max_scale(x, dim=(1, 2))
        x = fake_quant(x, _sorted_pbits(serve_params, every, x.device),
                       sx, g)
    wscale = serve_params.get("wscale")                     # [E, NG]
    n = max(bufs[name].shape[2] for name, _p, _v in pack_lib.SEGMENTS)
    y = torch.zeros((e, x.shape[1], n), dtype=torch.float32,
                    device=x.device)
    ops = [(bufs[name], None if wscale is None else wscale[:, goff:goff + ng],
            p, off) for name, p, off, _kp, goff, ng in segs]
    pm.segments_matmul(x, ops, rows=rows, group_size=g, out=y)
    b = serve_params.get("b")
    if b is not None:
        y = y + b[:, None, :].float()
    return y.to(x.dtype)


def quantize_pack_mixed(w: torch.Tensor, pbits: np.ndarray,
                        scales: Optional[torch.Tensor] = None,
                        group_size: int = GROUP_SIZE,
                        perm: Optional[torch.Tensor] = None,
                        out=None) -> Dict:
    """Quantize + bit-pack a [K, N] weight (or an [S, K, N] stack whose
    slices share one split) into the [K4|K2|K1] segments that its sorted
    per-group ``pbits`` ([K // G], or [S, K // G]) define, in one
    ``quantize_pack`` launch. ``perm`` (int32 [K] or [S, K] on w's
    device): the sorted row k is w's row perm[k], read in place; None:
    w is sorted already. ``scales`` are in sorted order. ``out``: the
    three carriers to write (else allocated)."""
    w = w.float()
    k, n = w.shape[-2:]
    pbits = np.asarray(pbits)
    if pbits.ndim != w.dim() - 1 or pbits.shape[-1] * group_size != k:
        raise ValueError(f"pbits {pbits.shape} do not cover K={k} in "
                         f"groups of {group_size}")
    ranks = np.select([pbits == 4, pbits == 2, pbits == 1], [0, 1, 2], -1)
    if np.any(ranks < 0) or np.any(np.diff(ranks, axis=-1) < 0):
        raise ValueError("pbits must be sorted 4 -> 2 -> 1")
    counts = np.stack([(pbits == p).sum(-1) for p in (4, 2, 1)], -1)
    counts = counts.reshape(-1, 3)
    if np.any(counts != counts[0]):
        raise ValueError("stacked slices must share one [K4|K2|K1] split")
    segs = tuple(int(c) * group_size for c in counts[0])
    if scales is not None:
        scales = scales.float().contiguous()
    packed = qp.quantize_pack_segments(
        w if w.stride(-1) == 1 else w.contiguous(), perm, scales,
        segments=segs, group_size=group_size, out=out)
    out = {"segments": segs, "scales": scales, "n": n,
           "group_size": group_size}
    out.update((name, t) for (name, _p, _v), t in zip(pack_lib.SEGMENTS,
                                                      packed))
    return out


def qkv_attn_decode(q: torch.Tensor, cache: Dict, q_pos: torch.Tensor, *,
                    window: Optional[int] = None) -> torch.Tensor:
    """Decode attention over one layer's packed 4-bit ring (``k_codes`` /
    ``v_codes`` [B, T, Hk, D // 2], ``k_scale`` / ``v_scale`` [B, T, Hk, 1]
    f16, ``pos`` [B, T]); q [B, S, Hk, G, D] with RoPE applied, ``q_pos``
    [B, S] (< 0 = masked lane). Returns [B, S, Hk, G, D] fp32 through
    kernel B4 (on CPU tensors its plain version, the reference's oracle
    ``qkv_attn_jnp``: ``kernels.attn_decode.qkv_attn_ref``)."""
    return ad.qkv_attn_decode(
        q, cache["k_codes"], cache["v_codes"], cache["k_scale"],
        cache["v_scale"], cache["pos"], q_pos.to(torch.int32), window=window)


def qkv_attn_decode_paged(q: torch.Tensor, cache: Dict, q_pos: torch.Tensor,
                          *, window: Optional[int] = None) -> torch.Tensor:
    """Decode attention over one layer's packed 4-bit paged cache (pool
    leaves [P, page_size, Hk, ...], ``pos`` [P, page_size], ``page_table``
    [B, NP]); otherwise as :func:`qkv_attn_decode`, through kernel B5."""
    return ad.qkv_attn_decode_paged(
        q, cache["k_codes"], cache["v_codes"], cache["k_scale"],
        cache["v_scale"], cache["pos"], cache["page_table"],
        q_pos.to(torch.int32), window=window)


# --------------------------------------------------------------------------
# Training ops: a kernel forward and a kernel backward each (the reference's
# backward is jnp in a shared custom VJP, which XLA fuses on the TPU).
# --------------------------------------------------------------------------

def hash_eps(shape: Tuple[int, int], seed, device=None) -> torch.Tensor:
    """The shared Phase-I noise draw: eps ~ U(-1, 1) [K, N] fp32 from the
    counter hash of the global element index and the seed."""
    k, n = shape
    return ni.hash_eps(k, n, seed, device)


class _NoiseInject(torch.autograd.Function):
    """clip(w + sigma(s) * eps, +-(2 - sigma)) through kernel B9; the
    backward through B9's backward kernel, which recomputes eps from the
    hash (``base.py::_noise_inject_bwd`` of the reference)."""

    @staticmethod
    def forward(ctx, w, s, seed, group_size):
        ctx.save_for_backward(w, s, seed)
        ctx.group_size = group_size
        return ni.noise_inject(w, s, seed, group_size)

    @staticmethod
    def backward(ctx, g):
        w, s, seed = ctx.saved_tensors
        dw, ds = ni.noise_inject_bwd(w, s, seed, g.contiguous(),
                                     ctx.group_size)
        return dw, ds, None, None


def noise_inject(w: torch.Tensor, s: torch.Tensor, seed,
                 group_size: int = GROUP_SIZE) -> torch.Tensor:
    """Phase-I fused perturbation of w [K, N] fp32 with logits s
    [K // group_size], differentiable in (w, s). ``seed`` is a uint32 (an
    int or a one-element int64 tensor on w's device). A stacked expert
    bank w [E, K, N] takes s [E, K // group_size] and E seeds: one launch
    each way."""
    return _NoiseInject.apply(w.contiguous(), s,
                              ni.seed_tensor(seed, w.device), group_size)


class _FakeQuant(torch.autograd.Function):
    """Quantize-dequantize through kernel B8 with the clipped-STE
    backward through B8's backward kernel (dx = g * in_range;
    ``base.py::_fake_quant_bwd``)."""

    @staticmethod
    def forward(ctx, x, pbits, scale, row_scale, k_dim, group_size):
        ctx.save_for_backward(x, pbits, scale)
        ctx.layout = (row_scale, k_dim, group_size)
        return fq.fake_quant(x, pbits, scale, row_scale=row_scale,
                             k_dim=k_dim, group_size=group_size)

    @staticmethod
    def backward(ctx, g):
        x, pbits, scale = ctx.saved_tensors
        row_scale, k_dim, group_size = ctx.layout
        dx = fq.fake_quant_bwd(x, pbits, scale, g.contiguous(),
                               row_scale=row_scale, k_dim=k_dim,
                               group_size=group_size)
        return dx, None, None, None, None, None


def fake_quant(x: torch.Tensor, pbits: torch.Tensor, scale,
               group_size: int = GROUP_SIZE) -> torch.Tensor:
    """Clipped-STE quantize-dequantize of x [..., K] along K with
    per-group ``pbits`` [K // group_size]. ``scale`` is one value per row
    (a scalar, or any [..., 1] shape that broadcasts over x's rows:
    [1, ..., 1], one per row, one per expert [E, 1, 1] of x [E, M, K]) or
    per group [K // group_size]. Differentiable in x.

    An expert bank's activations x [E, ..., K] take each expert's own
    precisions ``pbits`` [E, K // group_size] (and a per-row scale that
    broadcasts per expert, or per-group scales [E, K // group_size]): one
    launch each way."""
    k = x.shape[-1]
    lead = x.shape[:-1]
    m = int(np.prod(lead, dtype=np.int64)) if lead else 1
    bank = pbits.dim() == 2
    e = pbits.shape[0] if bank else 1
    if bank and (x.dim() < 2 or x.shape[0] != e):
        raise ValueError(f"pbits {tuple(pbits.shape)} of {e} experts for "
                         f"x {tuple(x.shape)}")
    s = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    ng = max(k // group_size, 1)
    if s.dim() == 0 or (s.shape[-1] == 1 and s.numel() == 1):
        s_op, row = s.reshape(1).expand(m).contiguous(), True
    elif s.shape[-1] == 1 and s.dim() == x.dim() and all(
            a in (1, b) for a, b in zip(s.shape[:-1], lead)):
        s_op, row = s.expand(lead + (1,)).reshape(m).contiguous(), True
    elif tuple(s.shape) == tuple(pbits.shape[:-1]) + (ng,):
        s_op, row = s.contiguous(), False
    else:
        raise ValueError(f"scale {tuple(s.shape)} is neither per row nor "
                         f"per group of x {tuple(x.shape)}")
    shape = (e, m // e, k) if bank else (m, k)
    y = _FakeQuant.apply(x.reshape(shape).contiguous(),
                         pbits.float().contiguous(), s_op, row, 1,
                         group_size)
    return y.reshape(x.shape)


def fake_quant_weight(w: torch.Tensor, pbits: torch.Tensor,
                      scale: torch.Tensor,
                      group_size: int = GROUP_SIZE) -> torch.Tensor:
    """Clipped-STE quantize-dequantize of a weight w [K, N] along K with
    per-group ``pbits`` and ``scale`` [K // group_size]: the reference's
    ``fake_quant(swapaxes(w), ...)`` swapped back, read in place. A stacked
    bank w [E, K, N] takes pbits and scales [E, K // group_size]: one
    launch each way."""
    return _FakeQuant.apply(w.contiguous(), pbits.float().contiguous(),
                            scale.float().contiguous(), False, 0,
                            group_size)
