"""Mamba2 / SSD block (state-space duality, arXiv:2405.21060).
Counterpart of ``repro.models.ssm``: a scalar-identity A per head, one
group of B/C. The full-sequence forward and the chunked prefill run the
chunked SSD decomposition (the quadratic form within a chunk, the
recurrence across chunks); decode is the O(1) state update. The recurrent
state ``h`` stays fp32 (the accumulator stays wide, DESIGN.md §5); the
in/out projections are ``SmolLinear``s (serve: kernel B1 on the packed
carriers).

The SSD contractions follow the port's row-reduction rule
(``core.numerics``): ``ssd_chunked`` runs in float64 and rounds its
outputs once to fp32, and decode's read-out ``C h`` sums in float64, so a
row's result does not depend on the batch, the chunk layout or the
device's GEMM. The reference runs these products in fp32 outside any
kernel; the float64 sums are within fp32 rounding of it. The causal conv
is the reference's loop of ``CONV_K`` fp32 multiply-adds in its order
(no ``conv1d``). Caches are updated in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core import smol
from repro_torch.core.numerics import sum_fp64
from repro_torch.core.qtypes import QuantConfig
from .common import rms_norm, silu

CONV_K = 4          # causal depthwise conv width
HEAD_DIM = 64       # SSM head dim P
# The fp leaves of a mixer, in the reference's order.
FP_LEAVES = ("conv_w", "conv_b", "A_log", "D", "dt_bias", "norm_g")


def mamba2_init(d_model: int, d_state: int, qcfg: QuantConfig, *,
                generator, device, expand: int = 2,
                dtype=torch.float32) -> Dict:
    """Random mixer. ``dt`` comes from ``np.random.default_rng(0)``
    whatever the generator, as the reference draws it, so ``dt_bias``
    equals the reference's bitwise; ``A = -exp(A_log) = -1``."""
    d_inner = expand * d_model
    h = d_inner // HEAD_DIM
    conv_dim = d_inner + 2 * d_state
    proj_out = 2 * d_inner + 2 * d_state + h       # z, x, B, C, dt
    dt = np.exp(np.random.default_rng(0).uniform(
        np.log(1e-3), np.log(1e-1), h)).astype(np.float32)
    kw = dict(generator=generator, device=device, dtype=dtype)
    in_proj = smol.linear_init(d_model, proj_out, qcfg, **kw)
    conv_w = torch.randn((CONV_K, conv_dim), generator=generator,
                         device=device) * 0.1
    return {
        "in_proj": in_proj,
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "A_log": torch.zeros((h,), dtype=torch.float32, device=device),
        "D": torch.ones((h,), dtype=torch.float32, device=device),
        "dt_bias": torch.as_tensor(np.log(np.expm1(dt)), device=device),
        "norm_g": torch.ones((d_inner,), dtype=torch.float32,
                             device=device),
        "out_proj": smol.linear_init(d_inner, d_model, qcfg, **kw),
    }


class Mamba2(nn.Module):
    """One mixer: ``in_proj`` and ``out_proj`` as ``SmolLinear``s, the fp
    leaves as parameters (frozen until training asks for gradients)."""

    def __init__(self, tree: Dict):
        super().__init__()
        self.in_proj = smol.SmolLinear(tree["in_proj"])
        for name in FP_LEAVES:
            setattr(self, name, nn.Parameter(tree[name],
                                             requires_grad=False))
        self.out_proj = smol.SmolLinear(tree["out_proj"])

    def tree(self) -> Dict:
        out = {"in_proj": self.in_proj.leaf()}
        out.update((name, getattr(self, name)) for name in FP_LEAVES)
        out["out_proj"] = self.out_proj.leaf()
        return out


def _replace_inf(t: torch.Tensor) -> torch.Tensor:
    """+inf -> 0 (JAX's guard in ``logaddexp``'s derivative)."""
    return torch.where(t == float("inf"), torch.zeros((), dtype=t.dtype,
                                                      device=t.device), t)


class _Softplus(torch.autograd.Function):
    """``jax.nn.softplus``, i.e. ``logaddexp(x, 0)`` as JAX computes it,
    with JAX's derivative: the forward is ``max(x, 0) + log1p(exp(-|x|))``
    (``F.softplus`` returns x itself above its threshold of 20); the
    backward is ``logaddexp``'s custom JVP, ``g * exp(x - out)`` with +inf
    read as 0, which is 0.5 at x = 0 (autograd of the forward's formula
    gives 1 there)."""

    @staticmethod
    def forward(ctx, x):
        out = torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g * torch.exp(_replace_inf(x) - _replace_inf(out))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` with JAX's derivative (:class:`_Softplus`)."""
    return _Softplus.apply(x)


def _segsum_exp(da: torch.Tensor) -> torch.Tensor:
    """da [..., L] log-decays -> lower-triangular decay matrix
    L[i, j] = exp(sum_{j < t <= i} da_t), 0 for j > i. [..., L, L]. The
    upper triangle is set to -inf before the ``exp`` (which gives 0
    exactly, with a zero gradient): masking after it would multiply an
    overflowed ``exp(diff)`` by a zero cotangent, NaN in the backward."""
    n = da.shape[-1]
    cs = torch.cumsum(da, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]          # [..., i, j]
    mask = torch.tril(torch.ones((n, n), dtype=torch.bool,
                                 device=da.device))
    return torch.exp(torch.where(mask, diff, torch.full(
        (), float("-inf"), dtype=da.dtype, device=da.device)))


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero steps appended along dim 1."""
    if not pad:
        return t
    shape = (t.shape[0], pad) + tuple(t.shape[2:])
    return torch.cat([t, t.new_zeros(shape)], dim=1)


def ssd_chunked(xdt: torch.Tensor, da: torch.Tensor, b_mat: torch.Tensor,
                c_mat: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    xdt [B, S, H, P] (x times dt), da [B, S, H] (dt * A, the negative
    log-decay of a step), b_mat and c_mat [B, S, N] (one group, broadcast
    over H), h0 an optional [B, H, P, N] carried state (None: zeros).
    Returns y [B, S, H, P] and the final state [B, H, P, N], fp32.

    A length that is not a multiple of ``chunk`` is padded with
    state-neutral steps (da = 0: decay 1; zero inputs: no contribution)
    and the output sliced back, as the reference pads every call."""
    bsz, s, h, p = xdt.shape
    n = b_mat.shape[-1]
    q = chunk
    pad = (-s) % q
    nc = (s + pad) // q
    f64 = torch.float64
    xdt = _pad_seq(xdt.float(), pad).reshape(bsz, nc, q, h, p).to(f64)
    da = _pad_seq(da.float(), pad).reshape(bsz, nc, q, h).to(f64)
    bm = _pad_seq(b_mat.float(), pad).reshape(bsz, nc, q, n).to(f64)
    cm = _pad_seq(c_mat.float(), pad).reshape(bsz, nc, q, n).to(f64)

    da_h = da.movedim(-1, 2)                             # [B, nc, H, Q]
    da_cs = torch.cumsum(da_h, dim=-1)

    # Within a chunk (quadratic in its length).
    ell = _segsum_exp(da_h)                              # [B,nc,H,Q,Q]
    cb = torch.einsum("bcin,bcjn->bcij", cm, bm)         # [B,nc,Q,Q]
    y_diag = torch.einsum("bcij,bchij,bcjhp->bcihp", cb, ell, xdt)

    # Each chunk's contribution to the carried state.
    decay_states = torch.exp(da_cs[..., -1:] - da_cs)    # [B,nc,H,Q]
    states = torch.einsum("bcjn,bchj,bcjhp->bchpn", bm, decay_states, xdt)

    # The recurrence across chunks (the only sequential loop).
    chunk_decay = torch.exp(da_cs[..., -1])              # [B,nc,H]
    hcur = xdt.new_zeros((bsz, h, p, n)) if h0 is None \
        else h0.float().to(f64)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(hcur)
        hcur = chunk_decay[:, c, :, None, None] * hcur + states[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                 # [B,nc,H,P,N]

    # The carried state, decayed, read by C.
    state_decay = torch.exp(da_cs)                       # [B,nc,H,Q]
    y_off = torch.einsum("bcin,bchpn,bchi->bcihp", cm, h_prev, state_decay)

    y = (y_diag + y_off).reshape(bsz, s + pad, h, p)[:, :s]
    return y.float(), hcur.float()


def ssd_reference(xdt: torch.Tensor, da: torch.Tensor, b_mat: torch.Tensor,
                  c_mat: torch.Tensor, h0: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain sequential recurrence, fp32 (the tests' oracle)."""
    bsz, s, h, p = xdt.shape
    n = b_mat.shape[-1]
    hcur = xdt.new_zeros((bsz, h, p, n), dtype=torch.float32) \
        if h0 is None else h0.float()
    ys = []
    for t in range(s):
        xt, dat = xdt[:, t].float(), da[:, t].float()
        bt, ct = b_mat[:, t].float(), c_mat[:, t].float()
        hcur = torch.exp(dat)[..., None, None] * hcur \
            + xt[..., None] * bt[:, None, None, :]
        ys.append(sum_fp64("bhpn,bn->bhp", hcur, ct))
    return torch.stack(ys, dim=1), hcur


def _split_proj(zxbcdt: torch.Tensor, d_inner: int, d_state: int):
    z = zxbcdt[..., :d_inner]
    xin = zxbcdt[..., d_inner:2 * d_inner]
    b_mat = zxbcdt[..., 2 * d_inner:2 * d_inner + d_state]
    c_mat = zxbcdt[..., 2 * d_inner + d_state:2 * d_inner + 2 * d_state]
    dt_raw = zxbcdt[..., 2 * d_inner + 2 * d_state:]
    return z, xin, b_mat, c_mat, dt_raw


def _conv_taps(win: torch.Tensor, w: torch.Tensor, s: int) -> torch.Tensor:
    """sum_i win[:, i:i + s] * w[i] in fp32, the reference's loop (from
    zeros, tap by tap)."""
    out = torch.zeros(win.shape[:1] + (s,) + win.shape[2:],
                      dtype=torch.float32, device=win.device)
    for i in range(w.shape[0]):
        out = out + win[:, i:i + s].float() * w[i].float()
    return out


def _causal_conv(seq: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of a fresh sequence: seq [B, S, C], w [K, C],
    left-padded with K - 1 zeros; SiLU; cast back to seq's dtype."""
    k = w.shape[0]
    pad = torch.cat([seq.new_zeros((seq.shape[0], k - 1, seq.shape[2])),
                     seq], dim=1)
    out = _conv_taps(pad, w, seq.shape[1])
    return silu(out + b.float()).to(seq.dtype)


def _gate_norm_out(m: Mamba2, y: torch.Tensor, z: torch.Tensor,
                   x_dtype: torch.dtype, qcfg: QuantConfig,
                   noise=None) -> torch.Tensor:
    """y [..., d_inner] fp32: gated by SiLU(z), RMS-normed (eps 1e-5, the
    mixer's own), projected out in x's dtype."""
    y = y * silu(z.float())
    y = rms_norm(m.norm_g, y)
    return m.out_proj(y.to(x_dtype), qcfg, noise)


def mamba2_apply(m: Mamba2, x: torch.Tensor, qcfg: QuantConfig,
                 noise: Optional[smol.NoiseSource] = None, *, d_state: int,
                 expand: int = 2, chunk: int = 256) -> torch.Tensor:
    """Full-sequence forward from a zero state. x [B, S, D] -> [B, S, D]."""
    bsz, s, d_model = x.shape
    d_inner = expand * d_model
    h = d_inner // HEAD_DIM
    zxbcdt = m.in_proj(x, qcfg, noise)
    z, xin, b_mat, c_mat, dt_raw = _split_proj(zxbcdt, d_inner, d_state)
    conv_in = torch.cat([xin, b_mat, c_mat], dim=-1)
    conv_out = _causal_conv(conv_in, m.conv_w, m.conv_b)
    xin, b_mat, c_mat = torch.split(conv_out, (d_inner, d_state, d_state),
                                    dim=-1)

    dt = softplus(dt_raw.float() + m.dt_bias)            # [B, S, H]
    a = -torch.exp(m.A_log)                              # [H]
    xh = xin.reshape(bsz, s, h, HEAD_DIM)
    xdt = xh.float() * dt[..., None]
    y, _ = ssd_chunked(xdt, dt * a, b_mat, c_mat, chunk)
    y = y + m.D[None, None, :, None] * xh.float()
    return _gate_norm_out(m, y.reshape(bsz, s, d_inner), z, x.dtype, qcfg,
                          noise)


# ------------------------------------------------------------- decode ----
def init_ssm_cache(batch: int, d_model: int, d_state: int, *,
                   expand: int = 2, dtype=torch.float32,
                   device=None) -> Dict:
    """The decode state of one layer: ``h`` fp32 [B, H, P, N] and the conv
    window ``conv`` [B, K - 1, conv_dim] in the cache dtype."""
    d_inner = expand * d_model
    h = d_inner // HEAD_DIM
    conv_dim = d_inner + 2 * d_state
    return {
        "h": torch.zeros((batch, h, HEAD_DIM, d_state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, CONV_K - 1, conv_dim), dtype=dtype,
                            device=device),
    }


def mamba2_decode(m: Mamba2, x: torch.Tensor, cache: Dict,
                  qcfg: QuantConfig, *, d_state: int,
                  expand: int = 2) -> torch.Tensor:
    """One-token decode, x [B, 1, D] -> [B, 1, D]. Every row's state
    advances (no position mask, as the reference): an idle row's state is
    garbage that admission wipes."""
    bsz, _, d_model = x.shape
    d_inner = expand * d_model
    h = d_inner // HEAD_DIM
    zxbcdt = m.in_proj(x[:, 0], qcfg)
    z, xin, b_mat, c_mat, dt_raw = _split_proj(zxbcdt, d_inner, d_state)
    conv_in = torch.cat([xin, b_mat, c_mat], dim=-1)        # [B, C]
    window = torch.cat([cache["conv"],
                        conv_in[:, None].to(cache["conv"].dtype)], dim=1)
    conv_out = _conv_taps(window, m.conv_w, 1)[:, 0]         # [B, C] fp32
    conv_out = silu(conv_out + m.conv_b.float())
    xin, b_mat, c_mat = torch.split(conv_out, (d_inner, d_state, d_state),
                                    dim=-1)

    dt = softplus(dt_raw.float() + m.dt_bias)                # [B, H]
    a = -torch.exp(m.A_log)
    xh = xin.reshape(bsz, h, HEAD_DIM)
    hs = torch.exp(dt * a)[..., None, None] * cache["h"] \
        + (xh * dt[..., None])[..., None] * b_mat[:, None, None, :]
    y = sum_fp64("bhpn,bn->bhp", hs, c_mat) + m.D[None, :, None] * xh
    out = _gate_norm_out(m, y.reshape(bsz, d_inner), z, x.dtype, qcfg)
    cache["h"].copy_(hs)
    cache["conv"].copy_(window[:, 1:])
    return out[:, None]


def mamba2_prefill(m: Mamba2, x: torch.Tensor, cache: Dict,
                   pos: torch.Tensor, qcfg: QuantConfig, *, d_state: int,
                   expand: int = 2, chunk: int = 256) -> torch.Tensor:
    """Chunked multi-token step through the SSD decomposition. x [B, C, D];
    pos [B, C] with trailing -1 marking padding lanes (each slot feeds a
    contiguous valid prefix). The conv's left context comes from the
    cache's window and the state threads through ``ssd_chunked(h0=...)``.
    Padding lanes are state-neutral (dt = 0) and the window is written
    back from the last valid inputs, so a slot with no valid lane keeps
    its cache bitwise. Outputs at padding lanes are garbage."""
    bsz, s, d_model = x.shape
    d_inner = expand * d_model
    h = d_inner // HEAD_DIM
    valid = pos >= 0                                         # [B, S]
    zxbcdt = m.in_proj(x, qcfg)
    z, xin, b_mat, c_mat, dt_raw = _split_proj(zxbcdt, d_inner, d_state)
    conv_in = torch.cat([xin, b_mat, c_mat], dim=-1)         # [B, S, C]
    win = torch.cat([cache["conv"].to(conv_in.dtype), conv_in], dim=1)
    conv_out = silu(_conv_taps(win, m.conv_w, s) + m.conv_b.float())
    xin, b_mat, c_mat = torch.split(conv_out, (d_inner, d_state, d_state),
                                    dim=-1)

    dt = softplus(dt_raw.float() + m.dt_bias)                # [B, S, H]
    dt = torch.where(valid[..., None], dt, torch.zeros((), device=dt.device))
    a = -torch.exp(m.A_log)
    xh = xin.reshape(bsz, s, h, HEAD_DIM)
    xdt = xh.float() * dt[..., None]
    y, h_last = ssd_chunked(xdt, dt * a, b_mat, c_mat, chunk,
                            h0=cache["h"])
    y = y + m.D[None, None, :, None] * xh.float()
    out = _gate_norm_out(m, y.reshape(bsz, s, d_inner), z, x.dtype, qcfg)

    # The window's write-back: a slot's last K - 1 real inputs. With n
    # valid lanes, win[n : n + K - 1] (n = 0 keeps the old window).
    n_valid = valid.sum(dim=1)                               # [B]
    idx = n_valid[:, None] + torch.arange(CONV_K - 1, device=x.device)
    new_conv = torch.gather(win, 1, idx[..., None].expand(
        -1, -1, win.shape[-1]))
    cache["h"].copy_(h_last)
    cache["conv"].copy_(new_conv.to(cache["conv"].dtype))
    return out
