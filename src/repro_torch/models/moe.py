"""Mixture-of-Experts feed-forward: top-k routing, dispatch into stacked
expert banks (drop-free in serving, static capacity with drops in
training), shared experts (DeepSeekMoE) and Mixtral-style top-2, and the
load-balancing loss. Counterpart of ``repro.models.moe``.

The serve forward follows the reference's order step by step: the fp32
router (a plain fp32 matmul: the router is never quantized), its softmax,
top-k with ties to the lower expert index, the top-k gates normalized;
a stable sort of the (token, rank) assignments by expert gives each its
row in the [E, T, D] dispatch buffer (drop-free: capacity T, so no
assignment is dropped and a token's output never depends on its batch
neighbours); the three expert projections run as grouped GEMMs over the
stacked packed banks (``backend.packed_matmul_grouped``: kernel B6), each
told how many rows of each expert are live, so no work goes to rows and
experts that no token was routed to; the
expert outputs are gathered back, weighted by the gates and summed per
token as a left fold in top-k order in the activation dtype, which is how
the reference's ``segment_sum`` adds them (one rounding per add, the same
order on every device, no atomics); the shared experts add a dense MLP.

Training (Phase I and II, and FP) follows the reference's
``moe_apply`` step by step: the static capacity C = max(1, ceil(T k / E *
1.25)) from the call's own T, the same stable ranks, ``keep = rank <
C``, each kept assignment added into its row of the [E, C, D] buffer and
each dropped one adding zeros into the clamped row C - 1; the banks run
their NOISE or QAT rule over [E, C, D] (kernels B9 and B8 over the whole
bank, one launch each way), the outputs gathered back with the dropped
gates zeroed and summed per token, then the shared MLP, and the
load-balancing loss E * sum(mean(probs) * mean(any hit)). The router is an
fp32 skip linear and takes a gradient. The scatter and the gathers (and
their backward passes) are sort-based index puts and gathers, with no
atomics, so a step repeats bitwise.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.backend import base as backend
from repro_torch.core import smol
from repro_torch.core.qtypes import QuantConfig
from . import mlp as mlp_lib
from .common import activation, silu

# Training capacity of an expert, in units of its fair share T k / E.
CAPACITY_FACTOR = 1.25

def moe_init(d_model: int, d_ff: int, num_experts: int, qcfg: QuantConfig,
             *, generator, device, num_shared: int = 0,
             act: str = "swiglu", dtype=torch.float32) -> Dict:
    """Random MoE leaves: the fp32 router [D, E] (not quantized), stacked
    expert banks ``up`` / ``gate`` / ``down`` [E, K, N] (one
    ``smol.linear_init`` per expert, stacked) and, with ``num_shared``, a
    shared MLP of width ``d_ff * num_shared``."""
    kw = dict(generator=generator, device=device, dtype=dtype)

    def expert_bank(din, dout):
        leaves = [smol.linear_init(din, dout, qcfg, **kw)
                  for _ in range(num_experts)]
        return {name: torch.stack([lf[name] for lf in leaves])
                for name in leaves[0]}

    p = {"router": smol.linear_init(d_model, num_experts, qcfg,
                                    generator=generator, device=device,
                                    quantized=False, dtype=torch.float32),
         "up": expert_bank(d_model, d_ff),
         "down": expert_bank(d_ff, d_model)}
    if act == "swiglu":
        p["gate"] = expert_bank(d_model, d_ff)
    if num_shared:
        p["shared"] = mlp_lib.mlp_init(
            d_model, d_ff * num_shared, qcfg,
            generator=generator, device=device, act=act, dtype=dtype)
    return p


class ExpertBank(smol.SmolLinear):
    """One stacked expert bank ([E, ...] leaves). Serving runs the grouped
    driver over a packed bank; training runs the bank's NOISE or QAT rule
    (``smol.linear_apply`` on [E, ...] leaves). The module path (e.g.
    ``blocks.3.moe.up``) keys a bank's noise draws: E weight seeds and
    the activation noise of the whole [E, C, K] input."""

    def forward(self, x: torch.Tensor, qcfg: QuantConfig, noise=None,
                rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [E, C, K] -> [E, C, N] in x's dtype; ``rows`` [E] int32, the
        live rows of each expert (serving: ``backend.packed_matmul_grouped``;
        training reads every row)."""
        if "w4" in self._names:
            if qcfg.mode != "serve":
                raise ValueError(f"packed bank under mode {qcfg.mode!r}")
            return backend.packed_matmul_grouped(self.leaf(), x, qcfg,
                                                 rows=rows)
        draw = None
        if qcfg.mode == "noise" and "s" in self._names:
            if noise is None:
                raise ValueError("a Phase-I bank needs its noise draws")
            draw = noise.draw(self.path, x, experts=x.shape[0])
        return smol.linear_apply(self.rule_leaf(qcfg), x, qcfg, draw)


class MoE(nn.Module):
    def __init__(self, tree: Dict, act: str = "swiglu"):
        super().__init__()
        self.act = act
        self.router = smol.SmolLinear(tree["router"])
        self.up = ExpertBank(tree["up"])
        self.down = ExpertBank(tree["down"])
        self.gate = ExpertBank(tree["gate"]) if "gate" in tree else None
        self.shared = mlp_lib.MLP(tree["shared"], act=act) \
            if "shared" in tree else None

    def tree(self) -> Dict:
        out = {"router": self.router.leaf(), "up": self.up.leaf(),
               "down": self.down.leaf()}
        if self.gate is not None:
            out["gate"] = self.gate.leaf()
        if self.shared is not None:
            out["shared"] = self.shared.tree()
        return out


def route(logits: torch.Tensor, top_k: int):
    """fp32 router logits [T, E] -> (gates [T, k], expert ids [T, k]):
    the softmax, the k largest probabilities with ties to the lower
    expert index (a stable descending sort, as ``jax.lax.top_k``), and the
    gates normalized by their sum, taken left to right."""
    return top_k_gates(torch.softmax(logits.float(), dim=-1), top_k)


def top_k_gates(probs: torch.Tensor, top_k: int):
    """:func:`route` from the router's probabilities [T, E]."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = vals[:, :top_k], ids[:, :top_k]
    total = gates[:, 0]
    for j in range(1, top_k):
        total = total + gates[:, j]
    return gates / total[:, None], ids


def dispatch_rows(expert_ids: torch.Tensor, num_experts: int) -> torch.Tensor:
    """The row of each (token, rank) assignment in its expert's slice of
    the dispatch buffer: its rank among the assignments to that expert in
    (token, rank) order (a stable sort by expert)."""
    flat = expert_ids.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    sorted_expert = flat[order]
    start = torch.searchsorted(
        sorted_expert, torch.arange(num_experts, device=flat.device))
    rank_sorted = torch.arange(flat.numel(), device=flat.device) \
        - start[sorted_expert]
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    return rank


def combine(y_tok: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """y_tok [T, k, D] weighted by the gates [T, k] (cast to y_tok's
    dtype) and summed over k as a left fold from zero in top-k order,
    rounding after each add: the reference's ``segment_sum`` in update
    order."""
    w = y_tok * gates.to(y_tok.dtype)[..., None]
    y = torch.zeros_like(w[:, 0])
    for j in range(w.shape[1]):
        y = y + w[:, j]
    return y


def moe_apply(moe: MoE, x: torch.Tensor, qcfg: QuantConfig, *,
              num_experts: int, top_k: int, noise=None
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """MoE feed-forward, x [B, S, D] -> (y [B, S, D], aux): the drop-free
    serve path (aux None: serving has no loss) or, in any other mode, the
    training path with static capacity and the load-balancing loss aux
    (an fp32 scalar). ``noise`` supplies the Phase-I draws."""
    if qcfg.mode == "serve":
        return _moe_serve(moe, x, qcfg, num_experts=num_experts,
                          top_k=top_k), None
    b, s, d = x.shape
    t = b * s
    e = num_experts
    xt = x.reshape(t, d)
    cap = max(1, math.ceil(t * top_k / e * CAPACITY_FACTOR))
    logits = moe.router(xt.float(), qcfg)                     # [T, E]
    probs = torch.softmax(logits.float(), dim=-1)
    gates, ids = top_k_gates(probs, top_k)
    flat_expert = ids.reshape(-1)
    rank = dispatch_rows(ids, e)
    keep = rank < cap                                         # capacity drop
    rank_c = torch.clamp(rank, max=cap - 1)
    token_idx = torch.arange(t, device=x.device).repeat_interleave(top_k)
    gathered = xt[token_idx]
    upd = torch.where(keep[:, None], gathered, torch.zeros_like(gathered))
    # Kept assignments own their rows; the dropped ones add zeros into
    # the clamped row cap - 1, as the reference's scatter-add does.
    x_e = torch.zeros((e, cap, d), dtype=x.dtype, device=x.device)
    x_e = x_e.index_put((flat_expert, rank_c), upd, accumulate=True)
    h = moe.up(x_e, qcfg, noise)                              # [E, C, F]
    if moe.gate is not None:
        h = silu(moe.gate(x_e, qcfg, noise)) * h
    else:
        h = activation(moe.act)(h)
    y_e = moe.down(h, qcfg, noise)                            # [E, C, D]
    y_tok = y_e[flat_expert, rank_c]                          # [T*k, D]
    kept = torch.where(keep, gates.reshape(-1),
                       torch.zeros_like(gates.reshape(-1)))
    y = combine(y_tok.reshape(t, top_k, d), kept.reshape(t, top_k))
    if moe.shared is not None:
        y = y + moe.shared(xt[None], qcfg, noise)[0]
    # Load balancing (GShard / Switch): E * sum_e mean(p_e) * mean(hit_e).
    me = probs.mean(dim=0)
    hit = torch.zeros((t, e), dtype=torch.float32, device=x.device)
    hit = hit.scatter(1, ids, 1.0)
    ce = (hit > 0).float().mean(dim=0)
    aux = e * torch.sum(me * ce)
    return y.reshape(b, s, d).to(x.dtype), aux


def _moe_serve(moe: MoE, x: torch.Tensor, qcfg: QuantConfig, *,
               num_experts: int, top_k: int) -> torch.Tensor:
    """Serve-phase MoE feed-forward, x [B, S, D] -> [B, S, D]."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    logits = moe.router(xt.float(), qcfg)                     # [T, E]
    gates, ids = route(logits, top_k)
    flat_expert = ids.reshape(-1)
    rank = dispatch_rows(ids, num_experts)
    token_idx = torch.arange(t, device=x.device).repeat_interleave(top_k)
    # Drop-free capacity: every expert has a row for every token. Expert
    # e's assignments fill its rows 0..count_e-1; the grouped GEMMs skip
    # the rest. The counts stay on the device (torch.bincount would read
    # its maximum back to the host to size its output).
    x_e = torch.zeros((num_experts, t, d), dtype=x.dtype, device=x.device)
    x_e.index_put_((flat_expert, rank), xt[token_idx], accumulate=True)
    counts = torch.zeros(num_experts, dtype=torch.int32, device=x.device)
    counts.scatter_add_(0, flat_expert, torch.ones_like(flat_expert,
                                                        dtype=torch.int32))
    h = moe.up(x_e, qcfg, rows=counts)
    if moe.gate is not None:
        h = silu(moe.gate(x_e, qcfg, rows=counts)) * h
    else:
        h = activation(moe.act)(h)
    y_e = moe.down(h, qcfg, rows=counts)                      # [E, T, D]
    y = combine(y_e[flat_expert, rank].reshape(t, top_k, d), gates)
    if moe.shared is not None:
        y = y + moe.shared(xt[None], qcfg)[0]
    return y.reshape(b, s, d).to(x.dtype)
