"""Mixture-of-Experts feed-forward: top-k routing, drop-free dispatch into
stacked expert banks, shared experts (DeepSeekMoE) and Mixtral-style
top-2. Counterpart of ``repro.models.moe`` for serving.

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

Expert banks in Phase I and II (MoE training) belong to a later port
slice: there ``moe_apply`` raises.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.backend import base as backend
from repro_torch.core import smol
from repro_torch.core.qtypes import QuantConfig
from . import mlp as mlp_lib
from .common import activation, silu

TRAINING_SLICE = ("MoE expert banks in Phase I/II (training) belong to a "
                  "later port slice; the port serves MoE models from "
                  "packed banks")


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
    driver over a packed bank; the module path (e.g. ``blocks.3.moe.up``)
    is what keys a bank's noise draws in training."""

    def forward(self, x: torch.Tensor, qcfg: QuantConfig, noise=None,
                rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [E, C, K] -> [E, C, N] in x's dtype; ``rows`` [E] int32, the
        live rows of each expert (``backend.packed_matmul_grouped``)."""
        if "w4" not in self._names or qcfg.mode != "serve":
            raise NotImplementedError(TRAINING_SLICE)
        return backend.packed_matmul_grouped(self.leaf(), x, qcfg, rows=rows)


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
    probs = torch.softmax(logits.float(), dim=-1)
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
              num_experts: int, top_k: int) -> torch.Tensor:
    """Serve-phase MoE feed-forward, x [B, S, D] -> [B, S, D]."""
    if qcfg.mode != "serve":
        raise NotImplementedError(TRAINING_SLICE)
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
