"""AdamW with SONIQ's parameter groups. Counterpart of
``repro.optim.adamw`` (not ``torch.optim.AdamW``, whose semantics
differ):

  * global-norm gradient clipping over every gradient,
  * decoupled weight decay only on ``w`` and ``table`` leaves (not on
    norms, biases or ``s``),
  * the Phase-I ``s`` logits at lr * ``s_lr_mult``,
  * integer leaves (``pbits``, the packed metadata) are buffers, not
    parameters, so they take no update,
  * moments in fp32 regardless of the parameter dtype.

The reference returns new arrays; the port updates parameters and moments
in place, one leaf at a time (what keeps full-width training inside the
card's memory), with each step's arithmetic in the reference's order.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    s_lr_mult: float = 10.0         # Phase-I s logits move faster (SMOL)
    clip_norm: float = 1.0
    moment_dtype: str = "float32"


def leaf_name(path: str) -> str:
    """The leaf's own name (``w``, ``s``, ``b``, ``g``, ``table``)."""
    return path.rsplit(".", 1)[-1]


def trainable(model: nn.Module) -> List[Tuple[str, nn.Parameter]]:
    """(path, parameter) of every parameter, in module order."""
    return list(model.named_parameters())


def init_state(model: nn.Module, moment_dtype: str = "float32") -> Dict:
    mdt = getattr(torch, moment_dtype)
    params = trainable(model)
    return {"mu": {n: torch.zeros_like(p, dtype=mdt) for n, p in params},
            "nu": {n: torch.zeros_like(p, dtype=mdt) for n, p in params},
            "count": 0}


def global_norm(grads: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
    """sqrt of the sum of every gradient's sum of squares (leaf order)."""
    total = None
    for g in grads:
        if g is None:
            continue
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    if total is None:
        return torch.zeros(())
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(model: nn.Module, grads: Dict[str, torch.Tensor],
                  state: Dict, cfg: AdamWConfig, lr_scale=1.0) -> Dict:
    """One AdamW step in place; ``grads`` maps parameter paths to
    gradients (a missing or None gradient leaves its parameter alone).
    Returns {"grad_norm": the pre-clip global norm}."""
    params = trainable(model)
    if not params:
        return {"grad_norm": torch.zeros(())}
    dev = params[0][1].device
    f32 = dict(dtype=torch.float32, device=dev)
    state["count"] += 1
    count = float(state["count"])
    c1 = 1.0 - torch.pow(torch.tensor(cfg.b1, **f32), count)
    c2 = 1.0 - torch.pow(torch.tensor(cfg.b2, **f32), count)
    gn = global_norm([grads.get(n) for n, _ in params]).to(dev)
    scale = torch.clamp(torch.tensor(cfg.clip_norm, **f32)
                        / torch.clamp(gn, min=1e-9), max=1.0)
    lr0 = torch.tensor(cfg.lr, **f32) * torch.as_tensor(lr_scale, **f32)
    for path, p in params:
        g = grads.get(path)
        if g is None:
            continue
        name = leaf_name(path)
        lr = lr0 * cfg.s_lr_mult if name == "s" else lr0
        decay = bool(cfg.weight_decay) and name in ("w", "table")
        leaf = (p, g, state["mu"][path], state["nu"][path])
        # Element by element, so in chunks: a leaf's fp32 temporaries
        # (five of its size at once) would not fit beside a full-width
        # model's table.
        if all(t.is_contiguous() for t in leaf):
            flat = [t.view(-1) for t in leaf]
            parts = [[t[sl] for t in flat] for sl in _chunks(p.numel())]
        else:
            parts = [leaf]
        for part in parts:
            _update(*part, scale, c1, c2, lr, cfg, decay)
    return {"grad_norm": gn}


# Elements of a leaf updated at once (256 MB of fp32).
UPDATE_CHUNK = 1 << 26


def _chunks(n: int):
    return [slice(a, min(a + UPDATE_CHUNK, n))
            for a in range(0, n, UPDATE_CHUNK)]


def _update(p, g, mu, nu, scale, c1, c2, lr, cfg: AdamWConfig,
            decay: bool) -> None:
    """One AdamW step of flat views of a parameter, its gradient and its
    moments, in place, in the reference's order of operations."""
    gf = g.float() * scale
    mu_new = cfg.b1 * mu.float() + (1 - cfg.b1) * gf
    nu_new = cfg.b2 * nu.float() + (1 - cfg.b2) * torch.square(gf)
    update = (mu_new / c1) / (torch.sqrt(nu_new / c2) + cfg.eps)
    if decay:
        update = update + cfg.weight_decay * p.float()
    p.copy_((p.float() - lr * update).to(p.dtype))
    mu.copy_(mu_new)
    nu.copy_(nu_new)
