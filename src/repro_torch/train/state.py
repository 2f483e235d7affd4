"""Train state and one optimizer step (microbatch accumulation, two-phase
SONIQ). Counterpart of ``repro.train.state``; gradient compression and the
hoisted weight quantization are not ported yet.

The state is a dict: ``model`` (the :class:`~repro_torch.models.lm.LM`,
updated in place), ``opt`` (AdamW moments keyed by parameter path) and
``step``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import smol
from repro_torch.device import DeviceLike
from repro_torch.models import lm
from repro_torch.optim import adamw, schedules

# A step's Phase-I noise: microbatch index -> the source of its draws.
StepNoiseFn = Callable[[int], smol.NoiseSource]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    num_microbatches: int = 1
    adamw: adamw.AdamWConfig = dataclasses.field(
        default_factory=adamw.AdamWConfig)
    warmup: int = 100
    t1: int = 350            # Phase I steps (paper T1)
    t2: int = 650            # total steps (paper T2)
    phase2_lr_mult: float = 0.3
    seed: int = 0


def init_state(arch_cfg, tcfg: TrainConfig, *, model: Optional[lm.LM] = None,
               device: DeviceLike = None) -> Dict[str, Any]:
    """Fresh state around ``model`` (default: a random model in
    ``arch_cfg``'s phase from ``tcfg.seed`` on ``device``, the card unless
    the CPU is asked for), whose parameters now take gradients."""
    if model is None:
        model = lm.init_params(arch_cfg, seed=tcfg.seed, device=device)
    model.requires_grad_(True)
    return {"model": model,
            "opt": adamw.init_state(model, tcfg.adamw.moment_dtype),
            "step": 0}


def split_microbatches(batch: Dict, n: int) -> List[Dict]:
    """Split the global batch into n microbatches along the batch axis."""
    out: List[Dict] = [{} for _ in range(n)]
    for k, x in batch.items():
        x = np.asarray(x) if not isinstance(x, torch.Tensor) else x
        if x.shape[0] % n:
            raise ValueError(f"batch {k} {tuple(x.shape)} does not split "
                             f"into {n} microbatches")
        m = x.shape[0] // n
        for i in range(n):
            out[i][k] = x[i * m:(i + 1) * m]
    return out


def train_step(state: Dict, batch: Dict, arch_cfg, tcfg: TrainConfig,
               noise: Optional[StepNoiseFn] = None):
    """One optimizer step over ``tcfg.num_microbatches`` microbatches,
    each gradient divided by their number and summed in order. Phase I
    (``arch_cfg.quant.mode == "noise"``) needs ``noise``; after the update
    its weights are projected into +-(2 - sigma(s)). Returns (state,
    metrics) with the metrics as device tensors; ``moe_aux`` is the MoE
    load-balancing loss averaged over the microbatches (0 without MoE
    blocks)."""
    model = state["model"]
    phase1 = arch_cfg.quant.mode == "noise"
    if phase1 and noise is None:
        raise ValueError("a Phase-I step needs its noise draws")
    params = adamw.trainable(model)
    n_mb = tcfg.num_microbatches
    grads: Optional[List[Optional[torch.Tensor]]] = None
    loss = aux = None
    for i, mb in enumerate(split_microbatches(batch, n_mb)):
        src = noise(i) if phase1 else None
        l, met = lm.loss_fn(model, mb, arch_cfg, src)
        g = torch.autograd.grad(l, [p for _, p in params],
                                allow_unused=True)
        if n_mb == 1:
            grads, loss, aux = list(g), l.detach(), met["moe_aux"]
            break
        g = [None if t is None else t.float() / n_mb for t in g]
        part, apart = l.detach() / n_mb, met["moe_aux"] / n_mb
        if grads is None:
            grads, loss, aux = g, part, apart
        else:
            grads = [a if b is None else (b if a is None else a + b)
                     for a, b in zip(grads, g)]
            loss, aux = loss + part, aux + apart
    lr_scale = schedules.two_phase(
        state["step"], t1=tcfg.t1, warmup=tcfg.warmup, total=tcfg.t2,
        phase2_mult=tcfg.phase2_lr_mult)
    om = adamw.apply_updates(model, {n: g for (n, _), g in
                                     zip(params, grads)},
                             state["opt"], tcfg.adamw, lr_scale=lr_scale)
    del grads
    if phase1:
        # Paper Alg. 1 line 7: project the weights into +-(2 - sigma(s)).
        smol.project_noise_weights(model, arch_cfg.quant)
    state["step"] += 1
    return state, {"loss": loss, "moe_aux": aux, "lr_scale": lr_scale, **om}


def step_noise(seed: int, step: int, quantize_activations: bool = True
               ) -> StepNoiseFn:
    """The default Phase-I draws of one step: microbatch i draws from
    ``StepNoise((seed, step, i))``."""
    return lambda i: smol.StepNoise((seed, step, i), quantize_activations)
