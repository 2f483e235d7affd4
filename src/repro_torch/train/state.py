"""Train state and one optimizer step (microbatch accumulation, two-phase
SONIQ, the hoisted weight quantization, int8 error-feedback gradient
compression). Counterpart of ``repro.train.state``.

The state is a dict: ``model`` (the :class:`~repro_torch.models.lm.LM`,
updated in place), ``opt`` (AdamW moments keyed by parameter path),
``step`` and, when compressing gradients, ``err`` (the compression error
keyed by parameter path). ``interop.state_to_tree`` maps it to the
reference's layout (``train/checkpoint.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import smol
from repro_torch.device import DeviceLike
from repro_torch.models import lm
from repro_torch.optim import adamw, grad_compress, schedules

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
    grad_compress: bool = False
    checkpoint_every: int = 100
    ckpt_dir: Optional[str] = None
    seed: int = 0
    # Fake-quantize the weights once a step instead of once a microbatch
    # (and recompute); Phase II only. The step's losses and parameters are
    # bitwise the unhoisted step's.
    hoist_weight_quant: bool = False


def init_state(arch_cfg, tcfg: TrainConfig, *, model: Optional[lm.LM] = None,
               device: DeviceLike = None) -> Dict[str, Any]:
    """Fresh state around ``model`` (default: a random model in
    ``arch_cfg``'s phase from ``tcfg.seed`` on ``device``, the card unless
    the CPU is asked for), whose parameters now take gradients."""
    if model is None:
        model = lm.init_params(arch_cfg, seed=tcfg.seed, device=device)
    model.requires_grad_(True)
    state = {"model": model,
             "opt": adamw.init_state(model, tcfg.adamw.moment_dtype),
             "step": 0}
    if tcfg.grad_compress:
        state["err"] = grad_compress.init_error_tree(
            dict(adamw.trainable(model)))
    return state


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
    blocks).

    ``tcfg.hoist_weight_quant`` (Phase II): every weight is fake-quantized
    once (``smol.prequantize_tree``), each microbatch takes its gradient
    with respect to the quantized weights, and the fp32 sum runs one
    backward through B8 (the clipped STE: a mask, so the result is
    bitwise the unhoisted step's). ``tcfg.grad_compress``: the gradients
    then pass through int8 compression with error feedback."""
    model = state["model"]
    phase1 = arch_cfg.quant.mode == "noise"
    if phase1 and noise is None:
        raise ValueError("a Phase-I step needs its noise draws")
    params = adamw.trainable(model)
    hoist = tcfg.hoist_weight_quant and arch_cfg.quant.mode == "qat"
    fwd_cfg, hoisted, leaves = arch_cfg, {}, {}
    if hoist:
        fwd_cfg = dataclasses.replace(arch_cfg, quant=dataclasses.replace(
            arch_cfg.quant, prequantized=True))
        # fp32 with the quantize graph; the forward reads a detached copy
        # in the compute dtype, whose gradients are summed in fp32.
        hoisted = smol.prequantize_tree(model, arch_cfg.quant,
                                        torch.float32)
        dt = getattr(torch, arch_cfg.dtype)
        leaves = {path: wq.detach().to(dt).requires_grad_(True)
                  for path, wq in hoisted.items()}
    weight_of = {f"{path}.w": path for path in hoisted}
    inputs = [leaves[weight_of[n]] if n in weight_of else p
              for n, p in params]
    n_mb = tcfg.num_microbatches
    grads: Optional[List[Optional[torch.Tensor]]] = None
    loss = aux = None
    with smol.hoisted_weights(model, leaves):
        for i, mb in enumerate(split_microbatches(batch, n_mb)):
            src = noise(i) if phase1 else None
            l, met = lm.loss_fn(model, mb, fwd_cfg, src)
            g = torch.autograd.grad(l, inputs, allow_unused=True)
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
    del leaves
    if hoist:
        # One backward through the step's quantization (B8 backward once
        # a linear or bank).
        idx = [i for i, (n, _) in enumerate(params) if n in weight_of]
        outs = [hoisted[weight_of[params[i][0]]] for i in idx]
        cots = [torch.zeros_like(o) if grads[i] is None else grads[i].float()
                for i, o in zip(idx, outs)]
        for i, dw in zip(idx, torch.autograd.grad(
                outs, [params[i][1] for i in idx], cots)):
            grads[i] = dw
        del hoisted, outs, cots
    named = {n: g for (n, _), g in zip(params, grads)}
    del grads
    if tcfg.grad_compress:
        qtree, state["err"] = grad_compress.compress_tree(named,
                                                          state["err"])
        named = grad_compress.decompress_tree(qtree)
        del qtree
    lr_scale = schedules.two_phase(
        state["step"], t1=tcfg.t1, warmup=tcfg.warmup, total=tcfg.t2,
        phase2_mult=tcfg.phase2_lr_mult)
    om = adamw.apply_updates(model, named, state["opt"], tcfg.adamw,
                             lr_scale=lr_scale)
    del named
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
