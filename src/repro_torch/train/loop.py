"""The two-phase SONIQ training loop. Counterpart of ``repro.train.loop``
(checkpoint and restart are not ported yet).

Steps [0, t1) run Phase I (mode "noise"); at step t1 the boundary runs on
the host (Problem-1 solve + PatternMatch + precision freeze, in place on
the model) and the optimizer restarts with fresh moments; steps [t1, t2)
run Phase II (mode "qat") at lr * ``phase2_lr_mult``.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterator, List, Optional

import torch

from repro_torch.api import transforms
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import lm
from repro_torch.optim import adamw
from . import state as state_lib

# Phase-I draws of a step: step -> (microbatch -> noise source).
NoiseFactory = Callable[[int], state_lib.StepNoiseFn]


def train(arch_cfg, tcfg: state_lib.TrainConfig,
          batches: Iterator[Dict], *, model: Optional[lm.LM] = None,
          device: DeviceLike = None, noise: Optional[NoiseFactory] = None,
          hooks: Optional[List[Callable]] = None) -> Dict:
    """Run Phase I, the boundary and Phase II for ``tcfg.t2`` steps on
    ``device`` (the card unless the CPU is asked for). ``model`` is the
    starting model (default: random, from ``tcfg.seed``, in the phase of
    step 0); ``noise`` gives each step's Phase-I draws (default: seeded
    ``StepNoise`` from ``tcfg.seed + 1`` and the step). ``hooks`` are
    called as hook(step, state, metrics). Returns {"state", "history",
    "pattern_report"}."""
    dev = resolve_device(device)
    hooks = hooks or []
    noise_cfg = arch_cfg.with_quant_mode("noise")
    qat_cfg = arch_cfg.with_quant_mode("qat")
    in_phase1 = tcfg.t1 > 0
    if model is None:
        model = lm.init_params(noise_cfg if in_phase1 else qat_cfg,
                               seed=tcfg.seed, device=dev)
    state = state_lib.init_state(arch_cfg, tcfg, model=model.to(dev))
    qa = arch_cfg.quant.quantize_activations
    if noise is None:
        noise = lambda step: state_lib.step_noise(  # noqa: E731
            tcfg.seed + 1, step, qa)
    history = []
    pattern_report = None
    for step in range(tcfg.t2):
        if step == tcfg.t1 and in_phase1:
            # ---- Phase I -> Phase II boundary (host-side) ----
            _, pattern_report = transforms.freeze_qat(state["model"],
                                                      arch_cfg.quant)
            state["opt"] = adamw.init_state(state["model"],
                                            tcfg.adamw.moment_dtype)
            in_phase1 = False
        batch = next(batches)
        t0 = time.perf_counter()
        state, metrics = state_lib.train_step(
            state, batch, noise_cfg if in_phase1 else qat_cfg, tcfg,
            noise(step) if in_phase1 else None)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics.update(step=step, wall=time.perf_counter() - t0,
                       phase=1 if step < tcfg.t1 else 2)
        history.append(metrics)
        for h in hooks:
            h(step, state, metrics)
    return {"state": state, "history": history,
            "pattern_report": pattern_report}
