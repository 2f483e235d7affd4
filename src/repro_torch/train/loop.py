"""The two-phase SONIQ training loop with checkpoint and restart.
Counterpart of ``repro.train.loop``.

Steps [0, t1) run Phase I (mode "noise"); at step t1 the boundary runs on
the host (Problem-1 solve + PatternMatch + precision freeze, in place on
the model) and the optimizer restarts with fresh fp32 moments; steps
[t1, t2) run Phase II (mode "qat") at lr * ``phase2_lr_mult``.

With ``tcfg.ckpt_dir`` the loop resumes from the newest checkpoint there
(the reference's format, ``train/checkpoint.py``) and saves every
``tcfg.checkpoint_every`` steps (host copies first, then the write,
joined before the next step). A checkpoint is written after its step and
before the boundary, so one labelled exactly t1 still holds Phase-I
parameters and the boundary runs after it. As in the reference, the loop
reads ``batches`` from the iterator it is given, from the first step it
runs; the caller feeds a resumed run the batches of its steps.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterator, List, Optional

import torch

from repro_torch import interop
from repro_torch.api import transforms
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import lm
from repro_torch.optim import adamw
from . import checkpoint as ckpt_lib
from . import state as state_lib

# Phase-I draws of a step: step -> (microbatch -> noise source).
NoiseFactory = Callable[[int], state_lib.StepNoiseFn]


def train(arch_cfg, tcfg: state_lib.TrainConfig,
          batches: Iterator[Dict], *, model: Optional[lm.LM] = None,
          device: DeviceLike = None, noise: Optional[NoiseFactory] = None,
          hooks: Optional[List[Callable]] = None, host_id: int = 0) -> Dict:
    """Run Phase I, the boundary and Phase II up to step ``tcfg.t2`` on
    ``device`` (the card unless the CPU is asked for), from the newest
    checkpoint in ``tcfg.ckpt_dir`` if there is one. ``model`` is the
    starting model otherwise (default: random, from ``tcfg.seed``, in the
    phase of step 0); ``noise`` gives each step's Phase-I draws (default:
    seeded ``StepNoise`` from ``tcfg.seed + 1`` and the step). ``hooks``
    are called as hook(step, state, metrics). Returns {"state",
    "history", "pattern_report"}; the history starts at the first step
    run, and the report is None when the boundary was not run here."""
    dev = resolve_device(device)
    hooks = hooks or []
    noise_cfg = arch_cfg.with_quant_mode("noise")
    qat_cfg = arch_cfg.with_quant_mode("qat")
    in_phase1 = tcfg.t1 > 0
    latest = ckpt_lib.latest_step(tcfg.ckpt_dir) if tcfg.ckpt_dir else None
    if latest is not None:
        in_phase1 = latest <= tcfg.t1 and tcfg.t1 > 0
        tree, _ = ckpt_lib.restore(tcfg.ckpt_dir, step=latest,
                                   host_id=host_id)
        state = interop.state_from_tree(tree, arch_cfg, dev)
        del tree
        if tcfg.grad_compress and "err" not in state:
            raise ValueError(f"step {latest} in {tcfg.ckpt_dir} holds no "
                             f"gradient-compression error (err)")
        if not tcfg.grad_compress:
            state.pop("err", None)
    else:
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
    for step in range(state["step"], tcfg.t2):
        if step == tcfg.t1 and in_phase1:
            # ---- Phase I -> Phase II boundary (host-side) ----
            _, pattern_report = transforms.freeze_qat(state["model"],
                                                      arch_cfg.quant)
            # Fresh fp32 moments, whatever moment_dtype (as the
            # reference's adamw.init_state(params)); Phase I's are
            # released first, so the card never holds both.
            state["opt"] = None
            state["opt"] = adamw.init_state(state["model"])
            if "err" in state:     # the logits s are gone
                names = {n for n, _ in adamw.trainable(state["model"])}
                state["err"] = {n: e for n, e in state["err"].items()
                                if n in names}
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
        if tcfg.ckpt_dir and (step + 1) % tcfg.checkpoint_every == 0:
            ckpt_lib.async_save(interop.state_to_tree(state), tcfg.ckpt_dir,
                                step + 1, host_id=host_id).join()
    return {"state": state, "history": history,
            "pattern_report": pattern_report}
