"""Training launcher of the port: two-phase SONIQ training on synthetic
tokens, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \
        --steps 6 --t1 3 --batch 8 --seq 128              # the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \
        --reduced --device cpu --steps 4 --t1 2 --batch 2 --seq 16
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch deepseek-moe-16b --reduced --device cpu --steps 4 --t1 2 \
        --batch 2 --seq 16                                 # MoE, CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-2.7b \
        --reduced --device cpu --steps 4 --t1 2 --batch 2 --seq 16  # SSM
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-vl-72b \
        --reduced --device cpu --steps 4 --t1 2 --batch 2 --seq 16  # VLM

Runs ``--t1`` Phase-I (noise) steps, the boundary, then Phase II (QAT) up
to ``--steps``, on random weights from ``--seed`` and ``TokenStream``
batches from the same seed, printing one line per step (with the MoE
load-balancing loss on the MoE archs; the VLM trains on the text tokens,
as the reference's launcher feeds it). ``--device cpu``
runs the kernels' plain versions (use with ``--reduced``). Exits non-zero
if a loss is not finite.

``--ckpt DIR`` checkpoints every ``--steps // 2`` steps into DIR in the
JAX package's format and resumes from the newest checkpoint there
(printing ``resumed from step N``; the stream restarts at its first
batch, as the reference's launcher's does); ``repro_torch.launch.serve
--ckpt DIR`` serves what it wrote. ``--hoist`` fake-quantizes the weights
once a Phase-II step instead of once a microbatch; ``--grad-compress``
passes the gradients through int8 compression with error feedback.
"""
from __future__ import annotations

import argparse
import math
import sys

from repro_torch.configs import get_config
from repro_torch.core import schedule
from repro_torch.data import synthetic
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import loop
from repro_torch.train import state as state_lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--t1", type=int, default=0, help="Phase I steps")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--hoist", action="store_true")
    ap.add_argument("--grad-compress", action="store_true")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tcfg = state_lib.TrainConfig(
        num_microbatches=args.microbatches, t1=args.t1, t2=args.steps,
        warmup=max(args.steps // 10, 1), seed=args.seed,
        ckpt_dir=args.ckpt, checkpoint_every=max(args.steps // 2, 1),
        hoist_weight_quant=args.hoist, grad_compress=args.grad_compress)
    stream = synthetic.TokenStream(synthetic.TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, batch_size=args.batch,
        seed=args.seed))

    def report(step, _state, m):
        aux = f" moe_aux={m['moe_aux']:.4f}" if cfg.num_experts else ""
        print(f"step {step} phase {m['phase']}: loss={m['loss']:.4f}{aux} "
              f"gnorm={m['grad_norm']:.3f} ms={m['wall'] * 1e3:.1f}",
              flush=True)

    if args.ckpt:
        latest = ckpt_lib.latest_step(args.ckpt)
        if latest is not None:
            print(f"resumed from step {latest}", flush=True)
    out = loop.train(cfg, tcfg, stream.batches(), device=args.device,
                     hooks=[report])
    if out["pattern_report"] is not None:
        print(f"boundary: average bpp "
              f"{schedule.average_bpp(out['pattern_report']):.3f}, "
              f"patterns {out['pattern_report']['allowed']}")
    if not all(math.isfinite(m["loss"]) for m in out["history"]):
        print("non-finite loss", file=sys.stderr)
        return 1
    print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
