"""End-to-end example on the PyTorch port: two-phase SONIQ training of a
transformer LM.

    PYTHONPATH=src python examples/torch_train_lm_soniq.py --device cpu  # tiny, CPU
    PYTHONPATH=src python examples/torch_train_lm_soniq.py --preset 100m # ~100M, card
    PYTHONPATH=src python examples/torch_train_lm_soniq.py \
        --arch h2o-danube-1.8b --reduced --steps 40                     # a ported arch

Runs Phase I (noise search) -> Problem-1/PatternMatch boundary -> Phase II
(QAT) through the port's ``train.loop.train``, with checkpointing into
``--ckpt`` (the JAX package's format); prints the loss curve and the
deployed bpp. Exits non-zero if a loss is not finite.
"""
import argparse
import dataclasses
import math
import sys

sys.path.insert(0, "src")

from repro_torch import soniq                         # noqa: E402
from repro_torch.configs import get_config            # noqa: E402
from repro_torch.configs.base import ArchConfig       # noqa: E402
from repro_torch.data import synthetic                # noqa: E402
from repro_torch.train import loop, state as state_lib  # noqa: E402

QuantConfig = soniq.QuantConfig


def tiny_config(quant: QuantConfig) -> ArchConfig:
    return ArchConfig(
        name="tiny-demo", family="dense", num_layers=2, d_model=128,
        num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=512, head_dim=32,
        dtype="float32", param_dtype="float32", quant=quant, q_block=64)


def preset_100m(quant: QuantConfig) -> ArchConfig:
    return ArchConfig(
        name="soniq-100m", family="dense", num_layers=12, d_model=768,
        num_heads=12, num_kv_heads=12, d_ff=3072, vocab_size=32768,
        quant=quant)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=["tiny", "100m"], default="tiny")
    ap.add_argument("--arch", default=None,
                    help="use a ported architecture instead of a preset")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    quant = QuantConfig(mode=soniq.Phase.QAT, lam=1e-3)
    if args.arch:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
        cfg = dataclasses.replace(cfg, quant=quant)
    else:
        cfg = (tiny_config if args.preset == "tiny" else preset_100m)(quant)

    t1 = args.steps // 2
    tcfg = state_lib.TrainConfig(
        t1=t1, t2=args.steps, warmup=max(args.steps // 10, 2),
        checkpoint_every=max(args.steps // 3, 5), ckpt_dir=args.ckpt)
    stream = synthetic.TokenStream(synthetic.TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        batch_size=args.batch))

    result = loop.train(cfg, tcfg, stream.batches(), device=args.device)
    hist = result["history"]
    p1 = [h["loss"] for h in hist if h["phase"] == 1]
    p2 = [h["loss"] for h in hist if h["phase"] == 2]
    print(f"\nPhase I loss:  {p1[0]:.3f} -> {p1[-1]:.3f}" if p1 else "")
    print(f"Phase II loss: {p2[0]:.3f} -> {p2[-1]:.3f}" if p2 else "")
    if result["pattern_report"]:
        print(f"deployed bpp: "
              f"{soniq.average_bpp(result['pattern_report']):.2f}"
              f" (vs 32.0 fp32, 4.0 uniform-4)")
    return 0 if all(math.isfinite(h["loss"]) for h in hist) else 1


if __name__ == "__main__":
    sys.exit(main())
