"""How far XLA's CPU ``rsqrt`` and ``torch.rsqrt`` are from the correctly
rounded fp32 ``1 / sqrt(x)``, and whether a fixed formula in fp32 gives
XLA's results bit for bit (ROADMAP §C, numeric differences by design: the
training forward's RMS norm and the CNN's batch norm take an ``rsqrt``).

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/rsqrt_vs_jax.py \\
        [--n 1000000] [--seed 0]

On ``--n`` uniform fp32 values in [0.5, 4) from ``--seed``, prints for
``jax.jit(jax.lax.rsqrt)`` and ``torch.rsqrt`` the share of results that
differ from ``1 / sqrt`` computed in float64 and rounded once, and the
largest gap in ulps; then, for formulas computable in fp32 on any machine
(one rounding per operation, as numpy does them), the share of results
that differ from XLA's. CPU only; it imports both packages.
"""
from __future__ import annotations

import argparse

import jax
import numpy as np
import torch


def ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| in units in the last place of fp32 (same-sign values)."""
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def report(name: str, got: np.ndarray, want: np.ndarray) -> None:
    d = ulps(got, want)
    print(f"{name}: differs in {np.mean(d > 0):.4f} of results, "
          f"largest gap {int(d.max())} ulp")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10 ** 6)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    x = np.random.default_rng(args.seed).uniform(0.5, 4.0, args.n).astype(
        np.float32)
    exact = (1.0 / np.sqrt(x.astype(np.float64))).astype(np.float32)
    xla = np.asarray(jax.jit(jax.lax.rsqrt)(x))
    tor = torch.rsqrt(torch.from_numpy(x)).numpy()
    print(f"{args.n} fp32 values, uniform in [0.5, 4), seed {args.seed}; "
          f"jax {jax.__version__}, torch {torch.__version__}")
    print("against the correctly rounded 1 / sqrt:")
    report("  jax.jit(jax.lax.rsqrt)", xla, exact)
    report("  torch.rsqrt", tor, exact)
    f32 = np.float32
    half = f32(0.5) * x
    candidates = {
        "1 / sqrt (two roundings)": f32(1.0) / np.sqrt(x),
        "sqrt(1 / x)": np.sqrt(f32(1.0) / x),
        "torch.rsqrt": tor,
        "Newton step y(1.5 - 0.5 x y y) from the exact y":
            exact * (f32(1.5) - half * exact * exact),
        "Newton step y + y(0.5 - 0.5 x y y) from the exact y":
            exact + exact * (f32(0.5) - half * exact * exact),
    }
    print("against jax.jit(jax.lax.rsqrt):")
    for name, got in candidates.items():
        report(f"  {name}", got.astype(np.float32), xla)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
