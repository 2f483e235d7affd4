"""How far the port's decoder sinusoids (``repro_torch.models.common.
sinusoid_at``) are from the reference's (``repro.models.lm._sinusoid_at``,
XLA fp32 on the CPU), piece by piece (ROADMAP §C, numeric differences by
design: the encoder-decoder adds them in every decode, prefill and verify
step).

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/sinusoid_vs_jax.py \\
        [--d 1024] [--positions 2048]

At positions 0 .. ``--positions`` - 1 and width ``--d`` (whisper-medium's
d_model by default), prints the share of denominators ``1e4 ** (dim / d)``
that differ from the reference's for the port's form (float64 ``pow``
rounded once) and for torch's fp32 ``pow``; the share of fp32 angles that
differ (the port's product with the reciprocal, and a true division);
then the share of sinusoid values that differ from the
reference's for the port (float64 sin and cos of the fp32 angles, rounded
once) and for a naive torch fp32 version, and the largest gap. CPU only;
it imports both packages.
"""
from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import lm as jlm
from repro_torch.models import common


def share(a: np.ndarray, b: np.ndarray) -> str:
    diff = a != b
    return (f"{np.mean(diff):.4f} ({int(diff.sum())} of {diff.size}), "
            f"largest gap {float(np.abs(a - b).max()):.3e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, default=1024)
    ap.add_argument("--positions", type=int, default=2048)
    args = ap.parse_args(argv)
    d, n = args.d, args.positions
    pos = np.arange(n, dtype=np.int32)
    dim = jnp.arange(0, d, 2)
    jden = np.asarray(jax.jit(lambda: 1e4 ** (dim / d))())
    jang = np.asarray(jax.jit(lambda p: p[..., None].astype(jnp.float32)
                              / (1e4 ** (dim / d)))(pos))
    want = np.asarray(jax.jit(lambda p: jlm._sinusoid_at(p, d))(pos))
    pden = common.sinusoid_denominators(d)
    tden = (1e4 ** (torch.arange(0, d, 2) / d)).float().numpy()
    tpos = torch.from_numpy(pos)
    pang = (tpos.float()[:, None] * torch.from_numpy(
        np.float32(1.0) / pden)).numpy()
    dang = (tpos.float()[:, None] / torch.from_numpy(pden)).numpy()
    got = common.sinusoid_at(tpos, d).numpy()
    ang32 = tpos.float()[:, None] / torch.from_numpy(tden)
    naive = torch.stack([torch.sin(ang32), torch.cos(ang32)], -1).reshape(
        n, d).numpy()
    print(f"d {d}, positions 0..{n - 1}; jax {jax.__version__}, torch "
          f"{torch.__version__}")
    print(f"denominators, port (float64 pow, one rounding) vs the "
          f"reference: {share(pden, jden)}")
    print(f"denominators, torch fp32 pow vs the reference: "
          f"{share(tden, jden)}")
    print(f"angles, port (times the fp32 reciprocal, as XLA rewrites the "
          f"division by a constant) vs the reference: {share(pang, jang)}")
    print(f"angles, an fp32 division vs the reference: {share(dang, jang)}")
    print(f"sinusoids, port (float64 sin/cos of the fp32 angles) vs the "
          f"reference: {share(got, want)}")
    print(f"sinusoids, naive torch fp32 vs the reference: "
          f"{share(naive, want)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
