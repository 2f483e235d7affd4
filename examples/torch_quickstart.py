"""Quickstart on the PyTorch port: the SONIQ lifecycle on one linear layer,
end to end, through ``repro_torch.soniq``.

    PYTHONPATH=src python examples/torch_quickstart.py                # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu \
        --steps 40                                                    # the CPU

1. Phase I  - noise-injected precision search (trainable s per 16-channel
              group, bit-count regularizer).           soniq.init_linear
2. Boundary - Problem-1 pattern solve + PatternMatch + precision freeze.
                                                        soniq.to_qat
3. Phase II - STE fine-tuning on the frozen {1,2,4}-bit SMOL grid.
4. Deploy   - channel reorder + bit-pack; the packed forward (the segment
              GEMM kernel on the card, its plain version on the CPU)
              equals the QAT forward.                   soniq.to_serve

Exits non-zero if the packed forward is not within 1e-4 of the QAT one.
"""
import argparse
import sys

sys.path.insert(0, "src")

import numpy as np                               # noqa: E402
import torch                                     # noqa: E402

from repro_torch import resolve_device, soniq    # noqa: E402
from repro_torch.core import noise               # noqa: E402

K, N, BATCH = 256, 128, 64


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=800,
                    help="Phase I steps (Phase II runs steps // 8)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)

    qcfg = soniq.QuantConfig(mode=soniq.Phase.NOISE, lam=2e-2)
    # Teacher with heterogeneous channel importance, the structure SONIQ
    # exists to find: the first quarter of input channels carry most of
    # the signal, the rest progressively less.
    importance = torch.cat([torch.full((K // 4,), v, device=dev)
                            for v in (1.0, 0.25, 0.05, 0.01)])
    w_true = torch.randn((K, N), generator=gen, device=dev) * 0.2 \
        * importance[:, None]

    def draw(i):   # fresh data every step, fully determined by i
        g = torch.Generator(device=dev)
        g.manual_seed(10_000 + i)
        xi = torch.randn((BATCH, K), generator=g, device=dev)
        return xi, xi @ w_true

    state = soniq.init_linear(K, N, qcfg, seed=0, device=dev)
    lin = state.model
    # Start from the pretrained weights (the paper fine-tunes trained
    # networks).
    with torch.no_grad():
        lin.w.copy_(w_true + 0.01 * torch.randn((K, N), generator=gen,
                                                device=dev))
    s0 = lin.s.detach()[:1]
    print(f"Phase I: {lin.s.shape[0]} channel groups at "
          f"s_init={float(s0):.3f} (sigma={float(noise.sigma(s0)):.4f} "
          f"= 2^-3)")

    lr = 0.03
    for i in range(args.steps):
        xi, yi = draw(i)
        pred = soniq.apply(state, xi, noise=(0, i))
        loss = torch.mean((pred - yi) ** 2) \
            + qcfg.lam * soniq.bit_penalty(lin.s)
        gw, gs = torch.autograd.grad(loss, [lin.w, lin.s])
        with torch.no_grad():
            lin.w -= lr * gw
            # s gets its own (faster) schedule: paper Phase I runs for
            # epochs.
            lin.s -= 8 * lr * gs
    x, y = draw(999)   # eval batch

    bits = noise.snap_124(noise.precision_from_s(lin.s.detach()))
    values, counts = np.unique(bits.cpu().numpy(), return_counts=True)
    print(f"learned precisions: "
          f"{ {int(v): int(c) for v, c in zip(values, counts)} }")

    # Boundary: Problem 1 + PatternMatch under the P4 hardware subset.
    qat, report = soniq.to_qat(state)
    print(f"PatternMatch: {report['layers'][0]['vectors']} vectors, "
          f"bpp={report['layers'][0]['bpp']:.2f} "
          f"(patterns: {report['allowed'][:4]})")

    # Phase II: STE fine-tune.
    for _ in range(max(args.steps // 8, 1)):
        loss = torch.mean((soniq.apply(qat, x) - y) ** 2)
        (gw,) = torch.autograd.grad(loss, [lin.w])
        with torch.no_grad():
            lin.w -= 0.01 * gw

    # Deploy: pack in place, then run the packed forward (one segment-GEMM
    # launch on the card). A single layer is not a stacked leaf, so the
    # trained precisions are kept verbatim under to_serve's "auto".
    with torch.no_grad():
        y_qat = soniq.apply(qat, x)
        served = soniq.to_serve(qat)
        y_kernel = soniq.apply(served, x)
    err = float(torch.max(torch.abs(y_kernel - y_qat)))
    nbytes = sum(served.params[k].numel() for k in ("w4", "w2", "w1"))
    print(f"packed size: {nbytes} bytes vs fp32 {K * N * 4} "
          f"({K * N * 4 / nbytes:.1f}x compression)")
    print(f"kernel vs QAT max err: {err:.2e}")
    rel = float(torch.linalg.norm(y_qat - y) / torch.linalg.norm(y))
    print(f"task relative error at deploy: {rel:.3f}")
    return 0 if err < 1e-4 else 1


if __name__ == "__main__":
    sys.exit(main())
