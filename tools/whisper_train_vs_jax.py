"""The figures of ROADMAP §C for encoder-decoder training: the GELU's and
tanh's gradients, LayerNorm's gradient, and the clipped STE's knife edge,
the port against the JAX package on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/whisper_train_vs_jax.py
    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/whisper_train_vs_jax.py \\
        --continue          # also the checkpoint continuation (~1 min)

Prints:
  gelu, tanh   on 200,000 N(0, 9) draws, fp32 and bf16, against the
               jitted ``jax.vjp``: the share of gradients that differ and
               the largest difference, under autograd of the forward's
               ops (what the port took before ``common._Gelu`` and
               ``common._Tanh``) and under the shipped backward.
  layer_norm   y, dx, dg, db: relative L2 against ``jax.vjp`` of the
               reference's ``layer_norm``, and each package's against a
               float64 oracle (64 x 1024, seeded).
  knife edge   the reduced whisper QAT step of
               ``tests/test_torch_whisper_train.py`` at 2 and 4 decoder
               layers: the clipped-STE mask calls, the elements one fp32
               step above the grid top, and the worst leaf's gradient
               (relative L2) against ``jax.grad`` with the masks as they
               are.
  --continue   the port's continuation of the reference's step-2
               checkpoint against the reference's uninterrupted run, with
               the masks as they are: the largest parameter difference.
CPU only; it imports both packages, as the parity tests do.
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_train as train_t  # noqa: E402
import test_torch_whisper_train as whisper_t  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import quant as pquant  # noqa: E402
from repro_torch.models import common as pcommon  # noqa: E402
from repro_torch.train import loop as ploop  # noqa: E402
from repro_torch.train import state as pstate  # noqa: E402


def activations():
    x = (np.random.default_rng(0).standard_normal(200_000) * 3.0
         ).astype(np.float32)
    g = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)
    forms = {"gelu": (jax.nn.gelu, lambda t: pcommon._gelu_forward(t)[0],
                      pcommon.gelu),
             "tanh": (jnp.tanh, pcommon._tanh_forward, pcommon.tanh)}
    for name, (jfn, autograd, shipped) in forms.items():
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
            xj, gj = jnp.asarray(x).astype(jdt), jnp.asarray(g).astype(jdt)
            want = np.asarray(jax.jit(
                lambda a, b: jax.vjp(jfn, a)[1](b)[0])(xj, gj).astype(
                    jnp.float32))
            row = []
            for rule, fn in (("autograd", autograd), ("shipped", shipped)):
                t = torch.tensor(np.asarray(xj.astype(jnp.float32))).to(
                    tdt).requires_grad_(True)
                fn(t).backward(torch.tensor(np.asarray(
                    gj.astype(jnp.float32))).to(tdt))
                got = t.grad.float().numpy()
                row.append(f"{rule}: {np.mean(got != want):.4f} differ, max "
                           f"{np.abs(got - want).max():.3g}")
            print(f"{name} {tdt}: " + "; ".join(row))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def layer_norm():
    rng = np.random.default_rng(1024)
    x = (rng.normal(0, 1, (64, 1024)) + rng.normal(0, 1, (64, 1))
         ).astype(np.float32)
    leaf = {"g": rng.normal(1, 0.1, 1024).astype(np.float32),
            "b": rng.normal(0, 0.1, 1024).astype(np.float32)}
    cot = rng.standard_normal(x.shape).astype(np.float32)
    jy, vjp = jax.jit(lambda p, a: jax.vjp(jcommon.layer_norm, p, a))(
        leaf, x)
    jleaf, jx = jax.jit(vjp)(cot)
    tx, tg, tb = (torch.tensor(a, requires_grad=True)
                  for a in (x, leaf["g"], leaf["b"]))
    y = pcommon.layer_norm(tg, tb, tx)
    y.backward(torch.tensor(cot))
    xd, gd, bd = (torch.tensor(a, dtype=torch.float64, requires_grad=True)
                  for a in (x, leaf["g"], leaf["b"]))
    xc = xd - xd.mean(-1, keepdim=True)
    yd = xc / torch.sqrt((xc * xc).mean(-1, keepdim=True) + 1e-5) * gd + bd
    yd.backward(torch.tensor(cot, dtype=torch.float64))
    for name, port, ref, oracle in (
            ("y", y.detach(), jy, yd.detach()), ("dx", tx.grad, jx, xd.grad),
            ("dg", tg.grad, jleaf["g"], gd.grad),
            ("db", tb.grad, jleaf["b"], bd.grad)):
        print(f"layer_norm {name}: port vs JAX {_rel(port, ref):.3g}; vs "
              f"float64: port {_rel(port, oracle):.3g}, JAX "
              f"{_rel(ref, oracle):.3g}")


@contextlib.contextmanager
def counted_edges(out):
    """Count the elements each port mask call finds one fp32 step above
    its grid top (the mask itself unchanged)."""
    real = pquant.fake_quant_in_range

    def count(x, pbits, scale, group_size=16):
        xs, p, _s = pquant._fake_quant_operands(x, pbits, scale, group_size)
        top = 2.0 - torch.exp2(1.0 - p)
        above = torch.nextafter(top, torch.tensor(float("inf")))
        out.append(int(((xs.abs() > top) & (xs.abs() <= above)).sum()))
        return real(x, pbits, scale, group_size)

    pquant.fake_quant_in_range = count
    try:
        yield
    finally:
        pquant.fake_quant_in_range = real


def knife_edge():
    real_configs = whisper_t._configs
    for layers in (2, 4):
        whisper_t._configs = lambda arch, n=layers: real_configs(
            layers=n, arch=arch)
        edges = []
        try:
            with counted_edges(edges):
                whisper_t.test_train_step_gradients_equal_jax("qat")
            worst = "within relative L2 1e-5 at every leaf"
        except AssertionError as e:
            worst = f"leaves beyond 1e-5, worst first: {e}"[:400]
        finally:
            whisper_t._configs = real_configs
        print(f"knife edge, {layers} decoder layers: {len(edges)} mask "
              f"calls, {sum(edges)} elements one step above the grid top "
              f"(in {sum(1 for e in edges if e)} calls); gradients {worst}")


def continuation():
    arch = train_t.WHISPER_ARCH
    with tempfile.TemporaryDirectory() as tmp:
        jd, pd = f"{tmp}/jax", f"{tmp}/port"
        jout, _pout = train_t.loop_train_runs(arch, jax_ckpt=jd,
                                              port_ckpt=pd)
        d = whisper_t._step_dir(jd, 2, f"{tmp}/ck")
        jcfg, pcfg = train_t._configs(arch=arch)
        out = ploop.train(pcfg, pstate.TrainConfig(ckpt_dir=d,
                                                   **train_t.LOOP_TK),
                          itertools.islice(train_t.loop_stream(jcfg), 2,
                                           None), device="cpu")
        diffs = np.concatenate(train_t._abs_diffs(
            interop.tree_to_numpy(out["state"]["model"]),
            jax.device_get(jout["state"]["params"])))
        print(f"continuation of the reference's step-2 checkpoint, masks as "
              f"they are: largest parameter difference {diffs.max():.3g} "
              f"({int((diffs > 1e-4).sum())} elements beyond 1e-4)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--continue", dest="cont", action="store_true")
    args = ap.parse_args(argv)
    activations()
    layer_norm()
    knife_edge()
    if args.cont:
        continuation()
    return 0


if __name__ == "__main__":
    sys.exit(main())
