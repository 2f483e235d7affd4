"""The port's training step against the JAX package on the CPU where the
two disagree (ROADMAP §C.3-§C.5), under the port's float64 row sums (the
shipped rule) or under fp32 sums in the training forward (``--rule
fp32``, patched in for the measurement: the RMS mean as ``torch.mean``,
the attention contractions and softmax in fp32, as the reference).

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/sum_rule_vs_jax.py
    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/sum_rule_vs_jax.py \\
        --rule fp32

Prints, on the reduced fp32 models of ``tests/test_torch_train.py`` and
``tests/test_torch_moe_train.py``:
  C.3  the 2-microbatch QAT step on the batch of
       ``test_microbatches_average_their_gradients`` against the
       reference's ``train_step``: loss, gradient norm, updated
       parameters; then each sequence alone: |x| / s at the abs-max of
       every QAT activation quantization, port and JAX.
  C.4  one step as ``test_train_step_equals_jax`` (QAT, NOISE on
       replayed draws): the largest parameter difference and the
       elements beyond 2e-6.
  C.5  one deepseek-moe-16b step (QAT, NOISE) with every embedding
       shifted by +0.05 along the all-ones direction: expert ids, loss,
       gradient norm and ``moe_aux``.
CPU only; it imports both packages, as the parity tests do.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_moe_train as moe_t  # noqa: E402
import test_torch_train as train_t  # noqa: E402
from repro.core import smol as jsmol  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import state as jstate  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import smol as psmol  # noqa: E402
from repro_torch.models import attention as pattention  # noqa: E402
from repro_torch.models import common as pcommon  # noqa: E402
from repro_torch.models import lm as plm  # noqa: E402
from repro_torch.models import moe as pmoe  # noqa: E402
from repro_torch.optim import adamw as padamw  # noqa: E402
from repro_torch.train import state as pstate  # noqa: E402


def _rms_norm_fp32(g, x, eps=1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * g.float()).to(x.dtype)


def _sdpa_fp32(q, k, v, mask):
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float())
    scores = scores * np.float32(1.0 / np.sqrt(q.shape[-1]))
    if mask is not None:
        scores = torch.where(mask[:, None, None], scores,
                             torch.full((), pattention.NEG_INF))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(),
                        v.float()).to(v.dtype)


def _batch(vocab, batch_size=2):
    return next(jsynthetic.TokenStream(jsynthetic.TokenStreamConfig(
        vocab_size=vocab, seq_len=16, batch_size=batch_size,
        seed=1)).batches())


def _step_pair(jcfg, pcfg, tree, batch, n_mb=1, noise=False):
    tk = dict(warmup=1, t1=1 if noise else 0, t2=4,
              num_microbatches=n_mb)
    jt = jstate.TrainConfig(adamw=jadamw.AdamWConfig(lr=1e-3), **tk)
    pt = pstate.TrainConfig(adamw=padamw.AdamWConfig(lr=1e-3), **tk)
    rng = jax.random.PRNGKey(17)
    jst = {"params": tree, "opt": jadamw.init_state(tree),
           "step": jnp.ones((), jnp.int32)}
    with train_t._true_division():
        jnew, jm = jax.jit(lambda s, b, r: jstate.train_step(
            s, b, jcfg, jt, r))(jst, {k: jnp.asarray(v)
                                      for k, v in batch.items()}, rng)
    model = interop.params_from_numpy(tree, pcfg, "cpu")
    pst = pstate.init_state(pcfg, pt, model=model)
    pst["step"] = 1
    draws = train_t.JaxDraws(train_t.linear_key_paths(rng, pcfg.num_layers))
    _, pm = pstate.train_step(pst, batch, pcfg, pt,
                              (lambda i: draws) if noise else None)
    d = np.concatenate(train_t._abs_diffs(interop.tree_to_numpy(model),
                                          jax.device_get(jnew["params"])))
    return dict(loss=(float(pm["loss"]), float(jm["loss"])),
                grad_norm_rel=abs(float(pm["grad_norm"])
                                  / float(jm["grad_norm"]) - 1),
                max_diff=float(d.max()), beyond_2e6=int((d > 2e-6).sum()),
                elements=int(d.size))


def _ratios(jcfg, pcfg, tree, mb):
    """|x| / s at the abs-max of every QAT activation quantization of one
    forward, the port's and JAX's."""
    jr, pr = [], []
    real_j, real_p = jsmol._quantize_act, psmol._quantize_act

    def spy_j(x, pbits, qcfg, g):
        s = jsmol._act_scale(x, qcfg)
        jax.debug.callback(lambda v: jr.append(float(v)), jnp.max(
            jnp.abs(x.astype(jnp.float32))) / s.reshape(()))
        return real_j(x, pbits, qcfg, g)

    def spy_p(x, pbits, qcfg, g):
        s = psmol._act_scale(x, qcfg, pbits.dim() == 2)
        pr.append(float((x.float().abs().max() / s).item()))
        return real_p(x, pbits, qcfg, g)

    with train_t._true_division(), mock.patch.object(jsmol, "_quantize_act",
                                                     spy_j):
        jax.jit(lambda p, b: jlm.loss_fn(p, b, jcfg, None)[0])(
            tree, {k: jnp.asarray(v) for k, v in mb.items()})
    model = interop.params_from_numpy(tree, pcfg, "cpu")
    with mock.patch.object(psmol, "_quantize_act", spy_p), torch.no_grad():
        plm.loss_fn(model, mb, pcfg)
    return ([f"{r:.7f}" for r in pr], [f"{r:.7f}" for r in jr])


def _moe_step(mode, shift):
    jcfg, pcfg = moe_t._configs("deepseek-moe-16b", mode)
    tree = moe_t._tree(jcfg, 9)
    tree["embed"]["table"] = tree["embed"]["table"] + np.float32(shift)
    pt = pstate.TrainConfig(adamw=padamw.AdamWConfig(lr=1e-3), warmup=1,
                            t1=1 if mode == "noise" else 0, t2=4)
    batch = _batch(jcfg.vocab_size)
    rng = jax.random.PRNGKey(23)
    jids, pids = [], []
    real_j, real_p = jmoe.moe_apply, pmoe.top_k_gates

    def spy_j(params, x, *a, top_k, **kw):
        probs = jax.nn.softmax(x.reshape(-1, x.shape[-1]).astype(
            jnp.float32) @ params["router"]["w"], -1)
        jax.debug.callback(lambda v: jids.append(np.asarray(v)),
                           jax.lax.top_k(probs, top_k)[1])
        return real_j(params, x, *a, top_k=top_k, **kw)

    def spy_p(probs, top_k):
        gates, ids = real_p(probs, top_k)
        pids.append(ids.numpy())
        return gates, ids

    with train_t._true_division(), mock.patch.object(jmoe, "moe_apply",
                                                     spy_j):
        (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
            lambda p, b, r: jlm.loss_fn(p, b, jcfg, r), has_aux=True,
            allow_int=True))(tree, {k: jnp.asarray(v)
                                    for k, v in batch.items()},
                             rng if mode == "noise" else None)
    model = interop.params_from_numpy(tree, pcfg, "cpu")
    pst = pstate.init_state(pcfg, pt, model=model)
    pst["step"] = 1
    draws = moe_t.MoEDraws(moe_t.model_key_paths(rng, pcfg))
    with mock.patch.object(pmoe, "top_k_gates", spy_p):
        _, pm = pstate.train_step(pst, batch, pcfg, pt,
                                  (lambda i: draws) if mode == "noise"
                                  else None)
    return dict(ids_equal=bool(np.array_equal(pids[0], jids[0])),
                loss=(float(pm["loss"]), float(jloss)),
                grad_norm_rel=abs(float(pm["grad_norm"])
                                  / float(jadamw.global_norm(jgrads)) - 1),
                moe_aux=(float(pm["moe_aux"]), float(jmet["moe_aux"])))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rule", choices=("fp64", "fp32"), default="fp64")
    args = ap.parse_args(argv)
    if args.rule == "fp32":
        mock.patch.object(pcommon, "rms_norm", _rms_norm_fp32).start()
        mock.patch.object(pattention, "sdpa", _sdpa_fp32).start()
    print(f"rule: {args.rule}")
    jcfg, pcfg = train_t._configs()
    qj, qp = jcfg.with_quant_mode("qat"), pcfg.with_quant_mode("qat")
    tree = train_t._jax_params(qj)
    batch = _batch(qj.vocab_size)
    print("C.3 2-microbatch QAT step:",
          _step_pair(qj, qp, tree, batch, n_mb=2))
    for row in (0, 1):
        port, ref = _ratios(qj, qp, tree,
                            {k: v[row:row + 1] for k, v in batch.items()})
        print(f"C.3 sequence {row} |x|/s, port: {port}")
        print(f"C.3 sequence {row} |x|/s, JAX:  {ref}")
    for mode in ("qat", "noise"):
        mj, mp = jcfg.with_quant_mode(mode), pcfg.with_quant_mode(mode)
        print(f"C.4 one {mode} step:", _step_pair(
            mj, mp, train_t._jax_params(mj), batch, noise=mode == "noise"))
    for mode in ("qat", "noise"):
        print(f"C.5 shifted deepseek-moe-16b {mode} step:",
              _moe_step(mode, 0.05))
    return 0


if __name__ == "__main__":
    sys.exit(main())
