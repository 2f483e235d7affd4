"""Port parity for hybrid training (jamba-1.5-large-398b) against the JAX
package on the CPU: the freeze's walk over a hybrid unit's sublayers
(plan group, ``sub{i}`` sorted as the reference's dict keys, the path
within it, the unit, a bank's experts), one ``train_step`` at NOISE on
the reduced config (one unit of 8 sublayers: Mamba2 mixers, one
attention sublayer, MLPs and 4-expert top-2 MoEs; fp32) and one at QAT,
with every leaf's gradient, AdamW on bf16 leaves with fp32 moments, the
bf16-parameter model's step, the CPU plain version of B9 band by band,
and the profile's hybrid spans. ``tests/test_torch_hybrid_train_loop.py``
holds ``loop.train``, checkpoints, hoisting, the trained model's tokens
and the launcher.

NOISE replays the reference's draws (``MoEDraws`` of ``model_key_paths``:
each unit's key folds in the sublayer index, then splits in 4). The
reference's gradient is jitted with the abs-max scale divisions kept
true (``_true_division``) and without its per-sublayer remat (the same
values; its compile takes half the time). The trees are filled from
numpy on ``jax.eval_shape`` of the reference's init."""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import transforms as jtransforms
from repro.configs import get_config as jget_config
from repro.core import schedule as jschedule
from repro.data import synthetic as jsynthetic
from repro.models import lm as jlm
from repro.optim import adamw as jadamw

from repro_torch import interop
from repro_torch.api import transforms as ptransforms
from repro_torch.configs import get_config as pget_config
from repro_torch.core import schedule as pschedule
from repro_torch.core import smol as psmol
from repro_torch.kernels import noise_inject as pni
from repro_torch.models import lm as plm
from repro_torch.optim import adamw as padamw
from repro_torch.train import state as pstate

from test_torch_moe_train import MoEDraws, model_key_paths
from test_torch_ssm_train import rel_l2
from test_torch_train import _one_thread  # noqa: F401
from test_torch_train import _true_division
from test_torch_whisper_train import _float_leaves

ROOT = Path(__file__).resolve().parent.parent
ARCH = "jamba-1.5-large-398b"
REL_L2 = 1e-5
# The card configuration's cut (chip_smoke.py phase 24) at reduced width:
# one unit of a Mamba2 mixer with the MLP and attention with the MoE.
CUT = dict(num_layers=2, attn_every=2, attn_offset=1, moe_every=2)


def configs(**narrow):
    """The reduced hybrid in both packages (fp32; the reference on its
    ``xla_ref`` backend), ``narrow`` replacing more fields."""
    j = jget_config(ARCH).reduced()
    j = dataclasses.replace(j, quant=dataclasses.replace(
        j.quant, backend="xla_ref"), **narrow)
    return j, dataclasses.replace(pget_config(ARCH).reduced(), **narrow)


def hybrid_tree(jcfg, seed):
    """A tree in the reference's layout (``jax.eval_shape`` of its init,
    keys sorted as its own trees hold them) filled from numpy: weights
    N(0, 1/K), logits spread over the three bands, precisions from
    {1, 2, 4}, the mixers' conv, D and norm near a Mamba2 init, their
    decay (A_log, dt_bias) small enough that no chunk's cumulative decay
    passes fp32's ``exp`` in the reference's SSD gradient, which is NaN
    there (ROADMAP §C; the port masks before the ``exp``)."""
    shapes = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    rng = np.random.default_rng(seed)

    def fill(path, a):
        name = path[-1].key
        if name == "pbits":
            return rng.choice(np.array([1, 2, 4], a.dtype), a.shape)
        if name == "s":
            v = rng.normal(-0.2, 1.5, a.shape)
        elif name in ("g", "norm_g", "D"):
            v = rng.normal(1.0, 0.1, a.shape)
        elif name in ("b", "conv_b"):
            v = rng.normal(0.0, 0.02, a.shape)
        elif name == "A_log":
            v = np.log(rng.uniform(1.0, 4.0, a.shape))
        elif name == "dt_bias":
            v = rng.uniform(-6.0, -4.0, a.shape)
        elif name == "conv_w":
            v = rng.normal(0.0, 0.3, a.shape)
        else:
            std = 0.02 if name == "table" else 1 / np.sqrt(a.shape[-2])
            v = rng.standard_normal(a.shape) * std
        return np.asarray(v, a.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def batch_of(cfg, seed, b=2, s=16):
    return next(jsynthetic.TokenStream(jsynthetic.TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=s, batch_size=b,
        seed=seed)).batches())


# ------------------------------------------------------------ the walk ----
@pytest.mark.parametrize("narrow", [
    {}, dict(CUT, num_layers=4), dict(attn_every=12, num_layers=12,
                                      d_model=64, d_ff=64, num_heads=2,
                                      num_kv_heads=1)],
    ids=["unit8", "cut-2units", "sub12"])
def test_freeze_walks_the_reference_tree(narrow):
    """``schedule._noise_linears`` on a hybrid (the parent raised
    IndexError: one plan-group entry a unit, indexed by the flat block)
    lists the linears and banks in the reference's ``_iter_s_layers``
    order: plan group, sublayer (``sub10`` before ``sub2`` at 12
    sublayers, as the reference's sorted keys), the path within it, the
    unit; then the histograms, the pattern report and every frozen
    pbits equal the reference's ``freeze_qat`` on the same logits (two
    units: a bank's rows unit-major, expert-minor)."""
    jcfg, pcfg = configs(**narrow)
    jcfg, pcfg = jcfg.with_quant_mode("noise"), pcfg.with_quant_mode("noise")
    tree = hybrid_tree(jcfg, 3)
    model = interop.params_from_numpy(tree, pcfg, "cpu")
    n = pcfg.attn_every
    units = pcfg.num_layers // n
    got = []
    for lin in pschedule._noise_linears(model):
        _, b, *path = lin.path.split(".")
        got.append((f"sub{int(b) % n}", tuple(path), int(b) // n))
    want = [(p[2], tuple(p[3:]), u)
            for p, _node in jschedule._iter_s_layers(tree)
            for u in range(units)]
    assert got == want
    assert pschedule.collect_histograms(model, pcfg.quant) == \
        jschedule.collect_histograms(tree, jcfg.quant)
    jnew, jrep = jtransforms.freeze_qat(tree, jcfg.quant)
    _, prep = ptransforms.freeze_qat(model, pcfg.quant)
    assert prep["allowed"] == jrep["allowed"]
    assert prep["layers"] == jrep["layers"]
    assert pschedule.average_bpp(prep) == jschedule.average_bpp(jrep)
    back = interop.flatten_tree(interop.tree_to_numpy(model))
    frozen = 0
    for key, want_pb in interop.flatten_tree(jax.device_get(jnew)).items():
        if key.endswith("/pbits"):
            np.testing.assert_array_equal(back[key], np.asarray(want_pb))
            frozen += 1
    assert frozen == len(want) // units


# ---------------------------------------------------------- train step ----
def step_case(mode):
    """One step of the reduced hybrid (one unit of 8 sublayers, fp32) from
    the same tree and batch (NOISE on the reference's replayed draws)
    against ``jax.value_and_grad`` of the reference's ``lm.loss_fn``: the
    step's loss and load-balancing loss within rtol 1e-5, every gradient
    it hands AdamW (the mixers' conv, A_log, D, dt_bias, norm_g; the
    norms, the routers, the banks, the readout, the table) within
    relative L2 1e-5, its gradient norm within rtol 1e-5."""
    jcfg, pcfg = configs(remat="none")
    jcfg, pcfg = jcfg.with_quant_mode(mode), pcfg.with_quant_mode(mode)
    pcfg = dataclasses.replace(pcfg, remat="full")
    tree = hybrid_tree(jcfg, 9)
    batch = batch_of(jcfg, 1)
    key = jax.random.PRNGKey(23)
    with _true_division():
        (jl, jmet), jg = jax.jit(jax.value_and_grad(
            lambda p, b, r: jlm.loss_fn(p, b, jcfg, r), has_aux=True,
            allow_int=True))(jax.tree.map(jnp.asarray, tree),
                             {k: jnp.asarray(v) for k, v in batch.items()},
                             key if mode == "noise" else None)
    draws = MoEDraws(model_key_paths(key, pcfg))
    tk = dict(warmup=1, t1=1 if mode == "noise" else 0, t2=4)
    pt = pstate.TrainConfig(**tk)
    st = pstate.init_state(pcfg, pt, model=interop.params_from_numpy(
        tree, pcfg, "cpu"))
    st["step"] = 1
    seen = {}
    real = padamw.apply_updates

    def spy(model, grads, *a, **kw):
        seen.update(grads)
        return real(model, grads, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(padamw, "apply_updates", spy)
        _, pm = pstate.train_step(st, batch, pcfg, pt,
                                  (lambda i: draws) if mode == "noise"
                                  else None)
    np.testing.assert_allclose(float(pm["loss"]), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(pm["moe_aux"]),
                               float(jmet["moe_aux"]), rtol=1e-5)
    want = _float_leaves(jg, pcfg)
    assert set(want) == set(seen)
    errs = {n: rel_l2(g, want[n]) for n, g in seen.items()}
    assert max(errs.values()) <= REL_L2, sorted(
        errs.items(), key=lambda kv: -kv[1])[:6]
    np.testing.assert_allclose(float(pm["grad_norm"]),
                               float(jadamw.global_norm(jg)), rtol=1e-5)


@pytest.mark.parametrize("mode", ["noise", "qat"])
def test_train_step_equals_jax(mode):
    """``step_case`` at NOISE and at QAT."""
    step_case(mode)


# ---------------------------------------------------------------- bf16 ----
def test_adamw_updates_bf16_leaves_as_the_reference():
    """One AdamW update of bf16 leaves (``w`` with decay, ``b`` without)
    and an fp32 ``s`` (at the ``s`` rate) from bf16 gradients and
    non-zero fp32 moments: the parameters (bf16 bits), both moments and
    the count bitwise the reference's eager ``apply_updates``; the
    parameters keep their dtypes. The gradients' global norm stays under
    the clip, so the clip scale is exactly 1 in both."""
    rng = np.random.default_rng(31)
    k, n = 64, 48
    w = jnp.asarray(rng.normal(0, 0.2, (k, n)).astype(np.float32)).astype(
        jnp.bfloat16)
    b = jnp.asarray(rng.normal(0, 0.2, (n,)).astype(np.float32)).astype(
        jnp.bfloat16)
    s = rng.normal(-0.2, 1.5, (k // 16,)).astype(np.float32)
    tree = {"b": b, "s": jnp.asarray(s), "w": w}
    grads = {"b": jnp.asarray(rng.normal(0, 1e-2, (n,)).astype(np.float32)
                              ).astype(jnp.bfloat16),
             "s": jnp.asarray(rng.normal(0, 1e-2, s.shape).astype(
                 np.float32)),
             "w": jnp.asarray(rng.normal(0, 1e-2, (k, n)).astype(np.float32)
                              ).astype(jnp.bfloat16)}
    mu = {name: jnp.asarray(rng.normal(0, 1e-3, a.shape).astype(np.float32))
          for name, a in tree.items()}
    nu = {name: jnp.asarray(rng.uniform(0, 1e-5, a.shape).astype(
        np.float32)) for name, a in tree.items()}
    cfg = jadamw.AdamWConfig(lr=1e-3)
    assert float(jadamw.global_norm(grads)) < cfg.clip_norm
    jnew, jst, _ = jadamw.apply_updates(
        tree, grads, {"mu": mu, "nu": nu, "count": jnp.zeros((), jnp.int32)},
        cfg, lr_scale=jnp.float32(0.7))

    def bits(a):
        t = torch.tensor(np.asarray(a).view(np.int16)).view(torch.bfloat16) \
            if np.asarray(a).dtype.itemsize == 2 else torch.tensor(
                np.asarray(a))
        return t

    lin = psmol.SmolLinear({"w": bits(w), "b": bits(b), "s": bits(s)})
    lin.requires_grad_(True)
    st = {"mu": {name: bits(a) for name, a in mu.items()},
          "nu": {name: bits(a) for name, a in nu.items()}, "count": 0}
    padamw.apply_updates(lin, {name: bits(g) for name, g in grads.items()},
                         st, padamw.AdamWConfig(lr=1e-3), lr_scale=0.7)
    assert st["count"] == int(jst["count"]) == 1
    for name in ("w", "b", "s"):
        got = getattr(lin, name).detach()
        want = bits(jnew[name])
        assert got.dtype == want.dtype == (torch.float32 if name == "s"
                                           else torch.bfloat16)
        assert torch.equal(got.view(torch.int16 if got.element_size() == 2
                                    else torch.int32),
                           want.view(torch.int16 if want.element_size() == 2
                                     else torch.int32)), name
        for mom in ("mu", "nu"):
            assert torch.equal(st[mom][name], bits(jst[mom][name])), \
                (mom, name)


def test_bf16_model_step_keeps_every_dtype():
    """The card configuration's cut at reduced width with bf16 parameters
    and compute (jamba's ``param_dtype``): a NOISE step, then a hoisted
    QAT step of one microbatch, each hands AdamW every gradient in its
    parameter's dtype (bf16 linears, banks, table and readout; fp32
    norms, ``s``, routers and the mixers' A_log, D, dt_bias, norm_g), as
    the reference's ``jax.grad`` and its hoisted VJP give them; every
    parameter keeps its dtype and the moments are fp32; the losses are
    finite and within 1e-2 of the fp32 upcast's on the same batch."""
    _, pcfg = configs(**CUT)
    bcfg = dataclasses.replace(pcfg, dtype="bfloat16",
                               param_dtype="bfloat16")
    batch = batch_of(pcfg, 5)
    seen = []
    real = padamw.apply_updates

    def spy(model, grads, *a, **kw):
        seen.append({n: (grads[n].dtype, p.dtype)
                     for n, p in padamw.trainable(model)})
        return real(model, grads, *a, **kw)

    losses = {}
    for tag, cfg in (("bf16", bcfg), ("fp32", pcfg)):
        ncfg = cfg.with_quant_mode("noise")
        model = plm.init_params(bcfg.with_quant_mode("noise"), seed=7,
                                device="cpu")
        if tag == "fp32":
            model = plm.LM(ncfg, interop._map(
                model.tree(), lambda t: t.detach().float().clone()
                if t.is_floating_point() else t.clone()))
        dtypes = {n: p.dtype for n, p in model.named_parameters()}
        tcfg = pstate.TrainConfig(warmup=1, t1=1, t2=2,
                                  hoist_weight_quant=True)
        st = pstate.init_state(ncfg, tcfg, model=model)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(padamw, "apply_updates", spy)
            _, m1 = pstate.train_step(st, batch, ncfg, tcfg,
                                      pstate.step_noise(1, 0))
            ptransforms.freeze_qat(st["model"], ncfg.quant)
            st["opt"] = padamw.init_state(st["model"])
            qcfg = cfg.with_quant_mode("qat")
            _, m2 = pstate.train_step(st, batch, qcfg, tcfg)
        losses[tag] = (float(m1["loss"]), float(m2["loss"]))
        if tag == "bf16":
            for step in seen:
                assert all(g == p for g, p in step.values()), step
            assert {p for _g, p in seen[0].values()} == {torch.bfloat16,
                                                         torch.float32}
            assert seen[0]["blocks.1.moe.up.w"][1] == torch.bfloat16
            assert seen[0]["blocks.0.mamba.A_log"][1] == torch.float32
            for n, p in st["model"].named_parameters():
                assert p.dtype == dtypes[n], n
            assert {t.dtype for t in st["opt"]["mu"].values()} == {
                torch.float32}
    for a, b in zip(losses["bf16"], losses["fp32"]):
        assert np.isfinite(a)
        np.testing.assert_allclose(a, b, rtol=1e-2)


# ------------------------------------------------------------ plain B9 ----
@pytest.mark.parametrize("shape,row0", [((320, 24), 0), ((3, 192, 20), 0),
                                        ((128, 40), 64)])
def test_cpu_plain_b9_bands_bitwise(monkeypatch, shape, row0):
    """On the CPU the plain B9 and its backward run band by band
    (``CPU_BAND_ROWS`` rows, for speed); the forward, dw and ds equal
    the whole-weight computation bit for bit (a bank; a band of a
    taller weight at ``row0``)."""
    rng = np.random.default_rng(len(shape) + row0)
    w = torch.tensor(rng.uniform(-2.2, 2.2, shape).astype(np.float32))
    s = torch.tensor(rng.normal(-0.5, 2.0, shape[:-2] + (
        shape[-2] // 16,)).astype(np.float32))
    seed = torch.tensor(rng.integers(0, 2 ** 32, (w.shape[0] if w.dim() == 3
                                                  else 1,)))
    g = torch.tensor(rng.standard_normal(shape).astype(np.float32))
    runs = []
    for rows in (64, 1 << 30):
        monkeypatch.setattr(pni, "CPU_BAND_ROWS", rows)
        out = pni.noise_inject_plain(w, pni.group_sigma(s), seed, row0=row0)
        runs.append((out,) + pni.noise_inject_bwd_plain(w, s, seed, g,
                                                        row0=row0))
    for a, b in zip(*runs):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# ------------------------------------------------------------- profile ----
def test_step_profile_counts_hybrid_ops_apart():
    """``tools/step_profile.py`` under ``HYBRID_TRAIN_SPANS`` on a
    training step of the card configuration's cut (reduced width): the
    chunked SSD and the float64 attention label their forward ops and,
    as ``ssd_bwd`` / ``attention_bwd``, the autograd nodes they made; the
    MoE's routing and AdamW's update label theirs."""
    sys.path.insert(0, str(ROOT / "tools"))
    import step_profile
    from torch.profiler import ProfilerActivity, profile
    _, pcfg = configs(**CUT)
    qcfg = pcfg.with_quant_mode("qat")
    tcfg = pstate.TrainConfig(warmup=1, t1=0, t2=2)
    st = pstate.init_state(qcfg, tcfg, model=plm.init_params(
        qcfg, seed=2, device="cpu"))
    undo = step_profile.install_spans(step_profile.HYBRID_TRAIN_SPANS)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            pstate.train_step(st, batch_of(pcfg, 3, s=8), qcfg, tcfg)
    finally:
        undo()
    events = prof.events()
    labels = step_profile.forward_labels(events)
    nodes = {}
    for e in events:
        if e.name.startswith(step_profile.NODE):
            nodes.setdefault(step_profile._label(e, labels), set()).add(
                e.name[len(step_profile.NODE):])
    assert {"ssd", "attention", "moe_routing"} <= set(labels.values())
    assert {"ssd_bwd", "attention_bwd", "moe_routing"} <= set(nodes)
    assert any(step_profile._label(e, labels) == "adamw" and
               e.name.startswith("aten::") for e in events)
