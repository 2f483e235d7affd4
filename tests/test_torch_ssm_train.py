"""Port parity for SSM training (mamba2-2.7b, reduced to 2 layers)
against the JAX package on the CPU: softplus with JAX's derivative, the
segment-sum decay masked before its ``exp``, the Mamba2 mixer's gradients
at FP, NOISE and QAT against ``jax.grad`` (NOISE on the reference's draws,
replayed), the recompute, ``loop.train`` through Phase I, the freeze and
Phase II, checkpoints continued in both directions, the trained model
served, hoisting, microbatches and compression, the façade, and the
launcher.

The shared cases live beside their dense versions (``train_step``, the
freeze and the checkpointed states are parametrised over the SSM in
``tests/test_torch_train.py`` and ``tests/test_torch_checkpoint.py``);
this file drives the helpers of those files on the SSM. The reference's
steps are jitted with the abs-max scale divisions kept true
(``_true_division``)."""
import copy
import itertools
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import transforms as jtransforms
from repro.core import schedule as jschedule
from repro.core.qtypes import QuantConfig as JQuantConfig
from repro.models import ssm as jssm
from repro.serve import engine as jengine
from repro.train import loop as jloop
from repro.train import state as jstate

from repro_torch import interop, soniq
from repro_torch.core import schedule as pschedule
from repro_torch.core import smol as psmol
from repro_torch.core.qtypes import QuantConfig as PQuantConfig
from repro_torch.data import synthetic as psynthetic
from repro_torch.models import ssm as pssm
from repro_torch.serve import engine as pengine
from repro_torch.train import checkpoint as pckpt
from repro_torch.train import loop as ploop
from repro_torch.train import state as pstate

from test_torch_train import (LOOP_TK, SSM_ARCH, JaxDraws, _abs_diffs,
                              _configs, _stacked_linears, _true_division,
                              assert_loop_train_equal, loop_stream,
                              loop_train_runs, microbatch_case,
                              recompute_case)
from test_torch_train_substrate import hoisted_case
from test_torch_train import _one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
REL_L2 = 1e-5


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), 1e-30))


# ---------------------------------------------------- softplus, segsum ----
def test_softplus_has_jax_derivative():
    """The forward is bitwise the formula serving uses; the backward is
    ``logaddexp``'s custom JVP (``g * exp(x - out)``, +inf read as 0):
    0.5 at 0, within 5e-7 of ``jax.grad(jax.nn.softplus)`` on a seeded
    grid with the tails and both infinities."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(0, 4, 4096), [0.0, -0.0, 20.0, -20.0,
                                                 30.0, -104.0, 89.0, np.inf,
                                                 -np.inf]]).astype(np.float32)
    g = rng.normal(0, 1, x.shape).astype(np.float32)
    t = torch.tensor(x, requires_grad=True)
    out = pssm.softplus(t)
    want_fwd = torch.clamp(t.detach(), min=0.0) + torch.log1p(
        torch.exp(-t.detach().abs()))
    assert torch.equal(out.detach(), want_fwd)
    out.backward(torch.tensor(g))
    _, vjp = jax.vjp(jax.nn.softplus, jnp.asarray(x))
    (jgrad,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad), rtol=0,
                               atol=5e-7)
    one = torch.zeros((), requires_grad=True)
    pssm.softplus(one).backward()
    assert one.grad.item() == 0.5 == float(jax.grad(jax.nn.softplus)(0.0))


def test_segsum_exp_gradients_stay_finite_where_the_reference_overflows():
    """The decay matrix's upper triangle is filled with -inf before the
    ``exp``: the forward is bitwise the masked-after form on ordinary
    decays, and the gradient is finite where an upper-triangle ``diff``
    passes float64's exp range (> 709). The reference masks after its fp32
    ``exp``, so past 88.7 its gradient is 0 * inf = NaN (ROADMAP §C)."""
    rng = np.random.default_rng(1)
    da = torch.tensor(-rng.uniform(0, 0.3, (2, 3, 32)))
    n = da.shape[-1]
    cs = torch.cumsum(da, -1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((n, n), dtype=torch.bool))
    assert torch.equal(pssm._segsum_exp(da),
                       torch.where(mask, torch.exp(diff),
                                   torch.zeros((), dtype=da.dtype)))
    big = torch.full((2, 64), -12.0, dtype=torch.float64,
                     requires_grad=True)        # diff up to 12 * 63 = 756
    (pssm._segsum_exp(big) * 2.0).sum().backward()
    assert torch.isfinite(big.grad).all() and big.grad.abs().sum() > 0
    # Through the chunked scan: dt = 2 a step (da = -2) over a 64-step
    # chunk, an fp32 diff of up to 126.
    b, s, h, p, ns = 1, 64, 2, 4, 8
    xdt = rng.normal(0, 1, (b, s, h, p)).astype(np.float32)
    bm = rng.normal(0, 1, (b, s, ns)).astype(np.float32)
    cm = rng.normal(0, 1, (b, s, ns)).astype(np.float32)
    da32 = np.full((b, s, h), -2.0, np.float32)
    jgrad = jax.grad(lambda d: jnp.sum(jssm.ssd_chunked(
        jnp.asarray(xdt), d, jnp.asarray(bm), jnp.asarray(cm), 64)[0]))(
        jnp.asarray(da32))
    assert np.isnan(np.asarray(jgrad)).any()
    td = torch.tensor(da32, requires_grad=True)
    y, _ = pssm.ssd_chunked(torch.tensor(xdt), td, torch.tensor(bm),
                            torch.tensor(cm), 64)
    y.sum().backward()
    assert torch.isfinite(td.grad).all()


# -------------------------------------------------------------- mixer ----
MIXER = dict(d_model=128, d_state=32, chunk=16)


def _mixer_case(mode, seed=5):
    """The reference's mixer leaf in ``mode`` (NOISE logits spread over
    the bands), an input of 37 steps (padded to 48 by the scan) and a
    cotangent."""
    rng = np.random.default_rng(seed)
    jq = JQuantConfig(mode=mode, backend="xla_ref")
    tree = jax.device_get(jssm.mamba2_init(
        jax.random.PRNGKey(seed), MIXER["d_model"], MIXER["d_state"], jq))
    tree = jax.tree.map(np.array, tree)
    if mode == "noise":
        for name in ("in_proj", "out_proj"):
            s = tree[name]["s"]
            tree[name]["s"] = rng.normal(-0.2, 1.5, s.shape).astype(
                np.float32)
    tree["conv_b"] = rng.normal(0, 0.1, tree["conv_b"].shape).astype(
        np.float32)
    tree["norm_g"] = rng.normal(1, 0.1, tree["norm_g"].shape).astype(
        np.float32)
    x = rng.normal(0, 1, (2, 37, MIXER["d_model"])).astype(np.float32)
    g = rng.normal(0, 1, x.shape).astype(np.float32)
    return jq, tree, x, g


def _float_paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_float_paths(v, f"{prefix}{k}."))
        elif np.issubdtype(v.dtype, np.floating):
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("mode", ["fp", "noise", "qat"])
def test_mixer_grads_equal_jax(mode):
    """``mamba2_apply`` and its gradients (x and every float leaf: the
    two linears' ``w`` and ``s``, ``conv_w``, ``conv_b``, ``A_log``,
    ``D``, ``dt_bias``, ``norm_g``) within relative L2 1e-5 of
    ``jax.grad`` of the reference's mixer; NOISE on the reference's draws
    (its key split in 2: ``in_proj``, ``out_proj``)."""
    jq, tree, x, g = _mixer_case(mode)
    key = jax.random.PRNGKey(11) if mode == "noise" else None
    flt = _float_paths(tree)

    def put(leaves):
        out = jax.tree.map(jnp.asarray, tree)
        for path, v in leaves.items():
            node = out
            *parts, last = path.split(".")
            for part in parts:
                node = node[part]
            node[last] = v
        return out

    def loss(leaves, x_):
        y = jssm.mamba2_apply(put(leaves), x_, jq, key,
                              d_state=MIXER["d_state"],
                              chunk=MIXER["chunk"])
        return jnp.sum(y * g), y

    with _true_division():
        (_, jy), (jgl, jgx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(
            {k: jnp.asarray(v) for k, v in flt.items()}, jnp.asarray(x))
    m = pssm.Mamba2({k: ({n: torch.tensor(a) for n, a in v.items()}
                         if isinstance(v, dict) else torch.tensor(v))
                     for k, v in tree.items()})
    m.in_proj.path, m.out_proj.path = "in_proj", "out_proj"
    m.requires_grad_(True)
    noise = None
    if mode == "noise":
        kin, kout = jax.random.split(key)
        noise = JaxDraws({"in_proj": kin, "out_proj": kout})
    xt = torch.tensor(x, requires_grad=True)
    y = pssm.mamba2_apply(m, xt, PQuantConfig(mode=mode), noise,
                          d_state=MIXER["d_state"], chunk=MIXER["chunk"])
    (y * torch.tensor(g)).sum().backward()
    errs = {"y": rel_l2(y.detach(), jy), "dx": rel_l2(xt.grad, jgx)}
    params = dict(m.named_parameters())
    assert set(params) == set(flt)
    for path, p in params.items():
        errs[path] = rel_l2(p.grad, jgl[path])
    assert max(errs.values()) <= REL_L2, errs


def test_recomputed_mamba_blocks_see_the_same_noise():
    """The mixer's two linears draw by path (``blocks.N.mamba.in_proj``,
    ``.out_proj``), so the recomputed blocks replay the same noise: loss
    and gradients bitwise the plain backward's."""
    recompute_case(SSM_ARCH)


# ------------------------------------------------ loop and checkpoints ----
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's and the port's ``loop.train`` (``LOOP_TK``: steps
    0-1 Phase I, the boundary, 2-3 Phase II) from the same spread model,
    batches and replayed draws, each checkpointing at steps 2 and 4."""
    jd = str(tmp_path_factory.mktemp("jax_ckpt"))
    pd = str(tmp_path_factory.mktemp("port_ckpt"))
    jout, pout = loop_train_runs(SSM_ARCH, jax_ckpt=jd, port_ckpt=pd)
    return jd, pd, jout, pout


def test_loop_train_equals_jax(runs):
    """``test_loop_train_equals_jax`` on the SSM: the history within 1e-4,
    the report and the frozen pbits of both mixer linears equal."""
    _jd, _pd, jout, pout = runs
    assert_loop_train_equal(jout, pout)


def _step_dir(src, step, dst):
    """A checkpoint directory holding only ``src``'s step ``step``."""
    name = f"step_{step:08d}"
    shutil.copytree(os.path.join(src, name), os.path.join(dst, name))
    with open(os.path.join(dst, "LATEST"), "w") as f:
        f.write(str(step))
    return dst


def _assert_continues(history, report, params, ref):
    np.testing.assert_allclose([m["loss"] for m in history],
                               [m["loss"] for m in ref["history"][2:]],
                               rtol=1e-4, atol=1e-4)
    assert report["layers"] == ref["pattern_report"]["layers"]
    diffs = np.concatenate(_abs_diffs(params, jax.device_get(
        ref["state"]["params"])))
    assert diffs.max() <= 1e-4


def test_jax_checkpoint_continues_on_the_port(runs, tmp_path):
    """JAX -> port: the reference's step-2 checkpoint (Phase-I params with
    the mixer's fp leaves and their moments) restored by the port, which
    runs the boundary and steps 2-3: the report equal, losses and
    parameters within 1e-4 of the reference's uninterrupted run."""
    jd, _pd, jout, _pout = runs
    jcfg, pcfg = _configs(arch=SSM_ARCH)
    d = _step_dir(jd, 2, str(tmp_path / "ck"))
    out = ploop.train(pcfg, pstate.TrainConfig(ckpt_dir=d, **LOOP_TK),
                      itertools.islice(loop_stream(jcfg), 2, None),
                      device="cpu")
    assert [m["step"] for m in out["history"]] == [2, 3]
    _assert_continues(out["history"], out["pattern_report"],
                      interop.tree_to_numpy(out["state"]["model"]), jout)


def test_port_checkpoint_continues_on_jax(runs, tmp_path):
    """Port -> JAX: the port's step-2 checkpoint restored by the
    reference's loop, which runs the boundary and steps 2-3: the report
    equal, losses and parameters within 1e-4 of the reference's
    uninterrupted run."""
    _jd, pd, jout, _pout = runs
    jcfg, _pcfg = _configs(arch=SSM_ARCH)
    d = _step_dir(pd, 2, str(tmp_path / "ck"))
    with _true_division():
        out = jloop.train(jcfg, jstate.TrainConfig(ckpt_dir=d, **LOOP_TK),
                          itertools.islice(loop_stream(jcfg), 2, None))
    assert [m["step"] for m in out["history"]] == [2, 3]
    _assert_continues(out["history"], out["pattern_report"],
                      jax.device_get(out["state"]["params"]), jout)


def test_trained_model_serves_the_reference_tokens(runs):
    """The reference-trained QAT params packed by the port's
    ``DecodeEngine`` (2 B7 calls a layer) give the JAX ``DecodeEngine``'s
    greedy tokens on that packing; the port-trained model serves too."""
    _jd, _pd, jout, pout = runs
    jcfg, pcfg = _configs(arch=SSM_ARCH)
    qcfg = pcfg.with_quant_mode("qat")
    ecfg = dict(max_batch=3, cache_len=32, prefill_chunk=4)
    prompts = np.random.default_rng(3).integers(
        0, pcfg.vocab_size, (3, 6)).astype(np.int32)
    model = interop.params_from_numpy(
        jax.device_get(jout["state"]["params"]), qcfg, "cpu")
    eng = pengine.DecodeEngine(model, qcfg, pengine.EngineConfig(**ecfg),
                               device="cpu")
    got = eng.generate(prompts, 5)
    jeng = jengine.DecodeEngine(
        interop.tree_to_numpy(eng.model), jcfg.with_quant_mode("qat"),
        jengine.EngineConfig(backend="xla_ref", **ecfg), already_serve=True)
    np.testing.assert_array_equal(got, np.asarray(jeng.generate(prompts, 5)))
    own = pengine.DecodeEngine(pout["state"]["model"], qcfg,
                               pengine.EngineConfig(**ecfg), device="cpu")
    out = own.generate(prompts, 5)
    assert out.shape == (3, 11) and ((out >= 0) & (out < pcfg.vocab_size)
                                     ).all()


# ------------------------------------------------- hoisting, compression ----
def test_hoisted_ssm_step_is_the_unhoisted_step_bitwise():
    """A 2-microbatch QAT step on the SSM hoisted (one B8 call a mixer
    linear) and unhoisted: the same loss, gradient norm and parameters,
    bit for bit, also compressed; the compression error is kept for every
    leaf by path, the mixer's fp leaves included."""
    a, _b = hoisted_case(SSM_ARCH)
    hoisted = psmol.prequantize_tree(a["model"], a["model"].cfg.quant)
    assert sorted(hoisted) == [f"blocks.{i}.mamba.{n}" for i in (0, 1)
                               for n in ("in_proj", "out_proj")]
    names = {n for n, _ in a["model"].named_parameters()}
    assert set(a["err"]) == names
    for leaf in ("conv_w", "A_log", "dt_bias", "in_proj.w", "out_proj.w"):
        assert a["err"][f"blocks.1.mamba.{leaf}"].abs().sum() > 0, leaf


def test_ssm_microbatches_sum_their_gradients_in_order():
    microbatch_case(SSM_ARCH)


# --------------------------------------------------------------- façade ----
def test_facade_freezes_and_serves_a_trained_ssm():
    """``soniq.to_qat`` on an SSM LM after a Phase-I step: the frozen
    pbits and the report equal the reference's ``freeze_qat`` on the same
    trained logits. Then ``to_serve`` (2 B7 calls a layer): the served
    model's greedy tokens equal the ``DecodeEngine``'s packing of the
    same QAT model."""
    jcfg, pcfg = _configs(arch=SSM_ARCH)
    ncfg = pcfg.with_quant_mode("noise")
    state = soniq.init(ncfg, seed=4, device="cpu")
    tcfg = pstate.TrainConfig(warmup=1, t1=1, t2=2)
    st = pstate.init_state(ncfg, tcfg, model=state.model)
    batch = next(psynthetic.TokenStream(psynthetic.TokenStreamConfig(
        vocab_size=pcfg.vocab_size, seq_len=16, batch_size=2,
        seed=5)).batches())
    pstate.train_step(st, batch, ncfg, tcfg, pstate.step_noise(1, 0))
    jnew, jrep = jtransforms.freeze_qat(interop.tree_to_numpy(state.model),
                                        jcfg.with_quant_mode("noise").quant)
    qat, report = soniq.to_qat(state)
    assert len(report["layers"]) == 2 * pcfg.num_layers
    assert report["allowed"] == jrep["allowed"]
    assert report["layers"] == jrep["layers"]
    assert pschedule.average_bpp(report) == jschedule.average_bpp(jrep)
    for jl, pl in zip(_stacked_linears(jnew),
                      _stacked_linears(interop.tree_to_numpy(qat.model))):
        assert "s" not in pl
        np.testing.assert_array_equal(pl["pbits"], np.asarray(jl["pbits"]))
    twin = copy.deepcopy(qat.model)
    served = soniq.to_serve(qat)
    for block in served.model.blocks:
        assert "w4" in block.mamba.in_proj._names
    ecfg = pengine.EngineConfig(max_batch=2, cache_len=32, prefill_chunk=4)
    prompts = np.random.default_rng(6).integers(
        0, pcfg.vocab_size, (2, 5)).astype(np.int32)
    got = pengine.DecodeEngine(served.model, served.model_cfg, ecfg,
                               already_serve=True,
                               device="cpu").generate(prompts, 4)
    want = pengine.DecodeEngine(twin, pcfg.with_quant_mode("qat"), ecfg,
                                device="cpu").generate(prompts, 4)
    np.testing.assert_array_equal(got, want)


# -------------------------------------------------------------- profile ----
def test_step_profile_counts_the_ssd_backward_apart():
    """``tools/step_profile.py`` under ``SSM_TRAIN_SPANS``: the chunked
    SSD's forward ops (and their recompute) label ``ssd``, the autograd
    nodes they made ``ssd_bwd`` (matched by the forward op's thread and
    sequence number); the ops outside any range stay unlabelled."""
    sys.path.insert(0, str(ROOT / "tools"))
    import step_profile
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.checkpoint import checkpoint
    rng = np.random.default_rng(7)
    args = [torch.tensor(rng.normal(0, 1, shape).astype(np.float32),
                         requires_grad=True)
            for shape in ((1, 8, 2, 4), (1, 8, 2), (1, 8, 4), (1, 8, 4))]
    undo = step_profile.install_spans(step_profile.SSM_TRAIN_SPANS)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            y = checkpoint(lambda *a: pssm.ssd_chunked(*a, 4)[0], *args,
                           use_reentrant=False)
            (y.exp() * 2).sum().backward()
    finally:
        undo()
    events = prof.events()
    labels = step_profile.forward_labels(events)
    nodes = {}
    for e in events:
        if e.name.startswith(step_profile.NODE):
            nodes.setdefault(step_profile._label(e, labels), set()).add(
                e.name[len(step_profile.NODE):])
    assert set(labels.values()) == {"ssd"}
    assert "ssd_bwd" in nodes and any("Bmm" in n or "Mul" in n
                                      for n in nodes["ssd_bwd"])
    assert "ExpBackward0" in nodes[None]


# ------------------------------------------------------------ launcher ----
RUN = (
    "import runpy, sys\n"
    "for argv in {argvs!r}:\n"
    "    sys.argv = argv\n"
    "    try:\n"
    "        runpy.run_module(argv[0], run_name='__main__')\n"
    "    except SystemExit as e:\n"
    "        assert not e.code, (argv, e.code)\n"
    "bad = sorted(m for m in sys.modules if m == 'jax' or "
    "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
    "assert not bad, bad\n"
    "print('no jax loaded')\n")


def test_launcher_trains_and_serves_the_ssm_without_jax(tmp_path):
    """``launch.train --arch mamba2-2.7b --reduced --device cpu`` (Phase I,
    the boundary, hoisted compressed Phase-II steps at 2 microbatches,
    a checkpoint), then ``launch.serve --ckpt`` on what it wrote, in a
    subprocess that loads no jax."""
    ck = str(tmp_path / "ck")
    train = ["repro_torch.launch.train", "--arch", SSM_ARCH, "--reduced",
             "--device", "cpu", "--steps", "4", "--t1", "2", "--batch", "2",
             "--seq", "16", "--microbatches", "2", "--ckpt", ck, "--hoist",
             "--grad-compress"]
    serve = ["repro_torch.launch.serve", "--arch", SSM_ARCH, "--reduced",
             "--device", "cpu", "--ckpt", ck, "--requests", "2",
             "--prompt-len", "4", "--new-tokens", "3", "--cache-len", "16"]
    out = subprocess.run(
        [sys.executable, "-c", RUN.format(argvs=[train, serve])],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stdout + out.stderr[-4000:]
    assert out.stdout.rstrip().endswith("no jax loaded")
    assert out.stdout.count("phase 1:") == 2
    assert out.stdout.count("phase 2:") == 2
    assert "boundary: average bpp" in out.stdout and "done" in out.stdout
    assert "ssm state: h fp32" in out.stdout
    tree, step = pckpt.restore(ck)
    assert step == 4 and "err" in tree
    assert "conv_w" in tree["params"]["groups"][0]["mamba"]
