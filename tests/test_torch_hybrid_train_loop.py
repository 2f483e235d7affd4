"""Port parity for hybrid training (jamba-1.5-large-398b) against the JAX
package on the CPU, continued from ``tests/test_torch_hybrid_train.py``,
on the card configuration's cut at reduced width (one
unit of a Mamba2 mixer with the MLP and attention with a 4-expert MoE;
d_model 128, fp32): ``loop.train`` through Phase I, the freeze and Phase
II, checkpoints continued in both directions, the hoisted step bitwise
the unhoisted one (compressed too), the trained model's tokens after
``soniq.to_serve`` against the JAX ``DecodeEngine`` on the same packing;
a bf16 train state's checkpoint in the reference's layout both ways;
int8 compression of bf16 gradients; and the launcher.

NOISE replays the reference's draws (``MoEDraws`` of ``model_key_paths``).
The reference's steps are jitted with the abs-max scale divisions kept
true (``_true_division``), its engine's steps traced with the activation
scale's division kept true (``test_torch_hybrid._true_division``)."""
import dataclasses
import gc
import itertools
import json
import subprocess
import sys
import weakref
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import grad_compress as jgc
from repro.serve import engine as jengine
from repro.train import checkpoint as jckpt
from repro.train import loop as jloop
from repro.train import state as jstate

from repro_torch import interop, soniq
from repro_torch.api.state import SoniqState
from repro_torch.core.phases import Phase
from repro_torch.models import lm as plm
from repro_torch.optim import adamw as padamw
from repro_torch.optim import grad_compress as pgc
from repro_torch.serve import engine as pengine
from repro_torch.train import checkpoint as pckpt
from repro_torch.train import loop as ploop
from repro_torch.train import state as pstate

from test_torch_hybrid import _true_division as engine_true_division
from test_torch_hybrid_train import ARCH, CUT, batch_of, configs
from test_torch_moe_train import MoEDraws, model_key_paths
from test_torch_ssm_train import _assert_continues, _step_dir
from test_torch_train import _one_thread  # noqa: F401
from test_torch_train import (LOOP_TK, _true_division,
                              assert_loop_train_equal, loop_stream,
                              loop_train_runs)
from test_torch_train_substrate import _port_step

ROOT = Path(__file__).resolve().parent.parent
# ``_configs``' narrowing to the cut (it sets the two layers itself).
NARROW = {k: v for k, v in CUT.items() if k != "num_layers"}


# ------------------------------------------------ loop and checkpoints ----
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's and the port's ``loop.train`` (``LOOP_TK``: steps
    0-1 Phase I, the boundary, 2-3 Phase II) on the cut from the same
    spread model, batches and replayed draws, each checkpointing at steps
    2 and 4."""
    jd = str(tmp_path_factory.mktemp("jax_ckpt"))
    pd = str(tmp_path_factory.mktemp("port_ckpt"))
    jout, pout = loop_train_runs(
        ARCH, jax_ckpt=jd, port_ckpt=pd, narrow=NARROW,
        draws=lambda key, cfg: MoEDraws(model_key_paths(key, cfg)))
    return jd, pd, jout, pout


def test_loop_train_equals_jax(runs):
    """The history within 1e-4; the freeze's report (the mixer's two
    linears and the MLP's three, then attention's four and the MoE's
    three banks, an expert a row) and every frozen pbits equal."""
    _jd, _pd, jout, pout = runs
    assert_loop_train_equal(jout, pout)
    assert len(pout["pattern_report"]["layers"]) == 5 + 4 + 3 * 4
    assert [m["moe_aux"] > 0 for m in pout["history"]] == [True] * 4


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_continues_across_packages(runs, tmp_path, direction):
    """One package's step-2 checkpoint (Phase-I parameters laid out under
    ``groups[0]["sub{i}"]``, the mixer's fp leaves, the banks and their
    moments) restored by the other, which runs the boundary and steps
    2-3: the report equal, the losses and the parameters within 1e-4 of
    the reference's uninterrupted run."""
    jd, pd, jout, _pout = runs
    jcfg, pcfg = configs(**CUT)
    rest = itertools.islice(loop_stream(jcfg), 2, None)
    src = jd if direction == "jax_to_port" else pd
    tree, _ = pckpt.restore(src, step=2)
    assert tree["params"]["groups"][0]["sub1"]["moe"]["up"]["w"].shape == (
        1, pcfg.num_experts, pcfg.d_model, pcfg.d_ff)
    assert tree["opt"]["mu"]["groups"][0]["sub0"]["mamba"]["A_log"] \
        .shape[0] == 1
    d = _step_dir(src, 2, str(tmp_path / "ck"))
    if direction == "jax_to_port":
        out = ploop.train(pcfg, pstate.TrainConfig(ckpt_dir=d, **LOOP_TK),
                          rest, device="cpu")
        params = interop.tree_to_numpy(out["state"]["model"])
    else:
        with _true_division():
            out = jloop.train(jcfg, jstate.TrainConfig(ckpt_dir=d,
                                                       **LOOP_TK), rest)
        params = jax.device_get(out["state"]["params"])
    assert [m["step"] for m in out["history"]] == [2, 3]
    _assert_continues(out["history"], out["pattern_report"], params, jout)


def test_trained_model_serves_the_reference_tokens(runs):
    """The port-trained model through ``soniq.to_serve`` (one B7 call a
    linear and a bank): its greedy tokens on the port's ``DecodeEngine``
    equal the JAX ``DecodeEngine``'s on the same packed tree."""
    _jd, _pd, _jout, pout = runs
    jcfg, pcfg = configs(**CUT)
    qcfg = pcfg.with_quant_mode("qat")
    served = soniq.to_serve(SoniqState(Phase.QAT, pout["state"]["model"],
                                       qcfg))
    ecfg = dict(max_batch=3, cache_len=32, prefill_chunk=4)
    prompts = np.random.default_rng(3).integers(
        0, pcfg.vocab_size, (3, 6)).astype(np.int32)
    got = pengine.DecodeEngine(served.model, qcfg,
                               pengine.EngineConfig(**ecfg),
                               already_serve=True,
                               device="cpu").generate(prompts, 5)
    jeng = jengine.DecodeEngine(
        interop.tree_to_numpy(served.model), jcfg.with_quant_mode("qat"),
        jengine.EngineConfig(backend="xla_ref", **ecfg), already_serve=True)
    with engine_true_division():
        want = np.asarray(jeng.generate(prompts, 5))
    np.testing.assert_array_equal(got, want)


def test_boundary_releases_phase_one_moments_first(monkeypatch):
    """At the freeze the loop makes the fresh fp32 moments only once Phase
    I's are released: when ``adamw.init_state`` runs at the boundary, no
    Phase-I moment is alive (the parent made the new set first, so the
    card held both: 2 x 37 GB at ``chip_smoke.py``'s jamba cut)."""
    _, pcfg = configs(**CUT)
    refs, alive = [], []
    real = padamw.init_state

    def spy(model, *a, **kw):
        gc.collect()
        alive.append(sum(r() is not None for r in refs))
        return real(model, *a, **kw)

    def hook(step, st, _m):
        if step == 0:
            refs.extend(weakref.ref(t) for t in st["opt"]["mu"].values())

    monkeypatch.setattr(padamw, "init_state", spy)
    out = ploop.train(pcfg, pstate.TrainConfig(t1=1, t2=2, warmup=1),
                      iter([batch_of(pcfg, 6)] * 2), device="cpu",
                      hooks=[hook])
    assert [m["phase"] for m in out["history"]] == [1, 2]
    assert refs and alive == [0, 0]


# ------------------------------------------------- hoisting, compression ----
def test_hoisted_step_is_the_unhoisted_step_bitwise():
    """A 2-microbatch QAT step on the cut hoisted (one B8 call a linear
    and a bank) and unhoisted: the same loss, ``moe_aux``, gradient norm
    and parameters, bit for bit; compressed too, with the same error for
    every leaf (the mixer's fp leaves and the routers included)."""
    _, pcfg = configs(**CUT)
    qcfg = pcfg.with_quant_mode("qat")
    tree = interop.tree_to_numpy(plm.init_params(qcfg, seed=4,
                                                 device="cpu"))
    batch = batch_of(pcfg, 1, b=4)
    for compress in (False, True):
        (a, ma), (b, mb) = [
            _port_step(tree, qcfg, batch, num_microbatches=2,
                       hoist_weight_quant=h, grad_compress=compress)
            for h in (False, True)]
        for key in ("loss", "grad_norm", "moe_aux"):
            assert float(ma[key]) == float(mb[key]), key
        for (n, x), (_, y) in zip(a["model"].named_parameters(),
                                  b["model"].named_parameters()):
            assert torch.equal(x, y), n
        if compress:
            assert "blocks.0.mamba.A_log" in a["err"]
            assert "blocks.1.moe.router.w" in a["err"]
            for n in a["err"]:
                assert torch.equal(a["err"][n], b["err"][n]), n


def test_bf16_gradients_compress_as_the_reference():
    """int8 error-feedback compression of bf16 gradients (the bf16
    hybrid's linears and banks) with an fp32 error: codes, scale and the
    new error bitwise the reference's eager ``compress_leaf``; two
    compressed bf16 steps run twice are bitwise alike."""
    rng = np.random.default_rng(8)
    for shape in ((64, 48), (2, 32, 24)):
        g = jnp.asarray(rng.normal(0, 1e-3, shape).astype(np.float32)
                        ).astype(jnp.bfloat16)
        err = rng.normal(0, 1e-5, shape).astype(np.float32)
        jq, js, je = jgc.compress_leaf(g, jnp.asarray(err))
        pg = torch.tensor(np.asarray(g).view(np.int16)).view(torch.bfloat16)
        pq, ps, pe = pgc.compress_leaf(pg, torch.tensor(err))
        np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
        assert ps.item() == float(js)
        np.testing.assert_array_equal(pe.numpy().view(np.int32),
                                      np.asarray(je).view(np.int32))
    _, pcfg = configs(**CUT)
    bcfg = dataclasses.replace(pcfg, dtype="bfloat16",
                               param_dtype="bfloat16").with_quant_mode("qat")
    batch = batch_of(pcfg, 2)
    tcfg = pstate.TrainConfig(warmup=1, t1=0, t2=4, grad_compress=True)
    runs = []
    for _ in range(2):
        st = pstate.init_state(bcfg, tcfg, model=plm.init_params(
            bcfg, seed=6, device="cpu"))
        for _step in range(2):
            st, met = pstate.train_step(st, batch, bcfg, tcfg)
        runs.append((float(met["loss"]), st))
    (la, a), (lb, b) = runs
    assert la == lb and np.isfinite(la)
    for (n, x), (_, y) in zip(a["model"].named_parameters(),
                              b["model"].named_parameters()):
        assert x.dtype == y.dtype and torch.equal(x, y), n
    for n in a["err"]:
        assert a["err"][n].dtype == torch.float32
        assert torch.equal(a["err"][n], b["err"][n]), n


def test_bf16_state_checkpoint_crosses_both_ways(tmp_path):
    """The bf16 hybrid's train state after a Phase-I step (bf16
    parameters, fp32 ``s`` and moments, the count) written by each
    package in the reference's layout: the same keys
    (``params/groups/0/sub{i}/...``, stacked over units), the same
    manifest dtypes and the same bytes; each package's file restores in
    the other (the reference's ``restore`` into its state's structure,
    the port's ``state_from_tree``) bitwise, bf16 leaves as bf16."""
    _, pcfg = configs(**CUT)
    ncfg = dataclasses.replace(pcfg, dtype="bfloat16",
                               param_dtype="bfloat16").with_quant_mode("noise")
    tcfg = pstate.TrainConfig(warmup=1, t1=1, t2=2)
    st = pstate.init_state(ncfg, tcfg, model=plm.init_params(
        ncfg, seed=5, device="cpu"))
    st, _ = pstate.train_step(st, batch_of(pcfg, 4), ncfg, tcfg,
                              pstate.step_noise(1, 0))
    tree = interop.state_to_tree(st)
    pd, jd = str(tmp_path / "port"), str(tmp_path / "jax")
    pckpt.save(tree, pd, 1)

    def as_jax(a):
        a = np.asarray(a)
        return a.view(jnp.bfloat16) if a.dtype.kind == "V" else a

    jtree = jax.tree.map(as_jax, tree)
    jckpt.save(jtree, jd, 1)
    man = {}
    for d in (pd, jd):
        with open(Path(d) / "step_00000001" / "manifest.json") as f:
            man[d] = json.load(f)
    assert man[pd]["leaves"] == man[jd]["leaves"]
    assert man[pd]["none_leaves"] == man[jd]["none_leaves"]
    leaves = man[pd]["leaves"]
    assert leaves["params/groups/0/sub1/moe/up/w"] == {
        "shape": [1, pcfg.num_experts, pcfg.d_model, pcfg.d_ff],
        "dtype": "bfloat16"}
    assert leaves["opt/mu/groups/0/sub1/moe/up/w"]["dtype"] == "float32"
    assert leaves["params/groups/0/sub0/mamba/A_log"]["dtype"] == "float32"
    with np.load(Path(pd) / "step_00000001" / "shard_0.npz") as zp, \
            np.load(Path(jd) / "step_00000001" / "shard_0.npz") as zj:
        assert sorted(zp.files) == sorted(zj.files)
        for k in zp.files:
            assert zp[k].tobytes() == zj[k].tobytes(), k
    # The reference restores the port's file into its own state.
    back, step = jckpt.restore(pd, jtree)
    assert step == 1
    for (path, want), (_p, got) in zip(
            jax.tree_util.tree_flatten_with_path(jtree)[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes(), path
    # The port restores the reference's file.
    ptree, _ = pckpt.restore(jd)
    state = interop.state_from_tree(ptree, ncfg, "cpu")
    for (n, x), (_, y) in zip(st["model"].named_parameters(),
                              state["model"].named_parameters()):
        assert x.dtype == y.dtype and torch.equal(x, y), n
    for mom in ("mu", "nu"):
        for n, t in st["opt"][mom].items():
            assert torch.equal(t, state["opt"][mom][n]), (mom, n)
    assert state["opt"]["count"] == st["opt"]["count"] == 1


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


def test_launcher_trains_the_hybrid_without_jax(tmp_path):
    """``launch.train --arch jamba-1.5-large-398b --reduced --device cpu``
    (Phase I, the boundary, hoisted compressed Phase-II steps at 2
    microbatches, a checkpoint in the reference's layout) exits 0 in a
    subprocess that loads no jax."""
    ck = str(tmp_path / "ck")
    train = ["repro_torch.launch.train", "--arch", ARCH, "--reduced",
             "--device", "cpu", "--steps", "4", "--t1", "2", "--batch", "2",
             "--seq", "16", "--microbatches", "2", "--ckpt", ck, "--hoist",
             "--grad-compress"]
    out = subprocess.run(
        [sys.executable, "-c", RUN.format(argvs=[train])],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stdout + out.stderr[-4000:]
    assert out.stdout.rstrip().endswith("no jax loaded")
    assert out.stdout.count("phase 1:") == 2
    assert out.stdout.count("phase 2:") == 2
    assert out.stdout.count("moe_aux=") == 4
    assert "boundary: average bpp" in out.stdout and "done" in out.stdout
    tree, step = pckpt.restore(ck)
    assert step == 4 and "err" in tree
    assert "conv_w" in tree["params"]["groups"][0]["sub0"]["mamba"]
