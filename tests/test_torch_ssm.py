"""Port parity for the SSM family (mamba2-2.7b, reduced): the config, the
chunked SSD scan, the Mamba2 mixer (full-sequence forward, decode and
chunked prefill with its cache), the reduced LM's decode, prefill and
verify steps with their recurrent state, and the engines, against the JAX
package (``xla_ref``) on numpy inputs from a seed. The reference's steps
are compiled as tests/test_torch_serve.py compiles them (the activation
scale's division kept true). The greedy-token checks use
tests/test_serve_families.py's ssm setup (``lm.init_params(PRNGKey(0))``,
prompts of 3/9/5 tokens, 5/4/4 new, max_batch 3, cache_len 32); the
JAX engines serve the port's packing of those params (``already_serve``),
so both packages run the same weights."""
import dataclasses
import re
import subprocess
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import quant as jquant
from repro.core.qtypes import QuantConfig as JQuantConfig
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.serve import engine as jengine
from repro.serve.scheduler import Request as JRequest

from repro_torch import interop
from repro_torch.api import transforms as ptransforms
from repro_torch.configs import get_config as pget_config
from repro_torch.core.qtypes import QuantConfig as PQuantConfig
from repro_torch.models import lm as plm
from repro_torch.models import ssm as pssm
from repro_torch.serve import engine as pengine
from repro_torch.serve.scheduler import Request as PRequest

from test_torch_train import _one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
ARCH = "mamba2-2.7b"
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
ENGINE = dict(max_batch=3, cache_len=32, prefill_chunk=4)


def _compile_as_written(fn, *args):
    """``fn`` jitted with the activation scale's division by the grid top
    kept a true division and no excess precision, as
    tests/test_torch_serve.py compiles the reference's steps."""
    top = jquant._static_grid_max
    with mock.patch.object(jquant, "_static_grid_max", lambda p:
                           jax.lax.optimization_barrier(jnp.float32(top(p)))):
        return jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return None if tree is None else torch.tensor(np.asarray(tree))


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return None if tree is None else tree.detach().numpy().copy()


# ------------------------------------------------------------- config ----
def test_config_equals_the_reference():
    want, got = jget_config(ARCH), pget_config(ARCH)
    a, b = dataclasses.asdict(want), dataclasses.asdict(got)
    a.pop("quant")
    b.pop("quant")
    assert a == b
    assert got.d_inner == want.d_inner == 5120
    assert got.layer_plan() == want.layer_plan() == (("mamba", 64),)
    ra, rb = (dataclasses.asdict(c.reduced()) for c in (want, got))
    ra.pop("quant")
    rb.pop("quant")
    assert ra == rb and rb["ssm_state"] == 32 and rb["ssm_chunk"] == 32


# ---------------------------------------------------------------- SSD ----
def _ssd_inputs(seed, b=2, s=37, h=3, p=4, n=8):
    rng = np.random.default_rng(seed)
    xdt = rng.standard_normal((b, s, h, p)).astype(np.float32)
    da = -np.logaddexp(rng.standard_normal((b, s, h)), 0).astype(np.float32)
    b_mat = rng.standard_normal((b, s, n)).astype(np.float32)
    c_mat = rng.standard_normal((b, s, n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return xdt, da, b_mat, c_mat, h0


_J_SSD = jax.jit(jssm.ssd_chunked, static_argnums=4)
_J_REF = jax.jit(jssm.ssd_reference)


@pytest.mark.parametrize("s,chunk", [(37, 8), (5, 8), (32, 8), (1, 4)])
@pytest.mark.parametrize("carried", [True, False])
def test_ssd_chunked_matches_jax(s, chunk, carried):
    """The port's chunked scan against JAX's ``ssd_chunked`` and
    ``ssd_reference`` (the sequential oracle), with and without a carried
    state, at lengths that are not a multiple of the chunk and shorter
    than one; the port's oracle against JAX's."""
    xdt, da, b_mat, c_mat, h0 = _ssd_inputs(s, s=s)
    h0 = h0 if carried else None
    jargs = [jnp.asarray(a) for a in (xdt, da, b_mat, c_mat)]
    jh0 = None if h0 is None else jnp.asarray(h0)
    targs = [torch.from_numpy(a) for a in (xdt, da, b_mat, c_mat)]
    th0 = None if h0 is None else torch.from_numpy(h0)
    y, h_last = pssm.ssd_chunked(*targs, chunk, h0=th0)
    assert y.dtype == h_last.dtype == torch.float32
    for want in (_J_SSD(*jargs, chunk, jh0), _J_REF(*jargs, jh0)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want[0]), **TOL)
        np.testing.assert_allclose(h_last.numpy(), np.asarray(want[1]),
                                   **TOL)
    yr, hr = pssm.ssd_reference(*targs, h0=th0)
    want = _J_REF(*jargs, jh0)
    np.testing.assert_allclose(yr.numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(hr.numpy(), np.asarray(want[1]), **TOL)


def test_ssd_chunked_state_threads_across_calls():
    """Splitting a sequence across two calls with the state carried
    through h0 equals one pass over it, and JAX's split run."""
    xdt, da, b_mat, c_mat, _ = _ssd_inputs(11, s=24)
    t = [torch.from_numpy(a) for a in (xdt, da, b_mat, c_mat)]
    y_full, h_full = pssm.ssd_chunked(*t, 8)
    y_a, h_a = pssm.ssd_chunked(*(a[:, :16] for a in t), 8)
    y_b, h_b = pssm.ssd_chunked(*(a[:, 16:] for a in t), 8, h0=h_a)
    np.testing.assert_allclose(torch.cat([y_a, y_b], 1).numpy(),
                               y_full.numpy(), **TOL)
    np.testing.assert_allclose(h_b.numpy(), h_full.numpy(), **TOL)
    j = [jnp.asarray(a) for a in (xdt, da, b_mat, c_mat)]
    _, jh_a = _J_SSD(*(a[:, :16] for a in j), 8, None)
    jy_b, jh_b = _J_SSD(*(a[:, 16:] for a in j), 8, jh_a)
    np.testing.assert_allclose(y_b.numpy(), np.asarray(jy_b), **TOL)
    np.testing.assert_allclose(h_b.numpy(), np.asarray(jh_b), **TOL)


def test_softplus_is_jax_softplus():
    x = np.concatenate([np.linspace(-40, 40, 4001),
                        [0.0, 20.0, 20.5, 1e-8, -1e-8]]).astype(np.float32)
    np.testing.assert_allclose(pssm.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(x)), rtol=2e-7,
                               atol=0)


# -------------------------------------------------------------- mixer ----
D_MODEL, D_STATE, CHUNK = 128, 32, 32


def test_dt_bias_is_the_reference_bitwise():
    """``dt`` comes from ``np.random.default_rng(0)`` in both packages,
    whatever the key or generator."""
    want = jssm.mamba2_init(jax.random.PRNGKey(3), D_MODEL, D_STATE,
                            JQuantConfig(mode="qat"))
    gen = torch.Generator().manual_seed(7)
    got = pssm.mamba2_init(D_MODEL, D_STATE, PQuantConfig(mode="qat"),
                           generator=gen, device="cpu")
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["dt_bias"].numpy(),
                                  np.asarray(want["dt_bias"]))
    for name in ("A_log", "D", "conv_b", "norm_g"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
    assert got["conv_w"].shape == want["conv_w"].shape == (4, 320)


def _mixer(mode):
    """(JAX params, port Mamba2, JAX qcfg, port qcfg) of one reduced-width
    mixer in ``mode``; the serve leaves are the port's packing of the QAT
    ones, handed to JAX as numpy."""
    jq = JQuantConfig(mode="qat" if mode == "serve" else mode,
                      act_scale_mode="per_token", backend="xla_ref")
    params = jax.device_get(jssm.mamba2_init(jax.random.PRNGKey(5), D_MODEL,
                                             D_STATE, jq))
    params["conv_b"] = np.random.default_rng(6).standard_normal(
        params["conv_b"].shape).astype(np.float32) * 0.1
    tree = _torch_tree(params)
    pq = PQuantConfig(mode=mode, act_scale_mode="per_token")
    if mode == "serve":
        tree = ptransforms.convert_tree(tree, pq)
        params = _numpy_tree(tree)
    return (params, pssm.Mamba2(tree),
            dataclasses.replace(jq, mode=mode), pq)


def _cache(seed, b):
    rng = np.random.default_rng(seed)
    return {"h": rng.standard_normal((b, 4, 64, D_STATE)).astype(
                np.float32) * 0.5,
            "conv": rng.standard_normal((b, 3, 320)).astype(np.float32)}


@pytest.mark.parametrize("mode", ["fp", "qat", "serve"])
def test_mamba2_apply_matches_jax(mode):
    """The full-sequence forward (40 steps: two chunks of 32, the second
    padded) at FP, QAT and SERVE."""
    params, mixer, jq, pq = _mixer(mode)
    x = np.random.default_rng(1).standard_normal((2, 40, D_MODEL)).astype(
        np.float32)
    want = _compile_as_written(lambda p, v: jssm.mamba2_apply(
        p, v, jq, d_state=D_STATE, chunk=CHUNK), params, x)(params, x)
    got = pssm.mamba2_apply(mixer, torch.from_numpy(x), pq, d_state=D_STATE,
                            chunk=CHUNK)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", ["fp", "qat", "serve"])
def test_mamba2_decode_matches_jax(mode):
    """One-token decode from a random state: output and the new ``h`` and
    conv window."""
    params, mixer, jq, pq = _mixer(mode)
    x = np.random.default_rng(2).standard_normal((3, 1, D_MODEL)).astype(
        np.float32)
    cache = _cache(3, 3)
    want, wcache = _compile_as_written(lambda p, v, c: jssm.mamba2_decode(
        p, v, c, jq, d_state=D_STATE), params, x, cache)(params, x, cache)
    pcache = _torch_tree(cache)
    got = pssm.mamba2_decode(mixer, torch.from_numpy(x), pcache, pq,
                             d_state=D_STATE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in ("h", "conv"):
        np.testing.assert_allclose(pcache[name].numpy(),
                                   np.asarray(wcache[name]), **TOL)


@pytest.mark.parametrize("mode", ["fp", "qat", "serve"])
def test_mamba2_prefill_matches_jax(mode):
    """A 6-lane chunked step from a random state: row 0 all lanes, row 1
    three lanes and padding (neutral: its state equals a 3-lane step's),
    row 2 none (its cache kept bitwise). Valid outputs and the new state
    against JAX's."""
    params, mixer, jq, pq = _mixer(mode)
    x = np.random.default_rng(4).standard_normal((3, 6, D_MODEL)).astype(
        np.float32)
    pos = np.full((3, 6), -1, np.int32)
    pos[0] = 10 + np.arange(6)
    pos[1, :3] = 7 + np.arange(3)
    cache = _cache(5, 3)
    want, wcache = _compile_as_written(lambda p, v, c, q: jssm.mamba2_prefill(
        p, v, c, q, jq, d_state=D_STATE, chunk=CHUNK), params, x, cache,
        pos)(params, x, cache, pos)
    pcache = _torch_tree(cache)
    got = pssm.mamba2_prefill(mixer, torch.from_numpy(x), pcache,
                              torch.from_numpy(pos).long(), pq,
                              d_state=D_STATE, chunk=CHUNK)
    live = pos >= 0
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               **TOL)
    for name in ("h", "conv"):
        np.testing.assert_allclose(pcache[name].numpy(),
                                   np.asarray(wcache[name]), **TOL)
        np.testing.assert_array_equal(pcache[name].numpy()[2], cache[name][2])
    # Padding lanes are state-neutral: row 1 alone over its 3 lanes.
    alone = _torch_tree({k: v[1:2] for k, v in cache.items()})
    pssm.mamba2_prefill(mixer, torch.from_numpy(x[1:2, :3]), alone,
                        torch.from_numpy(pos[1:2, :3]).long(), pq,
                        d_state=D_STATE, chunk=CHUNK)
    for name in ("h", "conv"):
        np.testing.assert_allclose(pcache[name].numpy()[1],
                                   alone[name].numpy()[0], **TOL)


# ----------------------------------------------------------------- LM ----
@pytest.fixture(scope="module")
def bridged():
    """(JAX qat cfg, port qat cfg, port serve cfg, port serve model, the
    packed tree in the JAX layout, the JAX QAT params): the reference's
    ssm setup, packed by the port."""
    jcfg, pcfg = jget_config(ARCH).reduced(), pget_config(ARCH).reduced()
    pscfg = dataclasses.replace(pcfg, quant=dataclasses.replace(
        pcfg.quant, mode="serve", act_scale_mode="per_token"))
    qat = jax.device_get(jlm.init_params(jax.random.PRNGKey(0), jcfg))
    model = interop.params_from_numpy(qat, pcfg, "cpu")
    tree = ptransforms.convert_tree(model.tree(), pscfg.quant, rebudget=True)
    served = plm.LM(pscfg, tree)
    return jcfg, pcfg, pscfg, served, interop.tree_to_numpy(served), qat


def _jscfg(jcfg):
    return dataclasses.replace(jcfg, quant=dataclasses.replace(
        jcfg.quant, mode="serve", act_scale_mode="per_token",
        backend="xla_ref"))


def _plan(vocab):
    """Prefill chunks of 9, 4 and 0 prompt tokens at batch 3 (width 4:
    padding lanes, a slot with none), then three decode steps."""
    rng = np.random.default_rng(2)
    b, c, lens = 3, 4, (9, 4, 0)
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in lens]
    plan, fed = [], np.zeros(b, np.int32)
    while (fed < np.asarray(lens)).any():
        tokens = np.zeros((b, c), np.int32)
        pos = np.full((b, c), -1, np.int32)
        last = np.zeros(b, np.int32)
        for i in range(b):
            n = int(min(c, lens[i] - fed[i]))
            if n > 0:
                tokens[i, :n] = prompts[i][fed[i]:fed[i] + n]
                pos[i, :n] = fed[i] + np.arange(n)
                last[i] = n - 1
                fed[i] += n
        plan.append(("prefill", (tokens, pos, last)))
    for t in range(3):
        plan.append(("decode", (rng.integers(0, vocab, b).astype(np.int32),
                                fed + t)))
    return plan, fed + 3


def _assert_cache_close(pcache, jcache, tol):
    for layer, (h, conv) in enumerate(zip(jcache["groups"][0]["ssm"]["h"],
                                          jcache["groups"][0]["ssm"]["conv"])):
        got = pcache["layers"][layer]["ssm"]
        np.testing.assert_allclose(got["h"].numpy(), np.asarray(h), **tol)
        np.testing.assert_allclose(got["conv"].numpy(), np.asarray(conv),
                                   **tol)


def test_lm_steps_match_jax(bridged):
    """fp32, batch 3: chunked prefill (padding lanes, a slot with no
    lane), three decode steps, then a verify step of 4 lanes (a padding
    lane in row 1): the logits of every live lane at 1e-4, and the
    recurrent state (``h``, ``conv``) of every layer after every step.
    Then the JAX cache, carried over by ``interop.cache_from_numpy``,
    takes a decode step in the port as in JAX."""
    jcfg, _pcfg, pscfg, model, served, _qat = bridged
    jscfg = _jscfg(jcfg)
    plan, fed = _plan(pscfg.vocab_size)
    b = 3
    jcache = jlm.init_cache(jscfg, b, 32, jnp.float32)
    pcache = plm.init_cache(pscfg, b, 32, torch.float32, device="cpu")
    steps = {"prefill": lambda p, cc, *a: jlm.prefill_step(p, jscfg, cc, *a),
             "decode": lambda p, cc, *a: jlm.decode_step(p, jscfg, cc, *a),
             "verify": lambda p, cc, *a: jlm.verify_step(p, jscfg, cc, *a)}
    rng = np.random.default_rng(5)
    vpos = fed[:, None] + np.arange(4)[None].astype(np.int32)
    vpos[1, 3] = -1
    plan.append(("verify", (rng.integers(0, pscfg.vocab_size, (b, 4)).astype(
        np.int32), vpos.astype(np.int32))))
    compiled = {}
    for kind, args in plan:
        if kind not in compiled:
            compiled[kind] = _compile_as_written(steps[kind], served, jcache,
                                                 *args)
        want, jcache = compiled[kind](served, jcache, *args)
        step = {"prefill": plm.prefill_step, "decode": plm.decode_step,
                "verify": plm.verify_step}[kind]
        got, pcache = step(model, pscfg, pcache, *args)
        assert np.isfinite(got.numpy()).all()
        live = args[1] >= 0 if kind == "verify" else slice(None)
        np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                                   **LOGIT_TOL)
        _assert_cache_close(pcache, jcache, LOGIT_TOL)
    host = jax.device_get(jcache)
    carried = interop.cache_from_numpy(host, pscfg, "cpu")
    assert len(carried["layers"]) == pscfg.num_layers
    for layer, lc in enumerate(carried["layers"]):
        assert set(lc) == {"ssm"}
        for name in ("h", "conv"):
            assert lc["ssm"][name].dtype == torch.float32
            np.testing.assert_array_equal(
                lc["ssm"][name].numpy(), host["groups"][0]["ssm"][name][layer])
    tok = rng.integers(0, pscfg.vocab_size, b).astype(np.int32)
    npos = (fed + 4).astype(np.int32)
    want, jnext = compiled["decode"](served, jcache, tok, npos)
    got, carried = plm.decode_step(model, pscfg, carried, tok, npos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    _assert_cache_close(carried, jnext, LOGIT_TOL)


def _jax_logits(params, cfg, tokens):
    return _compile_as_written(
        lambda p, t: jlm.logits(p, cfg, jlm.forward(p, cfg, tokens=t)[0]),
        params, tokens)(params, tokens)


def test_lm_forward_matches_jax(bridged):
    """The full-sequence forward of the QAT model (40 tokens: two chunks
    of 32, the second padded) and its logits at 1e-4."""
    jcfg, pcfg, *_rest, qat = bridged
    jq = dataclasses.replace(jcfg, quant=dataclasses.replace(
        jcfg.quant, backend="xla_ref"))
    tokens = np.random.default_rng(8).integers(
        0, pcfg.vocab_size, (2, 40)).astype(np.int32)
    model = interop.params_from_numpy(qat, pcfg, "cpu")
    with torch.no_grad():
        hidden, aux = plm.forward(model, pcfg, tokens)
        got = plm.logits(model, pcfg, hidden)
    assert aux is None
    np.testing.assert_allclose(got.numpy(), np.asarray(_jax_logits(
        qat, jq, tokens)), **LOGIT_TOL)


def test_params_cross_both_ways(bridged):
    """The weight bridge is generic: the QAT tree (``ln_mixer``, the
    mixer's fp leaves, the ``SmolLinear`` leaves inside it) and the
    packed tree come back from the port bitwise, stacked as the
    reference stacks them."""
    _jcfg, pcfg, pscfg, model, served, qat = bridged
    back = interop.tree_to_numpy(interop.params_from_numpy(qat, pcfg, "cpu"))
    flat_q, flat_b = interop.flatten_tree(qat), interop.flatten_tree(back)
    assert set(flat_q) == set(flat_b)
    assert "groups/0/mamba/in_proj/pbits" in flat_b
    assert "groups/0/ln_mixer/g" in flat_b
    for key, want in flat_q.items():
        np.testing.assert_array_equal(flat_b[key], np.asarray(want))
    again = interop.tree_to_numpy(interop.params_from_numpy(served, pscfg,
                                                            "cpu"))
    for key, want in interop.flatten_tree(served).items():
        np.testing.assert_array_equal(interop.flatten_tree(again)[key], want)


def test_to_serve_packs_the_mixer_linears(monkeypatch):
    """``soniq.to_serve`` on an SSM LM: one B7 call a mixer linear (in_proj
    and out_proj), the fp leaves (``conv_w`` ... ``norm_g``) left as they
    are, the packing bitwise the engine's; the served logits match the
    reference's forward on the same packed tree at 1e-4."""
    from repro_torch import soniq
    from repro_torch.kernels import quant_pack as pqp
    cfg = pget_config(ARCH).reduced()
    state = soniq.init(cfg, seed=3, device="cpu")
    fp = [{name: getattr(b.mamba, name) for name in pssm.FP_LEAVES}
          for b in state.model.blocks]
    values = [{k: v.clone() for k, v in d.items()} for d in fp]
    calls = []
    real = pqp.quantize_pack_segments
    monkeypatch.setattr(pqp, "quantize_pack_segments",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    served = soniq.to_serve(state)
    assert len(calls) == 2 * cfg.num_layers
    eng = pengine.DecodeEngine(soniq.init(cfg, seed=3, device="cpu").model,
                               cfg, pengine.EngineConfig(), device="cpu")
    for b, e, d, v in zip(served.model.blocks, eng.model.blocks, fp, values):
        for name in ("in_proj", "out_proj"):
            leaf, want = getattr(b.mamba, name).leaf(), \
                getattr(e.mamba, name).leaf()
            assert {"w4", "w2", "w1", "perm", "pbits_sorted",
                    "wscale"} <= set(leaf) and "w" not in leaf
            for k in want:
                assert torch.equal(leaf[k], want[k])
        for name in pssm.FP_LEAVES:
            assert getattr(b.mamba, name) is d[name]
            assert torch.equal(d[name], v[name])
    tokens = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    got = soniq.apply(served, tokens)
    jcfg = jget_config(ARCH).reduced()
    jscfg = dataclasses.replace(jcfg, quant=dataclasses.replace(
        jcfg.quant, mode="serve", backend="xla_ref"))
    want = _jax_logits(interop.tree_to_numpy(served.model), jscfg, tokens)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_seq_state_snapshot_restore_and_reset(bridged):
    """``extract_seq_state`` copies the ``h``/``conv`` leaves (None
    elsewhere, the reference's layout of the tree); ``restore_seq_state``
    writes them back in place and the snapshot serves a second restore;
    ``reset_cache_slots`` zeroes the listed rows' state only, as the
    reference's."""
    _jcfg, _pcfg, pscfg, model, _served, _qat = bridged
    cache = plm.init_cache(pscfg, 3, 32, torch.float32, device="cpu")
    tokens = np.arange(12, dtype=np.int32).reshape(3, 4) + 5
    pos = np.tile(np.arange(4), (3, 1))
    plm.prefill_step(model, pscfg, cache, tokens, pos, np.full(3, 3))
    before = _numpy_tree({"s": [lay["ssm"] for lay in cache["layers"]]})
    snap = plm.extract_seq_state(cache)
    assert len(snap["layers"]) == pscfg.num_layers
    assert set(snap["layers"][0]) == {"ssm"}
    assert snap["layers"][0]["ssm"]["h"] is not cache["layers"][0]["ssm"]["h"]
    for _ in range(2):
        plm.decode_step(model, pscfg, cache, tokens[:, 0], np.full(3, 4))
        moved = cache["layers"][0]["ssm"]["h"].numpy()
        assert not np.array_equal(moved, before["s"][0]["h"])
        assert plm.restore_seq_state(cache, snap) is cache
        for lay, want in zip(cache["layers"], before["s"]):
            for name in ("h", "conv"):
                np.testing.assert_array_equal(lay["ssm"][name].numpy(),
                                              want[name])
    jcache = {"groups": [{"ssm": {
        name: jnp.stack([jnp.asarray(w[name]) for w in before["s"]])
        for name in ("h", "conv")}}]}
    jsnap = jlm.extract_seq_state(jcache)
    assert set(jsnap["groups"][0]) == {"ssm"}
    plm.reset_cache_slots(cache, [0, 2])
    jreset = jlm.reset_cache_slots(jcache, jnp.asarray([0, 2]))
    for layer, lay in enumerate(cache["layers"]):
        for name in ("h", "conv"):
            got = lay["ssm"][name].numpy()
            np.testing.assert_array_equal(
                got, np.asarray(jreset["groups"][0]["ssm"][name][layer]))
            assert not got[[0, 2]].any()
            np.testing.assert_array_equal(got[1], before["s"][layer][name][1])


def test_packed_model_bytes_equal_the_reference(bridged):
    """Every SSM leaf is classified as the reference classifies it (fp
    leaves counted, ``s`` metadata) and the served model's bytes equal
    the reference's on the same tree; a QAT tree counts too."""
    _jcfg, _pcfg, _pscfg, model, served, qat = bridged
    got = pengine.packed_model_bytes(model)
    assert got == jengine.packed_model_bytes(served) > 0
    assert pengine.packed_model_bytes(interop.params_from_numpy(
        qat, _pcfg, "cpu")) == jengine.packed_model_bytes(qat)
    noise = {"w": torch.zeros(32, 8), "s": torch.zeros(2)}
    assert pengine.packed_model_bytes({"lin": noise}) == 32 * 8 * 4


# ------------------------------------------------------------ engines ----
_JAX_TOKENS = {}


def _requests(cls):
    rng = np.random.default_rng(1)
    return [cls(prompt=rng.integers(1, 100, (n,)), max_new_tokens=m, seed=i)
            for i, (n, m) in enumerate(zip((3, 9, 5), (5, 4, 4)))]


def _tokens_of(eng, reqs):
    got = {c.request_id: c.tokens for c in eng.serve(reqs)}
    return {k - min(got): v for k, v in got.items()}


def _jax_run(bridged, **kw):
    """The JAX ``DecodeEngine`` on the reference's setup, serving the
    port's packing of its QAT params: (tokens, spec_stats)."""
    key = tuple(sorted(kw.items()))
    if key not in _JAX_TOKENS:
        jcfg, *_rest, served, _qat = bridged
        eng = jengine.DecodeEngine(served, jcfg, jengine.EngineConfig(
            backend="xla_ref", **dict(ENGINE, **kw)), already_serve=True)
        _JAX_TOKENS[key] = (_tokens_of(eng, _requests(JRequest)),
                            eng.spec_stats())
    return _JAX_TOKENS[key]


def _port_engine(bridged, cls=pengine.DecodeEngine, **kw):
    _jcfg, pcfg, _pscfg, model, _served, _qat = bridged
    return cls(model, pcfg, pengine.EngineConfig(**dict(ENGINE, **kw)),
               already_serve=True, device="cpu")


ENGINE_FORMS = {
    "chunk4": {}, "chunk1": dict(prefill_chunk=1),
    "two_pass": dict(fuse_act_quant=False),
    "kv4_ring": dict(kv_bits=4),
    "kv4_paged": dict(kv_bits=4, kv_layout="paged", page_size=16),
    "fp_paged": dict(kv_layout="paged", page_size=16),
}


@pytest.mark.parametrize("form", sorted(ENGINE_FORMS))
def test_decode_engine_tokens_equal_jax(bridged, form):
    """The port's greedy tokens equal the JAX ``DecodeEngine``'s
    (chunk 4) at prefill chunk 4 and 1, in the two-pass activation form,
    and with the KV options, which an SSM-only stack ignores (the
    reference serves them with the same tokens: its state stays fp)."""
    want, _ = _jax_run(bridged)
    eng = _port_engine(bridged, **ENGINE_FORMS[form])
    got = _tokens_of(eng, _requests(PRequest))
    assert set(got) == set(want) == {0, 1, 2}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert set(eng.cache["layers"][0]) == {"ssm"}
    if eng.pool is not None:
        eng.pool.check()


def test_spec_engine_tokens_and_stats_equal_jax(bridged):
    """Speculative decoding (k = 2, the snapshot/recommit round): greedy
    tokens equal spec-off and the JAX speculative engine's, with its
    rounds and drafts."""
    want, _ = _jax_run(bridged)
    jtok, jst = _jax_run(bridged, spec_tokens=2)
    eng = _port_engine(bridged, spec_tokens=2)
    got = _tokens_of(eng, _requests(PRequest))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], jtok[k])
    st = eng.spec_stats()
    assert st["rounds"] > 0 and st["drafted"] == 2 * st["rounds"]
    assert (st["rounds"], st["drafted"]) == (jst["rounds"], jst["drafted"])


def test_spec_round_restores_bystanders_and_recommits(bridged):
    """One round at k = 2 beside a slot still in prefill: the drafts
    advance every row's state, yet after the round the prefill slot's
    state is that of a plain chunked step over its lanes and the drafting
    slot's that of feeding exactly its committed tokens (bitwise)."""
    _jcfg, _pcfg, _pscfg, model, _served, _qat = bridged
    eng = _port_engine(bridged, max_batch=2, spec_tokens=2)
    short = eng.submit(PRequest(prompt=np.asarray([5, 6], np.int32),
                                max_new_tokens=6, seed=0))
    eng.submit(PRequest(prompt=np.arange(20, 30, dtype=np.int32),
                        max_new_tokens=2, seed=1))
    eng.step()             # both prefill; the short prompt completes
    slot = {st.request.request_id == short: s
            for s, st in eng.sched.slots.items()}
    s0, s1 = slot[True], slot[False]
    fed0, gen0 = eng.sched.slots[s0].n_fed, list(eng.sched.slots[s0].generated)
    fed1 = eng.sched.slots[s1].n_fed
    assert (fed0, len(gen0), fed1) == (2, 1, 3)
    before = plm.extract_seq_state(eng.cache)
    eng.step()             # the round: s0 drafts, s1 feeds 3 prompt lanes
    assert eng.spec_rounds == 1
    committed = eng.sched.slots[s0].generated[len(gen0):]
    feed0 = [gen0[-1]] + committed[:-1]
    assert eng.sched.slots[s0].n_fed == fed0 + len(feed0)
    ref = plm.extract_seq_state(eng.cache)
    plm.restore_seq_state(ref, before)
    tokens = np.zeros((2, 3), np.int32)
    pos = np.full((2, 3), -1, np.int64)
    tokens[s0, :len(feed0)] = feed0
    pos[s0, :len(feed0)] = fed0 + np.arange(len(feed0))
    tokens[s1] = np.arange(20, 30)[fed1:fed1 + 3]
    pos[s1] = fed1 + np.arange(3)
    plm.verify_step(model, eng.cfg, ref, tokens, pos)
    for a, b in zip(eng.cache["layers"], ref["layers"]):
        for name in ("h", "conv"):
            assert torch.equal(a["ssm"][name], b["ssm"][name])


def test_lockstep_equals_jax_and_continuous(bridged):
    """The lockstep engine (token-level prefill through the decode rule)
    gives the reference's lockstep tokens and its continuous engine's on
    a same-length batch."""
    jcfg, *_rest, served, _qat = bridged
    prompts = np.random.default_rng(3).integers(1, 100, (3, 5)).astype(
        np.int32)
    lock = _port_engine(bridged, cls=pengine.LockstepEngine)
    got = lock.generate(prompts, 4)
    jlock = jengine.LockstepEngine(served, jcfg, jengine.EngineConfig(
        backend="xla_ref", **ENGINE), already_serve=True)
    np.testing.assert_array_equal(got, np.asarray(jlock.generate(prompts,
                                                                 4)))
    np.testing.assert_array_equal(_port_engine(bridged).generate(prompts, 4),
                                  got)


# ------------------------------------------------------------ entries ----
RUN = (
    "import runpy, sys\n"
    "sys.argv = {argv!r}\n"
    "runpy.run_module('repro_torch.launch.serve', run_name='__main__')\n"
    "bad = sorted(m for m in sys.modules if m == 'jax' or "
    "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
    "assert not bad, bad\n"
    "print('no jax loaded')\n")


def test_serve_launcher_serves_the_ssm_without_jax():
    argv = ["serve", "--arch", ARCH, "--reduced", "--device", "cpu",
            "--requests", "3", "--prompt-len", "6", "--new-tokens", "4",
            "--cache-len", "32"]
    out = subprocess.run([sys.executable, "-c", RUN.format(argv=argv)],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                                        "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stdout + out.stderr[-4000:]
    assert out.stdout.rstrip().endswith("no jax loaded")
    assert "ssm state: h fp32" in out.stdout and "kv cache" not in out.stdout
    assert len(re.findall(r"req \d \[length", out.stdout)) == 3
    # 4 layers of h [4, 4, 64, 32] fp32 and conv [4, 3, 320] fp32.
    want = 4 * (4 * 4 * 64 * 32 * 4 + 4 * 3 * 320 * 4)
    assert f"[ssm-state] {want:,} bytes" in out.stdout

