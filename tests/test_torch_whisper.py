"""Port parity for the encoder-decoder family (whisper-medium, reduced: 4
decoder and 2 encoder layers, d_model 128, 4 heads of 32 over 2 KV heads,
frontend_dim 16): the config, LayerNorm, the sinusoids, the encoder, the
cross K/V, the full-sequence forward with frames, the decode steps, the
weight and cache bridges and the engines, against the JAX package
(``xla_ref``) on numpy inputs from a seed.

The setup is tests/test_serve_families.py's encdec one
(``lm.init_params(PRNGKey(0))``, ``enc_out`` [3, 12, D] from
``default_rng(0)``, prompts of 3/9/5 tokens, 5/4/4 new, max_batch 3,
cache_len 32, prefill chunk 4), and a second ``enc_out`` made by
``encode`` of mel frames. Both packages serve the port's packing of the
QAT params (the JAX engines with ``already_serve``); the JAX engines and
their tokens are made once per module and shared by the tests, as the
reference's steps are compiled as tests/test_torch_serve.py compiles them
(the activation scale's division kept true)."""
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
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro.serve import kv_quant as jkv_quant
from repro.serve.scheduler import Request as JRequest

from repro_torch import interop
from repro_torch import soniq
from repro_torch.api import transforms as ptransforms
from repro_torch.configs import get_config as pget_config
from repro_torch.models import common as pcommon
from repro_torch.models import lm as plm
from repro_torch.serve import engine as pengine
from repro_torch.serve import kv_quant as pkv_quant
from repro_torch.serve.scheduler import Request as PRequest

from test_torch_train import _one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
ARCH = "whisper-medium"
TOL = dict(rtol=1e-4, atol=1e-4)
ENGINE = dict(max_batch=3, cache_len=32, prefill_chunk=4)


def _compile_as_written(fn, *args):
    """``fn`` jitted with the activation scale's division by the grid top
    kept a true division and no excess precision (tests/test_torch_serve.py
    compiles the reference's steps so)."""
    top = jquant._static_grid_max
    with mock.patch.object(jquant, "_static_grid_max", lambda p:
                           jax.lax.optimization_barrier(jnp.float32(top(p)))):
        return jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})


def _serve_cfg(cfg, **quant):
    return dataclasses.replace(cfg, quant=dataclasses.replace(
        cfg.quant, mode="serve", act_scale_mode="per_token", **quant))


def _requests(cls):
    rng = np.random.default_rng(1)
    return [cls(prompt=rng.integers(1, 100, (n,)), max_new_tokens=m, seed=i)
            for i, (n, m) in enumerate(zip((3, 9, 5), (5, 4, 4)))]


def _tokens_of(eng, reqs, enc_out):
    """Greedy tokens {request index: tokens} of ``reqs`` served after
    ``load_cross(enc_out)`` from an empty engine (``reset``: slot i then
    takes request i, and the cross K/V of batch row i)."""
    eng.reset()
    eng.load_cross(enc_out)
    got = {c.request_id: c.tokens for c in eng.serve(reqs)}
    return {k - min(got): v for k, v in got.items()}


# --------------------------------------------------------------- setup ----
@pytest.fixture(scope="module")
def bridged():
    """(JAX qat cfg, port qat cfg, the JAX QAT params, the port's packed
    model, that packing in the JAX layout, the mel frames)."""
    jcfg, pcfg = jget_config(ARCH).reduced(), pget_config(ARCH).reduced()
    qat = jax.device_get(jlm.init_params(jax.random.PRNGKey(0), jcfg))
    model = interop.params_from_numpy(qat, pcfg, "cpu")
    pscfg = _serve_cfg(pcfg)
    served = plm.LM(pscfg, ptransforms.convert_tree(
        model.tree(), pscfg.quant, rebudget=True))
    frames = np.random.default_rng(2).standard_normal(
        (3, 12, pcfg.frontend_dim)).astype(np.float32)
    return jcfg, pcfg, qat, served, interop.tree_to_numpy(served), frames


@pytest.fixture(scope="module")
def jax_runs(bridged):
    """The JAX engines' tokens: {(setup, form): tokens} for the fp ring
    and the 4-bit ring on both ``enc_out`` setups ("random", "encoded"),
    and speculative k = 2 on "random" with its ``spec_stats``; the
    encoded ``enc_out`` and the fp and 4-bit engines (their caches hold
    the last setup's cross K/V)."""
    jcfg, _pcfg, _qat, _served, tree, frames = bridged
    enc = {"random": np.random.default_rng(0).normal(
        0, 1, (3, 12, jcfg.d_model)).astype(np.float32)}
    out, engines = {}, {}
    for form, kw in (("fp", {}), ("kv4", dict(kv_bits=4))):
        eng = jengine.DecodeEngine(tree, jcfg, jengine.EngineConfig(
            backend="xla_ref", **ENGINE, **kw), already_serve=True)
        if "encoded" not in enc:
            enc["encoded"] = np.asarray(_compile_as_written(
                lambda p, f: jlm.encode(p, eng.cfg, f), eng.params,
                frames)(eng.params, frames))
        for setup in ("random", "encoded"):
            out[setup, form] = _tokens_of(eng, _requests(JRequest),
                                          enc[setup])
        engines[form] = eng
    spec = jengine.DecodeEngine(tree, jcfg, jengine.EngineConfig(
        backend="xla_ref", spec_tokens=2, **ENGINE), already_serve=True)
    out["random", "spec"] = _tokens_of(spec, _requests(JRequest),
                                       enc["random"])
    return out, spec.spec_stats(), enc, engines


# -------------------------------------------------------------- config ----
def test_config_equals_the_reference():
    want, got = jget_config(ARCH), pget_config(ARCH)
    for a, b in ((want, got), (want.reduced(), got.reduced())):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        da.pop("quant")
        db.pop("quant")
        assert da == db
    assert got.layer_plan() == want.layer_plan() == (("dec", 24),)
    assert (got.encoder_layers, got.frontend_dim, got.hd) == (24, 80, 64)
    caps = plm.serve_capabilities(got)
    assert (caps.state, caps.chunkable, caps.spec_capable) == \
        ("kv", True, True)
    assert plm.has_attention(got)


# ------------------------------------------------- norms and sinusoids ----
def test_layer_norm_matches_jax():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((5, 7, 128)) * 3 + 1.5).astype(np.float32)
    g = rng.standard_normal(128).astype(np.float32)
    b = rng.standard_normal(128).astype(np.float32)
    want = jax.jit(lambda v: jcommon.layer_norm({"g": g, "b": b}, v))(x)
    got = pcommon.layer_norm(torch.from_numpy(g), torch.from_numpy(b),
                             torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    leaf = pcommon.layer_norm_init(128)
    assert isinstance(pcommon.norm_module(leaf), pcommon.LayerNorm)
    for name, want in jcommon.layer_norm_init(128).items():
        np.testing.assert_array_equal(leaf[name].numpy(), np.asarray(want))


@pytest.mark.parametrize("d,n", [(128, 64), (1024, 1500)])
def test_sinusoids_match_jax(d, n):
    """The encoder's table bitwise; the decoder's denominators and angles
    bitwise (XLA multiplies by the constant's fp32 reciprocal), its values
    within one rounding (the reference's fp32 sin and cos are not
    reproducible: ``tools/sinusoid_vs_jax.py``)."""
    np.testing.assert_array_equal(pcommon.sinusoid_positions(n, d).numpy(),
                                  np.asarray(jcommon.sinusoid_positions(n,
                                                                        d)))
    dim = jnp.arange(0, d, 2)
    np.testing.assert_array_equal(
        pcommon.sinusoid_denominators(d),
        np.asarray(jax.jit(lambda: 1e4 ** (dim / d))()))
    pos = np.arange(-1, n, dtype=np.int32).reshape(-1, 1)
    want = np.asarray(jax.jit(lambda p: jlm._sinusoid_at(p, d))(pos))
    got = pcommon.sinusoid_at(torch.from_numpy(pos), d).numpy()
    assert got.shape == want.shape == (n + 1, 1, d)
    np.testing.assert_allclose(got, want, rtol=0, atol=1.2e-7)
    assert np.mean(got != want) < 0.02


# ------------------------------------------------ encoder, cross, forward ----
def test_encode_matches_jax(bridged, jax_runs):
    """``encode`` on the engine's packed parameters against the
    reference's on the JAX engine's."""
    _jcfg, pcfg, _qat, served, _tree, frames = bridged
    got = plm.encode(served, _serve_cfg(pcfg), frames)
    assert got.shape == (3, 12, pcfg.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), jax_runs[2]["encoded"], **TOL)


@pytest.mark.parametrize("kv_bits", [None, 4])
def test_build_cross_cache_matches_jax(bridged, jax_runs, kv_bits):
    """Every decoder layer's cross K/V of the encoded frames: fp within
    1e-4 (pos 0 .. T - 1 bitwise). At 4 bits the codes and scales are the
    port's fp projections quantized (bitwise), the port's quantizer on
    the reference's fp projections gives the reference's codes and
    scales bitwise, and the two packages' codes agree but where the fp
    projections (float64 sums against the reference's fp32) straddle a
    rounding boundary."""
    _jcfg, pcfg, _qat, served, _tree, _frames = bridged
    jeng = jax_runs[3]["fp"]
    enc = jax_runs[2]["encoded"]
    want_fp = jax.device_get(jlm.build_cross_cache(jeng.params, jeng.cfg,
                                                   jnp.asarray(enc)))
    got_fp = plm.build_cross_cache(served, _serve_cfg(pcfg), enc)
    if kv_bits is None:
        assert set(got_fp) == set(want_fp) == {"k", "v", "pos"}
        for name in ("k", "v"):
            assert got_fp[name].shape == (4, 3, 12, 2, 32)
            np.testing.assert_allclose(got_fp[name].numpy(), want_fp[name],
                                       **TOL)
        np.testing.assert_array_equal(got_fp["pos"].numpy(), want_fp["pos"])
        return
    want = jax.device_get(jlm.build_cross_cache(jeng.params, jeng.cfg,
                                                jnp.asarray(enc), kv_bits=4))
    got = plm.build_cross_cache(served, _serve_cfg(pcfg), enc, kv_bits=4)
    assert set(got) == set(want)
    for name in got:
        assert got[name].numpy().dtype == np.asarray(want[name]).dtype
    for a in ("k", "v"):
        for fp, q4 in ((got_fp[a], got),
                       (torch.tensor(np.asarray(want_fp[a])), want)):
            codes, scale = pkv_quant.quantize_kv(fp)
            np.testing.assert_array_equal(
                codes.numpy(), np.asarray(q4[f"{a}_codes"]).view(np.uint8))
            np.testing.assert_array_equal(
                scale.numpy(), np.asarray(q4[f"{a}_scale"]))
        same = got[f"{a}_codes"].numpy() == np.asarray(want[f"{a}_codes"])
        assert same.mean() > 0.99, same.mean()
    np.testing.assert_array_equal(got["pos"].numpy(), want["pos"])


def test_forward_with_frames_matches_jax(bridged):
    """The QAT model's full-sequence forward over tokens [2, 10] and
    frames [2, 12, 16]: logits at 1e-4; without frames it refuses."""
    jcfg, pcfg, qat, _served, _tree, frames = bridged
    jq = dataclasses.replace(jcfg, quant=dataclasses.replace(
        jcfg.quant, backend="xla_ref"))
    tokens = np.random.default_rng(8).integers(
        0, pcfg.vocab_size, (2, 10)).astype(np.int32)
    f = frames[:2]
    want = _compile_as_written(
        lambda p, t, fr: jlm.logits(p, jq, jlm.forward(
            p, jq, tokens=t, frames=fr)[0]), qat, tokens, f)(qat, tokens, f)
    model = interop.params_from_numpy(qat, pcfg, "cpu")
    with torch.no_grad():
        hidden, aux = plm.forward(model, pcfg, tokens, frames=f)
        got = plm.logits(model, pcfg, hidden)
        assert aux is None
        with pytest.raises(ValueError, match="frames"):
            plm.forward(model, pcfg, tokens)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------- LM steps ----
def test_lm_steps_match_jax(bridged, jax_runs):
    """fp32, batch 3, the fp cross K/V of the encoded frames: a chunked
    prefill (padding lanes, a slot with none), two decode steps (one
    slot idle), then a verify step of 3 lanes: the logits of every live
    lane at 1e-4. Then the JAX cache, cross subtree included, carried
    over by ``interop.cache_from_numpy``, takes a decode step in the port
    as in JAX."""
    jcfg, pcfg, _qat, served, tree, _frames = bridged
    jeng = jax_runs[3]["fp"]
    jscfg = jeng.cfg
    pscfg = _serve_cfg(pcfg)
    enc = jax_runs[2]["encoded"]
    jcache = jlm.init_cache(jscfg, 3, 32, jnp.float32, enc_len=12)
    jcache["cross"] = jlm.build_cross_cache(jeng.params, jscfg,
                                            jnp.asarray(enc))
    pcache = plm.init_cache(pscfg, 3, 32, torch.float32, device="cpu",
                            enc_len=12)
    pcache["cross"] = plm.build_cross_cache(served, pscfg, enc)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, pcfg.vocab_size, (3, 4)).astype(np.int32)
    pos = np.full((3, 4), -1, np.int32)
    pos[0] = np.arange(4)
    pos[1, :2] = np.arange(2)
    last = np.array([3, 1, 0], np.int32)
    plan = [("prefill", (tokens, pos, last)),
            ("decode", (tokens[:, 0], np.array([4, 2, 0], np.int32),
                        np.array([True, True, True]))),
            ("decode", (tokens[:, 1], np.array([5, 3, 1], np.int32),
                        np.array([True, False, True])))]
    vpos = np.array([[6, 7, 8], [3, 4, -1], [2, 3, 4]], np.int32)
    plan.append(("verify", (tokens[:, :3], vpos)))
    jsteps = {
        "prefill": lambda p, c, t, q, li: jlm.prefill_step(p, jscfg, c, t,
                                                           q, li),
        "decode": lambda p, c, t, q, a: jlm.decode_step(
            p, jscfg, c, t, q, active=a),
        "verify": lambda p, c, t, q: jlm.verify_step(p, jscfg, c, t, q)}
    psteps = {"prefill": plm.prefill_step, "verify": plm.verify_step,
              "decode": lambda m, cf, c, t, q, a: plm.decode_step(
                  m, cf, c, t, q, active=a)}
    compiled = {}
    for kind, args in plan:
        if kind not in compiled:
            compiled[kind] = _compile_as_written(jsteps[kind], tree, jcache,
                                                 *args)
        want, jcache = compiled[kind](tree, jcache, *args)
        got, pcache = psteps[kind](served, pscfg, pcache, *args)
        live = args[1] >= 0 if kind == "verify" else slice(None)
        if kind == "decode":
            live = args[2]
        np.testing.assert_allclose(got.numpy()[live],
                                   np.asarray(want)[live], **TOL)
    host = jax.device_get(jcache)
    carried = interop.cache_from_numpy(host, pscfg, "cpu")
    assert set(carried) == {"layers", "cross"}
    for name, leaf in host["cross"].items():
        np.testing.assert_array_equal(carried["cross"][name].numpy(), leaf)
    step = (tokens[:, 2], np.array([9, 5, 5], np.int32),
            np.array([True, True, True]))
    want, _ = compiled["decode"](tree, jcache, *step)
    got, _ = plm.decode_step(served, pscfg, carried, *step[:2],
                             active=step[2])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------------ bridges ----
def test_params_cross_both_ways(bridged):
    """The weight bridge carries ``enc_groups``, ``enc_norm``,
    ``frontend``, the LayerNorm ``g``/``b``, the cross attention and every
    bias: the QAT tree and the packed tree come back bitwise, stacked as
    the reference stacks them."""
    _jcfg, pcfg, qat, served, tree, _frames = bridged
    back = interop.tree_to_numpy(interop.params_from_numpy(qat, pcfg, "cpu"))
    flat_q, flat_b = interop.flatten_tree(qat), interop.flatten_tree(back)
    assert set(flat_q) == set(flat_b)
    for key in ("enc_groups/0/attn/wq/b", "enc_norm/b", "frontend/w",
                "groups/0/cross/wk/pbits", "groups/0/ln_cross/b",
                "groups/0/mlp/up/b", "final_norm/b"):
        assert key in flat_b, key
    for key, want in flat_q.items():
        np.testing.assert_array_equal(flat_b[key], np.asarray(want))
    assert flat_b["enc_groups/0/attn/wq/w"].shape[0] == 2
    again = interop.flatten_tree(interop.tree_to_numpy(
        interop.params_from_numpy(tree, _serve_cfg(pcfg), "cpu")))
    for key, want in interop.flatten_tree(tree).items():
        np.testing.assert_array_equal(again[key], want)
    assert "frontend/w" in again and "groups/0/cross/wq/w4" in again


# ------------------------------------------------------------ engines ----
def _port_engine(bridged, **kw):
    _jcfg, pcfg, _qat, served, _tree, _frames = bridged
    return pengine.DecodeEngine(served, pcfg, pengine.EngineConfig(
        **dict(ENGINE, **kw)), already_serve=True, device="cpu")


ENGINE_FORMS = {
    "fp_chunk4": ("fp", {}), "fp_chunk1": ("fp", dict(prefill_chunk=1)),
    "two_pass": ("fp", dict(fuse_act_quant=False)),
    "kv4_ring": ("kv4", dict(kv_bits=4)),
    "kv4_paged": ("kv4", dict(kv_bits=4, kv_layout="paged", page_size=16)),
}


@pytest.mark.parametrize("setup", ["random", "encoded"])
@pytest.mark.parametrize("form", sorted(ENGINE_FORMS))
def test_decode_engine_tokens_equal_jax(bridged, jax_runs, form, setup):
    """After ``load_cross``, the port's greedy tokens equal the JAX
    ``DecodeEngine``'s: the fp ring at chunk 4 and 1 and in the two-pass
    form against the reference's fp ring, the 4-bit ring and page pool
    (self-attention through B5, cross through B4) against its 4-bit
    ring."""
    want_form, kw = ENGINE_FORMS[form]
    want = jax_runs[0][setup, want_form]
    eng = _port_engine(bridged, **kw)
    got = _tokens_of(eng, _requests(PRequest), jax_runs[2][setup])
    assert set(got) == set(want) == {0, 1, 2}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert eng.cache["cross"]["pos"].shape == (4, 3, 12)
    if eng.pool is not None:
        eng.pool.check()


def test_spec_engine_tokens_and_stats_equal_jax(bridged, jax_runs):
    """Speculative decoding (k = 2) over the cross K/V: greedy tokens equal
    spec-off and the JAX speculative engine's, with its rounds and
    drafts."""
    out, jst, enc, _engines = jax_runs
    eng = _port_engine(bridged, spec_tokens=2)
    got = _tokens_of(eng, _requests(PRequest), enc["random"])
    for k in out["random", "fp"]:
        np.testing.assert_array_equal(got[k], out["random", "fp"][k])
        np.testing.assert_array_equal(got[k], out["random", "spec"][k])
    st = eng.spec_stats()
    assert st["rounds"] > 0 and st["drafted"] == 2 * st["rounds"]
    assert (st["rounds"], st["drafted"]) == (jst["rounds"], jst["drafted"])


@pytest.mark.parametrize("kv_bits", [None, 4])
def test_cross_accounting_and_reset_equal_jax(bridged, jax_runs, kv_bits):
    """``cross_payload_bytes`` equals the reference's on the same loaded
    cache, ``cache_payload_bytes`` leaves the cross K/V out (equal to the
    reference's too), and ``reset_cache_slots`` keeps them bitwise."""
    jeng = jax_runs[3]["fp" if kv_bits is None else "kv4"]
    eng = _port_engine(bridged, kv_bits=kv_bits)
    eng.load_cross(jax_runs[2]["encoded"])
    cross = pkv_quant.cross_payload_bytes(eng.cache)
    assert cross == jkv_quant.cross_payload_bytes(jeng.cache) > 0
    assert pkv_quant.cache_payload_bytes(eng.cache) == \
        jkv_quant.cache_payload_bytes(jeng.cache) > 0
    assert pkv_quant.cache_payload_bytes(eng.cache) + cross == \
        pkv_quant.cache_payload_bytes(
            {"layers": eng.cache["layers"], "x": eng.cache["cross"]})
    before = {k: v.clone() for k, v in eng.cache["cross"].items()}
    with torch.inference_mode():
        plm.reset_cache_slots(eng.cache, [0, 1, 2])
    for k, v in before.items():
        assert torch.equal(eng.cache["cross"][k], v)
    for k, v in jax.device_get(jeng.cache["cross"]).items():
        assert before[k].shape == v.shape
        assert before[k].numpy().dtype == v.dtype


def test_unloaded_cache_matches_jax_and_serves(bridged):
    """Before any ``load_cross`` the cache's cross K/V is the reference's
    ``init_cache`` layout (1500 entries, zeros; 4-bit: zero codes and
    scales, pos -1), and a decode step over it is finite (a zero
    attention output, as the reference's)."""
    jcfg, pcfg, *_rest = bridged
    pscfg = _serve_cfg(pcfg)
    for kv_bits in (None, 4):
        want = jax.device_get(jlm.init_cache(_serve_cfg(jcfg), 2, 16,
                                             jnp.float32, kv_bits=kv_bits))
        got = plm.init_cache(pscfg, 2, 16, torch.float32, device="cpu",
                             kv_bits=kv_bits)
        assert set(got["cross"]) == set(want["cross"])
        for name, leaf in want["cross"].items():
            assert got["cross"][name].shape == leaf.shape
            assert leaf.shape[2] == plm.ENC_LEN
            np.testing.assert_array_equal(got["cross"][name].numpy(), leaf)
    lg, _ = plm.decode_step(bridged[3], pscfg, got, np.array([1, 2]),
                            np.array([0, 0]))
    assert torch.isfinite(lg).all()


def test_soniq_apply_with_frames(bridged):
    """``soniq.apply(state, tokens, frames=...)``: at QAT bitwise the
    model's forward with those frames, after ``to_serve`` at SERVE against
    the reference's forward on the same packed tree. The state takes the engine's per-token activation scales: with
    one per-tensor scale the port's serve encoder (float64 sums in the
    plain segment GEMM) sits ~1e-6 from its QAT encoder and flips one
    activation code of ``enc_blocks.1.mlp.down`` on these inputs, which
    moves that layer's output by 0.18 (the reference's serve forward
    lands on the QAT side of that boundary)."""
    jcfg, pcfg, qat, *_rest, frames = bridged
    tokens = np.random.default_rng(9).integers(
        0, pcfg.vocab_size, (2, 6)).astype(np.int32)
    f = frames[:2]
    pcfg = dataclasses.replace(pcfg, quant=dataclasses.replace(
        pcfg.quant, act_scale_mode="per_token"))
    state = soniq.SoniqState(soniq.Phase.QAT, interop.params_from_numpy(
        qat, pcfg, "cpu"), pcfg)
    with torch.no_grad():
        got_qat = soniq.apply(state, tokens, frames=f)
        hidden, _ = plm.forward(state.model, pcfg, tokens, frames=f)
        assert torch.equal(got_qat, plm.logits(state.model, pcfg, hidden))
    served = soniq.to_serve(state)
    got = soniq.apply(served, tokens, frames=f)
    params = interop.tree_to_numpy(served.model)
    cfg = dataclasses.replace(jcfg, quant=dataclasses.replace(
        jcfg.quant, mode="serve", act_scale_mode="per_token",
        backend="xla_ref"))
    want = _compile_as_written(
        lambda p, t, fr: jlm.logits(p, cfg, jlm.forward(
            p, cfg, tokens=t, frames=fr)[0]), params, tokens, f)(
                params, tokens, f)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------------ entries ----
RUN = (
    "import runpy, sys\n"
    "sys.argv = {argv!r}\n"
    "runpy.run_module('repro_torch.launch.serve', run_name='__main__')\n"
    "bad = sorted(m for m in sys.modules if m == 'jax' or "
    "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
    "assert not bad, bad\n"
    "print('no jax loaded')\n")


def test_serve_launcher_serves_whisper_without_jax():
    """``--arch whisper-medium --reduced`` serves as the reference's
    launcher does (no frames: the decoder attends the zero cross K/V of a
    fresh cache)."""
    argv = ["serve", "--arch", ARCH, "--reduced", "--device", "cpu",
            "--requests", "3", "--prompt-len", "6", "--new-tokens", "4",
            "--cache-len", "32", "--kv-bits", "4"]
    out = subprocess.run([sys.executable, "-c", RUN.format(argv=argv)],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                                        "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stdout + out.stderr[-4000:]
    assert out.stdout.rstrip().endswith("no jax loaded")
    assert "kv cache: q4" in out.stdout
    assert len(re.findall(r"req \d \[length", out.stdout)) == 3
