"""Port parity for the hybrid family (jamba-1.5-large-398b, reduced: one
unit of 8 sublayers — Mamba2 mixers, one attention sublayer, MLPs and
4-expert top-2 MoEs — at d_model 128, ssm_chunk 32): the config and its
capabilities, the weight and cache bridges (the reference's
``groups[0]["sub{i}"]`` stacked over units against the port's flat
blocks), the full-sequence forward, the decode and prefill steps with
both kinds of state, the packing, and the engines (greedy tokens, the
speculative snapshot/recommit round over ring and paged K/V), against the
JAX package (``xla_ref``) on the reference's own init.

The reference tree is ``lm.init_params(PRNGKey(0))`` with the leaves that
the config's ``param_dtype="bfloat16"`` stores in bf16 rounded to bf16
(the reduced config keeps fp32): the JAX package serves that fp32 upcast,
and the port serves it once as fp32 and once as the bf16 model it came
from, bitwise alike. The JAX side packs once (``convert_tree``) and runs
three engines (fp ring, fp ring at k = 2, 4-bit ring), shared by the
file; its steps are compiled as tests/test_torch_serve.py compiles
them, its engines' steps traced with the same true division."""
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

from repro.api import transforms as jtransforms
from repro.configs import get_config as jget_config
from repro.core import quant as jquant
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro.serve.scheduler import Request as JRequest

from repro_torch import interop, soniq
from repro_torch.api import transforms as ptransforms
from repro_torch.configs import get_config as pget_config
from repro_torch.models import lm as plm
from repro_torch.serve import engine as pengine
from repro_torch.serve.scheduler import Request as PRequest

from test_torch_train import _one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
ARCH = "jamba-1.5-large-398b"
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
ENGINE = dict(max_batch=3, cache_len=32, prefill_chunk=4)
UNIT = ("mamba_mlp", "mamba_moe", "mamba_mlp", "attn_moe", "mamba_mlp",
        "mamba_moe", "mamba_mlp", "mamba_moe")
MIXERS = [i for i, kind in enumerate(UNIT) if kind.startswith("mamba")]
ATTN = UNIT.index("attn_moe")


def _true_division():
    """The reference traced with the activation scale's division by the
    grid top kept a true division (jitted, XLA would multiply by its
    reciprocal, one ulp off for some maxima; this setup's prefill puts
    one activation of the first mixer's ``in_proj`` on such a knife
    edge)."""
    top = jquant._static_grid_max
    return mock.patch.object(jquant, "_static_grid_max", lambda p:
                             jax.lax.optimization_barrier(
                                 jnp.float32(top(p))))


def _compile_as_written(fn, *args):
    """``fn`` jitted as the program is written: the true division and no
    excess precision."""
    with _true_division():
        return jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})


def _serve_cfg(cfg, **kw):
    return dataclasses.replace(cfg, quant=dataclasses.replace(
        cfg.quant, mode="serve", act_scale_mode="per_token", **kw))


def _bf16_keys(jcfg):
    """The reference's leaves that ``param_dtype="bfloat16"`` stores in
    bf16 (flattened keys), from its init's shapes."""
    shapes = jax.eval_shape(lambda k: jlm.init_params(k, dataclasses.replace(
        jcfg, param_dtype="bfloat16")), jax.random.PRNGKey(0))
    return {k for k, v in interop.flatten_tree(shapes).items()
            if v is not None and v.dtype == jnp.bfloat16}


def _map_keys(tree, keys, fn):
    flat = interop.flatten_tree(tree)
    return interop.unflatten_tree({k: fn(v) if k in keys else v
                                   for k, v in flat.items()})


@pytest.fixture(scope="module")
def setup():
    """The reference's setup: (JAX qat cfg, port qat cfg, port serve cfg,
    the bf16-rounded QAT tree (fp32 leaves), its bf16 keys, the JAX
    package's packing of it, the port's served model)."""
    jcfg, pcfg = jget_config(ARCH).reduced(), pget_config(ARCH).reduced()
    keys = _bf16_keys(jcfg)
    qat = jax.device_get(jlm.init_params(jax.random.PRNGKey(0), jcfg))
    qat = _map_keys(qat, keys, lambda a: np.asarray(
        jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)))
    jserved = jax.device_get(jtransforms.convert_tree(
        qat, dataclasses.replace(jcfg.quant, backend="xla_ref"),
        rebudget=True))
    pscfg = _serve_cfg(pcfg)
    model = interop.params_from_numpy(qat, pcfg, "cpu")
    served = plm.LM(pscfg, ptransforms.convert_tree(
        model.tree(), pscfg.quant, rebudget=True))
    return jcfg, pcfg, pscfg, qat, keys, jserved, served


# ------------------------------------------------------------- config ----
def test_config_equals_the_reference():
    """Field for field, the reduced config too; the unit's sublayer
    kinds, the port's flat block kinds and the serve capabilities."""
    want, got = jget_config(ARCH), pget_config(ARCH)
    for a, b in ((want, got), (want.reduced(), got.reduced())):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        da.pop("quant")
        db.pop("quant")
        assert da == db
        assert b.layer_plan() == a.layer_plan()
        assert b.hybrid_unit_kinds() == a.hybrid_unit_kinds() == UNIT
    assert got.param_dtype == "bfloat16" and got.reduced().num_layers == 8
    assert got.layer_plan() == (("hybrid_unit", 9),)
    assert plm.block_kinds(got) == list(UNIT) * 9
    assert plm.has_attention(got.reduced())
    caps, jcaps = plm.serve_capabilities(got), jlm.serve_capabilities(want)
    assert (caps.family, caps.chunkable, caps.spec_capable, caps.state,
            caps.note) == (jcaps.family, True, True, "hybrid", "")


def test_init_lays_out_the_reference_tree():
    """The port's own init (fp32 and bf16 parameters) has the reference's
    leaves, shapes and dtypes: bf16 linears, banks, table, readout and
    conv; fp32 norms, router and the mixers' A_log, D, dt_bias, norm_g."""
    jcfg, pcfg = jget_config(ARCH).reduced(), pget_config(ARCH).reduced()
    for dt in ("float32", "bfloat16"):
        want = interop.flatten_tree(jax.eval_shape(
            lambda k, c=dataclasses.replace(jcfg, param_dtype=dt):
            jlm.init_params(k, c), jax.random.PRNGKey(0)))
        model = plm.init_params(dataclasses.replace(pcfg, param_dtype=dt),
                                device="cpu")
        got = interop.flatten_tree(interop.tree_to_numpy(model))
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].shape == v.shape, k
            assert got[k].itemsize == v.dtype.itemsize, k
    assert "groups/0/sub3/attn/wq/pbits" in got
    assert "groups/0/sub1/moe/router/w" in got
    assert "groups/0/sub0/mamba/conv_w" in got


# --------------------------------------------------------------- bridge ----
def test_params_cross_both_ways(setup):
    """The QAT tree, the packed tree and a bf16 tree (JAX's bfloat16
    leaves) come back from the port bitwise, stacked as the reference
    stacks them; the port's block u * 8 + i is the reference's sub{i} of
    unit u, and a bf16 leaf keeps its bits and its dtype."""
    _jcfg, pcfg, pscfg, qat, keys, jserved, served = setup
    model = interop.params_from_numpy(qat, pcfg, "cpu")
    assert [b.kind for b in model.blocks] == list(UNIT)
    np.testing.assert_array_equal(
        model.blocks[ATTN].attn.wq.w.numpy(),
        qat["groups"][0][f"sub{ATTN}"]["attn"]["wq"]["w"][0])
    for tree, cfg, port in ((qat, pcfg, model), (jserved, pscfg, None)):
        port = port or interop.params_from_numpy(tree, cfg, "cpu")
        back = interop.flatten_tree(interop.tree_to_numpy(port))
        flat = interop.flatten_tree(tree)
        assert set(back) == set(flat)
        for k, want in flat.items():
            if want is not None:
                np.testing.assert_array_equal(back[k], np.asarray(want))
    tree16 = _map_keys(qat, keys, lambda a: np.asarray(
        jnp.asarray(a, jnp.bfloat16)))
    m16 = interop.params_from_numpy(
        tree16, dataclasses.replace(pcfg, param_dtype="bfloat16"), "cpu")
    assert m16.blocks[1].moe.up.w.dtype == torch.bfloat16
    assert m16.blocks[1].moe.router.w.dtype == torch.float32
    back = interop.flatten_tree(interop.tree_to_numpy(m16))
    for k, want in interop.flatten_tree(tree16).items():
        if k in keys:
            assert back[k].dtype == np.dtype("V2")
            np.testing.assert_array_equal(back[k].view(np.uint16),
                                          want.view(np.uint16))


def test_reference_npz_serves_through_load_npz(setup, tmp_path):
    """The reference's packed tree saved as its checkpoint's npz
    (``params/groups/0/sub3/attn/wq/w4`` ...) loads through ``load_npz``
    unchanged and serves the JAX engine's tokens."""
    jcfg, _pcfg, pscfg, _qat, _keys, jserved, _served = setup
    flat = {f"params/{k}": np.asarray(v)
            for k, v in interop.flatten_tree(jserved).items()
            if v is not None}
    assert "params/groups/0/sub3/attn/wq/w4" in flat
    step = tmp_path / "step_00000000"
    step.mkdir()
    np.savez(step / "shard_0.npz", **flat)
    model = interop.load_npz(str(step), pscfg, "cpu")
    eng = pengine.DecodeEngine(model, pscfg, pengine.EngineConfig(**ENGINE),
                               already_serve=True, device="cpu")
    want, _ = _jax_run(setup)
    got = _tokens_of(eng, _requests(PRequest))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_packed_carriers_equal_the_reference(setup):
    """The port's packing (``convert_tree``, B7's plain version) of the
    QAT tree is bitwise the JAX package's: carriers, channel order,
    sorted precisions, scales, every fp leaf."""
    *_rest, jserved, served = setup
    got = interop.flatten_tree(interop.tree_to_numpy(served))
    want = interop.flatten_tree(jserved)
    assert set(got) == set(want)
    assert "groups/0/sub1/moe/up/w4" in got
    for k, v in want.items():
        if v is not None:
            assert got[k].dtype == np.asarray(v).dtype, k
            np.testing.assert_array_equal(got[k], np.asarray(v))


# -------------------------------------------------------------- forward ----
@pytest.mark.parametrize("mode", ["qat", "serve"])
def test_forward_matches_jax(setup, mode):
    """The full-sequence forward (40 tokens: two SSD chunks of 32, the
    second padded) at QAT (``lm.forward``) and SERVE (``soniq.apply``
    after ``to_serve``): the hidden state and the logits at 1e-4, the MoE
    loss at QAT."""
    jcfg, pcfg, _pscfg, qat, _keys, _jserved, _served = setup
    tokens = np.random.default_rng(8).integers(
        0, pcfg.vocab_size, (2, 40)).astype(np.int32)
    model = interop.params_from_numpy(qat, pcfg, "cpu")
    if mode == "serve":
        state = soniq.to_serve(soniq.SoniqState(
            pcfg.quant.phase, model, _serve_cfg(pcfg).with_quant_mode(
                "qat")))
        model, cfg = state.model, _serve_cfg(pcfg)
        tree = interop.tree_to_numpy(model)
        jc = _serve_cfg(jcfg, backend="xla_ref")
    else:
        cfg, tree = pcfg, qat
        jc = dataclasses.replace(jcfg, quant=dataclasses.replace(
            jcfg.quant, backend="xla_ref"))

    def run(p, t):
        h, aux = jlm.forward(p, jc, tokens=t)
        return h, jlm.logits(p, jc, h), aux

    jh, jlg, jaux = _compile_as_written(run, tree, tokens)(tree, tokens)
    with torch.no_grad():
        h, aux = plm.forward(model, cfg, tokens)
        lg = plm.logits(model, cfg, h)
        if mode == "serve":
            np.testing.assert_array_equal(soniq.apply(state, tokens).numpy(),
                                          lg.numpy())
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **LOGIT_TOL)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **LOGIT_TOL)
    if mode == "qat":
        np.testing.assert_allclose(float(aux), float(jaux), **LOGIT_TOL)


# ---------------------------------------------------------------- steps ----
def _assert_cache_close(pcache, jcache, tol):
    """Every mixer's ``h`` / ``conv`` and the attention sublayer's K/V
    (``k``, ``v``, ``pos``) of the port's cache against the JAX cache."""
    group = jcache["groups"][0]
    for i, layer in enumerate(pcache["layers"]):
        sub = group[f"sub{i}"]
        assert set(layer) == set(sub) == ({"ssm"} if i in MIXERS else {"kv"})
        for kind, leaves in sub.items():
            for name, want in leaves.items():
                got = layer[kind][name].numpy()
                if name == "pos":
                    np.testing.assert_array_equal(got, np.asarray(want)[0])
                else:
                    np.testing.assert_allclose(got, np.asarray(want)[0],
                                               **tol)


def test_steps_match_jax(setup):
    """fp32 ring, batch 3: a chunked prefill of width 4 (9, 4 and 0
    prompt tokens: padding lanes, a slot with none) then a decode step:
    the logits of every slot at 1e-4 and, after each step, the seven
    mixers' state and the attention sublayer's K/V (the SSM's step
    contract). The JAX cache, carried over by ``cache_from_numpy``,
    comes back bitwise through ``cache_to_numpy`` and takes the next
    decode step in the port as in JAX."""
    jcfg, _pcfg, pscfg, _qat, _keys, jserved, served = setup
    jscfg = _serve_cfg(jcfg, backend="xla_ref")
    rng = np.random.default_rng(2)
    b, c = 3, 4
    tokens = rng.integers(0, pscfg.vocab_size, (b, c)).astype(np.int32)
    pos = np.full((b, c), -1, np.int32)
    pos[0], pos[1, :3] = np.arange(4), np.arange(3)
    last = np.asarray([3, 2, 0], np.int32)
    jcache = jlm.init_cache(jscfg, b, 32, jnp.float32)
    pcache = plm.init_cache(pscfg, b, 32, torch.float32, device="cpu")
    prefill = _compile_as_written(
        lambda p, cc, *a: jlm.prefill_step(p, jscfg, cc, *a), jserved,
        jcache, tokens, pos, last)
    want, jcache = prefill(jserved, jcache, tokens, pos, last)
    got, pcache = plm.prefill_step(served, pscfg, pcache, tokens, pos, last)
    np.testing.assert_allclose(got.numpy()[:2], np.asarray(want)[:2],
                               **LOGIT_TOL)
    _assert_cache_close(pcache, jcache, LOGIT_TOL)
    tok = rng.integers(0, pscfg.vocab_size, b).astype(np.int32)
    dpos = np.asarray([4, 3, 0], np.int32)
    decode = _compile_as_written(
        lambda p, cc, t, q: jlm.decode_step(p, jscfg, cc, t, q), jserved,
        jcache, tok, dpos)
    want, jnext = decode(jserved, jcache, tok, dpos)
    got, pcache = plm.decode_step(served, pscfg, pcache, tok, dpos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    _assert_cache_close(pcache, jnext, LOGIT_TOL)
    host = jax.device_get(jnext)
    carried = interop.cache_from_numpy(host, pscfg, "cpu")
    back = interop.flatten_tree(interop.cache_to_numpy(carried, pscfg))
    flat = interop.flatten_tree(host)
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v)
    tok2 = rng.integers(0, pscfg.vocab_size, b).astype(np.int32)
    want, jlast = decode(jserved, jnext, tok2, dpos + 1)
    got, carried = plm.decode_step(served, pscfg, carried, tok2, dpos + 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    _assert_cache_close(carried, jlast, LOGIT_TOL)


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_reset_cache_slots_wipes_both_kinds(setup, layout):
    """``reset_cache_slots`` on a stepped hybrid cache (4-bit K/V, ring or
    page pool) equals the reference's on the same cache: the listed
    rows' mixer state zeroed, their ring K/V emptied (pos -1) or, paged,
    their page-table rows unmapped; other rows bitwise as they were."""
    jcfg, _pcfg, pscfg, *_rest, served = setup
    kw = dict(kv_bits=4) if layout == "ring" else dict(
        kv_bits=4, kv_layout="paged", page_size=16)
    cache = plm.init_cache(pscfg, 3, 32, torch.float32, device="cpu", **kw)
    if layout == "paged":
        cache["layers"][ATTN]["kv"]["page_table"].copy_(
            torch.arange(1, 7, dtype=torch.int32).reshape(3, 2))
    tokens = np.arange(12, dtype=np.int32).reshape(3, 4) + 5
    plm.prefill_step(served, pscfg, cache, tokens,
                     np.tile(np.arange(4), (3, 1)), np.full(3, 3))
    before = interop.cache_to_numpy(cache, pscfg)
    plm.reset_cache_slots(cache, [0, 2])
    got = interop.flatten_tree(interop.cache_to_numpy(cache, pscfg))
    want = interop.flatten_tree(jax.device_get(jlm.reset_cache_slots(
        jax.tree.map(jnp.asarray, before), [0, 2])))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v)
    flat = interop.flatten_tree(before)
    for i in MIXERS:
        h = got[f"groups/0/sub{i}/ssm/h"][0]
        assert not h[[0, 2]].any() and h[1].any()
        np.testing.assert_array_equal(
            h[1], flat[f"groups/0/sub{i}/ssm/h"][0][1])
    kv = f"groups/0/sub{ATTN}/kv/"
    if layout == "ring":
        assert (got[kv + "pos"][0][[0, 2]] == -1).all()
        assert (got[kv + "pos"][0][1] >= 0).any()
    else:
        assert (got[kv + "page_table"][0][[0, 2]] == -1).all()
        np.testing.assert_array_equal(got[kv + "k_codes"],
                                      flat[kv + "k_codes"])


def test_seq_state_covers_the_mixers_only(setup):
    """The speculative snapshot holds the seven mixers' ``h`` and ``conv``
    and no K/V; ``seq_state_bytes`` counts them."""
    *_rest, pscfg, _qat, _keys, _jserved, _served = setup
    cache = plm.init_cache(pscfg, 3, 32, torch.float32, device="cpu")
    snap = plm.extract_seq_state(cache)
    for i, layer in enumerate(snap["layers"]):
        assert set(layer) == ({"ssm"} if i in MIXERS else {"kv"})
        if i == ATTN:
            assert all(v is None for v in layer["kv"].values())
    per = sum(t.numel() * 4 for t in cache["layers"][0]["ssm"].values())
    assert plm.seq_state_bytes(cache) == len(MIXERS) * per


def test_paged_attention_sublayers_share_one_page_table():
    """Two units (16 sublayers): the attention sublayers 3 and 11, seven
    mixers apart, map their pages through one shared table, as the
    reference broadcasts one table to every layer; the bridge keeps it
    shared."""
    cfg = dataclasses.replace(pget_config(ARCH).reduced(), num_layers=16)
    cache = plm.init_cache(cfg, 2, 32, torch.float32, device="cpu",
                           kv_bits=4, kv_layout="paged", page_size=16)
    kv = [layer["kv"] for layer in cache["layers"] if "kv" in layer]
    assert [i for i, layer in enumerate(cache["layers"])
            if "kv" in layer] == [ATTN, ATTN + 8]
    assert kv[0]["page_table"] is kv[1]["page_table"]
    back = interop.cache_from_numpy(interop.cache_to_numpy(cache, cfg), cfg,
                                    "cpu")
    kv = [layer["kv"] for layer in back["layers"] if "kv" in layer]
    assert kv[0]["page_table"] is kv[1]["page_table"]


# -------------------------------------------------------------- engines ----
_JAX = {}


def _requests(cls):
    rng = np.random.default_rng(1)
    return [cls(prompt=rng.integers(1, 100, (n,)), max_new_tokens=m, seed=i)
            for i, (n, m) in enumerate(zip((3, 9, 5), (5, 4, 4)))]


def _tokens_of(eng, reqs):
    got = {c.request_id: c.tokens for c in eng.serve(reqs)}
    return {k - min(got): v for k, v in got.items()}


def _jax_run(setup, **kw):
    """The JAX ``DecodeEngine`` serving the reference's packing, its steps
    traced with the true division (``_true_division``): (tokens,
    spec_stats), once a form for the file."""
    key = tuple(sorted(kw.items()))
    if key not in _JAX:
        jcfg, *_rest, jserved, _served = setup
        eng = jengine.DecodeEngine(jserved, jcfg, jengine.EngineConfig(
            backend="xla_ref", **dict(ENGINE, **kw)), already_serve=True)
        with _true_division():             # the engine traces its steps
            _JAX[key] = (_tokens_of(eng, _requests(JRequest)),
                         eng.spec_stats())
    return _JAX[key]


def _port_engine(setup, model=None, **kw):
    pcfg, served = setup[1], setup[-1]
    return pengine.DecodeEngine(model or served, pcfg,
                                pengine.EngineConfig(**dict(ENGINE, **kw)),
                                already_serve=model is None, device="cpu")


ENGINE_FORMS = {
    "fp_chunk4": ({}, {}),
    "fp_chunk1": ({}, dict(prefill_chunk=1)),
    "fp_paged": ({}, dict(kv_layout="paged", page_size=16)),
    "kv4_ring": (dict(kv_bits=4), dict(kv_bits=4)),
    "kv4_paged": (dict(kv_bits=4), dict(kv_bits=4, kv_layout="paged",
                                        page_size=16)),
}


@pytest.mark.parametrize("form", sorted(ENGINE_FORMS))
def test_decode_engine_tokens_equal_jax(setup, form):
    """Greedy tokens equal the JAX ``DecodeEngine``'s: the fp ring at
    chunk 4 and 1 and the fp page pool against its fp ring, the 4-bit
    ring and pool against its 4-bit ring; the cache holds K/V in the
    attention sublayer and state in the mixers."""
    jkw, pkw = ENGINE_FORMS[form]
    want, _ = _jax_run(setup, **jkw)
    eng = _port_engine(setup, **pkw)
    got = _tokens_of(eng, _requests(PRequest))
    assert set(got) == set(want) == {0, 1, 2}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert [set(layer) for layer in eng.cache["layers"]] == [
        {"kv"} if i == ATTN else {"ssm"} for i in range(8)]
    if eng.pool is not None:
        eng.pool.check()


@pytest.mark.parametrize("form", ["fp_ring", "kv4_paged"])
def test_spec_engine_tokens_and_stats_equal_jax(setup, form):
    """Speculative decoding (k = 2: the snapshot/recommit round) over the
    fp ring and the 4-bit page pool: greedy tokens equal spec-off's and
    the JAX engines'; over the fp ring, its rounds and drafts equal the
    JAX speculative engine's."""
    kw = dict(kv_bits=4, kv_layout="paged", page_size=16) \
        if form == "kv4_paged" else {}
    want, _ = _jax_run(setup, **({"kv_bits": 4} if kw else {}))
    eng = _port_engine(setup, spec_tokens=2, **kw)
    got = _tokens_of(eng, _requests(PRequest))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    st = eng.spec_stats()
    assert st["rounds"] > 0 and st["drafted"] == 2 * st["rounds"]
    if form == "fp_ring":
        jtok, jst = _jax_run(setup, spec_tokens=2)
        for k in want:
            np.testing.assert_array_equal(got[k], jtok[k])
        assert (st["rounds"], st["drafted"]) == (jst["rounds"],
                                                 jst["drafted"])
    else:
        eng.pool.check()


@pytest.mark.parametrize("form", ["fp_ring", "kv4_paged"])
def test_spec_round_restores_bystanders_and_recommits(setup, form):
    """One round at k = 2 beside a slot still in prefill, over the fp ring
    and the 4-bit page pool: the drafts advance every mixer's state, yet
    after the round (restore, verify, restore, masked recommit, paged
    rollback) the cache is bitwise that of one plain chunked step over
    the committed lanes from the pre-round state: every mixer's state and
    the attention sublayer's K/V."""
    kw = dict(kv_bits=4, kv_layout="paged", page_size=16) \
        if form == "kv4_paged" else {}
    eng = _port_engine(setup, max_batch=2, spec_tokens=2, **kw)
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
    ref = interop.cache_from_numpy(interop.cache_to_numpy(eng.cache,
                                                          eng.cfg),
                                   eng.cfg, "cpu")
    plm.restore_seq_state(ref, before)
    tokens = np.zeros((2, 3), np.int32)
    pos = np.full((2, 3), -1, np.int64)
    tokens[s0, :len(feed0)] = feed0
    pos[s0, :len(feed0)] = fed0 + np.arange(len(feed0))
    tokens[s1] = np.arange(20, 30)[fed1:fed1 + 3]
    pos[s1] = fed1 + np.arange(3)
    plm.verify_step(eng.model, eng.cfg, ref, tokens, pos)
    got = interop.flatten_tree(interop.cache_to_numpy(eng.cache, eng.cfg))
    want = interop.flatten_tree(interop.cache_to_numpy(ref, eng.cfg))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    if eng.pool is not None:
        eng.pool.check()


def test_bf16_parameters_serve_bitwise_their_fp32_upcast(setup):
    """The model with ``param_dtype="bfloat16"`` (the config's own; the
    reduced config's replaced on the port only): its packing, whose
    group abs-max and B7 read the bf16 weights as they are, is bitwise
    the fp32 upcast's and so the reference's; its fp leaves stay bf16
    (table, readout, conv) or fp32 (norms, router, A_log ...); its greedy
    tokens are bitwise the fp32 model's, which are the JAX engine's."""
    _jcfg, pcfg, _pscfg, qat, keys, _jserved, served = setup
    cfg16 = dataclasses.replace(pcfg, param_dtype="bfloat16")
    tree16 = _map_keys(qat, keys, lambda a: torch.tensor(a).bfloat16())
    model16 = interop.params_from_numpy(tree16, cfg16, "cpu")
    eng = _port_engine(setup, model=model16)
    m = eng.model
    assert m.embed.table.dtype == m.lm_head.w.dtype == torch.bfloat16
    assert m.blocks[0].mamba.conv_w.dtype == torch.bfloat16
    assert m.blocks[0].mamba.A_log.dtype == torch.float32
    assert m.blocks[1].moe.router.w.dtype == torch.float32
    got = interop.flatten_tree(interop.tree_to_numpy(m))
    want = interop.flatten_tree(interop.tree_to_numpy(served))
    packed = [k for k in want if k.rsplit("/", 1)[-1] in (
        "w4", "w2", "w1", "perm", "pbits_sorted", "wscale")]
    assert len(packed) > 100
    for k in packed:
        np.testing.assert_array_equal(got[k], want[k])
    toks = _tokens_of(eng, _requests(PRequest))
    want_toks, _ = _jax_run(setup)
    for k in want_toks:
        np.testing.assert_array_equal(toks[k], want_toks[k])


# -------------------------------------------------------------- entries ----
RUN = (
    "import runpy, sys\n"
    "sys.argv = {argv!r}\n"
    "runpy.run_module('repro_torch.launch.serve', run_name='__main__')\n"
    "bad = sorted(m for m in sys.modules if m == 'jax' or "
    "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
    "assert not bad, bad\n"
    "print('no jax loaded')\n")


def test_serve_launcher_serves_the_hybrid_without_jax():
    """``--arch jamba-1.5-large-398b --reduced --device cpu`` over the
    4-bit page pool: both kinds of state reported, no jax loaded."""
    argv = ["serve", "--arch", ARCH, "--reduced", "--device", "cpu",
            "--requests", "3", "--prompt-len", "6", "--new-tokens", "4",
            "--cache-len", "32", "--kv-bits", "4", "--kv-layout", "paged"]
    out = subprocess.run([sys.executable, "-c", RUN.format(argv=argv)],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                                        "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stdout + out.stderr[-4000:]
    assert out.stdout.rstrip().endswith("no jax loaded")
    assert "kv cache: q4, layout: paged" in out.stdout
    assert "ssm state: h fp32" in out.stdout
    assert len(re.findall(r"req \d \[length", out.stdout)) == 3
    # 7 mixers of h [4, 4, 64, 32] fp32 and conv [4, 3, 320] fp32.
    want = 7 * (4 * 4 * 64 * 32 * 4 + 4 * 3 * 320 * 4)
    assert f"[ssm-state] {want:,} bytes" in out.stdout
    assert "[paged-kv]" in out.stdout
