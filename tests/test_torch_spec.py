"""Port parity for self-speculative decoding (DESIGN.md §14): the draft
drivers (the [K2|K1] slice of the packed carriers) and ``verify_step``
against the JAX package (``xla_ref``), and the speculative
``DecodeEngine`` against the port's spec-off engine and the JAX
speculative engine on the JAX suite's tiny config and requests
(tests/test_serve_engine.py): fp and 4-bit KV, ring and page pool. The
JAX engines serve the port's packed tree (``already_serve``), so both
packages run the same weights."""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import transforms as jtransforms
from repro.backend.registry import resolve as jresolve
from repro.configs.base import ArchConfig as JArchConfig
from repro.core import quant as jquant
from repro.core.qtypes import QuantConfig as JQuantConfig
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro.serve.scheduler import Request as JRequest

from repro_torch import interop
from repro_torch.backend import base as pbackend
from repro_torch.configs import get_config as pget_config
from repro_torch.configs import list_archs as plist_archs
from repro_torch.configs.base import ArchConfig as PArchConfig
from repro_torch.core.qtypes import QuantConfig as PQuantConfig
from repro_torch.kernels import packed_matmul as ppm
from repro_torch.models import lm as plm
from repro_torch.serve import engine as pengine
from repro_torch.serve.scheduler import Request as PRequest

from test_torch_train import _one_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)

_TINY = dict(name="t", family="dense", num_layers=2, d_model=64,
             num_heads=2, num_kv_heads=2, d_ff=128, vocab_size=128,
             head_dim=32, dtype="float32", param_dtype="float32",
             q_block=32)


def _stacked(tree):
    """The port's per-layer serve tree -> the JAX layout (numpy leaves,
    one stacked ``groups`` entry for the dense plan)."""
    def host(node):
        if isinstance(node, dict):
            return {k: host(v) for k, v in node.items()}
        return None if node is None else node.numpy()
    blocks = [host(b) for b in tree["blocks"]]
    out = {k: host(v) for k, v in tree.items() if k != "blocks"}
    out["groups"] = [jax.tree.map(lambda *xs: np.stack(xs), *blocks)]
    return out


def _compile_as_written(fn, *args):
    """``fn`` jitted with bf16 rounded after every op and the activation
    scale's division by the grid top kept a true division, as
    tests/test_torch_serve.py compiles the reference's steps."""
    top = jquant._static_grid_max
    with mock.patch.object(jquant, "_static_grid_max", lambda p:
                           jax.lax.optimization_barrier(jnp.float32(top(p)))):
        return jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})


@pytest.fixture(scope="module")
def served():
    """(JAX qat cfg, port qat cfg, port serve model, the same packed tree
    in the JAX layout) from one JAX QAT init of the tiny config."""
    jcfg = JArchConfig(quant=JQuantConfig(mode="qat"), **_TINY)
    pcfg = PArchConfig(quant=PQuantConfig(mode="qat"), **_TINY)
    qat = jax.device_get(jlm.init_params(jax.random.PRNGKey(0), jcfg))
    eng = pengine.DecodeEngine(interop.params_from_numpy(qat, pcfg, "cpu"),
                               pcfg, pengine.EngineConfig(), device="cpu")
    return jcfg, pcfg, eng.model, _stacked(eng.model.tree())


def _ecfg(mod, **kw):
    base = dict(max_batch=2, cache_len=32, prefill_chunk=4)
    base.update(kw)
    return mod.EngineConfig(**base)


def _requests(cls, rng, lens=(3, 9, 5, 2), news=(6, 9, 4, 7), **kw):
    return [cls(prompt=rng.integers(1, 100, (n,)), max_new_tokens=m,
                seed=i, **kw) for i, (n, m) in enumerate(zip(lens, news))]


def _tokens_of(eng, reqs):
    got = {c.request_id: c.tokens for c in eng.serve(
        [dataclasses.replace(r) for r in reqs])}
    return {k - min(got): v for k, v in got.items()}


def _port(served, **kw):
    _jcfg, pcfg, model, _tree = served
    return pengine.DecodeEngine(model, pcfg, _ecfg(pengine, **kw),
                                already_serve=True, device="cpu")


# ----------------------------------------------------------- engines ----
@pytest.mark.parametrize("kv_layout", ["ring", "paged"])
@pytest.mark.parametrize("kv_bits", [None, 4])
def test_spec_greedy_tokens_equal_spec_off_and_jax(served, kv_bits,
                                                   kv_layout):
    """The acceptance pin of the reference (tests/test_serve_engine.py,
    ``test_spec_greedy_token_identity``) on the port: greedy speculative
    tokens equal the spec-off tokens and the JAX speculative engine's,
    with its rounds and drafts, and no extra weight bytes."""
    jcfg, _pcfg, model, tree = served
    kw = dict(kv_bits=kv_bits)
    if kv_layout == "paged":
        kw.update(kv_layout="paged", page_size=4)
    spec_kw = dict(spec_tokens=3, spec_draft_bits=2, **kw)
    base = _port(served, **kw)
    spec = _port(served, **spec_kw)
    jspec = jengine.DecodeEngine(tree, jcfg, _ecfg(
        jengine, backend="xla_ref", **spec_kw), already_serve=True)
    want = _tokens_of(base, _requests(PRequest, np.random.default_rng(0)))
    got = _tokens_of(spec, _requests(PRequest, np.random.default_rng(0)))
    ref = _tokens_of(jspec, _requests(JRequest, np.random.default_rng(0)))
    assert set(want) == set(got) == set(ref) == {0, 1, 2, 3}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], ref[k])
    st, jst = spec.spec_stats(), jspec.spec_stats()
    assert st["rounds"] > 0 and st["drafted"] == 3 * st["rounds"]
    assert (st["rounds"], st["drafted"]) == (jst["rounds"], jst["drafted"])
    assert pengine.packed_model_bytes(spec.model) == \
        pengine.packed_model_bytes(model) == \
        jengine.packed_model_bytes(tree)
    if kv_layout == "paged":
        spec.pool.check()


def test_spec_draft_counter_moves_only_with_spec_on(served):
    """Spec-off serving never runs a draft-mode matmul; the speculative
    engine does."""
    reqs = _requests(PRequest, np.random.default_rng(1), lens=(3, 5),
                     news=(4, 6))
    before = pbackend.draft_matmul_call_count()
    _tokens_of(_port(served), reqs)
    assert pbackend.draft_matmul_call_count() == before
    _tokens_of(_port(served, spec_tokens=2), reqs)
    assert pbackend.draft_matmul_call_count() > before


def test_spec_ring_wrap_guard_keeps_parity(served):
    """A slot whose round would write past the ring end does not draft;
    parity holds up to a full cache (5 + 11 = 16 = cache_len)."""
    reqs = [PRequest(prompt=np.arange(1, 6, dtype=np.int32),
                     max_new_tokens=11, seed=0)]
    base = _port(served, max_batch=1, cache_len=16)
    spec = _port(served, max_batch=1, cache_len=16, spec_tokens=3)
    np.testing.assert_array_equal(_tokens_of(spec, reqs)[0],
                                  _tokens_of(base, reqs)[0])
    st = spec.spec_stats()
    assert st["rounds"] > 0 and st["drafted"] < 11 * 3


def test_spec_temperature_reproducible_and_live(served):
    """Temperature > 0: rejection sampling on the host rng, the same
    stream across engine resets, other streams for other seeds."""
    eng = _port(served, spec_tokens=2)

    def run(offset):
        eng.reset()
        return _tokens_of(eng, [dataclasses.replace(r, seed=offset + i)
                                for i, r in enumerate(_requests(
                                    PRequest, np.random.default_rng(2),
                                    lens=(3, 6), news=(8, 6),
                                    temperature=0.8))])

    a, b = run(0), run(0)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    other = run(100)
    assert any(not np.array_equal(a[k], other[k]) for k in a)


@pytest.mark.parametrize("kv_layout", ["ring", "paged"])
def test_cancel_active_request_of_a_spec_engine(served, kv_layout):
    """A speculative engine cancels an active request mid-flight; the
    survivor's tokens are those it gets alone, and a paged pool keeps its
    invariants with every page of the victim released."""
    kw = dict(max_batch=2, spec_tokens=2)
    if kv_layout == "paged":
        kw.update(kv_bits=4, kv_layout="paged", page_size=4)
    keep = PRequest(prompt=np.asarray([9, 8, 7], np.int32),
                    max_new_tokens=6, seed=1)
    want = _tokens_of(_port(served, **kw), [keep])[0]
    eng = _port(served, **kw)
    victim = eng.submit(PRequest(prompt=np.asarray([1, 2], np.int32),
                                 max_new_tokens=8, seed=0))
    kept = eng.submit(dataclasses.replace(keep))
    for _ in range(2):
        eng.step()
    slot = next(s for s, st in eng.sched.slots.items()
                if st.request.request_id == victim)
    comp = eng.cancel(victim)
    assert comp is not None and comp.finish_reason == "evicted"
    assert eng.cancel(victim) is None
    if eng.pool is not None:
        eng.pool.check()
        assert (eng.pool.table[slot] == -1).all()
    done = {c.request_id: c for c in eng.run()}
    assert set(done) == {kept}
    np.testing.assert_array_equal(done[kept].tokens, want)


def test_spec_config_validation(served, monkeypatch):
    """The reference's checks: the width against the cache length, the
    draft precision, and the family gate naming the family."""
    with pytest.raises(ValueError, match="cache_len"):
        _port(served, cache_len=4, spec_tokens=8)
    with pytest.raises(ValueError, match="draft_slice_bits"):
        PQuantConfig(mode="serve", draft_slice_bits=3)
    with pytest.raises(ValueError, match="draft_slice_bits"):
        _port(served, spec_tokens=2, spec_draft_bits=3)
    caps = dataclasses.replace(plm.serve_capabilities(served[1]),
                               spec_capable=False, note="test ban")
    monkeypatch.setattr(plm, "serve_capabilities", lambda _cfg: caps)
    with pytest.raises(ValueError, match=r"family 'dense'.*test ban"):
        _port(served, spec_tokens=2)
    _port(served)                       # spec off: no gate


def test_serve_capabilities_match_jax():
    """Every registered config of the port has the reference's
    descriptor."""
    from repro.configs import get_config as jget_config
    for arch in plist_archs():
        got = plm.serve_capabilities(pget_config(arch))
        want = jlm.serve_capabilities(jget_config(arch))
        assert (got.family, got.chunkable, got.spec_capable, got.state) == \
            (want.family, want.chunkable, want.spec_capable, want.state)


# ----------------------------------------------------- draft drivers ----
def _weight(pbits, k, n, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.7).astype(np.float32)
    return {"w": w, "pbits": np.asarray(pbits, np.int8)}


def _leaves(qat):
    jleaf = jtransforms.pack_linear(
        qat, JQuantConfig(mode="qat", backend="xla_ref"))
    pleaf = {name: None if v is None else torch.from_numpy(np.array(v))
             for name, v in jleaf.items()}
    return jleaf, pleaf


class _Launches:
    """Records the segment list and mode of every ``segments_matmul``
    call the driver makes."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = ppm.segments_matmul

        def spy(x, segments, **kw):
            self.calls.append(([off for _w, _s, _p, off in segments],
                               [p for _w, _s, p, _o in segments],
                               kw.get("self_scale", False),
                               kw.get("sx") is not None))
            return real(x, segments, **kw)

        monkeypatch.setattr(ppm, "segments_matmul", spy)


# (precisions per group, K, the precisions a draft launch reads, its first
# k_off, whether it takes the self-scale form)
DRAFT_LEAVES = {
    "mixed": ((4, 2, 1, 4, 2, 2, 1, 4), 128, [2, 1], 48, False),
    "all4": ((4,) * 6, 96, [4], 0, True),
    "all2": ((2,) * 6, 96, [2], 0, True),
}


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "two_pass"])
@pytest.mark.parametrize("leaf", sorted(DRAFT_LEAVES))
def test_draft_driver_matches_jax(leaf, fused, monkeypatch):
    """Draft mode (``draft_slice_bits=2``) of the dense driver against the
    reference's ``xla_ref`` driver: a mixed leaf reads its [K2|K1]
    segments only (first k_off past K4, the driver's scale: the
    self-scale gate does not fire after the filter); an all-4-bit leaf
    keeps its full mix; an all-2-bit leaf is its own slice."""
    pbits, k, want_p, want_off, want_self = DRAFT_LEAVES[leaf]
    jleaf, pleaf = _leaves(_weight(pbits, k, 24, seed=k))
    rng = np.random.default_rng(k + 1)
    x = (rng.standard_normal((5, k)) * 1.5).astype(np.float32)
    x[0] = 0.0                                           # an all-zero row
    jq = JQuantConfig(mode="serve", act_scale_mode="per_token",
                      fuse_act_quant=fused, draft_slice_bits=2)
    pq = PQuantConfig(mode="serve", act_scale_mode="per_token",
                      fuse_act_quant=fused, draft_slice_bits=2)
    want = _compile_as_written(lambda lf, v: jresolve(
        "xla_ref").packed_matmul(lf, v, jq), jleaf, jnp.asarray(x))(
            jleaf, jnp.asarray(x))
    spy = _Launches(monkeypatch)
    before = pbackend.draft_matmul_call_count()
    got = pbackend.packed_matmul(pleaf, torch.from_numpy(x), pq)
    assert pbackend.draft_matmul_call_count() == before + 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    [(offs, ps, self_scale, driver_scale)] = spy.calls
    assert ps == want_p and offs[0] == want_off
    assert self_scale == (want_self and fused)
    assert driver_scale == (fused and not want_self)
    full = pbackend.packed_matmul(pleaf, torch.from_numpy(x),
                                  dataclasses.replace(
                                      pq, draft_slice_bits=None))
    if want_p == [4] or want_p == [2]:
        np.testing.assert_array_equal(got.numpy(), full.numpy())
    else:
        assert not np.allclose(got.numpy(), full.numpy())


def test_grouped_draft_driver_matches_jax(monkeypatch):
    """Draft mode of the grouped driver (the MoE draft) against the
    reference's: the [K2|K1] segments of every expert, after a whole-K
    fake-quant with the full sorted precisions."""
    e, m, k, n = 3, 5, 128, 24
    rng = np.random.default_rng(7)
    w = (rng.standard_normal((e, k, n)) * 0.7).astype(np.float32)
    pb = np.stack([rng.permutation(np.array((4, 2, 1, 4, 2, 2, 1, 4),
                                            np.int8)) for _ in range(e)])
    jleaf = jtransforms.convert_tree(
        {"w": w, "pbits": pb}, JQuantConfig(mode="qat", backend="xla_ref"),
        rebudget=True)
    pleaf = {name: None if v is None else torch.from_numpy(np.array(v))
             for name, v in jleaf.items()}
    x = (rng.standard_normal((e, m, k)) * 1.5).astype(np.float32)
    x[:, 0] = 0.0
    jq = JQuantConfig(mode="serve", act_scale_mode="per_token",
                      draft_slice_bits=2)
    want = _compile_as_written(lambda lf, v: jresolve(
        "xla_ref").packed_matmul_grouped(lf, v, jq), jleaf,
        jnp.asarray(x))(jleaf, jnp.asarray(x))
    spy = _Launches(monkeypatch)
    got = pbackend.packed_matmul_grouped(
        pleaf, torch.from_numpy(x), PQuantConfig(
            mode="serve", act_scale_mode="per_token", draft_slice_bits=2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    [(offs, ps, _self, _sx)] = spy.calls
    assert ps == [2, 1] and offs[0] > 0


# -------------------------------------------------------- verify step ----
def test_verify_step_logits_match_jax(served):
    """``verify_step`` after a chunked prefill: fp32 logits of every live
    lane ([B, C, V], a padding lane in row 1) against the reference's
    ``lm.verify_step`` at 1e-4, and lane j bitwise the logits a decode
    step gives at that position on the same cache."""
    jcfg, pcfg, model, tree = served
    jscfg = dataclasses.replace(jcfg, quant=dataclasses.replace(
        jcfg.quant, mode="serve", act_scale_mode="per_token",
        backend="xla_ref"))
    pscfg = dataclasses.replace(pcfg, quant=dataclasses.replace(
        pcfg.quant, mode="serve", act_scale_mode="per_token"))
    rng = np.random.default_rng(3)
    b, c = 2, 4
    prompt = rng.integers(1, 100, (b, 6)).astype(np.int32)
    ppos = np.tile(np.arange(6, dtype=np.int32), (b, 1))
    last = np.full((b,), 5, np.int32)
    tokens = rng.integers(1, 100, (b, c)).astype(np.int32)
    pos = (6 + np.tile(np.arange(c, dtype=np.int32), (b, 1)))
    pos[1, c - 1] = -1                                   # a padding lane
    jcache = jlm.init_cache(jscfg, b, 32, jnp.float32)
    prefill = _compile_as_written(
        lambda p, cc, t, q, l: jlm.prefill_step(p, jscfg, cc, t, q, l),
        tree, jcache, prompt, ppos, last)
    _, jcache = prefill(tree, jcache, prompt, ppos, last)
    verify = _compile_as_written(
        lambda p, cc, t, q: jlm.verify_step(p, jscfg, cc, t, q),
        tree, jcache, tokens, pos)
    want, _ = verify(tree, jcache, tokens, pos)
    pcache = plm.init_cache(pscfg, b, 32, torch.float32, device="cpu")
    plm.prefill_step(model, pscfg, pcache, prompt, ppos, last)
    fork = {"layers": [{"kv": {n: t.clone() for n, t in lay["kv"].items()}}
                       for lay in pcache["layers"]]}
    got, _ = plm.verify_step(model, pscfg, pcache, tokens, pos)
    assert got.shape == (b, c, pscfg.vocab_size)
    live = pos >= 0
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               **LOGIT_TOL)
    # Lane j equals a decode step at pos j once lanes < j are written.
    for j in range(c):
        lg, fork = plm.decode_step(model, pscfg, fork, tokens[:, j],
                                   pos[:, j], active=pos[:, j] >= 0)
        for r in range(b):
            if pos[r, j] >= 0:
                assert torch.equal(lg[r], got[r, j])


@pytest.mark.parametrize("m", [1, 4, 5, 16, 17, 33])
def test_row_block_matmul_rows_independent_of_the_row_count(m):
    """The serve readout / router product: each row is bitwise the same
    whatever the number of rows in the call, and within fp32 rounding of
    one plain product."""
    from repro_torch.core.numerics import row_block_matmul
    rng = np.random.default_rng(m)
    x = torch.as_tensor(rng.standard_normal((33, 96)), dtype=torch.float32)
    w = torch.as_tensor(rng.standard_normal((96, 40)), dtype=torch.float32)
    full = row_block_matmul(x, w)
    got = row_block_matmul(x[:m].reshape(1, m, 96), w)
    assert got.shape == (1, m, 40)
    assert torch.equal(got[0], full[:m])
    np.testing.assert_allclose(got[0].numpy(), (x[:m] @ w).numpy(), **TOL)


@pytest.mark.parametrize("bits,want", [(None, [4, 2, 1]), (1, [1]),
                                       (2, [2, 1]), (4, [4, 2, 1])])
def test_draft_segments_rule(bits, want):
    """The drivers' draft rule: the segments at or below the bound, the
    full mix where none is; no bound (spec off) keeps all of them and
    leaves the draft counter still."""
    segs = [("w4", 4, 0, 32, 0, 2), ("w2", 2, 32, 16, 2, 1),
            ("w1", 1, 48, 16, 3, 1)]
    before = pbackend.draft_matmul_call_count()
    got = pbackend._draft_slice(segs, PQuantConfig(draft_slice_bits=bits))
    assert [s[1] for s in got] == want
    assert pbackend.draft_matmul_call_count() - before == (bits is not None)
    assert pbackend.draft_segments(segs[:1], 2) == segs[:1]
