"""Port parity for serving the MoE decoders, against the JAX package.

The pieces: the grouped serve driver (kernel B8 over [E, M, K], then B6
per segment) against ``xla_ref``'s ``packed_matmul_grouped``, the packing
of a stacked expert bank, and the serve ``moe_apply`` (routing, drop-free
dispatch, the combine). The slice: decode and chunked-prefill logits on
the same served weights, greedy tokens of the port's engines against the
JAX ``DecodeEngine`` (fp ring on reduced deepseek-moe-16b and
mixtral-8x22b; the 4-bit ring and page pool on mixtral-8x22b), and the
port's continuous engine against its lockstep engine.

The reduced configs are cut in depth: deepseek-moe-16b keeps its dense
first layer and one MoE layer, mixtral-8x22b one MoE layer. The
JAX functions are compiled as the program is written (bf16 rounded after
every op, the activation scale's ``/ 1.875`` kept a true division), as
``tests/test_torch_serve.py`` does and for the same reason."""
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import transforms as jtransforms
from repro.backend import resolve as jresolve
from repro.configs import get_config as jget_config
from repro.core import quant as jquant
from repro.core.qtypes import QuantConfig as JQuantConfig
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.serve import engine as jengine
from repro.serve.scheduler import Request as JRequest

from repro_torch import interop
from repro_torch.api import transforms as ptransforms
from repro_torch.backend import base as pbackend
from repro_torch.configs import get_config as pget_config
from repro_torch.core.qtypes import QuantConfig as PQuantConfig
from repro_torch.models import lm as plm
from repro_torch.models import moe as pmoe
from repro_torch.serve import engine as pengine
from repro_torch.serve.scheduler import Request as PRequest

TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
AS_WRITTEN = {"xla_allow_excess_precision": False}


def _compile_as_written(fn, *args):
    top = jquant._static_grid_max
    with mock.patch.object(jquant, "_static_grid_max", lambda p:
                           jax.lax.optimization_barrier(jnp.float32(top(p)))):
        return jax.jit(fn).lower(*args).compile(compiler_options=AS_WRITTEN)


def _qat_tree(jcfg, seed):
    """A QAT tree in the JAX package's layout (``jax.eval_shape`` of
    ``lm.init_params``) filled from numpy: weights N(0, 1/K), the
    embedding N(0, 0.02^2), precisions drawn from {1, 2, 4} per group
    (packing rebudgets them onto the default mix), norm gains 1."""
    shapes = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    rng = np.random.default_rng(seed)

    def fill(path, a):
        name = path[-1].key
        if name == "pbits":
            return rng.choice(np.array([1, 2, 4], a.dtype), a.shape)
        if name in ("g", "b"):
            return np.full(a.shape, name == "g", a.dtype)
        std = 0.02 if name == "table" else 1 / np.sqrt(a.shape[-2])
        return (rng.standard_normal(a.shape) * std).astype(a.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


# ------------------------------------------------------- grouped driver ----
E, M, K, N = 3, 5, 128, 24


@functools.lru_cache(maxsize=None)
def _bank():
    """A stacked [E, K, N] QAT bank whose experts rank their groups in
    different orders, packed by the JAX package (``convert_tree``
    rebudgets every expert onto one split) and the same leaves as
    tensors."""
    rng = np.random.default_rng(7)
    w = (rng.standard_normal((E, K, N)) * 0.7).astype(np.float32)
    pb = np.stack([rng.permutation(np.array((4, 2, 1, 4, 2, 2, 1, 4),
                                            np.int8)) for _ in range(E)])
    qat = {"w": w, "pbits": pb}
    jleaf = jtransforms.convert_tree(
        qat, JQuantConfig(mode="qat", backend="xla_ref"), rebudget=True)
    pleaf = {name: None if v is None else torch.from_numpy(np.array(v))
             for name, v in jleaf.items()}
    return qat, jleaf, pleaf


def _x(seed, dtype):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((E, M, K)) * 1.5).astype(np.float32)
    x[:, 0] = 0.0                     # the empty rows of the dispatch buffer
    x[1, M - 1] *= 100.0              # an outlier row
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return torch.from_numpy(x).to(dtype), jnp.asarray(x).astype(jdt)


def test_port_packs_a_stacked_bank_as_the_reference():
    """``convert_tree`` on an [E, K, N] bank: bit-equal carriers, perms and
    scales, and one [K4|K2|K1] split (identical ``pbits_sorted`` rows)."""
    qat, jleaf, _pleaf = _bank()
    got = ptransforms.convert_tree(
        {"w": torch.from_numpy(qat["w"]), "pbits": torch.from_numpy(
            qat["pbits"])}, PQuantConfig(mode="qat"), rebudget=True)
    for name, want in jleaf.items():
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want))
    rows = got["pbits_sorted"].numpy()
    assert (rows == rows[0]).all() and len(set(rows[0].tolist())) == 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["per_token", "per_tensor", "none"])
def test_grouped_driver_matches_jax_xla_ref(mode, dtype):
    _qat, jleaf, pleaf = _bank()
    xt, xj = _x(1, dtype)
    jq = JQuantConfig(mode="serve", act_scale_mode=mode)
    fn = _compile_as_written(lambda leaf, v: jresolve(
        "xla_ref").packed_matmul_grouped(leaf, v, jq), jleaf, xj)
    want = np.asarray(fn(jleaf, xj).astype(jnp.float32))
    got = pbackend.packed_matmul_grouped(
        pleaf, xt, PQuantConfig(mode="serve", act_scale_mode=mode))
    assert got.shape == (E, M, N) and got.dtype == dtype
    assert torch.isfinite(got.float()).all()
    np.testing.assert_allclose(got.float().numpy(), want, **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["per_token", "per_tensor"])
def test_grouped_equals_per_expert_two_pass_bitwise(mode, dtype):
    """Expert e of the grouped driver is bitwise the dense two-pass driver
    on expert e's leaf (per_tensor: the scale of expert e's slice)."""
    _qat, _jleaf, pleaf = _bank()
    xt, _xj = _x(2, dtype)
    q = PQuantConfig(mode="serve", act_scale_mode=mode,
                     fuse_act_quant=False)
    got = pbackend.packed_matmul_grouped(pleaf, xt, q)
    for e in range(E):
        leaf = {k: None if v is None else v[e] for k, v in pleaf.items()}
        want = pbackend.packed_matmul(leaf, xt[e], q)
        assert torch.equal(got[e], want)


def test_fake_quant_takes_one_scale_per_expert():
    """A per-expert [E, 1, 1] scale over x [E, M, K] is one value per row,
    broadcast from its expert."""
    xt, _xj = _x(3, torch.float32)
    pbits = torch.tensor([4.0, 2.0, 1.0, 4.0, 2.0, 2.0, 1.0, 4.0])
    s = torch.tensor([0.5, 1.0, 2.0]).reshape(E, 1, 1)
    got = pbackend.fake_quant(xt, pbits, s)
    for e in range(E):
        want = pbackend.fake_quant(xt[e], pbits, s[e])
        assert torch.equal(got[e], want)


# -------------------------------------------------------------- routing ----
def test_route_breaks_ties_to_the_lower_expert_like_jax():
    logits = np.array([[0.0, 1.0, 1.0, 0.0, 1.0],
                       [2.0, 2.0, 2.0, 2.0, 2.0],
                       [0.3, -1.0, 0.3, 0.3, 5.0]], np.float32)
    gates, ids = pmoe.route(torch.from_numpy(logits), 3)
    jv, jids = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), -1), 3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    want = np.asarray(jv / jnp.sum(jv, -1, keepdims=True))
    np.testing.assert_allclose(gates.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("flags", [{}, AS_WRITTEN], ids=["default", "as_written"])
def test_bf16_combine_is_the_reference_segment_sum(flags):
    """The combine in bf16 equals the reference's ``segment_sum`` of the
    gated expert rows bit for bit: a left fold from zero in top-k order,
    one rounding per add."""
    rng = np.random.default_rng(5)
    t, k, d = 64, 6, 256
    y_tok = (rng.standard_normal((t * k, d)) * 2).astype(np.float32)
    gates = rng.random((t, k)).astype(np.float32)
    gates /= gates.sum(-1, keepdims=True)
    token_idx = np.repeat(np.arange(t), k)

    def ref(y, g):
        g = g.reshape(-1).astype(y.dtype)
        return jax.ops.segment_sum(y * g[:, None], token_idx,
                                   num_segments=t)

    yj = jnp.asarray(y_tok).astype(jnp.bfloat16)
    want = jax.jit(ref).lower(yj, jnp.asarray(gates)).compile(
        compiler_options=flags)(yj, jnp.asarray(gates))
    got = pmoe.combine(torch.from_numpy(y_tok).to(torch.bfloat16)
                       .reshape(t, k, d), torch.from_numpy(gates))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


# ----------------------------------------------------- moe_apply, slice ----
ARCHS = ("deepseek-moe-16b", "mixtral-8x22b")
# The dense first layer and one MoE layer; one MoE layer.
LAYERS = {"deepseek-moe-16b": 2, "mixtral-8x22b": 1}
ENGINE = dict(max_batch=3, cache_len=64, prefill_chunk=4)


def _requests(seed, lens=(3, 7, 5), news=(4, 6, 3)):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, 200, (n,)).astype(np.int32), m)
            for n, m in zip(lens, news)]


def _serve(eng, reqs, cls):
    out = {c.request_id: c.tokens for c in eng.serve(
        [cls(prompt=p, max_new_tokens=n, seed=i)
         for i, (p, n) in enumerate(reqs)])}
    return [out[i] for i in range(len(reqs))]


@pytest.fixture(scope="module")
def bridged():
    """{arch: (QAT tree, jax cfg, port cfg, port serve model, port serve
    cfg, jax serve cfg, served numpy tree)}: one QAT tree per arch,
    packed by the port (bit-equal to the JAX packing:
    tests/test_torch_moe.py, tests/test_torch_pack.py) and bridged back,
    so the JAX engines serve the port's packed weights
    (``already_serve``)."""
    out = {}
    for arch in ARCHS:
        layers = LAYERS[arch]
        jcfg = dataclasses.replace(jget_config(arch).reduced(),
                                   num_layers=layers)
        pcfg = dataclasses.replace(pget_config(arch).reduced(),
                                   num_layers=layers)
        qat = _qat_tree(jcfg, 0)
        pq = dataclasses.replace(pcfg.quant, mode="serve",
                                 act_scale_mode="per_token")
        jq = dataclasses.replace(jcfg.quant, mode="serve",
                                 act_scale_mode="per_token",
                                 backend="xla_ref")
        pscfg = dataclasses.replace(pcfg, quant=pq)
        model = plm.LM(pscfg, ptransforms.convert_tree(
            interop.params_from_numpy(qat, pcfg, "cpu").tree(), pcfg.quant,
            rebudget=True))
        out[arch] = (qat, jcfg, pcfg, model, pscfg,
                     dataclasses.replace(jcfg, quant=jq),
                     interop.tree_to_numpy(model))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(bridged, arch):
    """fp32 serve ``moe_apply`` of the first MoE layer on 2 x 7 tokens
    (all of the reduced config's experts, the shared and routed paths):
    the same expert ids, outputs within 1e-5."""
    _qat, jcfg, pcfg, model, _c, jscfg, served = bridged[arch]
    layer = jax.tree.map(lambda a: a[0], served["groups"][-1]["moe"])
    moe = [b for b in model.blocks if b.kind == "attn_moe"][0].moe
    pq = model.cfg.quant
    x = np.random.default_rng(9).standard_normal(
        (2, 7, pcfg.d_model)).astype(np.float32)
    fn = _compile_as_written(lambda p, v: jmoe.moe_apply(
        p, v, jscfg.quant, None, num_experts=jcfg.num_experts,
        top_k=jcfg.top_k, act=jcfg.mlp_act)[0], layer, jnp.asarray(x))
    want = np.asarray(fn(layer, jnp.asarray(x)))
    got, aux = pmoe.moe_apply(moe, torch.from_numpy(x), pq,
                              num_experts=pcfg.num_experts, top_k=pcfg.top_k)
    assert aux is None
    xt = x.reshape(-1, pcfg.d_model)
    _v, jids = jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(xt) @ layer["router"]["w"], -1), jcfg.top_k)
    _g, ids = pmoe.route(moe.router(torch.from_numpy(xt), pq), pcfg.top_k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert len(np.unique(np.asarray(jids))) == pcfg.num_experts
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_moe_qat_forward_runs_and_matches_jax(bridged):
    """The training ``moe_apply`` in QAT (Phase II) on the QAT tree: the
    reference's static-capacity forward, y and the load-balancing loss
    within 1e-5 (its drops and gradients: tests/test_torch_moe_train.py)."""
    qat, jcfg, pcfg, *_ = bridged["deepseek-moe-16b"]
    layer = jax.tree.map(lambda a: a[0], qat["groups"][-1]["moe"])
    moe = interop.params_from_numpy(qat, pcfg, "cpu").blocks[1].moe
    x = np.random.default_rng(13).standard_normal(
        (2, 7, pcfg.d_model)).astype(np.float32)
    jq = dataclasses.replace(jcfg.quant, mode="qat", backend="xla_ref")
    fn = _compile_as_written(lambda p, v: jmoe.moe_apply(
        p, v, jq, None, num_experts=jcfg.num_experts, top_k=jcfg.top_k,
        act=jcfg.mlp_act), layer, jnp.asarray(x))
    jy, jaux = fn(layer, jnp.asarray(x))
    y, aux = pmoe.moe_apply(moe, torch.from_numpy(x),
                            PQuantConfig(mode="qat"),
                            num_experts=pcfg.num_experts, top_k=pcfg.top_k)
    assert y.shape == x.shape and torch.isfinite(y).all()
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(bridged, arch):
    """fp32: a chunked prefill of two prompts (padding lanes), then decode
    steps, through both packages' steps on the same served weights."""
    _qat, _jcfg, _pcfg, model, pscfg, jscfg, served = bridged[arch]
    rng = np.random.default_rng(1)
    b, chunk, cache_len = 2, 4, 32
    jcache = jlm.init_cache(jscfg, b, cache_len, jnp.float32)
    pcache = plm.init_cache(pscfg, b, cache_len, torch.float32,
                            device="cpu")
    tokens = rng.integers(0, pscfg.vocab_size, (b, chunk)).astype(np.int32)
    pos = np.array([[0, 1, 2, 3], [0, 1, -1, -1]], np.int32)
    last = np.array([3, 1], np.int32)
    prefill = _compile_as_written(
        lambda p, c, t, q, i: jlm.prefill_step(p, jscfg, c, t, q, i),
        served, jcache, tokens, pos, last)
    jl, jcache = prefill(served, jcache, tokens, pos, last)
    pl, pcache = plm.prefill_step(model, pscfg, pcache, tokens, pos, last)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **LOGIT_TOL)
    nxt = np.array([4, 2], np.int32)
    tok = rng.integers(0, pscfg.vocab_size, b).astype(np.int32)
    decode = _compile_as_written(
        lambda p, c, t, q: jlm.decode_step(p, jscfg, c, t, q),
        served, jcache, tok, nxt)
    for step in range(3):
        jl, jcache = decode(served, jcache, tok, nxt + step)
        pl, pcache = plm.decode_step(model, pscfg, pcache, tok, nxt + step)
        assert np.isfinite(pl.numpy()).all()
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **LOGIT_TOL)
        tok = rng.integers(0, pscfg.vocab_size, b).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_engine_tokens_equal_jax_decode_engine(bridged, arch):
    """fp ring: the port's engine packs the QAT weights at construction,
    the JAX engine serves the same packed weights; on three mixed
    requests the greedy tokens are identical, and the port's lockstep
    engine gives each request's tokens too."""
    qat, jcfg, pcfg, _m, _c, _jc, served = bridged[arch]
    reqs = _requests(0)
    jeng = jengine.DecodeEngine(served, jcfg, jengine.EngineConfig(
        backend="xla_ref", **ENGINE), already_serve=True)
    want = _serve(jeng, reqs, JRequest)
    peng = pengine.DecodeEngine(interop.params_from_numpy(qat, pcfg, "cpu"),
                                pcfg, pengine.EngineConfig(**ENGINE),
                                device="cpu")
    got = _serve(peng, reqs, PRequest)
    lock = pengine.LockstepEngine(peng.model, peng.cfg,
                                  pengine.EngineConfig(**ENGINE),
                                  already_serve=True, device="cpu")
    for (p, n), g, w in zip(reqs, got, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(lock.generate(p[None], n)[0], w)


def test_kv4_ring_and_paged_tokens_equal_jax(bridged):
    """mixtral-8x22b with the packed 4-bit KV cache: the JAX paged
    engine's greedy tokens equal the port's paged engine's, its 4-bit
    ring engine's and its lockstep engine's (three 7-token prompts, 5 new
    tokens, pages of 4)."""
    qat, jcfg, pcfg, _m, _c, _jc, served = bridged["mixtral-8x22b"]
    kw = dict(max_batch=2, cache_len=32, prefill_chunk=4, kv_bits=4)
    paged_kw = dict(kv_layout="paged", page_size=4, **kw)
    prompts = np.random.default_rng(3).integers(1, 200, (3, 7)).astype(
        np.int32)
    jeng = jengine.DecodeEngine(served, jcfg, jengine.EngineConfig(
        backend="xla_ref", **paged_kw), already_serve=True)
    want = jeng.generate(prompts, 5)
    paged = pengine.DecodeEngine(interop.params_from_numpy(qat, pcfg, "cpu"),
                                 pcfg, pengine.EngineConfig(**paged_kw),
                                 device="cpu")
    np.testing.assert_array_equal(paged.generate(prompts, 5), want)
    paged.pool.check()
    for cls in (pengine.DecodeEngine, pengine.LockstepEngine):
        eng = cls(paged.model, paged.cfg, pengine.EngineConfig(**kw),
                  already_serve=True, device="cpu")
        np.testing.assert_array_equal(eng.generate(prompts, 5), want)


def test_two_pass_serve_tokens_equal_fused(bridged):
    """The two-pass activation form (``fuse_act_quant=False``: fake_quant,
    then the plain segment GEMM) serves the same tokens as the fused
    form, on the MoE model, whose expert banks take the two-pass form
    either way."""
    _qat, _jcfg, _pcfg, model, pscfg, *_ = bridged["deepseek-moe-16b"]
    reqs = _requests(8)
    runs = []
    for fuse in (True, False):
        eng = pengine.DecodeEngine(model, pscfg, pengine.EngineConfig(
            fuse_act_quant=fuse, **ENGINE), already_serve=True,
            device="cpu")
        runs.append(_serve(eng, reqs, PRequest))
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------- live rows of each expert ----
@pytest.mark.parametrize("act_quant", [False, True])
def test_grouped_plain_rows_leave_the_other_rows(act_quant):
    """B6's plain version with ``rows`` [E]: rows 0..rows[e]-1 of expert e
    as without it, every other row left as it was (a wrapper adding into
    ``out``); ``rows=None`` is the per-expert B3 plain version, bitwise."""
    from repro_torch.kernels import packed_matmul as ppm
    rng = np.random.default_rng(9)
    e, m, kp, n = 4, 5, 64, 24
    x = torch.from_numpy((rng.standard_normal((e, m, kp)) * 1.5)
                         .astype(np.float32))
    x = x / 40.0 if act_quant else x
    wp = torch.from_numpy(rng.integers(0, 256, (e, kp // 2, n),
                                       dtype=np.uint8))
    sc = torch.from_numpy((rng.random((e, kp // 16)) * 0.2 + 0.05)
                          .astype(np.float32))
    full = ppm.grouped_matmul_plain(x, wp, sc, p=4, act_quant=act_quant)
    for i in range(e):
        one = ppm.segment_matmul_plain(x[i], wp[i], sc[i], p=4,
                                       act_quant=act_quant)
        np.testing.assert_array_equal(full[i].numpy(), one.numpy())
    rows = torch.tensor([0, 5, 2, 1], dtype=torch.int32)
    out = ppm.packed_segment_matmul_grouped(
        x, wp, sc, p=4, act_quant=act_quant, rows=rows,
        out=torch.full((e, m, n), 3.25))
    for i, r in enumerate(rows.tolist()):
        np.testing.assert_allclose(out[i, :r].numpy(),
                                   (full[i, :r] + 3.25).numpy(), **TOL)
        assert (out[i, r:] == 3.25).all()


@pytest.mark.parametrize("mode", ["per_token", "per_tensor"])
def test_grouped_driver_rows_match_jax_on_live_rows(mode):
    """The grouped driver told each expert's live rows (the dispatch
    layout: live rows first, the rest zero) gives the reference's output
    on every live row; the other rows are the bias alone."""
    _qat, jleaf, pleaf = _bank()
    rng = np.random.default_rng(4)
    rows = np.array([2, 0, 5], np.int32)
    x = (rng.standard_normal((E, M, K)) * 1.5).astype(np.float32)
    x[np.arange(M)[None, :] >= rows[:, None]] = 0.0
    jq = JQuantConfig(mode="serve", act_scale_mode=mode)
    fn = _compile_as_written(lambda leaf, v: jresolve(
        "xla_ref").packed_matmul_grouped(leaf, v, jq), jleaf, jnp.asarray(x))
    want = np.asarray(fn(jleaf, jnp.asarray(x)))
    q = PQuantConfig(mode="serve", act_scale_mode=mode)
    got = pbackend.packed_matmul_grouped(pleaf, torch.from_numpy(x), q,
                                         rows=torch.from_numpy(rows))
    bias = np.zeros((E, N), np.float32) if pleaf.get("b") is None \
        else pleaf["b"].numpy()
    for e, r in enumerate(rows):
        np.testing.assert_allclose(got[e, :r].numpy(), want[e, :r], **TOL)
        np.testing.assert_array_equal(
            got[e, r:].numpy(), np.broadcast_to(bias[e], (M - r, N)))
