"""Port parity for the serve path: decode and chunked-prefill logits
against the JAX package (``xla_ref``) on the same bridged weights, greedy
tokens of the port's ``DecodeEngine`` against the JAX ``DecodeEngine``,
and the port's continuous engine against its lockstep engine.

The logit checks compile the reference's steps as the program is written
(``_compile_as_written``): XLA may otherwise keep fp32 across bf16 ops
(excess precision) and turn the activation scale's ``/ 1.875`` into a
multiply by the reciprocal, one ulp off for some maxima. The Pallas
self-scale kernel keeps that division true with a barrier
(``repro/kernels/packed_matmul.py``, ``_fused_selfscale_kernel``), and the
port divides everywhere. Either rewrite moves a bf16 activation across a
rounding tie, and requantization turns that into whole grid steps."""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import ArchConfig as JArchConfig
from repro.core import quant as jquant
from repro.core.qtypes import QuantConfig as JQuantConfig
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro.serve.scheduler import Request as JRequest

from repro_torch import interop
from repro_torch.api import transforms as ptransforms
from repro_torch.configs import get_config as pget_config
from repro_torch.configs.base import ArchConfig as PArchConfig
from repro_torch.core.qtypes import QuantConfig as PQuantConfig
from repro_torch.models import attention as pattention
from repro_torch.models import blocks as pblocks
from repro_torch.models import common as pcommon
from repro_torch.models import lm as plm
from repro_torch.serve import engine as pengine
from repro_torch.serve.scheduler import Request as PRequest

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
AS_WRITTEN = {"xla_allow_excess_precision": False}


def _tiny_kw(dtype="float32"):
    return dict(name="t", family="dense", num_layers=2, d_model=64,
                num_heads=2, num_kv_heads=2, d_ff=128, vocab_size=128,
                head_dim=32, dtype=dtype, param_dtype="float32",
                q_block=32)


def _configs(arch, dtype="float32"):
    if arch == "tiny":
        kw = _tiny_kw(dtype)
        return (JArchConfig(quant=JQuantConfig(mode="qat"), **kw),
                PArchConfig(quant=PQuantConfig(mode="qat"), **kw))
    return (jget_config(arch).reduced(), pget_config(arch).reduced())


def _serve(jcfg, pcfg):
    jq = dataclasses.replace(jcfg.quant, mode="serve",
                             act_scale_mode="per_token", backend="xla_ref")
    pq = dataclasses.replace(pcfg.quant, mode="serve",
                             act_scale_mode="per_token")
    return (dataclasses.replace(jcfg, quant=jq),
            dataclasses.replace(pcfg, quant=pq))


def _stacked(tree):
    """The port's per-layer serve tree -> the JAX package's layout (numpy
    leaves, one stacked ``groups`` entry for the dense plan)."""
    def host(node):
        if isinstance(node, dict):
            return {k: host(v) for k, v in node.items()}
        return None if node is None else node.numpy()
    blocks = [host(b) for b in tree["blocks"]]
    out = {k: host(v) for k, v in tree.items() if k != "blocks"}
    out["groups"] = [jax.tree.map(lambda *xs: np.stack(xs), *blocks)]
    return out


@pytest.fixture(scope="module")
def bridged():
    """{arch: (jax serve cfg, port serve cfg, jax serve params, port
    model, jax QAT params, jax cfg, port cfg)} from one JAX QAT init per
    arch. The port packs (bit-equal to the JAX packing:
    tests/test_torch_pack.py) and the packed leaves go back to the JAX
    layout, so both packages run the same served weights."""
    out = {}
    for arch in ("tiny", "h2o-danube-1.8b"):
        jcfg, pcfg = _configs(arch)
        qat = jax.device_get(jlm.init_params(jax.random.PRNGKey(0), jcfg))
        tree = ptransforms.convert_tree(
            interop.params_from_numpy(qat, pcfg, "cpu").tree(), pcfg.quant,
            rebudget=True)
        served = _stacked(tree)
        variants = [(arch, "float32")]
        if arch == "tiny":
            variants.append(("tiny-bf16", "bfloat16"))
        for name, dtype in variants:
            jd, pd = (dataclasses.replace(c, dtype=dtype)
                      for c in (jcfg, pcfg))
            jscfg, pscfg = _serve(jd, pd)
            out[name] = (jscfg, pscfg, served, plm.LM(pscfg, tree), qat,
                         jd, pd)
    return out


def _compile_as_written(fn, *args):
    """``fn`` jitted for ``args``, with bf16 rounded after every op and the
    activation scale's division by the grid top kept a true division (see
    the module note)."""
    top = jquant._static_grid_max
    with mock.patch.object(jquant, "_static_grid_max", lambda p:
                           jax.lax.optimization_barrier(jnp.float32(top(p)))):
        return jax.jit(fn).lower(*args).compile(compiler_options=AS_WRITTEN)


def _drive(bridged_entry, plan, batch, cache_len):
    """Run the same prefill/decode plan through both packages; yield
    (jax logits, port logits) per step."""
    jscfg, pscfg, served, model, *_ = bridged_entry
    jcache = jlm.init_cache(jscfg, batch, cache_len, jnp.float32)
    pcache = plm.init_cache(pscfg, batch, cache_len, torch.float32,
                            device="cpu")
    steps = {"prefill": lambda p, c, *a: jlm.prefill_step(p, jscfg, c, *a),
             "decode": lambda p, c, *a: jlm.decode_step(p, jscfg, c, *a)}
    compiled = {}
    for kind, args in plan:
        key = (kind,) + tuple(np.shape(a) for a in args)
        if key not in compiled:
            compiled[key] = _compile_as_written(steps[kind], served, jcache,
                                                *args)
        jl, jcache = compiled[key](served, jcache, *args)
        if kind == "prefill":
            pl, pcache = plm.prefill_step(model, pscfg, pcache, *args)
        else:
            pl, pcache = plm.decode_step(model, pscfg, pcache, *args)
        yield np.asarray(jl), pl.numpy()


def _plan(rng, vocab, lens, chunk, decode_steps):
    """Chunked prefill of prompts of ``lens`` (padding lanes -1), then
    greedy-free decode steps on random tokens."""
    b = len(lens)
    plan = []
    fed = np.zeros(b, np.int64)
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in lens]
    while (fed < np.asarray(lens)).any():
        tokens = np.zeros((b, chunk), np.int32)
        pos = np.full((b, chunk), -1, np.int32)
        last = np.zeros(b, np.int32)
        for i in range(b):
            n = min(chunk, lens[i] - fed[i])
            if n <= 0:
                continue
            tokens[i, :n] = prompts[i][fed[i]:fed[i] + n]
            pos[i, :n] = fed[i] + np.arange(n)
            last[i] = n - 1
            fed[i] += n
        plan.append(("prefill", (tokens, pos, last)))
    for t in range(decode_steps):
        tokens = rng.integers(0, vocab, b).astype(np.int32)
        plan.append(("decode", (tokens, (fed + t).astype(np.int32))))
    return plan


@pytest.mark.parametrize("arch", ["tiny", "h2o-danube-1.8b"])
def test_prefill_and_decode_logits_match_jax(bridged, arch):
    """fp32: chunked prefill (with padding lanes) then decode steps. On the
    reduced h2o-danube the positions run past its 64-token window, so the
    ring wraps and the sliding-window mask bites."""
    pcfg = bridged[arch][1]
    lens = (70, 37) if arch != "tiny" else (9, 4)
    plan = _plan(np.random.default_rng(1), pcfg.vocab_size, lens, 8, 4)
    for jl, pl in _drive(bridged[arch], plan, 2, 64):
        assert np.isfinite(pl).all()
        np.testing.assert_allclose(pl, jl, **LOGIT_TOL)


def test_bf16_logits_close_to_jax(bridged):
    """bf16 compute on the tiny config (the bf16 round trips of the
    activation prologue, norms, RoPE, attention and SwiGLU are live): the
    logits hold the fp32 bound and every step's greedy pick is JAX's."""
    pcfg = bridged["tiny-bf16"][1]
    plan = _plan(np.random.default_rng(2), pcfg.vocab_size, (9, 4), 4, 6)
    for jl, pl in _drive(bridged["tiny-bf16"], plan, 2, 32):
        assert np.isfinite(pl).all()
        np.testing.assert_allclose(pl, jl, **LOGIT_TOL)
        np.testing.assert_array_equal(pl.argmax(-1), jl.argmax(-1))


def test_bf16_blocks_bit_identical_teacher_forced(bridged):
    """bf16 on the tiny config, one block at a time: at every step of the
    plan each block of the JAX package gets the port's input to it and the
    port's cache before the step, so nothing can cascade. Every live
    lane's output is bit-identical."""
    jscfg, pscfg, served, model, *_ = bridged["tiny-bf16"]
    plan = _plan(np.random.default_rng(2), pscfg.vocab_size, (9, 4), 4, 6)
    cache = plm.init_cache(pscfg, 2, 32, torch.float32, device="cpu")
    compiled = {}
    checked = 0
    for kind, args in plan:
        tokens, pos = (args[0], args[1]) if kind == "prefill" else \
            (args[0][:, None], args[1][:, None])
        x = pcommon.embed_lookup(model.embed.table,
                                 torch.as_tensor(tokens, dtype=torch.int64),
                                 torch.bfloat16)
        posb = torch.as_tensor(pos, dtype=torch.int64)
        rope = pcommon.rope_tables(posb, pscfg.hd, pscfg.rope_theta)
        write = pattention.ring_write_index(pos, 32, "cpu")
        for i, block in enumerate(model.blocks):
            layer = jax.tree.map(lambda a: a[i], served["groups"][0])
            kv = {k: jnp.asarray(v.numpy())
                  for k, v in cache["layers"][i]["kv"].items()}
            args_j = (layer, jnp.asarray(x.float().numpy(), jnp.bfloat16),
                      {"kv": kv}, jnp.asarray(pos, jnp.int32))
            if pos.shape not in compiled:
                compiled[pos.shape] = _compile_as_written(
                    lambda p, h, c, q: jblocks.block_decode(
                        p, "attn_mlp", h, c, q, jscfg, jscfg.quant),
                    *args_j)
            want, _ = compiled[pos.shape](*args_j)
            x = pblocks.block_decode(block, x, cache["layers"][i], posb,
                                     pscfg, pscfg.quant, rope=rope,
                                     write=write)
            live = pos >= 0
            np.testing.assert_array_equal(
                x.float().numpy()[live],
                np.asarray(want.astype(jnp.float32))[live])
            checked += 1
    assert checked == 2 * len(plan)


def _mixed_prompts(rng, lens=(3, 7, 5, 2, 9), news=(4, 8, 3, 6, 5)):
    return [(rng.integers(1, 100, (n,)).astype(np.int32), m)
            for n, m in zip(lens, news)]


def test_decode_engine_tokens_equal_jax_decode_engine(bridged):
    """The JAX suite's mixed-request set (tests/test_serve_scheduler.py)
    on its tiny config: both engines pack the same QAT weights at
    construction and must emit identical greedy tokens."""
    *_, qat, jcfg, pcfg = bridged["tiny"]
    jeng = jengine.DecodeEngine(
        qat, jcfg, jengine.EngineConfig(max_batch=3, cache_len=64,
                                        prefill_chunk=4, backend="xla_ref"))
    peng = pengine.DecodeEngine(
        interop.params_from_numpy(qat, pcfg, "cpu"), pcfg,
        pengine.EngineConfig(max_batch=3, cache_len=64, prefill_chunk=4),
        device="cpu")
    reqs = _mixed_prompts(np.random.default_rng(0))
    want = {c.request_id: c.tokens for c in jeng.serve(
        [JRequest(prompt=p, max_new_tokens=n, seed=i)
         for i, (p, n) in enumerate(reqs)])}
    got = {c.request_id: c.tokens for c in peng.serve(
        [PRequest(prompt=p, max_new_tokens=n, seed=i)
         for i, (p, n) in enumerate(reqs)])}
    assert set(got) == set(want) == set(range(len(reqs)))
    for i in range(len(reqs)):
        np.testing.assert_array_equal(got[i], want[i])


@pytest.mark.parametrize("arch", ["tiny", "h2o-danube-1.8b"])
def test_continuous_equals_lockstep(bridged, arch):
    _jscfg, pscfg, _served, model, *_ = bridged[arch]
    ecfg = pengine.EngineConfig(max_batch=3, cache_len=64, prefill_chunk=4)
    lock = pengine.LockstepEngine(model, pscfg, ecfg, already_serve=True,
                                  device="cpu")
    cont = pengine.DecodeEngine(model, pscfg, ecfg, already_serve=True,
                                device="cpu")
    reqs = _mixed_prompts(np.random.default_rng(5))
    ref = {i: lock.generate(p[None], n)[0] for i, (p, n) in enumerate(reqs)}
    got = {c.request_id: c.tokens for c in cont.serve(
        [PRequest(prompt=p, max_new_tokens=n, seed=i)
         for i, (p, n) in enumerate(reqs)])}
    for i in range(len(reqs)):
        np.testing.assert_array_equal(got[i], ref[i])
    # Same-length prompts as one lockstep batch, and through generate().
    prompts = np.random.default_rng(6).integers(1, 100, (3, 6)).astype(
        np.int32)
    np.testing.assert_array_equal(cont.generate(prompts, 5),
                                  lock.generate(prompts, 5))


def test_temperature_sampling_reproducible(bridged):
    _jscfg, pscfg, _served, model, *_ = bridged["tiny"]
    eng = pengine.DecodeEngine(
        model, pscfg, pengine.EngineConfig(max_batch=3, cache_len=64,
                                           prefill_chunk=4),
        already_serve=True, device="cpu")

    def run(offset):
        eng.reset()
        got = {c.request_id: c.tokens for c in eng.serve(
            [PRequest(prompt=p, max_new_tokens=n, seed=offset + i,
                      temperature=0.8)
             for i, (p, n) in enumerate(
                 _mixed_prompts(np.random.default_rng(4)))])}
        return [got[k] for k in sorted(got)]

    a, b = run(0), run(0)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert any(not np.array_equal(x, y) for x, y in zip(a, run(100)))


def test_cancel_queued_and_active(bridged):
    _jscfg, pscfg, _served, model, *_ = bridged["tiny"]
    eng = pengine.DecodeEngine(
        model, pscfg, pengine.EngineConfig(max_batch=1, cache_len=64),
        already_serve=True, device="cpu")
    a = eng.submit(PRequest(prompt=np.arange(1, 5), max_new_tokens=6))
    b = eng.submit(PRequest(prompt=np.arange(1, 3), max_new_tokens=6))
    eng.step()
    assert eng.cancel(b).finish_reason == "evicted"        # queued
    comp = eng.cancel(a)                                   # active
    assert comp.finish_reason == "evicted" and eng.cancel(a) is None
    assert not eng.sched.has_work()
    assert eng.sched.free_slots == [0]


def test_jax_layout_serve_tree_bridges_back(bridged):
    """Serve leaves in the JAX layout (stacked [L, ...], None wscale
    allowed) unstack into the same per-layer modules."""
    _jscfg, pscfg, served, model, *_ = bridged["h2o-danube-1.8b"]
    again = interop.params_from_numpy(served, pscfg, "cpu")
    for a, b in zip(again.blocks, model.blocks):
        for name, t in b.attn.wo.leaf().items():
            np.testing.assert_array_equal(getattr(a.attn.wo, name).numpy(),
                                          t.numpy())


def test_packed_model_bytes_counts_carriers(bridged):
    _jscfg, pscfg, served, model, *_ = bridged["h2o-danube-1.8b"]
    assert pengine.packed_model_bytes(model) == \
        jengine.packed_model_bytes(served)
    with pytest.raises(ValueError, match="unknown leaf"):
        pengine.packed_model_bytes({"mystery": torch.zeros(3)})


def test_entry_points_need_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dataclasses.replace(pget_config("h2o-danube-1.8b").reduced(),
                              num_layers=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        plm.init_params(cfg)
    model = plm.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pengine.DecodeEngine(model, cfg, pengine.EngineConfig())
    for bad in (dict(kv_bits=4), dict(kv_layout="paged"),
                dict(spec_tokens=2)):
        with pytest.raises(NotImplementedError):
            pengine.DecodeEngine(model, cfg, pengine.EngineConfig(**bad),
                                 device="cpu")
