"""Port parity for the dense configs starcoder2-7b (biases, non-gated
gelu, Hk = 4), deepseek-67b and mistral-large-123b, reduced: the configs
equal the reference's field by field; decode and chunked-prefill logits
match the JAX package (``xla_ref``) at 1e-4 on the same packed weights;
the port's ``DecodeEngine`` emits the JAX ``DecodeEngine``'s greedy
tokens; and starcoder2-7b, the dense family's representative in
tests/test_serve_families.py, keeps them with speculative decoding on."""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import quant as jquant
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro.serve.scheduler import Request as JRequest

from repro_torch import interop
from repro_torch.api import transforms as ptransforms
from repro_torch.configs import get_config as pget_config
from repro_torch.models import lm as plm
from repro_torch.serve import engine as pengine
from repro_torch.serve.scheduler import Request as PRequest

from test_torch_train import _one_thread  # noqa: F401

ARCHS = ("starcoder2-7b", "deepseek-67b", "mistral-large-123b")
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
ENGINE = dict(max_batch=3, cache_len=32, prefill_chunk=4)


def _compile_as_written(fn, *args):
    """As tests/test_torch_serve.py compiles the reference's steps: bf16
    rounded after every op, the activation scale's division kept true."""
    top = jquant._static_grid_max
    with mock.patch.object(jquant, "_static_grid_max", lambda p:
                           jax.lax.optimization_barrier(jnp.float32(top(p)))):
        return jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})


def _stacked(tree):
    """The port's per-layer serve tree -> the JAX layout."""
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
    """{arch: (jax qat cfg, port qat cfg, port serve cfg, port serve
    model, the packed tree in the JAX layout)}: one JAX QAT init a config,
    packed by the port."""
    out = {}
    for arch in ARCHS:
        jcfg, pcfg = jget_config(arch).reduced(), pget_config(arch).reduced()
        pscfg = dataclasses.replace(pcfg, quant=dataclasses.replace(
            pcfg.quant, mode="serve", act_scale_mode="per_token"))
        qat = jax.device_get(jlm.init_params(jax.random.PRNGKey(0), jcfg))
        tree = ptransforms.convert_tree(
            interop.params_from_numpy(qat, pcfg, "cpu").tree(), pscfg.quant,
            rebudget=True)
        out[arch] = (jcfg, pcfg, pscfg, plm.LM(pscfg, tree), _stacked(tree))
    return out


_JAX_TOKENS = {}


def _requests(cls):
    rng = np.random.default_rng(1)
    return [cls(prompt=rng.integers(1, 100, (n,)), max_new_tokens=m, seed=i)
            for i, (n, m) in enumerate(zip((3, 9, 5), (5, 4, 4)))]


def _tokens_of(eng, reqs):
    got = {c.request_id: c.tokens for c in eng.serve(reqs)}
    return {k - min(got): v for k, v in got.items()}


def _jax_tokens(bridged, arch):
    """The JAX ``DecodeEngine``'s greedy tokens on the port's packed tree
    (one engine a config, shared by the tests)."""
    if arch not in _JAX_TOKENS:
        jcfg, *_rest, served = bridged[arch]
        eng = jengine.DecodeEngine(served, jcfg, jengine.EngineConfig(
            backend="xla_ref", **ENGINE), already_serve=True)
        _JAX_TOKENS[arch] = _tokens_of(eng, _requests(JRequest))
    return _JAX_TOKENS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_the_reference(arch):
    want = dataclasses.asdict(jget_config(arch))
    got = dataclasses.asdict(pget_config(arch))
    want.pop("quant")
    got.pop("quant")
    assert got == want
    assert dataclasses.asdict(pget_config(arch).reduced())["d_model"] == \
        jget_config(arch).reduced().d_model


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(bridged, arch):
    """fp32, batch 2: a chunked prefill of prompts of 9 and 4 tokens
    (padding lanes), then three decode steps, each step's logits at
    1e-4."""
    jcfg, _pcfg, pscfg, model, served = bridged[arch]
    jscfg = dataclasses.replace(jcfg, quant=dataclasses.replace(
        jcfg.quant, mode="serve", act_scale_mode="per_token",
        backend="xla_ref"))
    rng = np.random.default_rng(2)
    b, c, lens = 2, 4, (9, 4)
    prompts = [rng.integers(0, pscfg.vocab_size, n).astype(np.int32)
               for n in lens]
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
        plan.append(("decode", (rng.integers(0, pscfg.vocab_size, b).astype(
            np.int32), fed + t)))
    jcache = jlm.init_cache(jscfg, b, 32, jnp.float32)
    pcache = plm.init_cache(pscfg, b, 32, torch.float32, device="cpu")
    steps = {"prefill": lambda p, cc, *a: jlm.prefill_step(p, jscfg, cc, *a),
             "decode": lambda p, cc, *a: jlm.decode_step(p, jscfg, cc, *a)}
    compiled = {}
    for kind, args in plan:
        if kind not in compiled:
            compiled[kind] = _compile_as_written(steps[kind], served, jcache,
                                                 *args)
        want, jcache = compiled[kind](served, jcache, *args)
        step = plm.prefill_step if kind == "prefill" else plm.decode_step
        got, pcache = step(model, pscfg, pcache, *args)
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_engine_tokens_equal_jax(bridged, arch):
    """The reference's family request set (tests/test_serve_families.py):
    the port's greedy tokens equal the JAX ``DecodeEngine``'s, and its
    lockstep engine's on a same-length batch equal its continuous
    engine's."""
    _jcfg, _pcfg, pscfg, model, _served = bridged[arch]
    eng = pengine.DecodeEngine(model, pscfg, pengine.EngineConfig(**ENGINE),
                               already_serve=True, device="cpu")
    got = _tokens_of(eng, _requests(PRequest))
    want = _jax_tokens(bridged, arch)
    assert set(got) == set(want) == {0, 1, 2}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    lock = pengine.LockstepEngine(model, pscfg, pengine.EngineConfig(
        **ENGINE), already_serve=True, device="cpu")
    prompts = np.random.default_rng(3).integers(1, 100, (3, 5)).astype(
        np.int32)
    np.testing.assert_array_equal(eng.generate(prompts, 4),
                                  lock.generate(prompts, 4))


def test_starcoder2_spec_parity(bridged):
    """The dense leg of the reference's ``test_family_spec_parity``:
    speculative decoding (k = 2) keeps the greedy tokens, which equal the
    JAX engine's."""
    _jcfg, _pcfg, pscfg, model, _served = bridged["starcoder2-7b"]
    eng = pengine.DecodeEngine(model, pscfg, pengine.EngineConfig(
        spec_tokens=2, **ENGINE), already_serve=True, device="cpu")
    got = _tokens_of(eng, _requests(PRequest))
    want = _jax_tokens(bridged, "starcoder2-7b")
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    st = eng.spec_stats()
    assert st["rounds"] > 0 and st["drafted"] == 2 * st["rounds"]
