"""The port's ``soniq`` façade against the reference's (``repro.soniq``)
on the CPU: the typed phases and their param schemas, ``SoniqState`` and
``with_phase``, and the NOISE -> QAT -> SERVE lifecycle through ``init``
/ ``apply`` / ``to_qat`` / ``to_serve`` on a single linear and on the
reduced h2o-danube-1.8b, each phase's ``apply`` held to the reference's on
weights carried across (NOISE on replayed draws: ``JaxDraws``), the
freeze bitwise; and the port's own rules: in-place transforms consume
their state, and a transform on the wrong phase raises."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import soniq as jsoniq
from repro.configs import get_config as jget_config
from repro.models import cnn as jcnn

from repro_torch import interop, soniq
from repro_torch.api import transforms as ptransforms
from repro_torch.configs import get_config as pget_config
from repro_torch.models import cnn as pcnn
from test_torch_cnn import _cnn_true_division
from test_torch_train import (JaxDraws, _random_s, _true_division, jax_draw,
                              linear_key_paths)

from test_torch_train import _one_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
K, N = 128, 48


def _np(t):
    return t.detach().cpu().numpy()


# ------------------------------------------------------------- phases ----
def test_phases_match_jax():
    jp, pp = jsoniq.Phase, soniq.Phase
    assert [p.name for p in pp.ALL] == [p.name for p in jp.ALL]
    for j, p in zip(jp.ALL, pp.ALL):
        assert (p.index, p.trainable, p.needs_rng, p.learned_keys) == \
            (j.index, j.trainable, j.needs_rng, j.learned_keys)
        assert repr(p) == repr(j) and p == j.name and hash(p) == hash(j)
        assert (p.next.name if p.next else None) == \
            (j.next.name if j.next else None)
        assert pp.from_mode(p.name) is p and pp.from_mode(p) is p
        assert soniq.QuantConfig(mode=p).phase is p
        assert soniq.QuantConfig().with_mode(p).mode == p.name
    with pytest.raises(ValueError) as pe:
        pp.from_mode("train")
    with pytest.raises(ValueError) as je:
        jp.from_mode("train")
    assert str(pe.value) == str(je.value)
    leaves = [{"w": 0}, {"w": 0, "b": 0}, {"w": 0, "s": 0},
              {"w": 0, "pbits": 0}, {"w4": 0, "w2": 0, "w1": 0, "perm": 0,
                                     "pbits_sorted": 0}, {"s": 0}, "w"]
    for leaf in leaves:
        assert [p.owns_leaf(leaf) for p in pp.ALL] == \
            [p.owns_leaf(leaf) for p in jp.ALL], leaf


def _schema(schema):
    return {k: None if v is None else (tuple(v[0]), str(v[1]).split(".")[-1])
            for k, v in schema.items()}


def _jschema(schema):
    return {k: None if v is None else (tuple(v.shape), str(v.dtype))
            for k, v in schema.items()}


@pytest.mark.parametrize("phase", ["fp", "noise", "qat", "serve"])
def test_param_schema_matches_jax_and_the_leaves(phase):
    """``param_schema`` against the reference's, and against the leaves
    ``linear_init`` (and, in SERVE, ``pack_linear``) make."""
    pq, jq = soniq.QuantConfig(mode="qat"), jsoniq.QuantConfig(mode="qat")
    for use_bias in (False, True):
        got = _schema(soniq.Phase.from_mode(phase).param_schema(
            K, N, pq, use_bias=use_bias))
        assert got == _jschema(jsoniq.Phase.from_mode(phase).param_schema(
            K, N, jq, use_bias=use_bias))
    state = soniq.init_linear(K, N, pq.with_mode(
        "qat" if phase == "serve" else phase), device="cpu")
    if phase == "serve":
        state = soniq.to_serve(state)
    made = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in state.params.items()}
    assert made == {k: v for k, v in got.items() if k != "b"}


# -------------------------------------------------------------- state ----
def test_state_and_with_phase():
    spec = soniq.LinearSpec(k=K, n=N, quant=soniq.QuantConfig(mode="qat"))
    state = soniq.init(spec, soniq.QuantConfig(mode=soniq.Phase.NOISE),
                       seed=3, device="cpu")
    assert state.phase is soniq.Phase.NOISE
    assert state.qcfg.mode == "noise" and state.forward_cfg.quant.mode == \
        "noise"
    assert repr(state) == "SoniqState(Phase.NOISE, model=LinearSpec)"
    assert sorted(state.params) == ["s", "w"]
    assert state.model.w.requires_grad
    moved = state.replace(phase="qat")
    assert moved.phase is soniq.Phase.QAT and moved.model is state.model
    arch = pget_config("h2o-danube-1.8b")
    assert soniq.with_phase(arch, soniq.Phase.NOISE).quant.mode == "noise"
    assert soniq.with_phase(soniq.QuantConfig(), "serve").mode == "serve"
    assert soniq.with_phase(pcnn.CNNConfig(), soniq.Phase.FP).quant.mode \
        == "fp"
    assert soniq.with_phase(spec, "noise").quant.phase is soniq.Phase.NOISE
    # Same seed, same weights; another seed, others.
    again = soniq.init(spec, soniq.QuantConfig(mode="noise"), seed=3,
                       device="cpu")
    assert torch.equal(again.model.w, state.model.w)
    assert not torch.equal(soniq.init(spec, seed=4, device="cpu").model.w,
                           state.model.w)
    with pytest.raises(ValueError, match="to_serve"):
        soniq.init(spec, soniq.QuantConfig(mode="serve"), device="cpu")


def test_transforms_consume_their_state_and_check_the_phase():
    spec = soniq.LinearSpec(k=K, n=N, quant=soniq.QuantConfig(mode="noise"))
    x = torch.randn(3, K)
    noisy = soniq.init(spec, device="cpu")
    with pytest.raises(ValueError, match="needs noise"):
        soniq.apply(noisy, x)
    with pytest.raises(ValueError, match="to_serve expects Phase.QAT"):
        soniq.to_serve(noisy)
    qat, _ = soniq.to_qat(noisy)
    assert qat.model is noisy.model and qat.phase is soniq.Phase.QAT
    for call in (lambda: soniq.apply(noisy, x, noise=0),
                 lambda: soniq.to_qat(noisy),
                 lambda: soniq.to_serve(noisy)):
        with pytest.raises(ValueError, match=r"consumed by to_qat.*"
                                             r"Phase\.QAT"):
            call()
    with pytest.raises(ValueError, match="to_qat expects Phase.NOISE"):
        soniq.to_qat(qat)
    served = soniq.to_serve(qat)
    with pytest.raises(ValueError, match=r"consumed by to_serve.*"
                                         r"Phase\.SERVE"):
        soniq.apply(qat, x)
    with pytest.raises(ValueError, match="to_qat expects Phase.NOISE"):
        soniq.to_qat(served)
    assert soniq.apply(served, x).shape == (3, N)


# ----------------------------------------------------------- lifecycle ----
def _jax_apply(state, x, **kw):
    """``repro.soniq.apply`` jitted, its abs-max scales divided truly."""
    with _true_division():
        return np.asarray(jax.jit(lambda s, xx: jsoniq.apply(s, xx, **kw))(
            state, x))


def _assert_leaves_equal(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_leaves_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_leaves_equal(g, w, f"{path}/{i}")
    elif want is None:
        assert got is None, path
    else:
        assert torch.equal(got, want), path


def _spread_s(leaf, seed):
    leaf["s"] = np.random.default_rng(seed).normal(
        -0.2, 1.5, leaf["s"].shape).astype(np.float32)
    return leaf


def test_linear_lifecycle_equals_jax():
    """NOISE -> QAT -> SERVE on one linear, the reference's weights carried
    across: every phase's ``apply`` against ``repro.soniq.apply`` (SERVE
    on the port's packed leaf, which ``tests/test_torch_pack.py`` holds
    bitwise to the reference's packing), the frozen precisions and report
    bitwise."""
    jq = jsoniq.QuantConfig(mode=jsoniq.Phase.NOISE, backend="xla_ref")
    key = jax.random.PRNGKey(0)
    jstate = jsoniq.init_linear(key, K, N, jq, use_bias=True)
    leaf = _spread_s(jax.device_get(jstate.params), 1)
    leaf["b"] = np.linspace(-1, 1, N).astype(np.float32)
    jstate = jstate.replace(params=jax.tree.map(jnp.asarray, leaf))
    spec = soniq.LinearSpec(k=K, n=N, use_bias=True,
                            quant=soniq.QuantConfig(mode="noise"))
    pstate = soniq.SoniqState(soniq.Phase.NOISE,
                              interop.linear_from_numpy(leaf, "cpu"), spec)
    x = np.random.default_rng(2).standard_normal((4, 6, K)).astype(
        np.float32)
    rng = jax.random.PRNGKey(7)

    class Draws:
        def draw(self, path, xx):
            return jax_draw(rng, tuple(xx.shape))

    with torch.no_grad():
        np.testing.assert_allclose(
            _np(soniq.apply(pstate, x, noise=Draws())),
            _jax_apply(jstate, x, rng=rng), **TOL)
        jqat, jrep = jsoniq.to_qat(jstate)
        pqat, prep = soniq.to_qat(pstate)
        assert prep == jrep
        np.testing.assert_array_equal(_np(pqat.params["pbits"]),
                                      np.asarray(jqat.params["pbits"]))
        np.testing.assert_allclose(_np(soniq.apply(pqat, x)),
                                   _jax_apply(jqat, x), **TOL)
        # A single linear keeps its trained precisions under "auto".
        want = ptransforms.convert_tree(pqat.params, pqat.qcfg,
                                        rebudget=False)
        psrv = soniq.to_serve(pqat)
        _assert_leaves_equal(psrv.params, want)
        jsrv = jqat.replace(phase="serve",
                            params=interop.linear_to_numpy(psrv.model))
        np.testing.assert_allclose(_np(soniq.apply(psrv, x)),
                                   _jax_apply(jsrv, x), **TOL)


def test_lm_lifecycle_equals_jax():
    """NOISE -> QAT -> SERVE on the reduced h2o-danube-1.8b through the
    façade: logits against the reference's in each phase (NOISE on
    replayed draws), the freeze's report and precisions bitwise; "auto"
    rebudgets the block linears, which the reference holds stacked."""
    layers = 2
    jcfg = dataclasses.replace(
        jget_config("h2o-danube-1.8b").reduced(), num_layers=layers,
        quant=jsoniq.QuantConfig(mode="noise", backend="xla_ref"))
    pcfg = dataclasses.replace(
        pget_config("h2o-danube-1.8b").reduced(), num_layers=layers,
        quant=soniq.QuantConfig(mode="noise"))
    jstate = jsoniq.init(jcfg, rng=jax.random.PRNGKey(0))
    tree = _random_s(jax.device_get(jstate.params),
                     np.random.default_rng(5))
    jstate = jstate.replace(params=jax.tree.map(jnp.asarray, tree))
    pstate = soniq.SoniqState(soniq.Phase.NOISE,
                              interop.params_from_numpy(tree, pcfg, "cpu"),
                              pcfg)
    tokens = np.random.default_rng(6).integers(
        0, pcfg.vocab_size, (2, 16)).astype(np.int32)
    rng = jax.random.PRNGKey(9)

    def jax_logits(state, **kw):
        return _jax_apply(state, tokens, **kw)

    with torch.no_grad():
        got = soniq.apply(pstate, tokens, noise=JaxDraws(
            linear_key_paths(rng, layers)))
        np.testing.assert_allclose(_np(got), jax_logits(jstate, rng=rng),
                                   **TOL)
        jqat, jrep = jsoniq.to_qat(jstate)
        pqat, prep = soniq.to_qat(pstate)
        assert prep == jrep
        ptree = interop.tree_to_numpy(pqat.model)
        np.testing.assert_array_equal(
            ptree["groups"][0]["attn"]["wq"]["pbits"],
            np.asarray(jqat.params["groups"][0]["attn"]["wq"]["pbits"]))
        np.testing.assert_allclose(_np(soniq.apply(pqat, tokens)),
                                   jax_logits(jqat), **TOL)
        want = ptransforms.convert_tree(pqat.model.tree(), pqat.qcfg,
                                        rebudget=True)
        psrv = soniq.to_serve(pqat)
        _assert_leaves_equal(psrv.model.tree(), want)
        jsrv = jqat.replace(phase="serve",
                            params=interop.tree_to_numpy(psrv.model))
        np.testing.assert_allclose(_np(soniq.apply(psrv, tokens)),
                                   jax_logits(jsrv), **TOL)


def test_cnn_state_through_the_facade_equals_jax():
    """``soniq.init`` / ``apply`` on a CNNConfig: a QAT CNN's logits
    against the reference's on the same weights."""
    jc = jcnn.CNNConfig(channels=(32, 32), quant=jsoniq.QuantConfig(
        mode="qat", backend="xla_ref"))
    pc = pcnn.CNNConfig(channels=(32, 32),
                        quant=soniq.QuantConfig(mode="qat"))
    jstate = jsoniq.init(jc, rng=jax.random.PRNGKey(1))
    state = soniq.init(pc, device="cpu")
    assert isinstance(state.model, pcnn.CNN) and state.phase is \
        soniq.Phase.QAT
    state = soniq.SoniqState(soniq.Phase.QAT, interop.cnn_from_numpy(
        jax.device_get(jstate.params), pc, "cpu"), pc)
    x = np.random.default_rng(3).standard_normal((2, 8, 8, 3)).astype(
        np.float32)
    with _cnn_true_division():
        want = np.asarray(jax.jit(lambda s, xx: jsoniq.apply(s, xx))(
            jstate, x))
    with torch.no_grad():
        np.testing.assert_allclose(_np(soniq.apply(state, x)), want, **TOL)
