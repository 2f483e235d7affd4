"""Port parity for two-phase SONIQ training: the NOISE and QAT linear
rules (forward and gradients), the Phase I -> II boundary (Problem 1,
PatternMatch, freeze), AdamW, the token stream, one ``train_step`` and the
whole ``loop.train`` against the JAX package on the reduced fp32
h2o-danube-1.8b.

JAX draws Phase I's noise from threefry; the port cannot, so every NOISE
comparison replays JAX's draws: ``JaxDraws`` derives each linear's key as
the reference's forward splits it and hands the port the same weight seed
and activation noise. No test compares runs whose draws differ.

The JAX steps are jitted with the two abs-max scale divisions kept true
divisions (``_true_division``): XLA otherwise turns ``/ 1.875`` into a
multiply by the reciprocal, one ulp off for some maxima, where the port
(like the Pallas kernels) divides.
"""
import contextlib
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import transforms as jtransforms
from repro.configs import get_config as jget_config
from repro.core import noise as jnoise
from repro.core import patterns as jpatterns
from repro.core import quant as jquant
from repro.core import schedule as jschedule
from repro.core import smol as jsmol
from repro.core.qtypes import QuantConfig as JQuantConfig
from repro.data import synthetic as jsynthetic
from repro.models import attention as jattention
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.train import loop as jloop
from repro.train import state as jstate

from repro_torch import interop
from repro_torch.api import transforms as ptransforms
from repro_torch.configs import get_config as pget_config
from repro_torch.core import noise as pnoise
from repro_torch.core import patterns as ppatterns
from repro_torch.core import schedule as pschedule
from repro_torch.core import smol as psmol
from repro_torch.core.qtypes import QuantConfig as PQuantConfig
from repro_torch.models import attention as pattention
from repro_torch.data import synthetic as psynthetic
from repro_torch.models import lm as plm
from repro_torch.optim import adamw as padamw
from repro_torch.optim import schedules as pschedules
from repro_torch.train import loop as ploop
from repro_torch.train import state as pstate

ARCH = "h2o-danube-1.8b"
SSM_ARCH = "mamba2-2.7b"
WHISPER_ARCH = "whisper-medium"
GELU_ARCH = "starcoder2-7b"       # the dense family's non-gated gelu MLP
LINEARS = ("attn.wq", "attn.wk", "attn.wv", "attn.wo", "mlp.up",
           "mlp.gate", "mlp.down")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch in each of the port's test modules
    (they import this fixture): the suite runs several workers on the
    CPU's cores, and a full thread pool in each worker oversubscribes
    them; the models here are small."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- helpers ----
def _configs(layers=2, arch=ARCH, **narrow):
    """The reduced ``arch`` at ``layers`` layers in both packages;
    ``narrow`` replaces more fields (an encoder's depth, the widths)."""
    j = jget_config(arch).reduced()
    j = dataclasses.replace(j, num_layers=layers, quant=dataclasses.replace(
        j.quant, backend="xla_ref"), **narrow)
    p = dataclasses.replace(pget_config(arch).reduced(), num_layers=layers,
                            **narrow)
    return j, p


@contextlib.contextmanager
def _true_division():
    """Trace the reference with its abs-max scales divided truly."""
    top, eps = jquant._static_grid_max, jquant.ACT_SCALE_EPS

    def barrier(p):
        return jax.lax.optimization_barrier(jnp.float32(top(p)))

    def abs_max_scale(x, axis=None, grid_p=4, eps=eps):
        m = jnp.max(jnp.abs(jnp.asarray(x, jnp.float32)), axis=axis,
                    keepdims=True)
        return jax.lax.stop_gradient(jnp.maximum(m, eps) / barrier(grid_p))

    def per_group_weight_scale(w, group_size=16, grid_p=4, eps=eps):
        k = w.shape[0]
        wg = jnp.abs(jnp.asarray(w, jnp.float32)).reshape(
            k // group_size, group_size, -1)
        m = jnp.max(wg, axis=(1, 2))
        return jax.lax.stop_gradient(jnp.maximum(m, eps) / barrier(grid_p))

    with mock.patch.object(jquant, "abs_max_scale", abs_max_scale), \
            mock.patch.object(jquant, "per_group_weight_scale",
                              per_group_weight_scale):
        yield


def linear_key_paths(rng, num_layers, ssm=False, enc_layers=0,
                     gated=True):
    """{port linear path: its JAX key} as ``lm.forward`` splits ``rng``
    (group fold_in, per-layer scan split, block split in 4, attention's
    (qkv, o) split then qkv in 3, the MLP's split in 3; with ``ssm``, the
    block's third key to the mixer, split in 2 for ``in_proj`` and
    ``out_proj``). With ``enc_layers`` the encoder-decoder's: the encoder
    scans its layers under ``rng`` itself (no fold_in), and each decoder
    block's second key goes to its cross attention. An MLP without a
    gate (``gated=False``: gelu) takes the first and third of its three
    keys for ``up`` and ``down``."""
    out = {}

    def blocks(key, count, prefix, cross):
        for i in range(count):
            key, sub = jax.random.split(key)
            rs = jax.random.split(sub, 4)
            if ssm:
                kin, kout = jax.random.split(rs[2])
                out[f"{prefix}.{i}.mamba.in_proj"] = kin
                out[f"{prefix}.{i}.mamba.out_proj"] = kout
                continue
            parts = [("attn", rs[0])] + ([("cross", rs[1])] if cross
                                         else [])
            for part, k in parts:
                a, ao = jax.random.split(k)
                q3 = jax.random.split(a, 3)
                for name, kk in zip(("wq", "wk", "wv"), q3):
                    out[f"{prefix}.{i}.{part}.{name}"] = kk
                out[f"{prefix}.{i}.{part}.wo"] = ao
            m3 = jax.random.split(rs[3], 3)
            for name, kk in zip(("up", "gate", "down"), m3):
                if gated or name != "gate":
                    out[f"{prefix}.{i}.mlp.{name}"] = kk

    if enc_layers:
        blocks(rng, enc_layers, "enc_blocks", False)
    blocks(jax.random.fold_in(rng, 0), num_layers, "blocks",
           bool(enc_layers))
    return out


def key_paths_of(rng, pcfg):
    """``linear_key_paths`` of the port config's family and depth."""
    return linear_key_paths(rng, pcfg.num_layers,
                            ssm=pcfg.family == "ssm",
                            enc_layers=pcfg.encoder_layers,
                            gated=pcfg.mlp_act == "swiglu")


# Mel frames a batch row of the encoder-decoder's training batches.
FRAMES = 24


def with_frames(batch, cfg, rng):
    """``batch`` with mel frames [B, FRAMES, frontend_dim] fp32 drawn from
    ``rng`` (a numpy Generator) where ``cfg`` has an encoder; else
    ``batch`` itself."""
    if not cfg.encoder_layers:
        return batch
    b = np.asarray(batch["tokens"]).shape[0]
    return dict(batch, frames=rng.standard_normal(
        (b, FRAMES, cfg.frontend_dim)).astype(np.float32))


def jax_draw(key, shape, dtype=jnp.float32):
    """The reference's draws of one NOISE linear call with ``key``."""
    kw, kx = jax.random.split(key)
    seed = int(jax.random.bits(kw, (), jnp.uint32))
    eps = np.asarray(jax.random.uniform(kx, shape, dtype, -1.0, 1.0))
    return psmol.NoiseDraw(seed=torch.tensor([seed]),
                           act_eps=torch.tensor(eps))


class JaxDraws:
    """A port noise source replaying the reference's draws by path (each
    drawn once: a recomputed block reads the same draw)."""

    def __init__(self, keys):
        self.keys = keys
        self.drawn = {}

    def draw(self, path, x):
        at = (path, tuple(x.shape))
        if at not in self.drawn:
            self.drawn[at] = jax_draw(self.keys[path], tuple(x.shape))
        return self.drawn[at]


def _jax_params(cfg, seed=0):
    return jax.device_get(jlm.init_params(jax.random.PRNGKey(seed), cfg))


def _random_s(tree, rng):
    """Spread the Phase-I logits so the boundary has mixed precisions."""
    for lin in _stacked_linears(tree):
        lin["s"] = rng.normal(-0.2, 1.5, lin["s"].shape).astype(np.float32)
    return tree


def _quantized_nodes(node):
    """The (w, s) or (w, pbits) leaves of a subtree, dict keys sorted."""
    if not isinstance(node, dict):
        return []
    if "w" in node and ("s" in node or "pbits" in node):
        return [node]
    return [q for k in sorted(node) for q in _quantized_nodes(node[k])]


def _stacked_linears(tree):
    """The stacked quantized linears: an encoder's first (its attention
    and MLP), then the decoder's (attention, cross attention, MLP); a
    hybrid unit's sublayer by sublayer (``sub{i}``, sorted), its linears
    and expert banks sorted by path."""
    blk = tree["groups"][0]
    if "sub0" in blk:
        return _quantized_nodes(blk)
    if "mamba" in blk:
        return [blk["mamba"][n] for n in ("in_proj", "out_proj")]
    out = []
    for group in tree.get("enc_groups", []) + [blk]:
        for part in ("attn", "cross"):
            if part in group:
                out += [group[part][n] for n in ("wq", "wk", "wv", "wo")]
        out += [group["mlp"][n] for n in ("up", "gate", "down")
                if n in group["mlp"]]
    return out


def _assert_tree_close(port_tree, jax_tree, rtol, atol, path=""):
    if isinstance(jax_tree, dict):
        for k, v in jax_tree.items():
            _assert_tree_close(port_tree[k], v, rtol, atol, f"{path}/{k}")
        return
    if isinstance(jax_tree, (list, tuple)):
        for i, v in enumerate(jax_tree):
            _assert_tree_close(port_tree[i], v, rtol, atol, f"{path}/{i}")
        return
    np.testing.assert_allclose(np.asarray(port_tree, np.float64),
                               np.asarray(jax_tree, np.float64), rtol=rtol,
                               atol=atol, err_msg=path)


def _abs_diffs(port_tree, jax_tree):
    if isinstance(jax_tree, dict):
        return [d for k, v in jax_tree.items()
                for d in _abs_diffs(port_tree[k], v)]
    if isinstance(jax_tree, (list, tuple)):
        return [d for i, v in enumerate(jax_tree)
                for d in _abs_diffs(port_tree[i], v)]
    return [np.abs(np.asarray(port_tree, np.float64)
                   - np.asarray(jax_tree, np.float64)).ravel()]


# ------------------------------------------------------------ linears ----
@pytest.mark.parametrize("k,n", [(64, 48), (128, 96)])
@pytest.mark.parametrize("mode", ["noise", "qat"])
def test_linear_rule_and_grads_equal_jax(mode, k, n):
    rng = np.random.default_rng(k + n)
    jq = JQuantConfig(mode=mode, backend="xla_ref")
    pq = PQuantConfig(mode=mode)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    x = rng.standard_normal((2, 5, k)).astype(np.float32)
    g = rng.standard_normal((2, 5, n)).astype(np.float32)
    leaf = {"w": w}
    if mode == "noise":
        leaf["s"] = rng.normal(-0.5, 1.5, k // 16).astype(np.float32)
    else:
        leaf["pbits"] = rng.choice(np.array([1, 2, 4], np.int8), k // 16)
    key = jax.random.PRNGKey(k * n)
    names = ("w", "s") if mode == "noise" else ("w",)

    def jloss(wts, x_):
        p = dict(leaf, **dict(zip(names, wts)))
        y = jsmol.linear_apply(p, x_, jq, key if mode == "noise" else None)
        return jnp.sum(y * g), y

    with _true_division():
        (_, jy), (jgw, jgx) = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True))(
            tuple(jnp.asarray(leaf[n_]) for n_ in names), jnp.asarray(x))
    lin = psmol.SmolLinear({nm: torch.tensor(v) for nm, v in leaf.items()})
    lin.requires_grad_(True)
    xt = torch.tensor(x, requires_grad=True)
    draw = jax_draw(key, x.shape) if mode == "noise" else None
    y = psmol.linear_apply(lin.leaf(), xt, pq, draw)
    (y * torch.tensor(g)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **tol)
    for nm, jgrad in zip(names, jgw):
        np.testing.assert_allclose(getattr(lin, nm).grad.numpy(),
                                   np.asarray(jgrad), **tol, err_msg=nm)


@pytest.mark.parametrize("window", [None, 8])
def test_full_and_chunked_attention_equal_jax(window):
    """The training attention paths (dense, and in query blocks with the
    sliding-window key band) against the reference's at fp32."""
    rng = np.random.default_rng(6)
    b, s, hk, g, d = 2, 32, 2, 2, 8
    q = rng.standard_normal((b, s, hk, g, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    pos = np.tile(np.arange(s), (b, 1))
    kw = dict(causal=True, window=window)
    jfull = jattention.full_attention(q, k, v, pos, pos, **kw)
    jchunk = jattention.chunked_attention(q, k, v, pos, pos, q_block=8,
                                          **kw)
    tq, tk, tv, tp = (torch.tensor(a) for a in (q, k, v, pos))
    pfull = pattention.full_attention(tq, tk, tv, tp, tp, **kw)
    pchunk = pattention.chunked_attention(tq, tk, tv, tp, tp, q_block=8,
                                          **kw)
    for got, want in ((pfull, jfull), (pchunk, jchunk), (pchunk, jfull)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


def test_noise_readouts_equal_jax():
    """core.noise: the init logits and band thresholds, the soft bit count
    and its penalty, the readout and snap, the activation noise on a given
    draw and the weight projection."""
    rng = np.random.default_rng(12)
    s = np.concatenate([rng.normal(0, 3, 200), [jnoise.T_4B, jnoise.T_2B,
                                               8.0, -8.0]]).astype(np.float32)
    ts = torch.tensor(s)
    for p in (1, 2, 4):
        assert pnoise.s_init(p) == jnoise.s_init(p)
        np.testing.assert_array_equal(pnoise.init_s(5, p).numpy(),
                                      np.asarray(jnoise.init_s(5, p)))
    assert (pnoise.T_4B, pnoise.T_2B, pnoise.S_4B, pnoise.S_2B,
            pnoise.S_1B) == (jnoise.T_4B, jnoise.T_2B, jnoise.S_4B,
                             jnoise.S_2B, jnoise.S_1B)
    tol = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pnoise.bits_soft(ts).numpy(),
                               np.asarray(jnoise.bits_soft(s)), **tol)
    np.testing.assert_allclose(float(pnoise.bit_penalty(ts)),
                               float(jnoise.bit_penalty(s)), rtol=1e-6)
    raw = np.linspace(0.5, 4.5, 81).astype(np.float32)
    np.testing.assert_array_equal(pnoise.snap_124(torch.tensor(raw)).numpy(),
                                  np.asarray(jnoise.snap_124(raw)))
    away = s[np.abs(jnoise.bits_soft(s) - 1.0 - np.round(
        jnoise.bits_soft(s) - 1.0) - 0.5) > 1e-4]          # off the .5 ties
    np.testing.assert_array_equal(
        pnoise.precision_from_s(torch.tensor(away)).numpy(),
        np.asarray(jnoise.precision_from_s(away)))
    w = rng.normal(0, 1.2, (64, 8)).astype(np.float32)
    sg = s[:4]
    np.testing.assert_allclose(
        pnoise.clip_weights(torch.tensor(w), torch.tensor(sg)).numpy(),
        np.asarray(jnoise.clip_weights(w, sg)), **tol)
    x = rng.normal(0, 1, (3, 64)).astype(np.float32)
    eps = rng.uniform(-1, 1, x.shape).astype(np.float32)
    sx = np.float32(0.7)
    want = x + sx * np.repeat(np.asarray(jnoise.sigma(sg)), 16) * eps
    np.testing.assert_allclose(
        pnoise.inject_act_noise(torch.tensor(x), torch.tensor(sg),
                                torch.tensor(eps), sx).numpy(), want, **tol)
    pb = rng.choice(np.array([4, 2, 1], np.int8), 24)
    assert ppatterns.metadata_ints(pb) == jpatterns.metadata_ints(pb)


# ----------------------------------------------------------- boundary ----
@pytest.mark.parametrize("hist", [(64, 32, 32), (512, 0, 0), (16, 48, 192),
                                  (2000, 352, 96)])
@pytest.mark.parametrize("np_patterns", [4, 8, 45])
def test_solve_problem1_equals_jax(hist, np_patterns):
    allowed = jpatterns.patterns_for(np_patterns)
    assert ppatterns.patterns_for(np_patterns) == allowed
    j = jpatterns.solve_problem1(*hist, allowed)
    p = ppatterns.solve_problem1(*hist, allowed)
    assert (p.num_vectors, p.counts, p.capacity) == \
        (j.num_vectors, j.counts, j.capacity)


# The encoder at 12 layers and narrow width: its layer indices sort
# differently as strings ("10" before "2").
DEEP_ENCODER = dict(encoder_layers=12, d_model=64, num_heads=2, d_ff=128)


@pytest.mark.parametrize("arch,num_patterns,narrow", [
    (ARCH, 4, {}), (ARCH, 6, {}), (SSM_ARCH, 4, {}), (SSM_ARCH, 6, {}),
    (WHISPER_ARCH, 4, {}), (WHISPER_ARCH, 6, {}),
    (WHISPER_ARCH, 6, DEEP_ENCODER)],
    ids=["4", "6", "ssm-4", "ssm-6", "whisper-4", "whisper-6",
         "whisper-enc12-6"])
def test_freeze_qat_equals_jax(arch, num_patterns, narrow):
    """pattern_match_params / freeze_qat on the same trained logits: the
    same frozen pbits per linear, the same report (per-layer histograms,
    vectors, bpp, allowed patterns). On the SSM the mixer's two linears,
    ``in_proj`` before ``out_proj``, then the layer. On the
    encoder-decoder the encoder's stacked linears first, path by path with
    the layers inside each path, then the decoder's (cross attention
    included); the histograms too come in the reference's order."""
    jcfg, pcfg = _configs(arch=arch, **narrow)
    jcfg = jcfg.with_quant_mode("noise")
    jq = dataclasses.replace(jcfg.quant, num_patterns=num_patterns)
    pq = dataclasses.replace(pcfg.quant, mode="noise",
                             num_patterns=num_patterns)
    tree = _random_s(_jax_params(jcfg), np.random.default_rng(num_patterns))
    jnew, jrep = jtransforms.freeze_qat(tree, jq)
    model = interop.params_from_numpy(tree, pcfg, "cpu")
    assert pschedule.collect_histograms(model, pq) == \
        jschedule.collect_histograms(tree, jq)
    _, prep = ptransforms.freeze_qat(model, pq)
    assert prep["allowed"] == jrep["allowed"]
    assert prep["layers"] == jrep["layers"]
    assert pschedule.average_bpp(prep) == jschedule.average_bpp(jrep)
    ptree = interop.tree_to_numpy(model)
    for jl, pl in zip(_stacked_linears(jnew), _stacked_linears(ptree)):
        assert "s" not in pl
        np.testing.assert_array_equal(pl["pbits"], np.asarray(jl["pbits"]))


# -------------------------------------------------------------- optim ----
def test_adamw_step_equals_jax():
    jcfg, pcfg = _configs(layers=1)
    tree = _jax_params(jcfg.with_quant_mode("noise"))
    model = interop.params_from_numpy(tree, pcfg, "cpu")
    rng = np.random.default_rng(4)
    grads_np = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32)
        if np.issubdtype(a.dtype, np.floating) else None, tree)
    cfg = jadamw.AdamWConfig(lr=1e-2)
    jstate_ = jadamw.init_state(tree)
    upd = jax.jit(lambda t, g, s, lr: jadamw.apply_updates(t, g, s, cfg,
                                                           lr_scale=lr))
    new, jst, jm = upd(tree, grads_np, jstate_, 0.7)
    new, jst, jm = upd(new, grads_np, jst, 0.5)
    pst = padamw.init_state(model)
    pgrads = {n: torch.tensor(a) for n, a in _flat_port(grads_np, pcfg)}
    pcfg_opt = padamw.AdamWConfig(lr=1e-2)
    padamw.apply_updates(model, pgrads, pst, pcfg_opt, lr_scale=0.7)
    pm = padamw.apply_updates(model, pgrads, pst, pcfg_opt, lr_scale=0.5)
    np.testing.assert_allclose(float(pm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    _assert_tree_close(interop.tree_to_numpy(model), jax.device_get(new),
                       rtol=1e-6, atol=1e-6)


def test_adamw_chunked_update_is_the_whole_leaf_update(monkeypatch):
    """AdamW updates a leaf in chunks of ``UPDATE_CHUNK`` elements (the
    fp32 temporaries of a full-width table would not fit beside it on the
    card); every chunking gives the whole leaf's update bitwise: the
    parameters and both moments, with decay (``w``) and at the ``s``
    rate."""
    _, pcfg = _configs(layers=1)
    rng = np.random.default_rng(9)
    runs = []
    for chunk in (1 << 26, 1000, 7):
        monkeypatch.setattr(padamw, "UPDATE_CHUNK", chunk)
        model = plm.init_params(pcfg.with_quant_mode("noise"), seed=0,
                                device="cpu")
        grads = {n: torch.tensor(rng.standard_normal(p.shape).astype(
            np.float32)) for n, p in padamw.trainable(model)}
        rng = np.random.default_rng(9)
        st = padamw.init_state(model)
        for lr_scale in (0.7, 0.5):
            padamw.apply_updates(model, grads, st, padamw.AdamWConfig(),
                                 lr_scale=lr_scale)
        runs.append([t.clone() for _n, p in padamw.trainable(model)
                     for t in (p, st["mu"][_n], st["nu"][_n])])
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert torch.equal(a, b)


def _flat_port(tree, pcfg):
    """A JAX-layout tree -> (port parameter path, array) pairs."""
    out = [("embed.table", tree["embed"]["table"]),
           ("final_norm.g", tree["final_norm"]["g"]),
           ("lm_head.w", tree["lm_head"]["w"])]
    blk = tree["groups"][0]
    for i in range(pcfg.num_layers):
        out.append((f"blocks.{i}.ln_attn.g", blk["ln_attn"]["g"][i]))
        out.append((f"blocks.{i}.ln_ffn.g", blk["ln_ffn"]["g"][i]))
        for name in LINEARS:
            a, b = name.split(".")
            for leaf, arr in blk[a][b].items():
                if arr is not None:
                    out.append((f"blocks.{i}.{name}.{leaf}", arr[i]))
    return out


# --------------------------------------------------------------- data ----
def test_token_stream_equals_jax():
    jc = jsynthetic.TokenStreamConfig(vocab_size=500, seq_len=12,
                                      batch_size=3, seed=5)
    pc = psynthetic.TokenStreamConfig(vocab_size=500, seq_len=12,
                                      batch_size=3, seed=5)
    jb, pb = jsynthetic.TokenStream(jc).batches(), \
        psynthetic.TokenStream(pc).batches()
    for _ in range(3):
        a, b = next(jb), next(pb)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])


# --------------------------------------------------------- train step ----
@pytest.mark.parametrize("arch,mode", [
    (ARCH, "qat"), (ARCH, "noise"), (SSM_ARCH, "qat"), (SSM_ARCH, "noise"),
    (GELU_ARCH, "qat"), (GELU_ARCH, "noise")],
    ids=["qat", "noise", "ssm-qat", "ssm-noise", "gelu-qat", "gelu-noise"])
def test_train_step_equals_jax(arch, mode):
    """One step of the 2-layer reduced fp32 model from the same weights
    and batch (NOISE on replayed draws): the loss and the gradient norm
    within rtol 1e-5; the updated parameters within 2e-6 absolute but for
    at most 1 in 10,000 elements, and all within lr / 10 = 1e-4. Adam's
    first update g / (|g| + eps) is about sign(g), so a gradient that
    differs by summation order barely moves it, except where the gradient
    cancels to within ~1e-8 of zero and eps = 1e-8 makes the update
    sensitive: measured, 1 element of 32,768 of one weight, off by 3.3e-6
    (QAT) and 2.7e-5 (NOISE). On the SSM (the mixer's fp leaves train
    too) and on starcoder2-7b (the gelu MLP, biases) the same bounds."""
    jcfg, pcfg = _configs(arch=arch)
    jcfg, pcfg = jcfg.with_quant_mode(mode), pcfg.with_quant_mode(mode)
    tree = _jax_params(jcfg)
    tcfg_kw = dict(warmup=1, t1=1 if mode == "noise" else 0, t2=4)
    jt = jstate.TrainConfig(adamw=jadamw.AdamWConfig(lr=1e-3), **tcfg_kw)
    pt = pstate.TrainConfig(adamw=padamw.AdamWConfig(lr=1e-3), **tcfg_kw)
    batch = next(jsynthetic.TokenStream(jsynthetic.TokenStreamConfig(
        vocab_size=jcfg.vocab_size, seq_len=16, batch_size=2,
        seed=1)).batches())
    rng = jax.random.PRNGKey(17)
    jst = {"params": tree, "opt": jadamw.init_state(tree),
           "step": jnp.ones((), jnp.int32)}
    with _true_division():
        step = jax.jit(lambda s, b, r: jstate.train_step(s, b, jcfg, jt, r))
        jnew, jm = step(jst, {k: jnp.asarray(v) for k, v in batch.items()},
                        rng)
    model = interop.params_from_numpy(tree, pcfg, "cpu")
    pst = pstate.init_state(pcfg, pt, model=model)
    pst["step"] = 1
    draws = JaxDraws(key_paths_of(rng, pcfg))
    pst, pm = pstate.train_step(pst, batch, pcfg, pt,
                                (lambda i: draws) if mode == "noise"
                                else None)
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(pm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    diffs = np.concatenate(_abs_diffs(interop.tree_to_numpy(model),
                                      jax.device_get(jnew["params"])))
    assert diffs.max() <= 1e-4
    assert (diffs > 2e-6).mean() <= 1e-4


def test_microbatches_average_their_gradients():
    """A 2-microbatch step equals AdamW on the mean of the two
    microbatches' gradients (each halved, then summed), bit for bit. Held
    within the port: against the reference, the batch-1 microbatch of this
    batch puts the abs-max activation of block 0 on the STE knife edge
    (|x / s| = 1.875 -+ 1 ulp, ROADMAP §C)."""
    microbatch_case(ARCH)


def microbatch_case(arch):
    """``test_microbatches_average_their_gradients`` on the reduced
    ``arch``."""
    _, pcfg = _configs(arch=arch)
    pcfg = pcfg.with_quant_mode("qat")
    batch = with_frames(next(psynthetic.TokenStream(
        psynthetic.TokenStreamConfig(vocab_size=pcfg.vocab_size,
                                     seq_len=16, batch_size=2,
                                     seed=1)).batches()),
        pcfg, np.random.default_rng(1))
    tcfg = pstate.TrainConfig(num_microbatches=2, warmup=1, t1=0, t2=4)
    stepped = pstate.init_state(pcfg, tcfg, model=plm.init_params(
        pcfg, seed=0, device="cpu"))
    stepped, met = pstate.train_step(stepped, batch, pcfg, tcfg)
    manual = pstate.init_state(pcfg, tcfg, model=plm.init_params(
        pcfg, seed=0, device="cpu"))
    params = padamw.trainable(manual["model"])
    total, loss = None, 0.0
    for mb in pstate.split_microbatches(batch, 2):
        lmb, _ = plm.loss_fn(manual["model"], mb, pcfg)
        g = torch.autograd.grad(lmb, [p for _, p in params])
        g = [t / 2 for t in g]
        total = g if total is None else [a + b for a, b in zip(total, g)]
        loss = loss + lmb.detach() / 2
    padamw.apply_updates(manual["model"], {n: t for (n, _), t in
                                          zip(params, total)},
                         manual["opt"], tcfg.adamw,
                         lr_scale=pschedules.two_phase(
                             0, t1=tcfg.t1, warmup=tcfg.warmup,
                             total=tcfg.t2, phase2_mult=tcfg.phase2_lr_mult))
    assert float(met["loss"]) == float(loss)
    for (n, a), (_, b) in zip(padamw.trainable(stepped["model"]), params):
        assert torch.equal(a, b), n


def test_recomputed_blocks_see_the_same_noise():
    """The port's own Phase-I draws (``StepNoise``) are keyed by the
    linear's path, so recomputing each block in the backward gives the
    gradients of the plain backward bit for bit, and a second draw of the
    same (key, path) is the same noise."""
    recompute_case(ARCH)
    src = psmol.StepNoise((1, 0, 0))
    x = torch.zeros(2, 3, 128)
    d1, d2 = src.draw("blocks.0.attn.wq", x), src.draw("blocks.0.attn.wq", x)
    d3 = src.draw("blocks.0.attn.wk", x)
    assert torch.equal(d1.seed, d2.seed) and torch.equal(d1.act_eps,
                                                         d2.act_eps)
    assert not torch.equal(d1.act_eps, d3.act_eps)


def recompute_case(arch):
    """A NOISE loss and its gradients with every block recomputed in the
    backward equal the plain backward's, bit for bit (reduced ``arch``)."""
    _, pcfg = _configs(arch=arch)
    pcfg = pcfg.with_quant_mode("noise")
    batch = with_frames(next(psynthetic.TokenStream(
        psynthetic.TokenStreamConfig(vocab_size=pcfg.vocab_size,
                                     seq_len=16, batch_size=2,
                                     seed=4)).batches()),
        pcfg, np.random.default_rng(4))
    grads = {}
    for remat in ("full", "none"):
        cfg = dataclasses.replace(pcfg, remat=remat)
        model = plm.init_params(cfg, seed=0, device="cpu")
        model.requires_grad_(True)
        loss, _ = plm.loss_fn(model, batch, cfg, psmol.StepNoise((1, 0, 0)))
        grads[remat] = (loss.item(), torch.autograd.grad(
            loss, list(model.parameters())))
    assert grads["full"][0] == grads["none"][0]
    for a, b in zip(grads["full"][1], grads["none"][1]):
        assert torch.equal(a, b)


def test_loop_train_equals_jax():
    """loop.train with t1 = 2, t2 = 4 from the reference's initial model
    (logits spread so the boundary mixes precisions) on the same batches
    and replayed draws: the loss history within 1e-4 and the frozen pbits
    and pattern report equal to the reference's."""
    assert_loop_train_equal(*loop_train_runs(ARCH))


LOOP_TK = dict(t1=2, t2=4, warmup=1, seed=3)


def loop_stream(jcfg):
    """The loop runs' batches (the reference's token stream; an
    encoder-decoder's with mel frames from ``default_rng(2)``)."""
    rng = np.random.default_rng(2)
    return (with_frames(b, jcfg, rng) for b in jsynthetic.TokenStream(
        jsynthetic.TokenStreamConfig(vocab_size=jcfg.vocab_size,
                                     seq_len=16, batch_size=2,
                                     seed=2)).batches())


def loop_train_runs(arch, jax_ckpt=None, port_ckpt=None, stream=None,
                    narrow=None, draws=None):
    """The reference's ``loop.train`` and the port's on the reduced
    ``arch`` (``LOOP_TK``; ``narrow``: more config fields, as
    ``_configs`` takes them) from the reference's initial model, its
    logits spread, on the same batches (``stream(jcfg)``, default
    ``loop_stream``) and replayed draws (``draws(key, pcfg)``, default
    ``JaxDraws`` of ``key_paths_of``); each checkpoints every 2 steps
    into its directory when given one. Returns (the reference's output,
    the port's)."""
    stream = stream or loop_stream
    draws = draws or (lambda key, cfg: JaxDraws(key_paths_of(key, cfg)))
    jcfg, pcfg = _configs(arch=arch, **(narrow or {}))
    ck = dict(checkpoint_every=2)
    jt = jstate.TrainConfig(ckpt_dir=jax_ckpt, **ck, **LOOP_TK)
    pt = pstate.TrainConfig(ckpt_dir=port_ckpt, **ck, **LOOP_TK)
    tree = _random_s(jax.device_get(jstate.init_state(
        jax.random.PRNGKey(jt.seed), jcfg.with_quant_mode("noise"),
        jt)["params"]), np.random.default_rng(8))
    real_init = jstate.init_state

    def init_with(key, cfg, tcfg):
        st = real_init(key, cfg, tcfg)
        st["params"] = jax.tree.map(jnp.asarray, tree)
        return st

    with _true_division(), mock.patch.object(jstate, "init_state",
                                             init_with):
        jout = jloop.train(jcfg, jt, stream(jcfg))

    def noise(step):
        src = draws(jax.random.fold_in(jax.random.PRNGKey(jt.seed + 1),
                                       step), pcfg)
        return lambda i: src

    pout = ploop.train(pcfg, pt, stream(jcfg), device="cpu",
                       noise=noise,
                       model=interop.params_from_numpy(tree, pcfg, "cpu"))
    return jout, pout


def assert_loop_train_equal(jout, pout):
    """The history within 1e-4, the pattern report and every frozen pbits
    equal, the precisions mixed."""
    assert [m["phase"] for m in pout["history"]] == [1, 1, 2, 2]
    np.testing.assert_allclose([m["loss"] for m in pout["history"]],
                               [m["loss"] for m in jout["history"]],
                               rtol=1e-4, atol=1e-4)
    assert pout["pattern_report"]["allowed"] == \
        jout["pattern_report"]["allowed"]
    assert pout["pattern_report"]["layers"] == \
        jout["pattern_report"]["layers"]
    ptree = interop.tree_to_numpy(pout["state"]["model"])
    jtree = jax.device_get(jout["state"]["params"])
    bits = [np.asarray(lin["pbits"]) for lin in _stacked_linears(jtree)]
    assert len({int(b) for arr in bits for b in arr.ravel()}) > 1
    for jl, pl in zip(_stacked_linears(jtree), _stacked_linears(ptree)):
        np.testing.assert_array_equal(pl["pbits"], np.asarray(jl["pbits"]))
