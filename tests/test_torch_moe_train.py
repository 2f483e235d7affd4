"""Port parity for MoE training, against the JAX package on the CPU.

The pieces: an expert bank's NOISE and QAT rules (kernels B9 and B8 over
the whole bank, one call each way) against the reference's ``vmap`` of
``smol.linear_apply``, the bank forms of the plain kernel versions against
E calls of the 2-D ones, and the training ``moe_apply`` (static capacity
with drops, the combine, the shared experts, the load-balancing loss) with
its gradients. The slice: one ``train_step`` in NOISE and QAT on reduced
deepseek-moe-16b (its dense first layer and one MoE layer with a shared
expert) and reduced mixtral-8x22b (window 64), the boundary's pattern
report and per-expert precisions, and the launcher.

Phase I's draws are replayed from the reference's key tree (``MoEDraws``):
``moe_apply`` splits its key in 3 for the up, gate and down banks, each
bank splits its key in E, one an expert, and the shared MLP reuses the up
bank's key. The JAX steps are jitted with the abs-max scale divisions kept
true divisions (``_true_division``, as ``tests/test_torch_train.py``).
Routing is discrete, so each comparison asserts the expert ids (and the
capacity mask) first. The ``moe_apply`` test routes its inputs so that
expert 0 overflows its capacity and assignments are dropped.
"""
import dataclasses
import math
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import transforms as jtransforms
from repro.configs import get_config as jget_config
from repro.core import smol as jsmol
from repro.core.qtypes import QuantConfig as JQuantConfig
from repro.data import synthetic as jsynthetic
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.optim import adamw as jadamw

from repro_torch import interop
from repro_torch.api import transforms as ptransforms
from repro_torch.backend import base as pbase
from repro_torch.configs import get_config as pget_config
from repro_torch.core import schedule as pschedule
from repro_torch.core import smol as psmol
from repro_torch.core.qtypes import QuantConfig as PQuantConfig
from repro_torch.kernels import fake_quant as pfq
from repro_torch.kernels import noise_inject as pni
from repro_torch.launch import train as ptrain_launch
from repro_torch.models import moe as pmoe
from repro_torch.optim import adamw as padamw
from repro_torch.train import state as pstate

from test_torch_train import _true_division, jax_draw
from test_torch_train import _one_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ("deepseek-moe-16b", "mixtral-8x22b")
# The dense first layer and one MoE layer; one MoE layer.
LAYERS = {"deepseek-moe-16b": 2, "mixtral-8x22b": 1}


# ------------------------------------------------------------- helpers ----
class MoEDraws:
    """A port noise source replaying the reference's draws by path; a
    bank's key splits in E, one an expert (``moe._expert_linear``). Each
    draw is made once: a recomputed block reads the same draw."""

    def __init__(self, keys):
        self.keys = keys
        self.drawn = {}

    def draw(self, path, x, experts=None):
        at = (path, tuple(x.shape), experts)
        if at not in self.drawn:
            self.drawn[at] = self._draw(self.keys[path], x, experts)
        return self.drawn[at]

    @staticmethod
    def _draw(key, x, experts):
        if experts is None:
            return jax_draw(key, tuple(x.shape))
        draws = [jax_draw(k, tuple(x.shape[1:]))
                 for k in jax.random.split(key, experts)]
        return psmol.NoiseDraw(
            seed=torch.cat([d.seed for d in draws]),
            act_eps=torch.stack([d.act_eps for d in draws]))


def _moe_keys(key, prefix):
    """{path: key} of one ``moe_apply`` call: split in 3 for the banks;
    the shared MLP reuses the up bank's key (``moe.py:147``, ``:167``)
    and splits it in 3 for its linears."""
    r3 = jax.random.split(key, 3)
    out = {f"{prefix}moe.{n}": k for n, k in zip(("up", "gate", "down"), r3)}
    s3 = jax.random.split(r3[0], 3)
    out.update({f"{prefix}moe.shared.{n}": k
                for n, k in zip(("up", "gate", "down"), s3)})
    return out


def _block_keys(key, kind, p):
    """{path: key} of one block (prefix ``p``) as ``blocks.block_apply``
    splits ``key`` in 4: attention (qkv, o), then qkv in 3, from the
    first; a Mamba2 mixer's (``in_proj``, ``out_proj``) from the third;
    the MLP (in 3) or the MoE from the fourth."""
    rs = jax.random.split(key, 4)
    out = {}
    if kind.startswith("mamba"):
        kin, kout = jax.random.split(rs[2])
        out.update({p + "mamba.in_proj": kin, p + "mamba.out_proj": kout})
    else:
        a, ao = jax.random.split(rs[0])
        q3 = jax.random.split(a, 3)
        out.update({p + "attn.wq": q3[0], p + "attn.wk": q3[1],
                    p + "attn.wv": q3[2], p + "attn.wo": ao})
    if "moe" in kind:
        out.update(_moe_keys(rs[3], p))
    elif kind != "mamba":
        out.update({f"{p}mlp.{n}": k for n, k in zip(
            ("up", "gate", "down"), jax.random.split(rs[3], 3))})
    return out


def model_key_paths(rng, cfg):
    """{port path: JAX key} of every NOISE linear and bank as ``lm.forward``
    splits ``rng``: a fold_in per plan group, a split per layer of the
    group's scan, the block's split in 4 (``_block_keys``). A hybrid unit
    is one layer of its group's scan: its sublayer i (port block ``u *
    attn_every + i``) takes ``fold_in(the unit's key, i)``
    (``blocks.py:102``) and splits that in 4."""
    out, layer = {}, 0
    for gi, (kind, count) in enumerate(cfg.layer_plan()):
        key = jax.random.fold_in(rng, gi)
        subs = cfg.hybrid_unit_kinds() if kind == "hybrid_unit" else None
        for _ in range(count):
            key, sub = jax.random.split(key)
            if subs is None:
                out.update(_block_keys(sub, kind, f"blocks.{layer}."))
                layer += 1
                continue
            for i, sub_kind in enumerate(subs):
                out.update(_block_keys(jax.random.fold_in(sub, i), sub_kind,
                                       f"blocks.{layer}."))
                layer += 1
    return out


def _configs(arch, mode):
    layers = LAYERS[arch]
    j = dataclasses.replace(jget_config(arch).reduced(), num_layers=layers)
    j = dataclasses.replace(j, quant=dataclasses.replace(
        j.quant, backend="xla_ref")).with_quant_mode(mode)
    p = dataclasses.replace(pget_config(arch).reduced(),
                            num_layers=layers).with_quant_mode(mode)
    return j, p


def _tree(jcfg, seed):
    """A NOISE or QAT tree in the JAX layout (``jax.eval_shape`` of
    ``lm.init_params``, filled from numpy: the JAX init of expert banks
    takes tens of seconds on the CPU): weights N(0, 1/K), logits spread
    over the three bands, precisions from {1, 2, 4}."""
    shapes = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    rng = np.random.default_rng(seed)

    def fill(path, a):
        name = path[-1].key
        if name == "pbits":
            return rng.choice(np.array([1, 2, 4], a.dtype), a.shape)
        if name == "s":
            return rng.normal(-0.2, 1.5, a.shape).astype(a.dtype)
        if name in ("g", "b"):
            return np.full(a.shape, name == "g", a.dtype)
        std = 0.02 if name == "table" else 1 / np.sqrt(a.shape[-2])
        return (rng.standard_normal(a.shape) * std).astype(a.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


# ----------------------------------------------------------------- bank ----
E, C, K, N = 3, 5, 64, 48


def _bank_leaf(mode, rng):
    w = (rng.standard_normal((E, K, N)) / np.sqrt(K)).astype(np.float32)
    w[1] *= 3.0                       # experts with different scales
    leaf = {"w": w}
    if mode == "noise":
        leaf["s"] = rng.normal(-0.5, 1.5, (E, K // 16)).astype(np.float32)
    else:
        leaf["pbits"] = rng.choice(np.array([1, 2, 4], np.int8),
                                   (E, K // 16))
    return leaf


@pytest.mark.parametrize("act", ["per_tensor", "per_token"])
@pytest.mark.parametrize("mode", ["noise", "qat"])
def test_bank_rule_and_grads_equal_jax_vmap(mode, act):
    """A bank's rule on x [E, C, K] (empty capacity rows, an expert with
    10x inputs) against the reference's ``vmap`` of ``linear_apply`` with
    one key an expert: y, dx, dw and ds within 1e-5."""
    rng = np.random.default_rng(len(mode) * 7 + len(act))
    leaf = _bank_leaf(mode, rng)
    x = rng.standard_normal((E, C, K)).astype(np.float32)
    x[:, -2:] = 0.0
    x[2] *= 10.0
    g = rng.standard_normal((E, C, N)).astype(np.float32)
    jq = JQuantConfig(mode=mode, backend="xla_ref", act_scale_mode=act)
    pq = PQuantConfig(mode=mode, act_scale_mode=act)
    key = jax.random.PRNGKey(41)
    names = ("w", "s") if mode == "noise" else ("w",)

    def jloss(wts, x_):
        p = dict(leaf, **dict(zip(names, wts)))
        if mode == "noise":
            y = jax.vmap(lambda p_, xe, r: jsmol.linear_apply(p_, xe, jq, r)
                         )(p, x_, jax.random.split(key, E))
        else:
            y = jax.vmap(lambda p_, xe: jsmol.linear_apply(p_, xe, jq, None)
                         )(p, x_)
        return jnp.sum(y * g), y

    with _true_division():
        (_, jy), (jgw, jgx) = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True))(
            tuple(jnp.asarray(leaf[n_]) for n_ in names), jnp.asarray(x))
    bank = pmoe.ExpertBank({n_: torch.tensor(v) for n_, v in leaf.items()})
    bank.path = "bank"
    bank.requires_grad_(True)
    xt = torch.tensor(x, requires_grad=True)
    y = bank(xt, pq, MoEDraws({"bank": key}))
    (y * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **TOL)
    for nm, jgrad in zip(names, jgw):
        np.testing.assert_allclose(getattr(bank, nm).grad.numpy(),
                                   np.asarray(jgrad), **TOL, err_msg=nm)


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def test_bank_plain_versions_are_per_expert_calls_bitwise():
    """The bank forms of the plain kernel versions (B9 and B8 forward and
    backward, both B8 layouts and scale kinds) against E calls of the 2-D
    forms on the slices, bit for bit: each expert its own seed, logits,
    precisions and scales."""
    rng = np.random.default_rng(3)
    e, k, n, m = 3, 64, 40, 6
    w = torch.tensor(rng.uniform(-2.3, 2.3, (e, k, n)).astype(np.float32))
    s = torch.tensor(rng.normal(-0.5, 2.0, (e, k // 16)).astype(np.float32))
    seeds = torch.tensor([7, 2 ** 32 - 1, 12345], dtype=torch.int64)
    g = torch.tensor(rng.standard_normal((e, k, n)).astype(np.float32))
    sig = pni.group_sigma(s)
    got = pni.noise_inject_plain(w, sig, seeds)
    dw, ds = pni.noise_inject_bwd_plain(w, s, seeds, g)
    assert got.shape == w.shape and ds.shape == s.shape
    for i in range(e):
        assert torch.equal(got[i], pni.noise_inject_plain(
            w[i], sig[i], int(seeds[i])))
        dwi, dsi = pni.noise_inject_bwd_plain(w[i], s[i], int(seeds[i]),
                                              g[i])
        assert torch.equal(_bits(dw[i]), _bits(dwi))
        assert torch.equal(ds[i], dsi)
    pb = torch.tensor(rng.choice([1.0, 2.0, 4.0], (e, k // 16)),
                      dtype=torch.float32)
    sw = torch.tensor(rng.uniform(0.05, 0.5, (e, k // 16)),
                      dtype=torch.float32)
    x = torch.tensor(rng.standard_normal((e, m, k)).astype(np.float32)
                     ).to(torch.bfloat16)
    gx = torch.tensor(rng.standard_normal((e, m, k)).astype(np.float32)
                      ).to(torch.bfloat16)
    s_tensor = x.float().abs().amax(dim=(1, 2)).repeat_interleave(m) / 1.875
    s_token = x.float().abs().amax(dim=2).reshape(-1) / 1.875
    cases = [(w, sw, g, dict(row_scale=False, k_dim=0)),
             (x, s_tensor, gx, dict(row_scale=True)),
             (x, s_token, gx, dict(row_scale=True))]
    for xx, sc, gg, kw in cases:
        y = pfq.fake_quant_plain(xx, pb, sc, **kw)
        dx = pfq.fake_quant_bwd_plain(xx, pb, sc, gg, **kw)
        rows = sc.reshape(e, -1)
        for i in range(e):
            assert torch.equal(_bits(y[i]), _bits(pfq.fake_quant_plain(
                xx[i], pb[i], rows[i], **kw)))
            assert torch.equal(_bits(dx[i]), _bits(pfq.fake_quant_bwd_plain(
                xx[i], pb[i], rows[i], gg[i], **kw)))
    # The autograd ops take the bank through the same entry.
    wt = w.clone().requires_grad_(True)
    st = s.clone().requires_grad_(True)
    (pbase.noise_inject(wt, st, seeds) * g).sum().backward()
    assert torch.equal(_bits(wt.grad), _bits(dw)) and torch.equal(st.grad,
                                                                   ds)


# ------------------------------------------------------------ moe_apply ----
def _jax_route(layer, xt, e, top_k, cap):
    """The reference's routing and capacity mask (``moe.py:117-131``)."""
    probs = jax.nn.softmax(jnp.asarray(xt) @ layer["router"]["w"], -1)
    _g, ids = jax.lax.top_k(probs, top_k)
    flat = ids.reshape(-1)
    order = jnp.argsort(flat, stable=True)
    start = jnp.searchsorted(flat[order], jnp.arange(e))
    rank_sorted = jnp.arange(flat.shape[0]) - start[flat[order]]
    rank = jnp.zeros_like(rank_sorted).at[order].set(rank_sorted)
    return np.asarray(ids), np.asarray(rank < cap)


@pytest.fixture(scope="module")
def moe_layers():
    """{(arch, mode): (jax cfg, port cfg, JAX layer tree, port MoE)} of
    the first MoE layer of each reduced arch."""
    out = {}
    for arch in ARCHS:
        for mode in ("noise", "qat"):
            jcfg, pcfg = _configs(arch, mode)
            tree = _tree(jcfg, 5)
            layer = jax.tree.map(lambda a: a[0], tree["groups"][-1]["moe"])
            model = interop.params_from_numpy(tree, pcfg, "cpu")
            moe = [b for b in model.blocks if b.kind == "attn_moe"][0].moe
            out[arch, mode] = (jcfg, pcfg, layer, moe)
    return out


@pytest.mark.parametrize("mode", ["noise", "qat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_training_moe_apply_and_grads_equal_jax(moe_layers, arch, mode):
    """Training ``moe_apply`` on 2 x 9 tokens routed so that expert 0
    overflows its capacity: the expert ids and the keep mask equal, then y
    and the load-balancing loss within 1e-5, then ``jax.grad`` of
    sum(y * g) + aux against x and every parameter, router included
    (rtol 1e-5, atol 1e-5 times the leaf's largest gradient: each sums up
    to F, C or T products in an order of each package's own)."""
    jcfg, pcfg, layer, moe = moe_layers[arch, mode]
    e, k = pcfg.num_experts, pcfg.top_k
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 9, pcfg.d_model)).astype(np.float32)
    # Reflect each token to the positive side of u and point the router's
    # expert-0 column along u: expert 0 scores high for every token.
    u = np.ones(pcfg.d_model, np.float32) / np.sqrt(pcfg.d_model)
    x -= 2.0 * np.minimum(x @ u, 0.0)[..., None] * u
    layer = jax.tree.map(lambda a: a, layer)
    router = np.array(layer["router"]["w"])
    router[:, 0] = 4.0 * u
    layer["router"]["w"] = jnp.asarray(router)
    moe.router.w.data.copy_(torch.from_numpy(router))
    gy = rng.standard_normal(x.shape).astype(np.float32)
    t = x.shape[0] * x.shape[1]
    cap = max(1, math.ceil(t * k / e * 1.25))
    xt = x.reshape(t, -1)
    jids, jkeep = _jax_route(layer, xt, e, k, cap)
    ids = pmoe.route(moe.router(torch.from_numpy(xt), pcfg.quant), k)[1]
    keep = pmoe.dispatch_rows(ids, e) < cap
    np.testing.assert_array_equal(ids.numpy(), jids)
    np.testing.assert_array_equal(keep.numpy(), jkeep.reshape(-1))
    assert (~jkeep).sum() > 0, "no assignment was dropped"
    key = jax.random.PRNGKey(29)
    noise = key if mode == "noise" else None

    def jloss(params, x_):
        y, aux = jmoe.moe_apply(params, x_, jcfg.quant, noise,
                                num_experts=e, top_k=k, act=jcfg.mlp_act)
        return jnp.sum(y * gy) + aux, (y, aux)

    with _true_division():
        (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True, allow_int=True))(
            layer, jnp.asarray(x))
    moe.zero_grad(set_to_none=True)
    moe.requires_grad_(True)
    xp = torch.tensor(x, requires_grad=True)
    draws = MoEDraws(_moe_keys(key, "")) if mode == "noise" else None
    for name, lin in psmol.smol_linears(moe):
        lin.path = f"moe.{name}"
    y, aux = pmoe.moe_apply(moe, xp, pcfg.quant, num_experts=e, top_k=k,
                            noise=draws)
    ((y * torch.from_numpy(gy)).sum() + aux).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), **TOL)
    jgx = np.asarray(jgx)
    np.testing.assert_allclose(xp.grad.numpy(), jgx, rtol=1e-5,
                               atol=1e-5 * np.abs(jgx).max())
    want = jax.tree_util.tree_flatten_with_path(jgp)[0]
    mods = dict(moe.named_modules())
    checked = 0
    for path, jgrad in want:
        keys = [p.key for p in path]
        mod, leaf = ".".join(keys[:-1]), keys[-1]
        if leaf not in ("w", "s"):
            continue
        jgrad = np.asarray(jgrad)
        np.testing.assert_allclose(
            getattr(mods[mod], leaf).grad.numpy(), jgrad, rtol=1e-5,
            atol=1e-5 * np.abs(jgrad).max(), err_msg="/".join(keys))
        checked += 1
    assert checked >= (7 if mode == "noise" else 4)
    moe.requires_grad_(False)


# ---------------------------------------------------------- train step ----
@pytest.mark.parametrize("mode", ["noise", "qat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_equals_jax(arch, mode):
    """One step from the same tree and batch (NOISE on replayed draws)
    against the reference's loss and gradient (``jax.value_and_grad`` of
    ``lm.loss_fn``, which its ``train_step`` takes; the norm as its AdamW
    takes it): the MoE layer's expert ids first, then the loss, the
    gradient norm and the load-balancing loss within 1e-5."""
    jcfg, pcfg = _configs(arch, mode)
    tree = _tree(jcfg, 9)
    tk = dict(warmup=1, t1=1 if mode == "noise" else 0, t2=4)
    pt = pstate.TrainConfig(adamw=padamw.AdamWConfig(lr=1e-3), **tk)
    batch = next(jsynthetic.TokenStream(jsynthetic.TokenStreamConfig(
        vocab_size=jcfg.vocab_size, seq_len=16, batch_size=2,
        seed=1)).batches())
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(23)
    jids, pids = [], []
    real_j, real_p = jmoe.moe_apply, pmoe.top_k_gates

    def spy_j(params, x, *a, top_k, **kw):
        probs = jax.nn.softmax(x.reshape(-1, x.shape[-1]).astype(
            jnp.float32) @ params["router"]["w"], -1)
        jax.debug.callback(lambda v: jids.append(np.asarray(v)),
                           jax.lax.top_k(probs, top_k)[1])
        return real_j(params, x, *a, top_k=top_k, **kw)

    def spy_p(probs, top_k):
        gates, ids = real_p(probs, top_k)
        pids.append(ids.numpy())
        return gates, ids

    with _true_division(), mock.patch.object(jmoe, "moe_apply", spy_j):
        (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
            lambda p, b, r: jlm.loss_fn(p, b, jcfg, r), has_aux=True,
            allow_int=True))(tree, jb, rng if mode == "noise" else None)
    jnorm = jadamw.global_norm(jgrads)
    model = interop.params_from_numpy(tree, pcfg, "cpu")
    pst = pstate.init_state(pcfg, pt, model=model)
    pst["step"] = 1
    draws = MoEDraws(model_key_paths(rng, pcfg))
    with mock.patch.object(pmoe, "top_k_gates", spy_p):
        _, pm = pstate.train_step(pst, batch, pcfg, pt,
                                  (lambda i: draws) if mode == "noise"
                                  else None)
    assert jids and pids
    np.testing.assert_array_equal(pids[0], jids[0])
    np.testing.assert_allclose(float(pm["loss"]), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(pm["grad_norm"]), float(jnorm),
                               rtol=1e-5)
    np.testing.assert_allclose(float(pm["moe_aux"]), float(jmet["moe_aux"]),
                               rtol=1e-5)


# ------------------------------------------------------------ boundary ----
def test_freeze_qat_walks_banks_as_jax():
    """The boundary on a deepseek-moe-16b tree of a dense layer and two
    MoE layers with spread logits: the pattern report in the reference's
    order (plan group, sorted path, layer, expert) and every expert's
    frozen precisions identical."""
    jcfg, pcfg = _configs("deepseek-moe-16b", "noise")
    jcfg = dataclasses.replace(jcfg, num_layers=3)
    pcfg = dataclasses.replace(pcfg, num_layers=3)
    tree = _tree(jcfg, 17)
    jq = dataclasses.replace(jcfg.quant, num_patterns=6)
    pq = dataclasses.replace(pcfg.quant, num_patterns=6)
    jnew, jrep = jtransforms.freeze_qat(tree, jq)
    model = interop.params_from_numpy(tree, pcfg, "cpu")
    _, prep = ptransforms.freeze_qat(model, pq)
    assert prep["allowed"] == jrep["allowed"]
    assert prep["layers"] == jrep["layers"]
    assert pschedule.average_bpp(prep) == float(np.mean(
        [lr["bpp"] for lr in jrep["layers"]]))
    ptree = interop.tree_to_numpy(model)
    bank = ptree["groups"][1]["moe"]["up"]
    assert "s" not in bank and bank["pbits"].shape == (
        2, pcfg.num_experts, pcfg.d_model // 16)
    assert bank["pbits"].dtype == np.int8
    jflat = jax.tree_util.tree_flatten_with_path(jnew)[0]
    pflat = dict(jax.tree_util.tree_flatten_with_path(ptree)[0])
    frozen = 0
    for path, want in jflat:
        if path[-1].key == "pbits":
            np.testing.assert_array_equal(pflat[path], np.asarray(want))
            frozen += 1
    assert frozen == 7 + 4 + 3 + 3


@pytest.mark.parametrize("mode", ["noise", "qat"])
def test_bank_leaves_cross_both_ways(mode):
    """NOISE and QAT trees with stacked bank leaves (w [L, E, K, N], s or
    pbits [L, E, K / 16]) cross into the port (one [E, ...] bank a layer)
    and back unchanged."""
    jcfg, pcfg = _configs("deepseek-moe-16b", mode)
    tree = _tree(jcfg, 21)
    model = interop.params_from_numpy(tree, pcfg, "cpu")
    bank = model.blocks[1].moe.up
    leaf = "s" if mode == "noise" else "pbits"
    assert bank.w.shape == (pcfg.num_experts, pcfg.d_model, pcfg.d_ff)
    assert getattr(bank, leaf).shape == (pcfg.num_experts,
                                         pcfg.d_model // 16)
    back = dict(jax.tree_util.tree_flatten_with_path(
        interop.tree_to_numpy(model))[0])
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(back) == len(flat)
    for path, want in flat:
        np.testing.assert_array_equal(back[path], np.asarray(want))
        assert back[path].dtype == np.asarray(want).dtype


def test_launcher_trains_reduced_moe_on_the_cpu(capsys):
    assert ptrain_launch.main([
        "--arch", "deepseek-moe-16b", "--reduced", "--device", "cpu",
        "--steps", "3", "--t1", "2", "--batch", "2", "--seq", "16"]) == 0
    out = capsys.readouterr().out
    assert out.count("moe_aux=") == 3 and "boundary" in out
