"""Port parity for the paper's CNN family (``repro_torch.models.cnn``)
against ``repro.models.cnn`` on the CPU: the synthetic classification
data, the forward in every phase (stride 2 with XLA's asymmetric "SAME"
padding, an odd image size), one Phase-I and one Phase-II step's loss,
gradients and AdamW update as the benchmarks' ``train_cnn`` takes them,
the freeze, and the deploy packing of 1x1 and 3x3 convs.

The reference is jitted with its abs-max scale divisions by 1.875 kept
true divisions, as the port's are (``_true_division``, and here the conv
weight scale of ``cnn._quant_w_conv`` too): XLA otherwise multiplies by
the reciprocal, one ulp off for some maxima. Phase I replays the
reference's draws: ``cnn_apply`` splits its key in 64 and hands one to
each conv and to the head in call order (``CNNDraws``).
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
from repro.core import smol as jsmol
from repro.core.qtypes import QuantConfig as JQuantConfig
from repro.data import synthetic as jsynthetic
from repro.models import cnn as jcnn
from repro.optim import adamw as jadamw

from repro_torch import interop
from test_torch_train import _true_division
from repro_torch.api import transforms as ptransforms
from repro_torch.core import smol as psmol
from repro_torch.core.qtypes import QuantConfig as PQuantConfig
from repro_torch.data import synthetic as psynthetic
from repro_torch.models import cnn as pcnn
from repro_torch.optim import adamw as padamw

from test_torch_train import _one_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
# The reference's serve-vs-QAT bound (tests/test_api_lifecycle.py).
SERVE_TOL = dict(atol=1e-4, rtol=1e-3)
# train_cnn's optimizer (benchmarks/_common.py).
OPT = dict(lr=3e-3, weight_decay=1e-4, s_lr_mult=25.0)


def _cfgs(mode, channels=(32, 32), blocks=1):
    jc = jcnn.CNNConfig(channels=channels, blocks_per_stage=blocks,
                        quant=JQuantConfig(mode=mode, backend="xla_ref"))
    pc = pcnn.CNNConfig(channels=channels, blocks_per_stage=blocks,
                        quant=PQuantConfig(mode=mode))
    return jc, pc


def _params(jc, mode, seed=0):
    """The reference's init with the quantized convs' logits spread over
    the three bands (NOISE) or mixed precisions (QAT)."""
    tree = jax.device_get(jcnn.cnn_init(jax.random.PRNGKey(seed), jc))
    rng = np.random.default_rng(seed + 1)
    for blocks in tree["stages"]:
        for blk in blocks:
            pw = blk["pw"]
            if mode == "noise":
                pw["s"] = rng.normal(-0.2, 1.5, pw["s"].shape).astype(
                    np.float32)
            elif mode == "qat":
                pw["pbits"] = rng.choice(np.array([1, 2, 4], np.int8),
                                         pw["pbits"].shape)
    return tree


@contextlib.contextmanager
def _cnn_true_division():
    """``_true_division`` plus the conv weight scale of the reference's
    Phase-II conv rule, divided truly."""
    def quant_w_conv(w, pbits, qcfg, g):
        wt = jnp.moveaxis(w, 2, -1)                   # [kh, kw, Cout, Cin]
        cin = w.shape[2]
        m = jnp.max(jnp.abs(wt.reshape(-1, cin // g, g)), axis=(0, 2))
        top = jax.lax.optimization_barrier(jnp.float32(1.875))
        sw = jax.lax.stop_gradient(jnp.maximum(m, 1e-6) / top)
        return jnp.moveaxis(jsmol._backend(qcfg).fake_quant(
            wt, pbits, sw, g), -1, 2)

    with _true_division(), mock.patch.object(jcnn, "_quant_w_conv",
                                             quant_w_conv):
        yield


def _jax_apply(tree, x, jc, key):
    with _cnn_true_division():
        return np.asarray(jax.jit(lambda p, xx: jcnn.cnn_apply(
            p, xx, jc, key))(tree, jnp.asarray(x)))


def cnn_keys(rng, cfg):
    """{port module path: its JAX key} as ``cnn_apply`` splits ``rng``."""
    ks = jax.random.split(rng, 64)
    out, i = {"stem": ks[0]}, 1
    for si in range(len(cfg.channels)):
        for bi in range(cfg.blocks_per_stage):
            out[f"stages.{si}.{bi}.dw"] = ks[i]
            out[f"stages.{si}.{bi}.pw"] = ks[i + 1]
            i += 2
    out["head"] = ks[i]
    return out


class CNNDraws:
    """A port noise source replaying the reference's CNN draws by path."""

    def __init__(self, rng, cfg):
        self.keys = cnn_keys(rng, cfg)

    def draw(self, path, x):
        kw, kx = jax.random.split(self.keys[path])
        seed = int(jax.random.bits(kw, (), jnp.uint32))
        eps = np.asarray(jax.random.uniform(kx, tuple(x.shape), jnp.float32,
                                            -1.0, 1.0))
        return psmol.NoiseDraw(seed=torch.tensor([seed]),
                               act_eps=torch.tensor(eps))


def _images(n, hw, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (n, hw, hw, 3)).astype(np.float32)


# --------------------------------------------------------------- data ----
@pytest.mark.parametrize("dim,seed", [((6, 6, 3), 0), ((8, 8, 3), 5)])
def test_classification_dataset_is_bitwise_jax(dim, seed):
    kw = dict(num_classes=10, dim=dim, n_train=96, n_test=32, seed=seed)
    want = jsynthetic.classification_dataset(**kw)
    got = psynthetic.classification_dataset(**kw)
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype and gy.dtype == wy.dtype
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


# --------------------------------------------------------------- conv ----
@pytest.mark.parametrize("hw", [8, 7])
@pytest.mark.parametrize("k,stride,groups", [(3, 1, 1), (3, 2, 1),
                                             (3, 2, 8), (1, 1, 1)])
def test_same_padding_equals_xla(k, stride, groups, hw):
    """``conv2d_same`` against ``conv_general_dilated(..., "SAME")``: at
    stride 2 on an even size XLA pads (0, 1), so ``padding=1`` would
    differ. The port sums in float64 and XLA in fp32, a few fp32 ulps
    apart on sums of 27 standard-normal products."""
    rng = np.random.default_rng(k + stride + groups + hw)
    x = rng.standard_normal((2, hw, hw, 8)).astype(np.float32)
    w = rng.standard_normal((k, k, 8 // groups, 8)).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        x, w, (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups))
    got = pcnn.conv2d_same(torch.tensor(x), torch.tensor(w), stride,
                           groups).numpy()
    np.testing.assert_allclose(got, want, **TOL)


# ------------------------------------------------------------ forward ----
@pytest.mark.parametrize("hw", [8, 7])
@pytest.mark.parametrize("mode", ["fp", "noise", "qat", "serve"])
def test_cnn_forward_equals_jax(mode, hw):
    """``cnn_apply`` on the reference's weights (carried across) against
    ``repro.models.cnn.cnn_apply``; NOISE on replayed draws, SERVE on the
    reference's packed tree."""
    jc, pc = _cfgs("qat" if mode == "serve" else mode)
    tree = _params(jc, "qat" if mode == "serve" else mode)
    if mode == "serve":
        tree = jax.device_get(jtransforms.convert_tree(tree, jc.quant))
        jc = dataclasses.replace(jc, quant=jc.quant.with_mode("serve"))
        pc = dataclasses.replace(pc, quant=pc.quant.with_mode("serve"))
    x = _images(4, hw)
    key = jax.random.PRNGKey(5) if mode == "noise" else None
    want = _jax_apply(tree, x, jc, key)
    model = interop.cnn_from_numpy(tree, pc, device="cpu")
    noise = CNNDraws(key, jc) if mode == "noise" else None
    with torch.no_grad():
        got = pcnn.cnn_apply(model, x, pc, noise).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert float(pcnn.bits_per_param(model, pc.quant)) == \
        jcnn.bits_per_param(tree, jc.quant)


def test_interop_round_trip_keeps_the_tree():
    jc, pc = _cfgs("noise")
    tree = _params(jc, "noise")
    back = interop.cnn_to_numpy(interop.cnn_from_numpy(tree, pc, "cpu"))
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(got) == {p for p, _ in flat}
    for path, leaf in flat:
        np.testing.assert_array_equal(got[path], leaf)


# --------------------------------------------------------------- step ----
def _jax_step(tree, batch, jc, key, ocfg):
    """train_cnn's step: loss and gradients, then the update."""
    def loss(p):
        return jcnn.xent_loss(p, batch, jc, key)[0]
    jtree = jax.tree.map(jnp.asarray, tree)
    with _cnn_true_division():
        val, grads = jax.jit(jax.value_and_grad(loss, allow_int=True))(
            jtree)
    new, _opt, met = jadamw.apply_updates(jtree, grads,
                                          jadamw.init_state(jtree), ocfg)
    return float(val), grads, jax.device_get(new), float(met["grad_norm"])


def _flat(tree):
    """{"stages/0/0/pw/w": leaf} of a numpy (or JAX) tree."""
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("mode", ["noise", "qat"])
def test_cnn_step_equals_jax(mode):
    """One step of the benchmarks' recipe at channels (32, 32): the loss
    and every gradient against ``jax.value_and_grad(cnn.xent_loss,
    allow_int=True)`` (NOISE on replayed draws), then the port's AdamW
    (``s_lr_mult`` 25) fed the reference's gradients against
    ``adamw.apply_updates``."""
    jc, pc = _cfgs(mode)
    tree = _params(jc, mode, seed=2)
    (xtr, ytr), _ = jsynthetic.classification_dataset(
        num_classes=10, dim=(8, 8, 3), n_train=16, n_test=4, seed=2)
    batch = {"x": xtr, "y": ytr}
    key = jax.random.PRNGKey(11) if mode == "noise" else None
    jval, jgrads, jnew, jgn = _jax_step(tree, batch, jc, key,
                                        jadamw.AdamWConfig(**OPT))
    model = interop.cnn_from_numpy(tree, pc, device="cpu")
    model.requires_grad_(True)
    params = padamw.trainable(model)
    loss, _ = pcnn.xent_loss(model, batch, pc,
                             CNNDraws(key, jc) if key is not None else None)
    grads = torch.autograd.grad(loss, [p for _, p in params])
    np.testing.assert_allclose(float(loss.detach()), jval, rtol=1e-6)
    want = _flat(jgrads)
    names = [n.replace(".", "/") for n, _ in params]
    assert sorted(names) == sorted(k for k, v in want.items()
                                   if v.dtype != jax.dtypes.float0)
    # The reference's sorted tree order, so the gradient norm sums alike.
    assert names == [k for k in want if want[k].dtype != jax.dtypes.float0]
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]), **TOL,
                                   err_msg=name)
    named = {n: torch.tensor(np.asarray(want[n.replace(".", "/")]))
             for n, _ in params}
    met = padamw.apply_updates(model, named, padamw.init_state(model),
                               padamw.AdamWConfig(**OPT))
    np.testing.assert_allclose(float(met["grad_norm"]), jgn, rtol=1e-6)
    got = _flat(interop.cnn_to_numpy(model))
    for name, leaf in _flat(jnew).items():
        np.testing.assert_allclose(got[name], leaf, rtol=1e-6, atol=1e-7,
                                   err_msg=name)


def test_project_noise_weights_reaches_the_convs():
    """The Phase-I projection clips a conv's [Cin, kh * kw * Cout] rows
    as a linear's: the rows of every pw conv against
    ``noise.clip_weights`` of the normalized rows."""
    jc, pc = _cfgs("noise")
    tree = _params(jc, "noise")
    for blocks in tree["stages"]:
        for blk in blocks:
            blk["pw"]["w"] = blk["pw"]["w"] * 4.0       # beyond the clip
    model = interop.cnn_from_numpy(tree, pc, device="cpu")
    psmol.project_noise_weights(model, pc.quant)
    got = interop.cnn_to_numpy(model)
    for si, blocks in enumerate(tree["stages"]):
        for bi, blk in enumerate(blocks):
            leaf = {"w": np.moveaxis(blk["pw"]["w"], 2, 0).reshape(
                blk["pw"]["w"].shape[2], -1), "s": blk["pw"]["s"]}
            want = np.asarray(jsmol.project_noise_weights(
                {"l": leaf}, jc.quant)["l"]["w"])
            have = np.moveaxis(got["stages"][si][bi]["pw"]["w"], 2, 0)
            np.testing.assert_allclose(have.reshape(want.shape), want,
                                       rtol=1e-6, atol=1e-7)
            # dw and stem hold no logits: untouched.
            np.testing.assert_array_equal(got["stages"][si][bi]["dw"]["w"],
                                          blk["dw"]["w"])


# ------------------------------------------------------------- freeze ----
def test_freeze_equals_jax():
    """``freeze_qat`` on the same trained logits of two 128-input-channel
    pw convs: the same frozen pbits (bitwise) and report."""
    jc, pc = _cfgs("noise", channels=(128, 256))
    tree = _params(jc, "noise", seed=4)
    jnew, jrep = jtransforms.freeze_qat(tree, jc.quant)
    model = interop.cnn_from_numpy(tree, pc, device="cpu")
    _, prep = ptransforms.freeze_qat(model, pc.quant)
    assert prep == jrep
    got = interop.cnn_to_numpy(model)
    for si, blocks in enumerate(jnew["stages"]):
        for bi, blk in enumerate(blocks):
            pw = got["stages"][si][bi]["pw"]
            assert "s" not in pw and pw["pbits"].dtype == np.int8
            np.testing.assert_array_equal(pw["pbits"],
                                          np.asarray(blk["pw"]["pbits"]))


# ------------------------------------------------------------ packing ----
def _conv_leaf(k, cin, cout, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, k, cin, cout)) / np.sqrt(k * k * cin)
         ).astype(np.float32)
    pb = rng.choice(np.array([1, 2, 4], np.int8), cin // 16)
    return {"w": w, "pbits": pb}


def _assert_serve_leaf_equal(got, want):
    assert sorted(got) == sorted(want)
    for name, v in want.items():
        if v is None:
            assert got[name] is None, name
            continue
        g = got[name].numpy()
        assert g.shape == v.shape and g.dtype == np.asarray(v).dtype, name
        np.testing.assert_array_equal(g, np.asarray(v), err_msg=name)


@pytest.mark.parametrize("k", [1, 3])
def test_pack_conv_is_bitwise_jax(k):
    leaf = _conv_leaf(k, 64, 24, seed=k)
    qcfg = JQuantConfig(mode="qat", backend="xla_ref")
    want = jax.device_get(jtransforms.pack_conv(leaf, qcfg))
    got = ptransforms.pack_conv({n: torch.tensor(v) for n, v in leaf.items()},
                                PQuantConfig(mode="qat"))
    assert got["w4"].shape[1:] == (k, k, 24)
    _assert_serve_leaf_equal(got, want)


@pytest.mark.parametrize("rebudget", [True, "auto"])
def test_convert_tree_packs_conv_leaves_as_jax(rebudget):
    """A tree of a 1x1 and a 3x3 quantized conv and a linear: carriers,
    perm, pbits_sorted and wscale bitwise the reference's, rebudgeted only
    when ``rebudget is True``."""
    tree = {"a": _conv_leaf(1, 64, 24, seed=7), "b": _conv_leaf(3, 32, 16,
                                                               seed=8)}
    qcfg = JQuantConfig(mode="qat", backend="xla_ref")
    want = jax.device_get(jtransforms.convert_tree(tree, qcfg,
                                                   rebudget=rebudget))
    got = ptransforms.convert_tree(
        {n: {k: torch.tensor(v) for k, v in leaf.items()}
         for n, leaf in tree.items()}, PQuantConfig(mode="qat"),
        rebudget=rebudget)
    for name in tree:
        _assert_serve_leaf_equal(got[name], want[name])


# -------------------------------------------------------------- serve ----
def test_to_serve_matches_qat_forward():
    """The port's in-place ``to_serve`` of a QAT CNN against its own QAT
    forward at the reference's bound, stride 2 included."""
    from repro_torch import soniq
    _, pc = _cfgs("qat")
    state = soniq.init(pc, seed=0, device="cpu")
    x = torch.tensor(_images(4, 8, seed=9))
    with torch.no_grad():
        y_qat = soniq.apply(state, x)
        served = soniq.to_serve(state)
        y_srv = soniq.apply(served, x)
    assert "w4" in served.params["stages"][1][0]["pw"]
    np.testing.assert_allclose(y_srv.numpy(), y_qat.numpy(), **SERVE_TOL)
