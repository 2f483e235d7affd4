"""Port parity for deploy packing (kernel B7's plain version) and the
weight bridge: the port's packed carriers, channel order and scales equal
the JAX package's bit for bit, and JAX-packed leaves dequantize
identically in the port."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import transforms as jtransforms
from repro.configs import get_config as jget_config
from repro.core import pack as jpack
from repro.core.qtypes import QuantConfig as JQuantConfig
from repro.kernels import quant_pack as jquant_pack
from repro.models import lm as jlm
from repro.train import checkpoint as jckpt

from repro_torch import interop
from repro_torch.api import transforms as ptransforms
from repro_torch.configs import get_config as pget_config
from repro_torch.core import pack as ppack
from repro_torch.core.qtypes import QuantConfig as PQuantConfig
from repro_torch.kernels import quant_pack as pquant_pack

SERVE_LEAVES = ("w4", "w2", "w1", "perm", "pbits_sorted", "wscale")


def _pbits(kind, ng, rng):
    if kind == "mixed":
        return rng.choice(np.array([4, 2, 1], np.int8), ng)
    return np.full(ng, {"all4": 4, "all2": 2, "all1": 1}[kind], np.int8)


def _np(t):
    return None if t is None else np.asarray(t)


def _assert_leaf_equal(jleaf, pleaf):
    for name in SERVE_LEAVES:
        j, p = _np(jleaf.get(name)), pleaf.get(name)
        if j is None:
            assert p is None, name
            continue
        p = p.numpy()
        assert p.shape == j.shape, (name, p.shape, j.shape)
        np.testing.assert_array_equal(p, j, err_msg=name)


@pytest.mark.parametrize("scale_mode", ["per_group", "none"])
@pytest.mark.parametrize("kind", ["all4", "all2", "all1", "mixed"])
@pytest.mark.parametrize("k,n", [(16, 8), (128, 32), (2560, 16)])
def test_pack_linear_bit_equal(k, n, kind, scale_mode):
    rng = np.random.default_rng(k * 7 + n)
    w = (rng.standard_normal((k, n)) * 0.7).astype(np.float32)
    pbits = _pbits(kind, k // 16, rng)
    # The Pallas kernel in interpret mode for the smaller widths, the
    # plain-jnp reference (bit-identical by the JAX suite) at K=2560.
    backend = "pallas_interpret" if k <= 128 else "xla_ref"
    jleaf = jtransforms.pack_linear(
        {"w": w, "pbits": pbits},
        JQuantConfig(mode="qat", scale_mode=scale_mode, backend=backend))
    pleaf = ptransforms.pack_linear(
        {"w": torch.from_numpy(w), "pbits": pbits},
        PQuantConfig(mode="qat", scale_mode=scale_mode))
    _assert_leaf_equal(jleaf, pleaf)


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("scaled", [True, False])
def test_quantize_pack_plain_matches_pallas_kernel(p, scaled):
    rng = np.random.default_rng(p)
    k, n = 128, 24
    w = (rng.standard_normal((k, n)) * 1.3).astype(np.float32)
    # Put values exactly on rounding ties to pin half-to-even.
    w[0, :4] = np.array([0.0, 0.125, -0.125, 1.0], np.float32)
    scales = (rng.random(k // 16) + 0.5).astype(np.float32) if scaled \
        else None
    want = jquant_pack.quantize_pack(
        jnp.asarray(w), None if scales is None else jnp.asarray(scales),
        p=p, interpret=True)
    got = pquant_pack.quantize_pack(
        torch.from_numpy(w), None if scales is None
        else torch.from_numpy(scales), p=p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_convert_tree_stacked_bit_equal():
    """A stacked [L, K, N] QAT leaf packs per slice (rebudgeted) and
    re-stacks exactly as the JAX transform does."""
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((3, 64, 40)) * 0.5).astype(np.float32)
    pbits = rng.choice(np.array([4, 2, 1], np.int8), (3, 4))
    jq = JQuantConfig(mode="qat", backend="xla_ref")
    pq = PQuantConfig(mode="qat")
    jout = jtransforms.convert_tree({"lin": {"w": w, "pbits": pbits}}, jq)
    pout = ptransforms.convert_tree(
        {"lin": {"w": torch.from_numpy(w), "pbits": torch.from_numpy(pbits)}},
        pq)
    _assert_leaf_equal(jout["lin"], pout["lin"])


@pytest.mark.parametrize("kind", ["all4", "mixed"])
def test_rebudget_matches_jax(kind):
    rng = np.random.default_rng(11)
    w = rng.standard_normal((256, 8)).astype(np.float32)
    pbits = _pbits(kind, 16, rng)
    q = dict(mode="qat")
    np.testing.assert_array_equal(
        ptransforms.rebudget_pbits(pbits, torch.from_numpy(w),
                                   PQuantConfig(**q)),
        jtransforms.rebudget_pbits(pbits, w, JQuantConfig(**q)))


@pytest.mark.parametrize("kind", ["mixed", "all1"])
def test_jax_packed_leaves_dequantize_identically(kind):
    rng = np.random.default_rng(5)
    k, n = 128, 32
    w = (rng.standard_normal((k, n)) * 0.9).astype(np.float32)
    leaf = jtransforms.pack_linear(
        {"w": w, "pbits": _pbits(kind, k // 16, rng)},
        JQuantConfig(mode="qat", backend="xla_ref"))
    bufs = {name: np.array(leaf[name]) for name in ("w4", "w2", "w1")}
    wscale = np.array(leaf["wscale"])
    want = jax.jit(lambda b, s: jpack.dequant_packed_carriers(
        b, jnp.float32, s))(bufs, wscale)
    got = ppack.dequant_packed_carriers(
        {name: torch.from_numpy(b) for name, b in bufs.items()},
        torch.from_numpy(wscale))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("p", [1, 2, 4])
def test_pack_unpack_codes_round_trip_matches_jax(p):
    rng = np.random.default_rng(p + 20)
    u = rng.integers(0, 2 ** p, (64, 5)).astype(np.uint8)
    jb = np.asarray(jpack.pack_codes(jnp.asarray(u), p))
    pb = ppack.pack_codes(torch.from_numpy(u), p)
    np.testing.assert_array_equal(pb.numpy(), jb)
    np.testing.assert_array_equal(ppack.unpack_codes(pb, p, 64).numpy(), u)


@pytest.fixture(scope="module")
def reduced_qat():
    jcfg = jget_config("h2o-danube-1.8b").reduced()
    jcfg = dataclasses.replace(jcfg, num_layers=2)
    params = jax.device_get(jlm.init_params(jax.random.PRNGKey(1), jcfg))
    pcfg = dataclasses.replace(pget_config("h2o-danube-1.8b").reduced(),
                               num_layers=2)
    return jcfg, pcfg, params


def test_params_from_numpy_unstacks_layers(reduced_qat):
    _jcfg, pcfg, params = reduced_qat
    model = interop.params_from_numpy(params, pcfg, "cpu")
    assert len(model.blocks) == 2
    for i in range(2):
        np.testing.assert_array_equal(
            model.blocks[i].attn.wq.w.numpy(),
            params["groups"][0]["attn"]["wq"]["w"][i])
        np.testing.assert_array_equal(
            model.blocks[i].mlp.down.pbits.numpy(),
            params["groups"][0]["mlp"]["down"]["pbits"][i])
    np.testing.assert_array_equal(model.lm_head.w.numpy(),
                                  params["lm_head"]["w"])


def test_load_npz_reads_jax_checkpoint(reduced_qat, tmp_path):
    _jcfg, pcfg, params = reduced_qat
    jckpt.save({"params": params, "step": np.int32(7)}, str(tmp_path), 7)
    model = interop.load_npz(str(tmp_path), pcfg, "cpu")
    for i in range(2):
        leaf = model.blocks[i].mlp.gate.leaf()
        for name in ("w", "pbits"):
            np.testing.assert_array_equal(
                leaf[name].numpy(),
                params["groups"][0]["mlp"]["gate"][name][i])
    np.testing.assert_array_equal(model.embed.table.numpy(),
                                  params["embed"]["table"])
