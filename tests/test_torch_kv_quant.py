"""Port parity for the packed 4-bit KV cache (``repro_torch.serve.kv_quant``)
against the JAX package: quantize bit-equal (zero rows and rows whose
fp16 scale saturates included), the ring write through a wrap with masked
lanes, slot resets and the byte accounting. Inputs come from a numpy
seed and go to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArchConfig
from repro.core.qtypes import QuantConfig as JQuantConfig
from repro.models import lm as jlm
from repro.serve import kv_quant as jkq

from repro_torch import interop
from repro_torch.configs.base import ArchConfig as PArchConfig
from repro_torch.core.qtypes import QuantConfig as PQuantConfig
from repro_torch.models import lm as plm
from repro_torch.serve import kv_quant as pkq

from test_torch_train import _one_thread  # noqa: F401


def _kv(rng, shape, *, zero_row=True, huge_row=True):
    x = rng.standard_normal(shape).astype(np.float32)
    x[..., 0, :] *= 30.0                      # a loud head
    if zero_row:
        x[0, 0, 1] = 0.0                      # all-zero row: eps clamp
    if huge_row:
        x[-1, -1, 0] *= 1e6                   # abs-max > 1.2e5: fp16 top
    return x


def test_constants_match():
    assert pkq.P_BITS == jkq.P_BITS
    assert pkq.GRID_MAX == jkq.GRID_MAX
    assert pkq._SCALE_MAX == jkq._SCALE_MAX


@pytest.mark.parametrize("shape", [(2, 3, 2, 16), (1, 5, 4, 80)])
def test_quantize_kv_bit_equal(shape):
    x = _kv(np.random.default_rng(shape[-1]), shape)
    jc, js = jkq.quantize_kv(jnp.asarray(x))
    pc, ps = pkq.quantize_kv(torch.from_numpy(x))
    assert pc.dtype == torch.uint8 and ps.dtype == torch.float16
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    assert float(ps.max()) == pkq._SCALE_MAX          # saturated head
    assert float(ps[0, 0, 1, 0]) > 0                  # clamped zero row
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        want = np.asarray(jkq.dequantize_kv(jc, js, jdt).astype(
            jnp.float32))
        got = pkq.dequantize_kv(pc, ps, dt).float().numpy()
        np.testing.assert_array_equal(got, want)


def _ring_program(rng, b, t, h, d, steps):
    """Chunks of new K/V with positions that wrap the ring, masked lanes
    (pos -1) and an idle row."""
    pos0 = np.array([0, 3] + [5] * (b - 2))[:b]
    prog = []
    for i in range(steps):
        s = 3 if i % 2 == 0 else 1
        pos = (pos0[:, None] + i * 3 + np.arange(s)[None]).astype(np.int32)
        pos[0, -1] = -1                       # masked lane
        if b > 2:
            pos[2] = -1                       # idle row
        k = _kv(rng, (b, s, h, d), huge_row=i == 1)
        prog.append((k, -0.5 * k, pos))
    return prog


def test_update_qkv_cache_through_a_wrap_equals_jax():
    b, t, h, d = 3, 8, 2, 16
    prog = _ring_program(np.random.default_rng(0), b, t, h, d, 6)
    jc = jkq.init_qkv_cache(b, t, h, d)
    pc = pkq.init_qkv_cache(b, t, h, d, device="cpu")
    update = jax.jit(jkq.update_qkv_cache)
    for k, v, pos in prog:
        jc = update(jc, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
        pkq.update_qkv_cache(pc, torch.from_numpy(k), torch.from_numpy(v),
                             torch.from_numpy(pos))
        for name in jc:
            np.testing.assert_array_equal(pc[name].numpy(),
                                          np.asarray(jc[name]), name)
    assert int(pc["pos"].max()) >= t                  # it wrapped
    np.testing.assert_array_equal(pkq.slot_lengths(pc).numpy(),
                                  np.asarray(jkq.slot_lengths(jc)))
    # Decode-shaped [B] positions.
    k = _kv(np.random.default_rng(9), (b, 1, h, d))
    pos = np.array([20, -1, 7], np.int32)
    jc = update(jc, jnp.asarray(k), jnp.asarray(k), jnp.asarray(pos))
    pkq.update_qkv_cache(pc, torch.from_numpy(k), torch.from_numpy(k),
                         torch.from_numpy(pos))
    for name in jc:
        np.testing.assert_array_equal(pc[name].numpy(),
                                      np.asarray(jc[name]), name)
    for name in jc:
        want = np.asarray(jkq.reset_slots(jc, [0, 2])[name])
        got = pkq.reset_slots({n: x.clone() for n, x in pc.items()},
                              [0, 2])[name].numpy()
        np.testing.assert_array_equal(got, want, name)
    one = pkq.evict_slot({n: x.clone() for n, x in pc.items()}, 1)
    np.testing.assert_array_equal(
        one["pos"].numpy(), np.asarray(jkq.evict_slot(jc, 1)["pos"]))
    k, v, kpos = pkq.read_qkv_cache(pc, torch.float32)
    jk, jv, jpos = jkq.read_qkv_cache(jc, jnp.float32)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(kpos.numpy(), np.asarray(jpos))


def _tiny():
    kw = dict(name="t", family="dense", num_layers=2, d_model=64,
              num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
              head_dim=32, window=24, dtype="float32",
              param_dtype="float32", q_block=32)
    return (JArchConfig(quant=JQuantConfig(mode="qat"), **kw),
            PArchConfig(quant=PQuantConfig(mode="qat"), **kw))


@pytest.mark.parametrize("kw", [
    dict(kv_bits=4), dict(kv_bits=None),
    dict(kv_bits=4, kv_layout="paged", page_size=8),
    dict(kv_bits=4, kv_layout="paged", page_size=4, num_pages=7)],
    ids=["q4-ring", "fp-ring", "q4-paged", "q4-paged-small"])
def test_byte_accounting_equals_jax(kw):
    """Payload / meta / total bytes of a whole-model cache (the window
    clips the ring) equal the reference's; the bridged JAX cache has the
    port's layout."""
    jcfg, pcfg = _tiny()
    jc = jax.device_get(jlm.init_cache(jcfg, 3, 40, jnp.float32, **kw))
    pc = plm.init_cache(pcfg, 3, 40, torch.float32, device="cpu", **kw)
    assert pkq.cache_payload_bytes(pc) == jkq.cache_payload_bytes(jc)
    assert pkq.cross_payload_bytes(pc) == jkq.cross_payload_bytes(jc) == 0
    if kw["kv_bits"] is None:
        # The port's fp ring stamps pos as int64 (the reference: int32).
        assert pkq.cache_meta_bytes(pc) == 2 * jkq.cache_meta_bytes(jc)
        return
    assert pkq.cache_meta_bytes(pc) == jkq.cache_meta_bytes(jc)
    assert pkq.cache_bytes(pc) == jkq.cache_bytes(jc)
    bridged = interop.cache_from_numpy(jc, pcfg, "cpu")
    for got, want in zip(bridged["layers"], pc["layers"]):
        assert set(got["kv"]) == set(want["kv"])
        for name, t in want["kv"].items():
            assert got["kv"][name].dtype == t.dtype, name
            np.testing.assert_array_equal(got["kv"][name].numpy(),
                                          t.numpy(), name)
    if kw["kv_bits"] == 4 and "kv_layout" not in kw:
        ratio = jkq.cache_payload_bytes(jax.device_get(
            jlm.init_cache(jcfg, 3, 40, jnp.float16))) \
            / pkq.cache_payload_bytes(pc)
        assert ratio > 3.5


def test_reset_cache_slots_wipes_only_target_rows():
    jcfg, pcfg = _tiny()
    rng = np.random.default_rng(4)
    pc = plm.init_cache(pcfg, 3, 16, device="cpu", kv_bits=4)
    for layer in pc["layers"]:
        kv = layer["kv"]
        k = _kv(rng, (3, 2, 2, 32))
        pkq.update_qkv_cache(kv, torch.from_numpy(k), torch.from_numpy(k),
                             torch.tensor([[0, 1]] * 3))
    before = [{n: t.clone() for n, t in layer["kv"].items()}
              for layer in pc["layers"]]
    plm.reset_cache_slots(pc, [1])
    for layer, old in zip(pc["layers"], before):
        kv = layer["kv"]
        assert (kv["pos"][1] == -1).all()
        for name in ("k_codes", "v_codes", "k_scale", "v_scale"):
            assert (kv[name][1] == 0).all()
            assert torch.equal(kv[name][[0, 2]], old[name][[0, 2]])
