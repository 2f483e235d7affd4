"""Port parity for the segment GEMMs (plain versions of kernels B1, B2,
B3 and B6) and the shared serve driver, against the JAX package's Pallas
kernels (interpret mode) and its ``xla_ref`` driver, at the JAX suite's
bound of rtol = atol = 1e-5 (tests/test_fused_act_quant.py).

The plain versions sum in float64 and round once; the Pallas kernels sum
in fp32. On the outlier row (x * 100) an output that cancels can then
differ by more than 1e-5 of its own size while the fp32 sum is still
within its rounding error (ROADMAP.md §C), so that row alone is held to
1e-5 of the summed magnitudes, |xq| @ |wd|, plus 1e-5 — the fp32
reordering bound. Every other row keeps rtol = atol = 1e-5."""
import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import transforms as jtransforms
from repro.backend import resolve as jresolve
from repro.core.qtypes import QuantConfig as JQuantConfig

from repro_torch.api import transforms as ptransforms
from repro_torch.backend import base as pbackend
from repro_torch.core import quant as pquant
from repro_torch.core.qtypes import QuantConfig as PQuantConfig
from repro_torch.kernels import packed_matmul as ppm

from test_torch_train import _one_thread  # noqa: F401

# The kernels package shadows this module name with a deprecated
# function; import the module by its dotted path.
jpm = importlib.import_module("repro.kernels.packed_matmul")

TOL = dict(rtol=1e-5, atol=1e-5)


def _assert_matches_pallas(got, want, xq, wd, special):
    """rtol = atol = 1e-5 on every row but the outlier row, which holds
    |got - want| <= 1e-5 * (|xq| @ |wd|) + 1e-5 elementwise."""
    got, want = got.numpy(), np.asarray(want)
    m = got.shape[0]
    plain = m - 1 if special in ("outlier", "both") else m
    np.testing.assert_allclose(got[:plain], want[:plain], **TOL)
    if plain < m:
        mag = (xq[plain:].abs().double() @ wd.abs().double()).numpy()
        err = np.abs(got[plain:].astype(np.float64) - want[plain:])
        bad = err > 1e-5 * mag + 1e-5
        assert not bad.any(), (err[bad], mag[bad])


def _x(rng, m, k, special):
    x = (rng.standard_normal((m, k)) * 1.5).astype(np.float32)
    if special in ("zero", "both"):
        x[0] = 0.0                             # padding / fresh slot row
    if special in ("outlier", "both"):
        x[m - 1] *= 100.0
    return x


def _operands(p, dtype, m, special, kp=64, n=32, seed=0):
    rng = np.random.default_rng(seed + 31 * p + m)
    x = _x(rng, m, kp, special)
    wp = rng.integers(0, 256, (kp * p // 8, n), dtype=np.uint8)
    scales = (rng.random(kp // 16) * 0.2 + 0.05).astype(np.float32)
    xt = torch.from_numpy(x).to(dtype)
    xj = jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16
                               else jnp.float32)
    return xt, xj, wp, scales


CASES = [(1, "zero"), (5, "both")]


@pytest.mark.parametrize("m,special", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [1, 2, 4])
def test_fused_driver_scale_plain_matches_pallas(p, dtype, m, special):
    xt, xj, wp, scales = _operands(p, dtype, m, special)
    sx = pquant.abs_max_scale(xt, dim=-1)
    got = ppm.fused_act_segment_matmul(xt, sx, torch.from_numpy(wp),
                                       torch.from_numpy(scales), p=p)
    want = jpm.fused_act_segment_matmul(
        xj, jnp.asarray(sx.numpy()), jnp.asarray(wp), jnp.asarray(scales),
        p=p, interpret=True)
    assert np.isfinite(got.numpy()).all()
    wd = ppm.unpack_dequant(torch.from_numpy(wp), p, torch.from_numpy(scales))
    _assert_matches_pallas(got, want, ppm.act_quant(xt, sx, p), wd, special)


@pytest.mark.parametrize("m,special", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [1, 2, 4])
def test_fused_selfscale_plain_matches_pallas(p, dtype, m, special):
    xt, xj, wp, scales = _operands(p, dtype, m, special, kp=128, seed=7)
    got = ppm.fused_act_selfscale_matmul(xt, torch.from_numpy(wp),
                                         torch.from_numpy(scales), p=p)
    want = jpm.fused_act_selfscale_matmul(
        xj, jnp.asarray(wp), jnp.asarray(scales), p=p, interpret=True)
    assert np.isfinite(got.numpy()).all()
    wd = ppm.unpack_dequant(torch.from_numpy(wp), p, torch.from_numpy(scales))
    xq = ppm.act_quant(xt, pquant.abs_max_scale(xt, dim=-1), p)
    _assert_matches_pallas(got, want, xq, wd, special)


def test_selfscale_plain_equals_driver_scale_plain_bitwise():
    xt, _xj, wp, scales = _operands(2, torch.bfloat16, 5, "both", kp=128)
    wpt, st = torch.from_numpy(wp), torch.from_numpy(scales)
    a = ppm.fused_act_selfscale_matmul(xt, wpt, st, p=2)
    b = ppm.fused_act_segment_matmul(xt, pquant.abs_max_scale(xt, dim=-1),
                                     wpt, st, p=2)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_wrapper_accumulates_into_out_and_reads_column_slices():
    xt, _xj, wp, scales = _operands(4, torch.float32, 5, "both", kp=64)
    wide = torch.cat([torch.ones(5, 16), xt, torch.ones(5, 16)], dim=1)
    xs = wide[:, 16:80]
    assert xs.stride(0) == 96
    sx = pquant.abs_max_scale(xs, dim=-1)
    base = torch.full((5, 32), 0.5)
    got = ppm.fused_act_segment_matmul(xs, sx, torch.from_numpy(wp),
                                       torch.from_numpy(scales), p=4,
                                       out=base.clone())
    want = base + ppm.fused_act_segment_matmul_plain(
        xt, sx, torch.from_numpy(wp), torch.from_numpy(scales), p=4)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def _weight(pbits, k, n, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.7).astype(np.float32)
    return {"w": w, "pbits": np.asarray(pbits, np.int8)}


@functools.lru_cache(maxsize=None)
def _served_leaf(pbits, k, n, seed):
    """The JAX package's packed leaf and the same leaf as tensors (packed
    once per weight; callers only read them)."""
    leaf = jtransforms.pack_linear(
        _weight(pbits, k, n, seed),
        JQuantConfig(mode="qat", backend="xla_ref"))
    pleaf = {name: None if v is None else torch.from_numpy(np.array(v))
             for name, v in leaf.items()}
    return leaf, pleaf


def _port_leaf(pbits, k, n, seed):
    """The port's own packed leaf (bit-equal to the JAX packing:
    tests/test_torch_pack.py), for checks of the port alone."""
    qat = _weight(pbits, k, n, seed)
    return ptransforms.pack_linear(
        {"w": torch.from_numpy(qat["w"]), "pbits": qat["pbits"]},
        PQuantConfig(mode="qat"))


LEAVES = {
    "mixed": ((4, 2, 1, 4, 2, 2, 1, 4), 128),
    "uniform2": ((2,) * 6, 96),
    "narrow": ((4,), 8),
}


@pytest.mark.parametrize("mode", ["per_token", "per_tensor", "none"])
@pytest.mark.parametrize("leaf", sorted(LEAVES))
def test_driver_matches_jax_xla_ref(leaf, mode):
    pbits, k = LEAVES[leaf]
    jleaf, pleaf = _served_leaf(pbits, k, 24, seed=k)
    x = _x(np.random.default_rng(k + 1), 5, k, "both").reshape(1, 5, k)
    jq = JQuantConfig(mode="serve", act_scale_mode=mode)
    pq = PQuantConfig(mode="serve", act_scale_mode=mode)
    want = jax.jit(lambda leaf, v: jresolve("xla_ref").packed_matmul(
        leaf, v, jq))(jleaf, jnp.asarray(x))
    got = pbackend.packed_matmul(pleaf, torch.from_numpy(x), pq)
    assert got.shape == (1, 5, 24) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["per_token", "per_tensor", "none"])
@pytest.mark.parametrize("leaf", sorted(LEAVES))
def test_fused_equals_two_pass_plain_bitwise(leaf, mode, dtype):
    """The fused driver form and the two-pass form (whole-K fake-quant,
    then plain segment GEMMs) give bit-identical outputs: fusion moves
    the activation quantization, never changes its arithmetic."""
    pbits, k = LEAVES[leaf]
    pleaf = _port_leaf(pbits, k, 24, seed=k + 3)
    x = torch.from_numpy(_x(np.random.default_rng(k), 5, k, "both")).to(dtype)
    fused = PQuantConfig(mode="serve", act_scale_mode=mode)
    two = dataclasses.replace(fused, fuse_act_quant=False)
    a = pbackend.packed_matmul(pleaf, x, fused)
    b = pbackend.packed_matmul(pleaf, x, two)
    assert torch.isfinite(a.float()).all()
    np.testing.assert_array_equal(a.float().numpy(), b.float().numpy())


def test_two_pass_and_wrappers_refuse_non_cpu_tensors():
    """Off the CPU a wrapper launches its kernel or raises — there is no
    quiet fallback to the plain version. The two-pass form (B8, then B3)
    and the unquantized-activation form reach the kernels and raise there
    on a device that is neither the CPU nor the card."""
    pleaf = _port_leaf((4, 2), 32, 8, seed=1)
    meta = {k: None if v is None else v.to("meta") for k, v in pleaf.items()}
    x = torch.empty((2, 32), device="meta")
    for q in (dict(fuse_act_quant=False), dict(quantize_activations=False)):
        with pytest.raises(ValueError, match="unsupported device"):
            pbackend.packed_matmul(meta, x, PQuantConfig(
                mode="serve", act_scale_mode="per_token", **q))
    with pytest.raises(ValueError, match="unsupported device"):
        ppm.fused_act_segment_matmul(x[:, :16],
                                     torch.ones((2, 1), device="meta"),
                                     meta["w4"], None, p=4)
    with pytest.raises(ValueError, match="unsupported device"):
        ppm.packed_segment_matmul(x[:, :16], meta["w4"], None, p=4)
    with pytest.raises(ValueError, match="unsupported device"):
        ppm.packed_segment_matmul_grouped(x[None, :, :16], meta["w4"][None],
                                          None, p=4)


# ------------------------------------------------- plain segment GEMM, B3 ----
@pytest.mark.parametrize("act_quant", [False, True])
@pytest.mark.parametrize("scaled", [True, False])
@pytest.mark.parametrize("p", [1, 2, 4])
def test_plain_segment_plain_matches_pallas(p, scaled, act_quant):
    """B3's plain version against ``packed_segment_matmul`` in interpret
    mode: x as it is, or snapped to the grid (``act_quant``: x already in
    scale units); with and without group scales."""
    xt, xj, wp, scales = _operands(p, torch.float32, 5, "both", seed=11)
    if act_quant:
        xt, xj = xt / 40.0, xj / 40.0          # mostly inside the grid
    st = torch.from_numpy(scales) if scaled else None
    got = ppm.packed_segment_matmul(xt, torch.from_numpy(wp), st, p=p,
                                    act_quant=act_quant)
    want = jpm.packed_segment_matmul(
        xj, jnp.asarray(wp), jnp.asarray(scales) if scaled else None, p=p,
        act_quant=act_quant, interpret=True)
    assert np.isfinite(got.numpy()).all()
    xq = pquant.snap_to_grid(xt, p) if act_quant else xt
    wd = ppm.unpack_dequant(torch.from_numpy(wp), p, st)
    _assert_matches_pallas(got, want, xq, wd, "both")


@pytest.mark.parametrize("act_quant", [False, True])
@pytest.mark.parametrize("p", [1, 2, 4])
def test_grouped_segment_plain_matches_pallas(p, act_quant):
    """B6's plain version against ``packed_segment_matmul_grouped`` in
    interpret mode over E = 3 experts (per-expert group scales; the
    second case without scales)."""
    rng = np.random.default_rng(40 + p)
    e, m, kp, n = 3, 5, 64, 32
    x = np.stack([_x(rng, m, kp, "both") for _ in range(e)])
    if act_quant:
        x = x / 40.0
    wp = rng.integers(0, 256, (e, kp * p // 8, n), dtype=np.uint8)
    scales = None if act_quant else \
        (rng.random((e, kp // 16)) * 0.2 + 0.05).astype(np.float32)
    st = None if scales is None else torch.from_numpy(scales)
    got = ppm.packed_segment_matmul_grouped(
        torch.from_numpy(x), torch.from_numpy(wp), st, p=p,
        act_quant=act_quant)
    want = np.asarray(jpm.packed_segment_matmul_grouped(
        jnp.asarray(x), jnp.asarray(wp),
        None if scales is None else jnp.asarray(scales), p=p,
        act_quant=act_quant, interpret=True))
    assert got.shape == (e, m, n)
    for i in range(e):
        xi = torch.from_numpy(x[i])
        xq = pquant.snap_to_grid(xi, p) if act_quant else xi
        wd = ppm.unpack_dequant(torch.from_numpy(wp[i]), p,
                                None if st is None else st[i])
        _assert_matches_pallas(got[i], want[i], xq, wd, "both")


@pytest.mark.parametrize("leaf", sorted(LEAVES))
def test_unquantized_activations_match_jax_xla_ref(leaf):
    """``quantize_activations=False``: the perm, then the plain segment
    GEMMs on x as it is (B3)."""
    pbits, k = LEAVES[leaf]
    jleaf, pleaf = _served_leaf(pbits, k, 24, seed=k)
    x = _x(np.random.default_rng(k + 2), 5, k, "zero").reshape(5, k)
    jq = JQuantConfig(mode="serve", quantize_activations=False)
    pq = PQuantConfig(mode="serve", quantize_activations=False)
    want = jax.jit(lambda leaf, v: jresolve("xla_ref").packed_matmul(
        leaf, v, jq))(jleaf, jnp.asarray(x))
    got = pbackend.packed_matmul(pleaf, torch.from_numpy(x), pq)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------- one launch over a leaf's segments ----
MIXED_SEGS = [(4, 64), (2, 48), (1, 32)]


def _leaf_segments(segs, n, seed):
    """A leaf's segments [(wp, scales, p, k_off)] and its K."""
    rng = np.random.default_rng(seed)
    ops, off = [], 0
    for p, kp in segs:
        wp = torch.from_numpy(rng.integers(0, 256, (kp * p // 8, n),
                                           dtype=np.uint8))
        sc = torch.from_numpy((rng.random(kp // 16) * 0.2 + 0.05)
                              .astype(np.float32))
        ops.append((wp, sc, p, off))
        off += kp
    return ops, off


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["fused", "self", "plain", "snap"])
def test_segments_wrapper_plain_equals_per_segment_wrappers(mode, dtype):
    """The CPU path of the one-launch wrapper adds each segment's plain
    version into ``out`` in [K4|K2|K1] order: bitwise the per-segment
    wrappers one after the other, and its plain version."""
    segs = [(4, 128)] if mode == "self" else MIXED_SEGS
    ops, k = _leaf_segments(segs, 24, seed=3)
    x = torch.from_numpy(_x(np.random.default_rng(5), 5, k, "both"))
    x = (x / 40.0 if mode == "snap" else x).to(dtype)
    sx = pquant.abs_max_scale(x, dim=-1) if mode == "fused" else None
    kw = dict(sx=sx, self_scale=mode == "self", act_quant=mode == "snap")
    base = torch.full((5, 24), 0.25)
    got = ppm.segments_matmul(x, ops, out=base.clone(), **kw)
    want = base.clone()
    for wp, sc, p, off in ops:
        xs = x[:, off:off + wp.shape[0] * 8 // p]
        if mode == "fused":
            ppm.fused_act_segment_matmul(xs, sx, wp, sc, p=p, out=want)
        elif mode == "self":
            ppm.fused_act_selfscale_matmul(xs, wp, sc, p=p, out=want)
        else:
            ppm.packed_segment_matmul(xs, wp, sc, p=p,
                                      act_quant=mode == "snap", out=want)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    plain = ppm.segments_matmul_plain(x, ops, out=base.clone(), **kw)
    np.testing.assert_array_equal(plain.numpy(), got.numpy())


@pytest.mark.parametrize("mode", ["per_token", "per_tensor", "unquantized"])
@pytest.mark.parametrize("leaf", sorted(LEAVES))
def test_segments_wrapper_matches_jax_xla_ref(leaf, mode):
    """The one-launch wrapper over a JAX-packed leaf's segments, on the
    permuted activations with the driver's scale (or none: unquantized
    activations), against the reference's ``xla_ref`` driver, on rows
    without an outlier (a zero row first): rtol = atol = 1e-5 on every
    row."""
    pbits, k = LEAVES[leaf]
    jleaf, pleaf = _served_leaf(pbits, k, 24, seed=k)
    x = _x(np.random.default_rng(k + 4), 5, k, "zero")
    quantized = mode != "unquantized"
    jq = JQuantConfig(mode="serve", quantize_activations=quantized,
                      act_scale_mode=mode if quantized else "per_token")
    want = jax.jit(lambda leaf, v: jresolve("xla_ref").packed_matmul(
        leaf, v, jq))(jleaf, jnp.asarray(x))
    g = PQuantConfig(mode="serve").eff_group_size(k)
    bufs = {name: pleaf[name] for name in ("w4", "w2", "w1")}
    wscale = pleaf.get("wscale")
    ops = [(bufs[name], None if wscale is None else wscale[go:go + ng], p,
            off) for name, p, off, _kp, go, ng in
           pbackend._segments(bufs, g, expert=False)]
    xp = torch.from_numpy(x).index_select(-1, pleaf["perm"])
    sx = None
    if quantized:
        sx = torch.broadcast_to(pbackend.act_scale(xp, mode).reshape(-1, 1),
                                (5, 1)).contiguous()
    got = ppm.segments_matmul(xp, ops, sx=sx, group_size=g)
    if pleaf.get("b") is not None:
        got = got + pleaf["b"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
