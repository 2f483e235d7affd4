"""Port parity for the two training kernels' plain versions and their
backward passes: B9 ``noise_inject`` (with the counter PRNG) and B8
``fake_quant``, against the JAX package's Pallas kernels (interpret mode),
its jnp references and ``jax.grad`` of its backend ops.

Two measured gaps, both in the reference's own numerics:
- sigmoid: ``torch.sigmoid`` and ``jax.nn.sigmoid`` (XLA's logistic) differ
  by up to 2 ulp on some inputs (measured: 764 of 200,000 normal draws of
  std 4, none over 2 ulp). B9 takes sigmoid(s) per group as an operand, so
  its plain version is held bitwise to ``noise_inject_jnp`` on JAX's
  sigmoid, and within the measured sigmoid bound on the port's own.
- FMA: the interpret-mode kernel body is jitted, and XLA contracts
  ``w + sig * eps`` into one fused multiply-add; ``noise_inject_jnp`` (and
  the port, on the card too) rounds the product and the sum separately.
  The two differ by at most one rounding of the output.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backend import base as jbase
from repro.backend import registry as jregistry
from repro.core import quant as jquant
from repro.kernels import prng as jprng

from repro_torch.backend import base as pbase
from repro_torch.core import quant as pquant
from repro_torch.kernels import fake_quant as pfq
from repro_torch.kernels import noise_inject as pni
from repro_torch.kernels import prng as pprng

from test_torch_cuda import EDGE_SCALES, fake_quant_edge_operands
from test_torch_train import _one_thread  # noqa: F401

jni = importlib.import_module("repro.kernels.noise_inject")
jfq = importlib.import_module("repro.kernels.fake_quant")

SIGMA_ULP = 2          # measured bound, torch.sigmoid vs jax.nn.sigmoid
SHAPES = [(32, 48), (64, 96), (128, 40)]


def _ulp(a):
    return np.spacing(np.abs(a).astype(np.float32))


# ----------------------------------------------------------------- prng ----
def test_prng_bit_equal():
    rng = np.random.default_rng(0)
    idx = np.concatenate([rng.integers(0, 2 ** 32, 4096, dtype=np.uint64),
                          [0, 1, 2 ** 31, 2 ** 32 - 1]]).astype(np.uint32)
    for seed in (0, 1, 12345, 2 ** 31 + 7, 2 ** 32 - 1):
        want_h = np.asarray(jprng.hash_u32(jnp.asarray(idx), seed))
        got_h = pprng.hash_u32(torch.tensor(idx.astype(np.int64)), seed)
        np.testing.assert_array_equal(got_h.numpy(), want_h.astype(np.int64))
        want_u = np.asarray(jprng.uniform_pm1(jnp.asarray(idx), seed))
        got_u = pprng.uniform_pm1(torch.tensor(idx.astype(np.int64)), seed)
        assert got_u.dtype == torch.float32
        np.testing.assert_array_equal(got_u.numpy(), want_u)


def test_sigmoid_within_measured_bound():
    s = np.random.default_rng(1).normal(0, 4, 200_000).astype(np.float32)
    want = np.asarray(jax.nn.sigmoid(jnp.asarray(s)))
    got = torch.sigmoid(torch.tensor(s)).numpy()
    d = np.abs(got.view(np.int32).astype(np.int64)
               - want.view(np.int32).astype(np.int64))
    assert d.max() <= SIGMA_ULP


# ------------------------------------------------------------------ B9 ----
def _noise_operands(k, n, seed):
    rng = np.random.default_rng(k * 131 + n + seed)
    w = (rng.standard_normal((k, n)) * 0.8).astype(np.float32)
    w[0, :4] = [2.5, -2.5, 1.9999, -1.0]              # beyond / at the clip
    s = rng.normal(-0.5, 2.0, k // 16).astype(np.float32)
    s[0] = 8.0                                         # sigma ~ 1
    return w, s


@pytest.mark.parametrize("seed", [0, 7, 2 ** 32 - 5])
@pytest.mark.parametrize("k,n", SHAPES)
def test_noise_inject_plain_equals_jax(k, n, seed):
    w, s = _noise_operands(k, n, seed % 1000)
    ref = np.asarray(jbase.noise_inject_jnp(jnp.asarray(w), jnp.asarray(s),
                                            jnp.uint32(seed)))
    jsig = np.asarray(jax.nn.sigmoid(jnp.asarray(s)))
    # On JAX's sigmoid: bit for bit with the reference's jnp forward.
    got = pni.noise_inject_plain(torch.tensor(w), torch.tensor(jsig), seed)
    np.testing.assert_array_equal(got.numpy(), ref)
    # On the port's own sigmoid (the wrapper): within the sigmoid bound.
    mine = pni.noise_inject(torch.tensor(w), torch.tensor(s), seed).numpy()
    # |eps| < 1, so sigma's error moves the product by at most itself; the
    # product's and the sum's roundings add one spacing each.
    sig = np.repeat(jsig, 16)[:, None]
    bound = (SIGMA_ULP + 1) * _ulp(sig) + _ulp(ref)
    assert (np.abs(mine - ref) <= bound).all()
    # The Pallas kernel (interpret, FMA): within the product's rounding
    # and one rounding of the output.
    kern = np.asarray(jni.noise_inject(jnp.asarray(w), jnp.asarray(s),
                                       np.uint32(seed),
                                       interpret=True))
    assert (np.abs(got.numpy() - kern) <= _ulp(sig) + _ulp(kern)).all()


def test_noise_inject_rejects_overflowing_index():
    with pytest.raises(ValueError):
        pprng.element_index(1 << 16, 1 << 16, "cpu")


@pytest.mark.parametrize("k,n", SHAPES[1:])
def test_noise_inject_plain_band_by_band(k, n):
    """The plain versions a band of rows at a time (``row0``: the band's
    first row in the whole weight, whose element index the noise takes)
    equal the whole weight's, forward, dw, ds and ds's bound bitwise: how
    the on-card smoke holds B9 at the readout's 1.246e9 elements."""
    w, s = _noise_operands(k, n, 4)
    w, s = torch.tensor(w), torch.tensor(s)
    g = torch.randn((k, n), generator=torch.Generator().manual_seed(6))
    seed = 4242
    sig = pni.group_sigma(s)
    out = pni.noise_inject_plain(w, sig, seed)
    dw, ds = pni.noise_inject_bwd_plain(w, s, seed, g)
    bnd = pni.ds_bound(w, s, seed, g)
    for a in range(0, k, 32):
        b, gs = a + 32, slice(a // 16, a // 16 + 2)
        assert torch.equal(out[a:b], pni.noise_inject_plain(
            w[a:b], sig[gs], seed, row0=a))
        dw_b, ds_b = pni.noise_inject_bwd_plain(w[a:b], s[gs], seed, g[a:b],
                                                row0=a)
        assert torch.equal(dw[a:b], dw_b) and torch.equal(ds[gs], ds_b)
        assert torch.equal(bnd[gs], pni.ds_bound(w[a:b], s[gs], seed,
                                                 g[a:b], row0=a))
    with pytest.raises(ValueError):
        pprng.element_index(16, 1 << 16, "cpu", row0=(1 << 16) - 8)


@pytest.mark.parametrize("k,n", SHAPES[:2])
def test_noise_inject_backward_equals_jax_grad(k, n):
    w, s = _noise_operands(k, n, 3)
    seed = 99
    g = np.random.default_rng(5).standard_normal((k, n)).astype(np.float32)
    be = jregistry.resolve("xla_ref")

    def f(w_, s_):
        return jnp.sum(be.noise_inject(w_, s_, jnp.uint32(seed)) * g)

    jdw, jds = jax.jit(jax.grad(f, argnums=(0, 1)))(jnp.asarray(w),
                                                    jnp.asarray(s))
    wt = torch.tensor(w, requires_grad=True)
    st = torch.tensor(s, requires_grad=True)
    out = pbase.noise_inject(wt, st, seed)
    (out * torch.tensor(g)).sum().backward()
    np.testing.assert_array_equal(wt.grad.numpy(), np.asarray(jdw))
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(jds), rtol=1e-5,
                               atol=1e-6)


def test_hash_eps_equals_jax():
    got = pbase.hash_eps((48, 80), 4242).numpy()
    want = np.asarray(jbase.hash_eps((48, 80), jnp.uint32(4242)))
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ B8 ----
def _fq_operands(m, k, dtype, rng):
    x = (rng.standard_normal((m, k)) * 1.5).astype(np.float32)
    x[1] = 0.0                                            # zero row
    pbits = rng.choice(np.array([1.0, 2.0, 4.0], np.float32), k // 16)
    sx = np.asarray(jquant.abs_max_scale(jnp.asarray(x), axis=-1))
    # Ties: x / s exactly on a rounding boundary of each group's grid
    # (t = (u / h + 2^p - 1) / 2 = j + 0.5), and clip edges beyond it.
    p = np.repeat(pbits, 16)
    h = 2.0 ** (1 - p)
    j = rng.integers(0, 2 ** p.astype(int))
    u_tie = (2.0 * (j + 0.5) - (2.0 ** p - 1)) * h
    x[2] = (u_tie * sx[2, 0]).astype(np.float32)
    x[3, ::2] = (2.5 * sx[3, 0]).astype(np.float32)       # clip edge
    x[3, 1::2] = -(2.0 - h[1::2]) * sx[3, 0]              # top of the grid
    return jnp.asarray(x).astype(dtype), pbits


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("row_scale", [True, False])
@pytest.mark.parametrize("m,k", [(8, 64), (24, 128)])
def test_fake_quant_plain_equals_pallas(m, k, row_scale, dtype):
    rng = np.random.default_rng(m * 7 + k)
    x, pbits = _fq_operands(m, k, dtype, rng)
    if row_scale:
        scale = jquant.abs_max_scale(x, axis=-1)
    else:
        scale = jquant.per_group_weight_scale(x.T, 16)
    want = jfq.fake_quant(x, jnp.asarray(pbits), scale, row_scale=row_scale,
                          interpret=True)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    xt = torch.tensor(np.asarray(x.astype(jnp.float32))).to(tdt)
    got = pfq.fake_quant(xt, torch.tensor(pbits),
                         torch.tensor(np.asarray(scale)).reshape(-1),
                         row_scale=row_scale)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("row_scale", [True, False])
def test_fake_quant_plain_equals_pallas_on_the_edge_grid(row_scale, dtype):
    """The plain B8 bitwise the reference's Pallas kernel (interpret mode)
    on the card tests' edge grid (``test_torch_cuda.
    fake_quant_edge_operands``: ties, the grid's edge and one ulp either
    side, +-0, +-inf, NaN, subnormal x, a scale near FLT_MAX), so the
    kernel's edge cases on the card are tied to the reference: NaN where
    it has NaN, every other element's bits equal. The grid's two scales
    under 2^-100 (the smallest normal and a subnormal) are held on the
    card only: XLA on the CPU flushes subnormals to zero (the TPU has
    none) and rewrites x / s / h as x / (s h), so the reference returns
    NaN or 0 where IEEE arithmetic, the plain version's and the
    kernel's, returns the grid value times s (ROADMAP C)."""
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    x, pbits, scale = fake_quant_edge_operands(
        tdt, row_scale, 1, [s for s in EDGE_SCALES if s >= 2.0 ** -100])
    xj = jnp.asarray(x.float().numpy()).astype(dtype)
    sj = jnp.asarray(scale.numpy())
    want = np.asarray(jfq.fake_quant(
        xj, jnp.asarray(pbits.numpy()),
        sj.reshape(-1, 1) if row_scale else sj, row_scale=row_scale,
        interpret=True).astype(jnp.float32))
    got = pfq.fake_quant(x, pbits, scale, row_scale=row_scale)
    assert got.dtype == tdt
    got = got.float().numpy()
    nan = np.isnan(want)
    assert nan.any() and np.isinf(want).any()
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32),
                                  want[~nan].view(np.int32))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_fake_quant_weight_layout_equals_swapaxes(dtype):
    """The weight form reads w [K, N] in place; the reference quantizes
    swapaxes(w) [N, K] with the group scale along its last axis."""
    rng = np.random.default_rng(11)
    k, n = 64, 40
    w = jnp.asarray((rng.standard_normal((k, n)) * 0.3).astype(np.float32)
                    ).astype(dtype)
    pbits = rng.choice(np.array([1.0, 2.0, 4.0], np.float32), k // 16)
    sw = jquant.per_group_weight_scale(w, 16)
    want = jnp.swapaxes(jfq.fake_quant(jnp.swapaxes(w, 0, 1),
                                       jnp.asarray(pbits), sw,
                                       row_scale=False, interpret=True), 0, 1)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = pfq.fake_quant(torch.tensor(np.asarray(w.astype(jnp.float32))
                                      ).to(tdt), torch.tensor(pbits),
                         torch.tensor(np.asarray(sw)), row_scale=False,
                         k_dim=0)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_fake_quant_backward_equals_jax_grad():
    rng = np.random.default_rng(3)
    x, pbits = _fq_operands(16, 64, jnp.float32, rng)
    g = rng.standard_normal(x.shape).astype(np.float32)
    be = jregistry.resolve("xla_ref")
    sx = jquant.abs_max_scale(x)                   # per-tensor, [1, 1]
    jdx = jax.jit(jax.grad(lambda x_: jnp.sum(be.fake_quant(
        x_, jnp.asarray(pbits), sx) * g)))(x)
    xt = torch.tensor(np.asarray(x), requires_grad=True)
    y = pbase.fake_quant(xt, torch.tensor(pbits), torch.tensor(np.asarray(sx)))
    (y * torch.tensor(g)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jdx))
    # The weight form: the gradient of swapaxes -> fake_quant -> swapaxes.
    w = jnp.asarray((rng.standard_normal((64, 24)) * 0.2).astype(np.float32))
    gw = rng.standard_normal((64, 24)).astype(np.float32)
    sw = jquant.per_group_weight_scale(w, 16)
    jdw = jax.jit(jax.grad(lambda w_: jnp.sum(jnp.swapaxes(be.fake_quant(
        jnp.swapaxes(w_, 0, 1), jnp.asarray(pbits), sw), 0, 1) * gw)))(w)
    wt = torch.tensor(np.asarray(w), requires_grad=True)
    yw = pbase.fake_quant_weight(wt, torch.tensor(pbits),
                                 torch.tensor(np.asarray(sw)))
    (yw * torch.tensor(gw)).sum().backward()
    np.testing.assert_array_equal(wt.grad.numpy(), np.asarray(jdw))


def test_core_fake_quant_ste_equals_jax():
    rng = np.random.default_rng(9)
    x, pbits = _fq_operands(8, 32, jnp.float32, rng)
    sx = jquant.abs_max_scale(x, axis=-1)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jy, vjp = jax.vjp(lambda x_: jquant.fake_quant(x_, jnp.asarray(pbits),
                                                   sx), x)
    xt = torch.tensor(np.asarray(x), requires_grad=True)
    y = pquant.fake_quant(xt, torch.tensor(pbits), torch.tensor(np.asarray(sx)))
    y.backward(torch.tensor(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(xt.grad.numpy(),
                                  np.asarray(vjp(jnp.asarray(g))[0]))


# ---------------------------------------------- backward plain versions ----
# The plain backward passes (the kernels' plain versions) against the
# reference's custom VJPs, reached through jax.grad of the xla_ref backend:
# dw and dx bitwise, ds within BWD_DS_TOL (the two sum the same fp32 terms
# in different orders).
BWD_DS_TOL = dict(rtol=1e-5, atol=1e-6)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _noise_bwd_operands(k, n, seed):
    """w with elements whose z = w + sigma * eps lands exactly on +-(2 -
    sigma) and others moved one float of w outward from there, logits
    +-8, and a random cotangent."""
    rng = np.random.default_rng(k * 17 + n)
    w = (rng.standard_normal((k, n)) * 0.8).astype(np.float32)
    s = rng.normal(-0.5, 2.0, k // 16).astype(np.float32)
    s[0] = 8.0
    if s.size > 1:
        s[1] = -8.0
    sig = torch.sigmoid(torch.tensor(s)).numpy()
    # The edges are set with the port's sigmoid; they test the reference
    # only where the two sigmoids agree, which these logits do.
    assert np.array_equal(sig, np.asarray(jax.nn.sigmoid(jnp.asarray(s))))
    sg = np.repeat(sig, 16)[:, None]
    lim = np.float32(2.0) - sg
    prod = sg * pni.hash_eps(k, n, seed, "cpu").numpy()
    at, out = [], []
    for r in range(0, k, 7):
        for c in range(min(n, 6)):
            sign = np.float32(1.0 if (r + c) % 2 else -1.0)
            cand = sign * lim[r, 0] - prod[r, c]
            if (cand + prod[r, c]) != sign * lim[r, 0]:
                continue
            if c % 3 == 2:
                cand = np.nextafter(cand, sign * np.float32(4.0))
                out.append((r, c))
            else:
                at.append((r, c))
            w[r, c] = cand
    z = np.abs(w + prod)
    assert at and all(z[rc] == lim[rc[0], 0] for rc in at)
    assert any(z[rc] > lim[rc[0], 0] for rc in out)       # just beyond
    g = rng.standard_normal((k, n)).astype(np.float32)
    return w, s, g


@pytest.mark.parametrize("seed", [0, 2 ** 32 - 5])
@pytest.mark.parametrize("k,n", [(16, 48), (32, 13)])
def test_noise_inject_bwd_plain_equals_jax_vjp(k, n, seed):
    w, s, g = _noise_bwd_operands(k, n, seed)
    be = jregistry.resolve("xla_ref")

    def f(w_, s_):
        return jnp.sum(be.noise_inject(w_, s_, jnp.uint32(seed)) * g)

    # Eager, as the reference's VJP is written: under jit XLA contracts
    # w + sig * eps into one FMA, which moves z by a rounding and flips
    # elements that sit exactly on the clip.
    jdw, jds = jax.grad(f, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(s))
    dw, ds = pni.noise_inject_bwd_plain(torch.tensor(w), torch.tensor(s),
                                        seed, torch.tensor(g))
    assert dw.dtype == torch.float32 and ds.dtype == torch.float32
    np.testing.assert_array_equal(_bits(dw.numpy()), _bits(jdw))
    np.testing.assert_allclose(ds.numpy(), np.asarray(jds), **BWD_DS_TOL)


def _fq_bwd_operands(m, k, k_dim, row_scale, dtype, rng):
    """x ([m, k], or [k, m] for k_dim 0) on power-of-two scales (x / s
    exact), with elements exactly on each group's grid top 2 - 2^(1-p),
    one float of x's dtype beyond it, far beyond, a zero line; a cotangent
    with negative entries where the mask is 0 (dx must keep -0) and a
    NaN."""
    pbits = rng.choice(np.array([1.0, 2.0, 4.0], np.float32), k // 16)
    scale = (2.0 ** rng.integers(-3, 2, m if row_scale else k // 16)
             ).astype(np.float32)
    mm, kk = np.meshgrid(np.arange(m), np.arange(k), indexing="ij")
    top = (2.0 - 2.0 ** (1.0 - pbits[kk // 16])) * (
        scale[mm] if row_scale else scale[kk // 16])      # [m, k], exact
    x = (rng.standard_normal((m, k)) * 1.5).astype(np.float32)
    x[0] = 0.0
    x[1] = top[1]                                         # exactly the top
    x[3, ::2] = 2.5 * top[3, ::2]                         # far beyond
    x = jnp.asarray(x).astype(dtype)
    # One float of x's dtype beyond the top: the next magnitude up.
    up = jnp.asarray(-top[2]).astype(dtype)
    udt = jnp.uint16 if dtype == jnp.bfloat16 else jnp.uint32
    x = x.at[2].set(jax.lax.bitcast_convert_type(
        jax.lax.bitcast_convert_type(up, udt) + 1, dtype))
    g = rng.standard_normal((m, k)).astype(np.float32)
    g[2] = -np.abs(g[2])                 # -0 where the mask is 0
    g[3, 1] = np.nan
    g = jnp.asarray(g).astype(dtype)
    if k_dim == 0:
        x, g = x.T, g.T
    return x, pbits, scale, g


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("row_scale,k_dim", [(True, 1), (False, 1),
                                             (False, 0), (True, 0)])
@pytest.mark.parametrize("m,k", [(13, 16), (32, 48)])
def test_fake_quant_bwd_plain_equals_jax_vjp(m, k, row_scale, k_dim, dtype):
    rng = np.random.default_rng(m * 3 + k + 5 * k_dim + row_scale)
    x, pbits, scale, g = _fq_bwd_operands(m, k, k_dim, row_scale, dtype,
                                          rng)
    be = jregistry.resolve("xla_ref")
    js = jnp.asarray(scale)[:, None] if row_scale else jnp.asarray(scale)
    if k_dim == 1:
        _y, vjp = jax.vjp(lambda x_: be.fake_quant(x_, pbits, js), x)
    else:
        _y, vjp = jax.vjp(lambda x_: jnp.swapaxes(be.fake_quant(
            jnp.swapaxes(x_, 0, 1), pbits, js), 0, 1), x)
    (jdx,) = vjp(g)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    xt = torch.tensor(np.asarray(x.astype(jnp.float32))).to(tdt)
    gt = torch.tensor(np.asarray(g.astype(jnp.float32))).to(tdt)
    dx = pfq.fake_quant_bwd_plain(xt, torch.tensor(pbits),
                                  torch.tensor(scale), gt,
                                  row_scale=row_scale, k_dim=k_dim)
    assert dx.dtype == tdt
    want = np.asarray(jdx.astype(jnp.float32))
    got = dx.float().numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    np.testing.assert_array_equal(_bits(got)[fin], _bits(want)[fin])
    line = got[2] if k_dim == 1 else got[:, 2]
    assert (line == 0).all() and np.signbit(line).all()   # -0 kept
    top = got[1] if k_dim == 1 else got[:, 1]
    assert (top == (gt[1] if k_dim == 1 else gt[:, 1]).float().numpy()
            ).all()                                       # top inside


def test_training_backward_on_cpu_launches_no_kernel():
    """The autograd path on CPU tensors runs the plain backward passes: the
    backward kernels' counters stay at 0 and the gradients are the plain
    versions' own."""
    from repro_torch import kernels
    kernels.reset_launch_counts()
    w, s, g = _noise_bwd_operands(32, 13, 5)
    wt = torch.tensor(w, requires_grad=True)
    st = torch.tensor(s, requires_grad=True)
    (pbase.noise_inject(wt, st, 5) * torch.tensor(g)).sum().backward()
    dw, ds = pni.noise_inject_bwd_plain(torch.tensor(w), torch.tensor(s), 5,
                                        torch.tensor(g))
    assert torch.equal(wt.grad, dw) and torch.equal(st.grad, ds)
    rng = np.random.default_rng(2)
    x, pbits, scale, gx = _fq_bwd_operands(13, 32, 0, False, jnp.float32,
                                           rng)
    xt = torch.tensor(np.asarray(x), requires_grad=True)
    gt = torch.tensor(np.asarray(gx))
    (pbase.fake_quant_weight(xt, torch.tensor(pbits), torch.tensor(scale))
     * torch.nan_to_num(gt)).sum().backward()
    want = pfq.fake_quant_bwd_plain(xt.detach(), torch.tensor(pbits),
                                    torch.tensor(scale),
                                    torch.nan_to_num(gt), row_scale=False,
                                    k_dim=0)
    assert torch.equal(xt.grad, want)
    counts = kernels.launch_counts()
    assert counts["noise_inject_bwd"] == 0 and counts["fake_quant_bwd"] == 0
