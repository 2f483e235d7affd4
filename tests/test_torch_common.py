"""The port's activations against the reference's, element by element:
``models.common.gelu`` (and the tanh under it) against jitted
``jax.nn.gelu`` on 200,000 draws of N(0, 9), in fp32 and bf16, compiled
with XLA's default flags and as written (bf16 rounded after every op).
Both are bitwise: the port writes out XLA's CPU tanh (a rational
approximation evaluated with fused multiply-adds) and the multiply-add
XLA fuses in the fp32 gelu. So are their gradients against ``jax.vjp``
(JAX's tanh derivative on the rounded output and gelu's transposed ops
in XLA's order, not autograd of the approximation). LayerNorm's gradient
sits within fp32 rounding of the reference's, as close as the
reference's to a float64 oracle."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcommon

from repro_torch.models import common as pcommon

from test_torch_train import _one_thread  # noqa: F401

FLAGS = {"default": {}, "as_written": {"xla_allow_excess_precision": False}}


def _draws():
    return (np.random.default_rng(0).standard_normal(200_000) * 3.0
            ).astype(np.float32)


@pytest.mark.parametrize("flags", sorted(FLAGS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gelu_is_bitwise_the_reference(dtype, flags):
    x = _draws()
    x[:4] = [0.0, 1e-5, -1e-5, 12.0]              # the linear and clamped
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    xj = jnp.asarray(x).astype(jdt)
    fn = jax.jit(jcommon.activation("gelu")).lower(xj).compile(
        compiler_options=FLAGS[flags])
    want = np.asarray(fn(xj).astype(jnp.float32))
    got = pcommon.activation("gelu")(torch.from_numpy(x).to(dtype))
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_tanh_is_bitwise_xla_cpu_tanh():
    x = _draws()
    want = np.asarray(jax.jit(jnp.tanh)(jnp.asarray(x)))
    np.testing.assert_array_equal(pcommon.tanh(torch.from_numpy(x)).numpy(),
                                  want)


def _grid():
    """N(0, 9) draws, values inside tanh's linear branch (|x| <
    ``TANH_LINEAR``) and past its clamp (|x| > ``TANH_CLAMP``), and a
    cotangent."""
    rng = np.random.default_rng(1)
    x = np.concatenate([
        _draws()[:100_000], rng.uniform(-4e-4, 4e-4, 2000),
        rng.uniform(8.0, 40.0, 500), -rng.uniform(8.0, 40.0, 500),
        [0.0, -0.0, 1e-5, pcommon.TANH_LINEAR, pcommon.TANH_CLAMP, 4.8]]
    ).astype(np.float32)
    return x, rng.standard_normal(x.shape).astype(np.float32)


def _torch_vjp(fn, x, g, dtype):
    t = torch.tensor(x).to(dtype).requires_grad_(True)
    out = fn(t)
    out.backward(torch.tensor(g).to(dtype))
    assert t.grad.dtype == dtype
    return out.detach().float().numpy(), t.grad.float().numpy()


@pytest.mark.parametrize("flags", sorted(FLAGS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gelu_gradient_is_bitwise_the_reference(dtype, flags):
    """The gelu's forward and its gradient bitwise ``jax.vjp`` of
    ``jax.nn.gelu`` (jitted) on the grid, in fp32 and bf16, where
    autograd of the forward's ops differs in most values
    (``tools/whisper_train_vs_jax.py``)."""
    x, g = _grid()
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    xj, gj = jnp.asarray(x).astype(jdt), jnp.asarray(g).astype(jdt)
    act = jcommon.activation("gelu")
    fn = jax.jit(lambda a, b: jax.vjp(act, a)[1](b)[0]).lower(
        xj, gj).compile(compiler_options=FLAGS[flags])
    want = np.asarray(fn(xj, gj).astype(jnp.float32))
    fwd, grad = _torch_vjp(pcommon.activation("gelu"),
                           np.asarray(xj.astype(jnp.float32)),
                           np.asarray(gj.astype(jnp.float32)), dtype)
    np.testing.assert_array_equal(
        fwd, np.asarray(jax.jit(act)(xj).astype(jnp.float32)))
    np.testing.assert_array_equal(grad, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tanh_gradient_is_jax_derivative(dtype):
    """``tanh``'s gradient is JAX's, ``(g + g * ans) * (1 - ans)`` on the
    rounded output as XLA transposes and fuses it: bitwise ``jax.vjp`` of
    ``jnp.tanh`` (jitted), where autograd of the rational approximation
    differs in most values (``tools/whisper_train_vs_jax.py``)."""
    x, g = _grid()
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    xj, gj = jnp.asarray(x).astype(jdt), jnp.asarray(g).astype(jdt)
    want = np.asarray(jax.jit(lambda a, b: jax.vjp(jnp.tanh, a)[1](b)[0])(
        xj, gj).astype(jnp.float32))
    _, grad = _torch_vjp(pcommon.tanh, np.asarray(xj.astype(jnp.float32)),
                         np.asarray(gj.astype(jnp.float32)), dtype)
    np.testing.assert_array_equal(grad, want)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("d,spread", [(128, 1.0), (1024, 1.0),
                                      (1024, 30.0)])
def test_layer_norm_gradient_within_rounding_of_jax(d, spread):
    """LayerNorm's output and its gradients (x, ``g``, ``b``) against
    ``jax.vjp`` of ``repro.models.common.layer_norm`` (jitted): within
    relative L2 3e-7, and each within 2e-7 of a float64 oracle, where the
    reference's own sit at 0.6-1.5e-7 (its fp32 sums and XLA's ``rsqrt``
    against the port's float64 sums and ``torch.rsqrt``: a rounding
    difference, not a different gradient)."""
    rng = np.random.default_rng(d)
    x = (rng.normal(0, spread, (64, d)) + rng.normal(0, 1, (64, 1))
         ).astype(np.float32)
    leaf = {"g": rng.normal(1, 0.1, d).astype(np.float32),
            "b": rng.normal(0, 0.1, d).astype(np.float32)}
    cot = rng.standard_normal(x.shape).astype(np.float32)
    jy, vjp = jax.jit(lambda p, a: jax.vjp(jcommon.layer_norm, p, a))(
        leaf, x)
    jleaf, jx = jax.jit(vjp)(cot)
    tx, tg, tb = (torch.tensor(a, requires_grad=True)
                  for a in (x, leaf["g"], leaf["b"]))
    y = pcommon.layer_norm(tg, tb, tx)
    y.backward(torch.tensor(cot))
    xd, gd, bd = (torch.tensor(a, dtype=torch.float64, requires_grad=True)
                  for a in (x, leaf["g"], leaf["b"]))
    xc = xd - xd.mean(-1, keepdim=True)
    yd = xc / torch.sqrt((xc * xc).mean(-1, keepdim=True) + 1e-5) * gd + bd
    yd.backward(torch.tensor(cot, dtype=torch.float64))
    for got, want, oracle in ((y.detach(), jy, yd.detach()),
                              (tx.grad, jx, xd.grad),
                              (tg.grad, jleaf["g"], gd.grad),
                              (tb.grad, jleaf["b"], bd.grad)):
        assert _rel_l2(got, want) <= 3e-7
        assert _rel_l2(got, oracle) <= 2e-7
