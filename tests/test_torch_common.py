"""The port's activations against the reference's, element by element:
``models.common.gelu`` (and the tanh under it) against jitted
``jax.nn.gelu`` on 200,000 draws of N(0, 9), in fp32 and bf16, compiled
with XLA's default flags and as written (bf16 rounded after every op).
Both are bitwise: the port writes out XLA's CPU tanh (a rational
approximation evaluated with fused multiply-adds) and the multiply-add
XLA fuses in the fp32 gelu."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcommon

from repro_torch.models import common as pcommon

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
