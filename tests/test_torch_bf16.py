"""bf16 parameters on the port's load path: the weight bridge carries the
JAX package's bf16 leaves bitwise both ways, the packing's group abs-max
reduces a bf16 weight in its own dtype (no fp32 copy of it), and B7's
plain version packs a bf16 weight bitwise as its fp32 widening, equal to
the reference's kernel (interpret mode) on the same bf16 weights. B7's
CUDA launch on bf16 is held to these in tests/test_torch_cuda.py."""
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quant_pack as jquant_pack

from repro_torch import interop
from repro_torch.api import transforms as ptransforms
from repro_torch.core import quant as pquant
from repro_torch.core.qtypes import QuantConfig as PQuantConfig
from repro_torch.kernels import quant_pack as pquant_pack

from test_torch_train import _one_thread  # noqa: F401


def _bf16(shape, seed, scale=1.0):
    """A JAX bfloat16 host array (``jax.device_get``'s dtype) and the
    same values as a torch bf16 tensor."""
    rng = np.random.default_rng(seed)
    w = np.asarray(jnp.asarray(rng.standard_normal(shape) * scale,
                               jnp.bfloat16))
    return w, torch.from_numpy(w.view(np.int16).copy()).view(torch.bfloat16)


def test_interop_carries_bf16_leaves_bitwise():
    """A bf16 leaf as ``jax.device_get`` gives it (bfloat16, kind V) and
    as an npz gives it back (``|V2``) enters the port as a bf16 tensor of
    the same bits, and leaves it as ``|V2`` of the same bits."""
    w, want = _bf16((40, 24), 0)
    assert w.dtype.kind == "V" and w.dtype.itemsize == 2
    buf = io.BytesIO()
    np.savez(buf, w=w.view("V2"))
    buf.seek(0)
    v2 = np.load(buf)["w"]
    assert v2.dtype == np.dtype("V2")
    for leaf in (w, v2):
        lin = interop.linear_from_numpy({"w": leaf,
                                         "pbits": np.full(2, 4, np.int8)},
                                        "cpu")
        assert lin.w.dtype == torch.bfloat16
        assert torch.equal(lin.w.view(torch.int16), want.view(torch.int16))
        back = interop.linear_to_numpy(lin)["w"]
        assert back.dtype == np.dtype("V2")
        np.testing.assert_array_equal(back.view(np.uint16),
                                      w.view(np.uint16))


def test_group_absmax_reduces_bf16_in_place(monkeypatch):
    """``group_absmax`` of a bf16 [S, K, N] weight equals its fp32
    widening's, and no fp32 copy of the weight is made (only the
    [S, K // g] result is cast)."""
    _w, w = _bf16((3, 64, 40), 1, scale=0.05)
    want = ptransforms.group_absmax(w.float(), 16)
    widened = []
    real = torch.Tensor.float

    def spy(t, *a, **k):
        widened.append(t.numel())
        return real(t, *a, **k)

    monkeypatch.setattr(torch.Tensor, "float", spy)
    got = ptransforms.group_absmax(w, 16)
    monkeypatch.undo()
    assert got.dtype == torch.float32 and got.shape == (3, 4)
    assert torch.equal(got, want)
    assert w.numel() not in widened and max(widened, default=0) == 12


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("scaled", [True, False])
def test_quantize_pack_plain_on_bf16(p, scaled):
    """B7's plain version on a bf16 weight: bitwise its run on the fp32
    widening, and equal to the reference's kernel (interpret mode), which
    casts the bf16 weight in the kernel."""
    w, tw = _bf16((128, 24), p + 10, scale=1.3)
    tw[0, :4] = torch.tensor([0.0, 0.125, -0.125, 1.0])     # ties
    w = tw.view(torch.int16).numpy().view(w.dtype)
    rng = np.random.default_rng(p)
    sc = (rng.random(128 // 16) + 0.5).astype(np.float32) if scaled \
        else None
    tsc = None if sc is None else torch.from_numpy(sc)
    got = pquant_pack.quantize_pack(tw, tsc, p=p)
    assert torch.equal(got, pquant_pack.quantize_pack(tw.float(), tsc, p=p))
    want = jquant_pack.quantize_pack(
        jnp.asarray(w), None if sc is None else jnp.asarray(sc), p=p,
        interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_convert_tree_packs_bf16_banks_as_their_fp32_widening():
    """A bf16 [E, K, N] bank and a bf16 linear pack (rebudget, channel
    order, scales, carriers) bitwise as their fp32 widenings."""
    _w, bank = _bf16((4, 64, 40), 3, scale=0.05)
    _w, lin = _bf16((64, 24), 4, scale=0.05)
    rng = np.random.default_rng(5)
    pb = {"bank": torch.from_numpy(rng.choice(np.array([4, 2, 1], np.int8),
                                              (4, 4))),
          "lin": torch.from_numpy(rng.choice(np.array([4, 2, 1], np.int8),
                                             4))}
    qcfg = PQuantConfig(mode="qat")
    tree = {"bank": {"w": bank, "pbits": pb["bank"]},
            "lin": {"w": lin, "pbits": pb["lin"]}}
    wide = {k: {"w": v["w"].float(), "pbits": v["pbits"]}
            for k, v in tree.items()}
    got = ptransforms.convert_tree(tree, qcfg, rebudget=True)
    want = ptransforms.convert_tree(wide, qcfg, rebudget=True)
    for name in ("bank", "lin"):
        for k, v in want[name].items():
            if v is not None:
                assert torch.equal(got[name][k], v), (name, k)
    # The scales are the per-group scale of the sorted bf16 weight.
    w_sorted = bank[0].float()[got["bank"]["perm"][0].long()]
    assert torch.equal(got["bank"]["wscale"][0],
                       pquant.per_group_weight_scale(w_sorted))
