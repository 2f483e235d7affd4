"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip without a CUDA device (as on a CPU-only test
machine) and run on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Imports torch only (the machine with the card has no jax).
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.backend import base as backend
from repro_torch.core import quant
from repro_torch.core.qtypes import QuantConfig
from repro_torch.kernels import packed_matmul as pm
from repro_torch.kernels import quant_pack as qp

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _within_reorder_bound(got, want, xq, wd):
    mag = xq.abs().double() @ wd.abs().double()
    err = (got.double() - want.double()).abs()
    return bool((err <= 1e-5 * mag + 1e-6).all())


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("scaled", [True, False])
def test_quantize_pack_bit_equal(dev, p, scaled):
    g = torch.Generator(device=dev).manual_seed(p)
    w = torch.randn((320, 200), generator=g, device=dev)
    w[0, :3] = torch.tensor([0.125, -0.125, 0.0], device=dev)  # ties
    sc = quant.per_group_weight_scale(w) if scaled else None
    got = qp.quantize_pack(w, sc, p=p)
    assert torch.equal(got, qp.quantize_pack_plain(w, sc, p=p))


@pytest.mark.parametrize("self_scale", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("m,kp,n", [(1, 16, 8), (5, 96, 70), (33, 320, 130)])
def test_segment_gemm_within_reorder_bound(dev, p, dtype, self_scale, m, kp,
                                           n):
    g = torch.Generator(device=dev).manual_seed(m * 10 + p)
    wide = torch.randn((m, kp + 32), generator=g, device=dev).to(dtype)
    x = wide[:, 16:16 + kp]                    # a column slice, as the driver
    x[0] = 0                                   # zero row: eps clamp
    x[-1] *= 100                               # outlier row
    wp = torch.randint(0, 256, (kp * p // 8, n), generator=g, device=dev,
                       dtype=torch.uint8)
    sc = torch.rand((kp // 16,), generator=g, device=dev) + 0.01
    if self_scale:
        got = pm.fused_act_selfscale_matmul(x, wp, sc, p=p)
        want = pm.fused_act_selfscale_matmul_plain(x, wp, sc, p=p)
        sx = quant.abs_max_scale(x, dim=-1)
    else:
        sx = quant.abs_max_scale(x, dim=-1)
        got = pm.fused_act_segment_matmul(x, sx, wp, sc, p=p)
        want = pm.fused_act_segment_matmul_plain(x, sx, wp, sc, p=p)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert _within_reorder_bound(got, want, pm.act_quant(x, sx, p),
                                 pm.unpack_dequant(wp, p, sc))


def test_driver_launches_kernels_and_rows_are_batch_invariant(dev):
    """The serve driver on CUDA tensors goes through B1 (mixed leaf) and
    B2 (uniform leaf); each row's output is bitwise the same alone or in
    a batch."""
    g = torch.Generator(device=dev).manual_seed(0)
    for mix, key in (((0.5, 0.375, 0.125), "fused_act_segment_matmul"),
                     ((1.0, 0.0, 0.0), "fused_act_selfscale_matmul")):
        from repro_torch.api import transforms
        q = QuantConfig(mode="qat", mix=mix)
        w = torch.randn((256, 96), generator=g, device=dev)
        leaf = transforms.pack_linear(
            {"w": w, "pbits": torch.as_tensor(q.group_pbits(256))}, q)
        x = torch.randn((7, 256), generator=g, device=dev).to(torch.bfloat16)
        serve = QuantConfig(mode="serve", mix=mix, act_scale_mode="per_token")
        kernels.reset_launch_counts()
        batch = backend.packed_matmul(leaf, x, serve)
        assert kernels.launch_counts()[key] > 0
        for i in range(7):
            alone = backend.packed_matmul(leaf, x[i:i + 1], serve)
            assert torch.equal(alone[0], batch[i])
    with pytest.raises(NotImplementedError):
        backend.packed_matmul(leaf, x, QuantConfig(
            mode="serve", act_scale_mode="per_token", fuse_act_quant=False))
    assert np.isfinite(batch.float().cpu().numpy()).all()
