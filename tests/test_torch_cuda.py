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


# ------------------------------------------- decode attention (B4, B5) ----
def _kv_codes(g, shape, dev):
    from repro_torch.serve import kv_quant
    x = torch.randn(shape, generator=g, device=dev) * 2.0
    return kv_quant.quantize_kv(x)


@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("s,t", [(1, 256), (8, 256), (3, 700)])
def test_qkv_attn_decode_within_bound(dev, s, t, window):
    """B4 against its plain version: masked lanes, empty entries, a
    wrapped ring, a ragged last tile (T = 700)."""
    from repro_torch.kernels import attn_decode as ad
    from repro_torch.serve import kv_quant
    g = torch.Generator(device=dev).manual_seed(s * 1000 + t)
    b, hk, gq, d = 3, 2, 4, 80
    q = torch.randn((b, s, hk, gq, d), generator=g, device=dev)
    kc, ks = _kv_codes(g, (b, t, hk, d), dev)
    vc, vs = _kv_codes(g, (b, t, hk, d), dev)
    kv_pos = torch.arange(t, device=dev, dtype=torch.int32).repeat(b, 1)
    kv_pos[0] = (kv_pos[0] + t // 3) % t + t          # wrapped ring
    kv_pos[1, t // 2:] = -1
    q_pos = (torch.arange(s, device=dev, dtype=torch.int32)
             + int(kv_pos.max()) - s + 1).repeat(b, 1)
    q_pos[2, 0] = -1                                   # masked lane
    kernels.reset_launch_counts()
    got = ad.qkv_attn_decode(q, kc, vc, ks, vs, kv_pos, q_pos,
                             window=window)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["qkv_attn_decode"] == 1
    want = ad.qkv_attn_decode_plain(q, kc, vc, ks, vs, kv_pos, q_pos,
                                    window=window)
    k = kv_quant.dequantize_kv(kc, ks, torch.float32)
    v = kv_quant.dequantize_kv(vc, vs, torch.float32)
    bound = ad.error_bound(q, k, v, kv_pos, q_pos, window)
    assert torch.isfinite(got).all()
    assert ((got.double() - want.double()).abs() <= bound).all()


@pytest.mark.parametrize("s", [1, 8])
def test_qkv_attn_decode_paged_within_bound_and_equals_ring(dev, s):
    """B5 against its plain version over a shuffled table with unmapped
    pages and a page two slots share; and on the same content laid out
    as a ring, B5's rows equal B4's bitwise (both round one float64 value
    once), which is what keeps the paged engine token-identical."""
    from repro_torch.kernels import attn_decode as ad
    from repro_torch.serve import kv_pool
    g = torch.Generator(device=dev).manual_seed(s)
    b, hk, gq, d, ps, npg = 3, 2, 4, 80, 16, 6
    npages = b * npg + 1
    q = torch.randn((b, s, hk, gq, d), generator=g, device=dev)
    kc, ks = _kv_codes(g, (npages, ps, hk, d), dev)
    vc, vs = _kv_codes(g, (npages, ps, hk, d), dev)
    for t in (kc, ks, vc, vs):
        t[0] = 0
    perm = torch.randperm(npages - 1, generator=g, device=dev) + 1
    table = perm[:b * npg].reshape(b, npg).to(torch.int32)
    table[0, 2] = -1                                   # unmapped
    table[1, 0] = table[0, 0]                          # shared page
    pool_pos = torch.full((npages, ps), -1, dtype=torch.int32, device=dev)
    for bi in range(b):
        for lp in range(npg):
            pid = int(table[bi, lp])
            if pid > 0:
                pool_pos[pid] = lp * ps + torch.arange(ps, device=dev)
    q_pos = (torch.arange(s, device=dev, dtype=torch.int32)
             + npg * ps - s).repeat(b, 1)
    q_pos[2, -1] = -1
    kernels.reset_launch_counts()
    got = ad.qkv_attn_decode_paged(q, kc, vc, ks, vs, pool_pos, table,
                                   q_pos, window=40)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["qkv_attn_decode_paged"] == 1
    cache = {"k_codes": kc, "v_codes": vc, "k_scale": ks, "v_scale": vs,
             "pos": pool_pos, "page_table": table}
    want = ad.qkv_attn_decode_paged_plain(q, kc, vc, ks, vs, pool_pos,
                                          table, q_pos, window=40)
    k, v, k_pos = kv_pool.gather_paged(cache)
    bound = ad.error_bound(q, k, v, k_pos, q_pos, 40)
    assert torch.isfinite(got).all()
    assert ((got.double() - want.double()).abs() <= bound).all()
    safe = table.long().clamp(min=0)
    ring = [x[safe].reshape((b, npg * ps) + x.shape[2:]).contiguous()
            for x in (kc, vc, ks, vs)]
    ring_out = ad.qkv_attn_decode(q, *ring, k_pos.contiguous(), q_pos,
                                  window=40)
    assert torch.equal(ring_out, got)
