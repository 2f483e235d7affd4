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


def _pack_operands(shape, gen, dev, mix=(0.5, 0.375, 0.125)):
    """B7 operands of a [K, N] linear or an [S, K, N] bank: a random group
    order per slice (expanded to channels), the sorted group scales, and
    the segments of ``mix``; a few elements on rounding ties."""
    *lead, k, n = shape
    s = lead[0] if lead else 1
    w = torch.randn((s, k, n), generator=gen, device=dev) * 0.02
    w[:, 0, :3] = torch.tensor([0.0, 0.25, -0.25], device=dev)[:min(3, n)]
    gperm = torch.argsort(torch.rand((s, k // 16), generator=gen,
                                     device=dev), dim=-1)
    perm = (gperm[..., None] * 16 + torch.arange(16, device=dev)).reshape(
        s, k).to(torch.int32)
    w_sorted = torch.gather(w, 1, perm.long()[..., None].expand(s, k, n))
    sc = torch.stack([quant.per_group_weight_scale(ws) for ws in w_sorted])
    segs = QuantConfig(mode="qat", mix=mix).segments(k)
    if not lead:
        return w[0], perm[0], sc[0], segs
    return w, perm, sc, segs


@pytest.mark.parametrize("shape", [(2560, 640), (2560, 6912), (6912, 2560),
                                   (64, 2048, 1408), (64, 1408, 2048)])
def test_quantize_pack_segments_bitwise_at_full_width(dev, shape):
    """The one-launch entry at the h2o-danube-1.8b linears' shapes and one
    deepseek-moe-16b bank's (default mix): bitwise its plain version, in
    one launch per linear or bank."""
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    w, perm, sc, segs = _pack_operands(shape, g, dev)
    kernels.reset_launch_counts()
    got = qp.quantize_pack_segments(w, perm, sc, segments=segs)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["quantize_pack"] == 1
    want = qp.quantize_pack_segments_plain(w, perm, sc, segments=segs)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("unaligned", ["none", "w", "out"])
@pytest.mark.parametrize("mix", [(0.5, 0.25, 0.25), (0.0, 0.0, 1.0)])
@pytest.mark.parametrize("scaled", [True, False])
def test_quantize_pack_segments_scalar_path(dev, scaled, mix, unaligned):
    """N % 4 != 0 (48 x 13 slices), weights off 16-byte alignment (a bank
    viewed one element into its storage) and carriers off 4-byte alignment
    (``out`` one byte into a buffer) take the scalar body: bitwise the
    plain version, with and without scales, an empty segment included."""
    g = torch.Generator(device=dev).manual_seed(3)
    n = 13 if unaligned == "none" else 16
    w, perm, sc, segs = _pack_operands((3, 48, n), g, dev, mix)
    if unaligned == "w":
        store = torch.empty(w.numel() + 1, device=dev)
        store[1:] = w.reshape(-1)
        w = store[1:].view(w.shape)
        assert w.data_ptr() % 16
    out = None
    if unaligned == "out":
        shapes = [(3, kp * p // 8, n) for p, kp in zip((4, 2, 1), segs)]
        sizes = [a * b * c for a, b, c in shapes]
        parts = torch.split(torch.empty(sum(sizes) + 1, dtype=torch.uint8,
                                        device=dev)[1:], sizes)
        out = [t.view(shape) for t, shape in zip(parts, shapes)]
    sc = sc if scaled else None
    got = qp.quantize_pack_segments(w, perm, sc, segments=segs, out=out)
    want = qp.quantize_pack_segments_plain(w, perm, sc, segments=segs)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    one = qp.quantize_pack_segments(w[1], perm[1],
                                    None if sc is None else sc[1],
                                    segments=segs)
    for a, b in zip(one, want):
        assert torch.equal(a, b[1])


@pytest.mark.parametrize("shape", [(2560, 640), (64, 1408, 2048),
                                   (3, 48, 13), (3, 64, 20), (8192, 33280)])
@pytest.mark.parametrize("scaled", [True, False])
def test_quantize_pack_segments_on_bf16(dev, shape, scaled):
    """B7 on a bf16 weight (the hybrid's parameters), read as it is stored:
    bitwise its plain version and bitwise the fp32 launch on the widened
    weight, one launch; N % 4 != 0 (13) and an unaligned view take the
    scalar body, N = 20 the vector body with a partial column tile;
    (8192, 33280) is jamba-1.5-large-398b's in_proj."""
    g = torch.Generator(device=dev).manual_seed(sum(shape) + scaled)
    w, perm, sc, segs = _pack_operands(shape, g, dev)
    w = w.bfloat16()
    sc = sc if scaled else None
    views = [w]
    if shape[-1] == 13:
        store = torch.empty(w.numel() + 1, dtype=torch.bfloat16, device=dev)
        store[1:] = w.reshape(-1)
        views.append(store[1:].view(w.shape))
    for wv in views:
        kernels.reset_launch_counts()
        got = qp.quantize_pack_segments(wv, perm, sc, segments=segs)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["quantize_pack"] == 1
        wide = qp.quantize_pack_segments(w.float(), perm, sc, segments=segs)
        plain = qp.quantize_pack_segments_plain(wv, perm, sc, segments=segs)
        for a, b, c in zip(got, wide, plain):
            assert torch.equal(a, b) and torch.equal(a, c)


def test_convert_tree_on_the_card_equals_the_cpu():
    """Deploy packing of a reduced deepseek-moe-16b (attention, dense and
    shared MLPs, [E, K, N] banks) on the card: every serve leaf bitwise
    the CPU's, one B7 launch per linear and per bank."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.api import transforms
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = get_config("deepseek-moe-16b").reduced().with_quant_mode("qat")
    qcfg = cfg.quant.with_mode("serve")
    want = transforms.convert_tree(
        lm.init_params(cfg, seed=3, device="cpu").tree(), qcfg,
        rebudget=True)
    card = lm.init_params(cfg, seed=3, device="cpu").to("cuda")
    kernels.reset_launch_counts()
    got = transforms.convert_tree(card.tree(), qcfg, rebudget=True)
    launches = kernels.launch_counts()["quantize_pack"]
    leaves = 0

    def walk(a, b):
        nonlocal leaves
        if isinstance(a, dict):
            assert set(a) == set(b)
            leaves += "w4" in a
            for key in a:
                walk(a[key], b[key])
        elif isinstance(a, (list, tuple)):
            for x, y in zip(a, b):
                walk(x, y)
        elif a is not None:
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b)

    walk(got, want)
    assert launches == leaves > 0


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
    a batch. The two-pass form (B8, then B3) gives bitwise the fused
    output, and unquantized activations go through B3."""
    import dataclasses
    from repro_torch.api import transforms
    g = torch.Generator(device=dev).manual_seed(0)
    for mix, key in (((0.5, 0.375, 0.125), "fused_act_segment_matmul"),
                     ((1.0, 0.0, 0.0), "fused_act_selfscale_matmul")):
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
        for mode in ("per_token", "per_tensor"):
            fused = dataclasses.replace(serve, act_scale_mode=mode)
            two = dataclasses.replace(fused, fuse_act_quant=False)
            kernels.reset_launch_counts()
            assert torch.equal(backend.packed_matmul(leaf, x, two),
                               backend.packed_matmul(leaf, x, fused))
            counts = kernels.launch_counts()
            assert counts["fake_quant"] == 1
            assert counts["packed_segment_matmul"] > 0
        kernels.reset_launch_counts()
        raw = backend.packed_matmul(leaf, x, dataclasses.replace(
            serve, quantize_activations=False))
        assert kernels.launch_counts()["packed_segment_matmul"] > 0
        assert kernels.launch_counts()["fake_quant"] == 0
        assert torch.isfinite(raw.float()).all()
    assert np.isfinite(batch.float().cpu().numpy()).all()


@pytest.mark.parametrize("act_quant", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("m,kp,n", [(1, 16, 8), (5, 96, 70), (33, 320, 130)])
def test_plain_segment_gemm_within_reorder_bound(dev, p, dtype, act_quant,
                                                 m, kp, n):
    """B3 against its plain version: a column slice of a wider row, a zero
    row and an outlier row, x as it is or snapped (``act_quant``)."""
    g = torch.Generator(device=dev).manual_seed(m * 10 + p)
    wide = torch.randn((m, kp + 32), generator=g, device=dev).to(dtype)
    x = wide[:, 16:16 + kp]
    x[0] = 0
    x[-1] *= 100
    wp = torch.randint(0, 256, (kp * p // 8, n), generator=g, device=dev,
                       dtype=torch.uint8)
    sc = torch.rand((kp // 16,), generator=g, device=dev) + 0.01
    kernels.reset_launch_counts()
    got = pm.packed_segment_matmul(x, wp, sc, p=p, act_quant=act_quant)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["packed_segment_matmul"] == 1
    want = pm.segment_matmul_plain(x, wp, sc, p=p, act_quant=act_quant)
    xq = quant.snap_to_grid(x.float(), p) if act_quant else x.float()
    assert torch.isfinite(got).all()
    assert _within_reorder_bound(got, want, xq, pm.unpack_dequant(wp, p, sc))


@pytest.mark.parametrize("scaled", [True, False])
@pytest.mark.parametrize("p", [1, 2, 4])
def test_grouped_segment_gemm_equals_b3_per_expert(dev, p, scaled):
    """B6 over E = 5 experts (a column slice of x and of the per-expert
    scales, as the grouped driver passes them): within the reordering
    bound of its plain version, and expert e bitwise B3 on expert e."""
    g = torch.Generator(device=dev).manual_seed(100 + p)
    e, m, kp, n = 5, 4, 160, 72
    wide = torch.randn((e, m, kp + 48), generator=g, device=dev).to(
        torch.bfloat16)
    x = wide[:, :, 32:32 + kp]
    x[:, 1] = 0                                 # empty dispatch rows
    x[2, -1] *= 100
    wp = torch.randint(0, 256, (e, kp * p // 8, n), generator=g, device=dev,
                       dtype=torch.uint8)
    sc_all = torch.rand((e, kp // 16 + 3), generator=g, device=dev) + 0.01
    sc = sc_all[:, 3:] if scaled else None
    kernels.reset_launch_counts()
    got = pm.packed_segment_matmul_grouped(x, wp, sc, p=p)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["packed_segment_matmul_grouped"] == 1
    want = pm.grouped_matmul_plain(x, wp, sc, p=p)
    for i in range(e):
        si = None if sc is None else sc[i].contiguous()
        assert _within_reorder_bound(got[i], want[i], x[i].float(),
                                     pm.unpack_dequant(wp[i], p, si))
        assert torch.equal(got[i], pm.packed_segment_matmul(x[i], wp[i], si,
                                                            p=p))


def _segment_operands(g, dev, m, segs, n, dtype, e=None, group=16):
    """x [(E,) M, K] (a column slice of a wider row) and one leaf's
    segments [(wp, scales, p, k_off)] for the precisions ``segs`` [(p,
    kp)], with a zero row and an outlier row."""
    k = sum(kp for _p, kp in segs)
    lead = () if e is None else (e,)
    wide = torch.randn(lead + (m, k + 32), generator=g, device=dev)
    x = wide[..., 16:16 + k]
    x[..., 0, :] = 0
    x[..., -1, :] *= 100
    x = x.to(dtype)
    ops, off = [], 0
    for p, kp in segs:
        wp = torch.randint(0, 256, lead + (kp * p // 8, n), generator=g,
                           device=dev, dtype=torch.uint8)
        sc = torch.rand(lead + (-(-kp // group),), generator=g,
                        device=dev) + 0.01
        ops.append((wp, sc, p, off))
        off += kp
    return x, ops


MIXED = [(4, 160), (2, 96), (1, 64)]
# h2o-danube-1.8b's K = 2560 split: 160 slices, so a narrow N takes the
# split-K cluster at M <= 16 and not at M > 16.
WIDE = [(4, 1280), (2, 960), (1, 320)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["fused", "plain", "snap", "grouped",
                                  "grouped_snap"])
@pytest.mark.parametrize("segs", [MIXED, WIDE], ids=["mixed", "wide"])
@pytest.mark.parametrize("m", [1, 4, 33])
def test_multi_segment_launch_equals_single_launches_bitwise(dev, mode,
                                                             dtype, m,
                                                             segs):
    """One launch over a leaf's three segments is bitwise the three
    single-segment launches into the same accumulator, in every mode."""
    g = torch.Generator(device=dev).manual_seed(m)
    grouped = mode.startswith("grouped")
    x, ops = _segment_operands(g, dev, m, segs, 100, dtype,
                               e=3 if grouped else None)
    base = torch.randn(tuple(x.shape[:-1]) + (100,), generator=g,
                       device=dev)
    sx = quant.abs_max_scale(x, dim=-1).float().contiguous() \
        if mode == "fused" else None
    kw = dict(act_quant=mode.endswith("snap"))
    kernels.reset_launch_counts()
    one = pm.segments_matmul(x, ops, sx=sx, out=base.clone(), **kw)
    key = ("packed_segment_matmul_grouped" if grouped else
           "fused_act_segment_matmul" if mode == "fused" else
           "packed_segment_matmul")
    assert kernels.launch_counts()[key] == 1
    three = base.clone()
    for wp, sc, p, off in ops:
        xs = x[..., off:off + wp.shape[-2] * 8 // p]
        if grouped:
            pm.packed_segment_matmul_grouped(xs, wp, sc, p=p, out=three,
                                             **kw)
        elif mode == "fused":
            pm.fused_act_segment_matmul(xs, sx, wp, sc, p=p, out=three)
        else:
            pm.packed_segment_matmul(xs, wp, sc, p=p, out=three, **kw)
    torch.cuda.synchronize()
    assert torch.equal(one, three)
    cpu = pm.segments_matmul(x.cpu(), [(wp.cpu(), sc.cpu(), p, off)
                                       for wp, sc, p, off in ops],
                             sx=None if sx is None else sx.cpu(),
                             out=base.cpu(), **kw)
    def quantized(xs, p):
        if mode == "fused":
            return pm.act_quant(xs, sx, p)
        return quant.snap_to_grid(xs.float(), p) if kw["act_quant"] \
            else xs.float()

    xq = torch.cat([quantized(x[..., off:off + wp.shape[-2] * 8 // p], p)
                    for wp, _sc, p, off in ops], dim=-1)
    for i in range(3 if grouped else 1):
        sel = (lambda t: t[i]) if grouped else (lambda t: t)
        wd = torch.cat([pm.unpack_dequant(sel(wp), p, sel(sc).contiguous())
                        for wp, sc, p, off in ops])
        assert _within_reorder_bound(sel(one) - sel(base),
                                     sel(cpu).to(dev) - sel(base),
                                     sel(xq), wd)


@pytest.mark.parametrize("mode", ["fused", "plain", "grouped"])
@pytest.mark.parametrize("segs", [MIXED, WIDE], ids=["mixed", "wide"])
@pytest.mark.parametrize("m", [1, 4, 16])
def test_draft_launch_bitwise_the_launch_at_offset_zero(dev, mode, m, segs):
    """A draft launch reads the [K2|K1] segments only, the first at
    k_off = K4: bitwise the same launch on x's columns from K4 on (k_off
    0, the layout of every full launch), and within the fp32 bound of
    the plain version; one launch, at the decode (4) and verify (16)
    widths."""
    g = torch.Generator(device=dev).manual_seed(m + 7)
    grouped = mode == "grouped"
    x, ops = _segment_operands(g, dev, m, segs, 100, torch.bfloat16,
                               e=3 if grouped else None)
    draft = [op for op in ops if op[2] <= 2]
    k0 = draft[0][3]
    assert k0 == segs[0][1]
    sx = quant.abs_max_scale(x, dim=-1).float().contiguous() \
        if mode == "fused" else None
    kernels.reset_launch_counts()
    got = pm.segments_matmul(x, draft, sx=sx)
    assert sum(kernels.launch_counts().values()) == 1
    at0 = pm.segments_matmul(x[..., k0:], [(wp, sc, p, off - k0)
                                           for wp, sc, p, off in draft],
                             sx=sx)
    torch.cuda.synchronize()
    assert torch.equal(got, at0)
    want = pm.segments_matmul_plain(x, draft, sx=sx)
    xq = torch.cat([pm.act_quant(x[..., off:off + wp.shape[-2] * 8 // p], sx,
                                 p) if sx is not None else
                    x[..., off:off + wp.shape[-2] * 8 // p].float()
                    for wp, _sc, p, off in draft], dim=-1)
    for i in range(3 if grouped else 1):
        sel = (lambda t: t[i]) if grouped else (lambda t: t)
        wd = torch.cat([pm.unpack_dequant(sel(wp), p, sel(sc).contiguous())
                        for wp, sc, p, off in draft])
        assert _within_reorder_bound(sel(got), sel(want), sel(xq), wd)


@pytest.mark.parametrize("mode", ["fused", "self", "plain", "grouped"])
def test_rows_are_bitwise_equal_across_batch_sizes(dev, mode):
    """A row's output does not depend on how many rows share the launch
    (M in {1, 4, 5, 16, 17, 32, 33}: every row tile the kernel picks, with
    the split-K cluster and without)."""
    g = torch.Generator(device=dev).manual_seed(7)
    segs = [(4, 2560)] if mode == "self" else WIDE
    x, ops = _segment_operands(g, dev, 33, segs, 72, torch.bfloat16,
                               e=2 if mode == "grouped" else None)
    sx = quant.abs_max_scale(x, dim=-1).float().contiguous()
    ref = None
    for m in (33, 32, 17, 16, 5, 4, 1):
        xm = x[..., :m, :]
        got = pm.segments_matmul(
            xm, ops, sx=sx[:m].contiguous() if mode == "fused" else None,
            self_scale=mode == "self")
        if ref is None:
            ref = got
        assert torch.equal(got, ref[..., :m, :]), m


@pytest.mark.parametrize("act_quant", [False, True])
def test_grouped_rows_skip_dead_rows_and_experts(dev, act_quant):
    """B6 with ``rows``: the live rows equal the launch without it, rows
    past each expert's count (and experts with none) are left as they
    were."""
    g = torch.Generator(device=dev).manual_seed(11)
    e, m = 6, 5
    x, ops = _segment_operands(g, dev, m, MIXED, 70, torch.bfloat16, e=e)
    rows = torch.tensor([0, 5, 2, 0, 1, 4], dtype=torch.int32, device=dev)
    sentinel = torch.full((e, m, 70), 3.25, device=dev)
    full = pm.segments_matmul(x, ops, act_quant=act_quant,
                              out=sentinel.clone())
    kernels.reset_launch_counts()
    part = pm.segments_matmul(x, ops, act_quant=act_quant, rows=rows,
                              out=sentinel.clone())
    torch.cuda.synchronize()
    assert kernels.launch_counts()["packed_segment_matmul_grouped"] == 1
    for i, r in enumerate(rows.tolist()):
        assert torch.equal(part[i, :r], full[i, :r])
        assert (part[i, r:] == 3.25).all()
    cpu = pm.segments_matmul(x.cpu(), [(wp.cpu(), sc.cpu(), p, off)
                                       for wp, sc, p, off in ops],
                             act_quant=act_quant, rows=rows.cpu(),
                             out=sentinel.cpu())
    for i, r in enumerate(rows.tolist()):
        assert (cpu[i, r:] == 3.25).all()


# Kp that leave a partial round of slices, at group 16 and at group sizes
# that cut the 16-channel slices mid-group.
KP_GROUPS = [(kp, 16) for kp in (16, 48, 320, 1296)] + [
    (kp, grp) for kp in (48, 1296) for grp in (6, 24)]


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("kp,group", KP_GROUPS)
def test_segment_gemm_any_kp_and_group_within_bound(dev, kp, group, p):
    """B1 against its plain version on segments whose Kp is no multiple of
    a round of slices, and on group sizes other than 16."""
    g = torch.Generator(device=dev).manual_seed(kp + p)
    x, ops = _segment_operands(g, dev, 5, [(p, kp)], 96, torch.bfloat16,
                               group=group)
    wp, sc, _p, _off = ops[0]
    sx = quant.abs_max_scale(x, dim=-1).float().contiguous()
    got = pm.fused_act_segment_matmul(x, sx, wp, sc, p=p, group_size=group)
    want = pm.fused_act_segment_matmul_plain(x, sx, wp, sc, p=p,
                                             group_size=group)
    torch.cuda.synchronize()
    assert _within_reorder_bound(got, want, pm.act_quant(x, sx, p),
                                 pm.unpack_dequant(wp, p, sc, group))


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


def _attn_pool(g, dev, b, s, hk, gq, d, ps, npg):
    """A shuffled pool with page 2 of slot 0 and the last page of slot 1
    unmapped and a page slots 0 and 1 share, stamped as a ring of npg * ps
    entries; and the same content laid out as B4's ring."""
    from repro_torch.serve import kv_pool
    npages = b * npg + 1
    q = torch.randn((b, s, hk, gq, d), generator=g, device=dev)
    kc, ks = _kv_codes(g, (npages, ps, hk, d), dev)
    vc, vs = _kv_codes(g, (npages, ps, hk, d), dev)
    for t in (kc, ks, vc, vs):
        t[0] = 0
    perm = torch.randperm(npages - 1, generator=g, device=dev) + 1
    table = perm[:b * npg].reshape(b, npg).to(torch.int32)
    table[0, min(2, npg - 1)] = -1
    if b > 1:
        table[1, 0] = table[0, 0]
        table[1, -1] = -1
    pool_pos = torch.full((npages, ps), -1, dtype=torch.int32, device=dev)
    for bi in range(b):
        for lp in range(npg):
            pid = int(table[bi, lp])
            if pid > 0:
                pool_pos[pid] = lp * ps + torch.arange(ps, device=dev)
    q_pos = (torch.arange(s, device=dev, dtype=torch.int32)
             + npg * ps - s).repeat(b, 1)
    q_pos[-1, 0] = -1                                  # masked lane
    paged = (q, kc, vc, ks, vs, pool_pos, table, q_pos)
    cache = {"k_codes": kc, "v_codes": vc, "k_scale": ks, "v_scale": vs,
             "pos": pool_pos, "page_table": table}
    k_pos = kv_pool.gather_paged(cache)[2]
    safe = table.long().clamp(min=0)
    ring = [x[safe].reshape((b, npg * ps) + x.shape[2:]).contiguous()
            for x in (kc, vc, ks, vs)]
    return paged, (q, *ring, k_pos.contiguous(), q_pos)


@pytest.mark.parametrize("hk,gq,d", [(2, 4, 80), (2, 1, 128)],
                         ids=["h2o", "deepseek"])
@pytest.mark.parametrize("ps,npg,window", [(4, 37, None), (16, 17, 100),
                                           (16, 160, 1000)])
def test_paged_equals_ring_bitwise(dev, ps, npg, window, hk, gq, d):
    """One body, two address modes: B5 equals B4 bitwise on the same
    content laid out as a ring, at page sizes 4 and 16, entry counts not a
    multiple of the chunk length (148, 272) and one split into 64-entry
    chunks (2560), and at the G = 1, D = 128 shape; both within the bound
    of their plain version, one launch each."""
    from repro_torch.kernels import attn_decode as ad
    from repro_torch.serve import kv_quant
    g = torch.Generator(device=dev).manual_seed(ps * 1000 + npg + d)
    paged, ring = _attn_pool(g, dev, 3, 1, hk, gq, d, ps, npg)
    kernels.reset_launch_counts()
    got = ad.qkv_attn_decode_paged(*paged, window=window)
    ring_out = ad.qkv_attn_decode(*ring, window=window)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["qkv_attn_decode_paged"] == 1
    assert counts["qkv_attn_decode"] == 1
    assert torch.isfinite(got).all()
    assert torch.equal(ring_out, got)
    want = ad.qkv_attn_decode_plain(*ring, window=window)
    kd = kv_quant.dequantize_kv(ring[1], ring[3], torch.float32)
    vd = kv_quant.dequantize_kv(ring[2], ring[4], torch.float32)
    bound = ad.error_bound(ring[0], kd, vd, ring[5], ring[6], window)
    assert ((got.double() - want.double()).abs() <= bound).all()


@pytest.mark.parametrize("hk,gq,d", [(8, 4, 80), (16, 1, 128)],
                         ids=["h2o", "deepseek"])
@pytest.mark.parametrize("t,window", [(256, None), (4096, 1024), (100, 7)])
def test_attention_rows_alone_batched_and_repeated_bitwise(dev, t, window,
                                                           hk, gq, d):
    """A row's output is bitwise the same alone and in a batch of 4, in a
    decode step (S = 1) and as a row of a prefill chunk (S = 8), and from
    run to run: the split and every order are fixed by T alone."""
    from repro_torch.kernels import attn_decode as ad
    g = torch.Generator(device=dev).manual_seed(t + d)
    b, s = 4, 8
    q = torch.randn((b, s, hk, gq, d), generator=g, device=dev)
    kc, ks = _kv_codes(g, (b, t, hk, d), dev)
    vc, vs = _kv_codes(g, (b, t, hk, d), dev)
    kv_pos = torch.arange(t, device=dev, dtype=torch.int32).repeat(b, 1)
    kv_pos[0] = (kv_pos[0] + t // 3) % t + t          # wrapped ring
    kv_pos[1, t // 2:] = -1
    q_pos = (torch.arange(s, device=dev, dtype=torch.int32)
             + int(kv_pos.max()) - s + 1).repeat(b, 1)
    q_pos[3, s - 1] = -1                               # masked lane
    ops = (kc, vc, ks, vs, kv_pos)
    full = ad.qkv_attn_decode(q, *ops, q_pos, window=window)
    again = ad.qkv_attn_decode(q, *ops, q_pos, window=window)
    assert torch.equal(full, again)
    last = ad.qkv_attn_decode(q[:, -1:].contiguous(), *ops,
                              q_pos[:, -1:].contiguous(), window=window)
    assert torch.equal(last[:, 0], full[:, -1])
    for bi in range(b):
        one = ad.qkv_attn_decode(
            q[bi:bi + 1, -1:].contiguous(),
            *(x[bi:bi + 1].contiguous() for x in ops),
            q_pos[bi:bi + 1, -1:].contiguous(), window=window)
        assert torch.equal(one[0], last[bi])


@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
@pytest.mark.parametrize("hk,gq,d", [(8, 4, 80), (16, 1, 128), (4, 9, 128)],
                         ids=["h2o", "deepseek", "starcoder2"])
def test_verify_lanes_bitwise_the_decode_rows(dev, hk, gq, d, paged):
    """The verify step of k = 3 (S = 4 lanes at consecutive positions, the
    later lanes' entries already in the cache, a masked lane): lane j is
    bitwise the S = 1 call at lane j's position on the same cache, for
    B4 and B5, at G = 4, 1 (the decode runs the 1-row body, the verify
    the 4-row one) and 9 (a ragged last tile)."""
    from repro_torch.kernels import attn_decode as ad
    g = torch.Generator(device=dev).manual_seed(hk * 100 + gq + d)
    b, s = 4, 4
    if paged:
        args, _ring = _attn_pool(g, dev, b, s, hk, gq, d, 16, 16)
        fn = ad.qkv_attn_decode_paged
    else:
        t = 256
        kc, ks = _kv_codes(g, (b, t, hk, d), dev)
        vc, vs = _kv_codes(g, (b, t, hk, d), dev)
        kv_pos = torch.arange(t, device=dev, dtype=torch.int32).repeat(b, 1)
        q_pos = (torch.arange(s, device=dev, dtype=torch.int32)
                 + t - s).repeat(b, 1)
        q = torch.randn((b, s, hk, gq, d), generator=g, device=dev)
        args = (q, kc, vc, ks, vs, kv_pos, q_pos)
        fn = ad.qkv_attn_decode
    args = list(args)
    args[-1] = args[-1].clone()
    args[-1][3, 0] = -1                                # a masked lane
    full = fn(*args)
    q, q_pos = args[0], args[-1]
    for j in range(s):
        one = list(args)
        one[0] = q[:, j:j + 1].contiguous()
        one[-1] = q_pos[:, j:j + 1].contiguous()
        lane = fn(*one)
        torch.cuda.synchronize()
        assert torch.equal(lane[:, 0], full[:, j]), j


# ------------------------------------------------------------ training ----
# h2o-danube-1.8b's training linears, a ragged one, and mamba2-2.7b's
# in_proj (N = 10576, not a multiple of 64) and out_proj.
TRAIN_SHAPES = [(2560, 640), (6912, 2560), (48, 13), (2560, 10576),
                (5120, 2560)]


@pytest.mark.parametrize("k,n", TRAIN_SHAPES)
def test_noise_inject_bit_equal(dev, k, n):
    from repro_torch.kernels import noise_inject as ni
    g = torch.Generator(device=dev).manual_seed(k + n)
    w = torch.rand((k, n), generator=g, device=dev) * 2.2 - 1.1
    w[0, :4] = torch.tensor([2.5, -2.5, 1.999, -1.0], device=dev)
    s = torch.randn((k // 16,), generator=g, device=dev) * 2.0
    seed = torch.randint(0, 1 << 32, (1,), generator=g, device=dev)
    kernels.reset_launch_counts()
    got = ni.noise_inject(w, s, seed)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["noise_inject"] == 1
    assert torch.equal(got, ni.noise_inject_plain(w, ni.group_sigma(s),
                                                  seed))


# B8's edge grid: per precision of the config's bands, 16 values of x / s
# (column j of a group): the rounding ties next to the grid's ends, the
# grid's edge 2 - 2^(1-p) and one ulp (of x's dtype) either side of it,
# -(2 - 2^(1-p)) and one ulp beyond, beyond the clip, +-0, +-inf, NaN, a
# subnormal x (set after scaling) and two values inside; times scales
# that are a power of two, abs-max / 1.875 values, other significands,
# the smallest normal, a subnormal and one near FLT_MAX.
EDGE_PBITS = (1.0, 2.0, 4.0)
EDGE_SCALES = (0.25, 7.2 / 1.875, 0.3 / 1.875, 0.1, 2.0 ** -126, 1e-40,
               3e38)


def _edge_values(p, dtype):
    h = 2.0 ** (1 - p)
    g = 2.0 - h
    inf, nan = float("inf"), float("nan")
    vals = torch.tensor([-g + h, g - h, g, g, g, -g, -g, 2.5, 0.0, -0.0,
                         inf, -inf, nan, 0.0, 1.5 * h, 0.7]).to(dtype)
    bits = vals.view(torch.int16 if dtype == torch.bfloat16 else torch.int32)
    bits[3] += 1      # one ulp above the edge
    bits[4] -= 1      # one ulp below it
    bits[6] += 1      # one ulp beyond -(2 - 2^(1-p))
    return vals


def fake_quant_edge_operands(dtype, row_scale, k_dim, scales=EDGE_SCALES):
    """B8's operands over the edge grid in the layout of (row_scale,
    k_dim), CPU tensors: (x, pbits, scale). A per-row scale: one row a
    scale, K = 48 (one group a precision); a per-group scale: one group a
    (scale, precision), two rows (the second reversed within each
    group). k_dim 0 is the transposed (weight) layout."""
    scales = torch.tensor(scales, dtype=torch.float32)
    if row_scale:
        vals = torch.cat([_edge_values(p, dtype) for p in EDGE_PBITS])
        x = (vals.float()[None] * scales[:, None]).to(dtype)
        x[:, 13::16] = _subnormal(dtype)
        pbits = torch.tensor(EDGE_PBITS)
        scale = scales
    else:
        groups = [(p, s) for s in scales for p in EDGE_PBITS]
        row = torch.cat([(_edge_values(p, dtype).float() * s).to(dtype)
                         for p, s in groups])
        row[13::16] = _subnormal(dtype)
        x = torch.stack([row, row.reshape(-1, 16).flip(-1).reshape(-1)])
        pbits = torch.tensor([p for p, _s in groups])
        scale = torch.stack([s for _p, s in groups])
    x = x if k_dim == 1 else x.t().contiguous()
    return x, pbits, scale


def _subnormal(dtype):
    one = torch.ones((), dtype=torch.int16 if dtype == torch.bfloat16
                     else torch.int32)
    return one.view(dtype)


def _same_bits_or_nan(got, want):
    """Bitwise equal, NaN in the same places (whatever its payload)."""
    nan = want.isnan()
    return (torch.equal(got.isnan(), nan)
            and torch.equal(_int_view(got)[~nan], _int_view(want)[~nan]))


def _fake_quant_case(case, dtype, row_scale, k_dim, g, dev):
    """(x, pbits, scale, group_size) of one case of B8's bitwise test."""
    if case == "edge":
        x, pb, scale = fake_quant_edge_operands(dtype, row_scale, k_dim)
        return x.to(dev), pb.to(dev), scale.to(dev), 16
    # random: K = 2560; ragged: C not a multiple of 8 or 4 (K slow: N =
    # 1001; K fast is a multiple of 16, so its C = K = 2560); offset: x at
    # an odd element offset of its buffer; narrow: K = 12 < 16, one group.
    k = 12 if case == "narrow" else 2560
    m = 1001 if case == "ragged" else 96
    shape = (k, m) if k_dim == 0 else (m, k)
    n = shape[0] * shape[1]
    buf = (torch.randn(n + 1, generator=g, device=dev) * 2).to(dtype)
    x = (buf[1:] if case == "offset" else buf[:n]).view(shape)
    x[1] = 0
    group = min(k, 16)
    pb = torch.tensor([1.0, 2.0, 4.0], device=dev)[torch.randint(
        0, 3, (k // group,), generator=g, device=dev)]
    if row_scale:
        scale = quant.abs_max_scale(x, dim=k_dim).reshape(-1)
    else:
        xt = x if k_dim == 0 else x.t()
        scale = quant.per_group_weight_scale(xt, group)
    return x, pb, scale.contiguous(), group


@pytest.mark.parametrize("case", ["random", "edge", "ragged", "offset",
                                  "narrow"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("row_scale,k_dim", [(True, 1), (False, 1),
                                             (False, 0), (True, 0)])
def test_fake_quant_bit_equal(dev, dtype, row_scale, k_dim, case):
    """B8 bitwise its plain version (NaN where it has NaN), one launch a
    call, on every layout: random values, the edge grid, C not a multiple
    of the 16-byte vector, x at an odd element offset (unaligned loads)
    and K < 16 (the generic group instance)."""
    from repro_torch.kernels import fake_quant as fq
    g = torch.Generator(device=dev).manual_seed(3)
    x, pb, scale, group = _fake_quant_case(case, dtype, row_scale, k_dim,
                                           g, dev)
    if case == "offset":
        assert x.data_ptr() % 16
    kernels.reset_launch_counts()
    got = fq.fake_quant(x, pb, scale, row_scale=row_scale, k_dim=k_dim,
                        group_size=group)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fake_quant"] == 1
    want = fq.fake_quant_plain(x, pb, scale, row_scale=row_scale,
                               k_dim=k_dim, group_size=group)
    assert got.dtype == dtype
    assert _same_bits_or_nan(got, want)
    if case == "edge":
        assert want.isnan().any() and want.isinf().any()


@pytest.mark.parametrize("k,n,m", [(2560, 10576, 1024), (5120, 2560, 1024),
                                   (1024, 4096, 12000), (4096, 1024, 12000)])
def test_fake_quant_bit_equal_at_the_ssm_shapes(dev, k, n, m):
    """B8 at mamba2-2.7b's training linears (M = 8 x 128 tokens) and at
    whisper-medium's (fc1, fc2; the encoder's M = 8 x 1500 frames): the
    fp32 weight [K, N] with per-group scales (K along rows) and the bf16
    activations [M, K] with per-row abs-max / 1.875 scales, one launch
    each, bitwise the plain version."""
    from repro_torch.kernels import fake_quant as fq
    g = torch.Generator(device=dev).manual_seed(k + n)
    pb = torch.tensor([1.0, 2.0, 4.0], device=dev)[torch.randint(
        0, 3, (k // 16,), generator=g, device=dev)]
    w = torch.randn((k, n), generator=g, device=dev) / k ** 0.5
    x = (torch.randn((m, k), generator=g, device=dev) * 2).to(
        torch.bfloat16)
    cases = ((w, quant.per_group_weight_scale(w, 16), False, 0),
             (x, quant.abs_max_scale(x, dim=1).reshape(-1), True, 1))
    for t, scale, row_scale, k_dim in cases:
        kernels.reset_launch_counts()
        got = fq.fake_quant(t, pb, scale, row_scale=row_scale, k_dim=k_dim)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["fake_quant"] == 1
        assert torch.equal(got, fq.fake_quant_plain(
            t, pb, scale, row_scale=row_scale, k_dim=k_dim))


def _int_view(t):
    """Bits of a float tensor, so -0 and +0 compare unequal."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("k,n", TRAIN_SHAPES)
def test_noise_inject_bwd_equals_plain(dev, k, n):
    """B9's backward kernel: dw bitwise the plain version, ds within
    ``ni.ds_bound`` (the same fp32 terms summed in another order), one
    launch a call, and bitwise the same result run to run."""
    from repro_torch.kernels import noise_inject as ni
    g = torch.Generator(device=dev).manual_seed(k * 3 + n)
    w = torch.rand((k, n), generator=g, device=dev) * 2.2 - 1.1
    w[0, :4] = torch.tensor([2.5, -2.5, 1.999, -1.0], device=dev)
    s = torch.randn((k // 16,), generator=g, device=dev) * 2.0
    s[:2] = torch.tensor([8.0, -8.0], device=dev)
    seed = torch.randint(0, 1 << 32, (1,), generator=g, device=dev)
    cot = torch.randn((k, n), generator=g, device=dev)
    kernels.reset_launch_counts()
    dw, ds = ni.noise_inject_bwd(w, s, seed, cot)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["noise_inject_bwd"] == 1
    dw_p, ds_p = ni.noise_inject_bwd_plain(w, s, seed, cot)
    assert torch.equal(_int_view(dw), _int_view(dw_p))
    assert ((ds - ds_p).abs() <= ni.ds_bound(w, s, seed, cot)).all()
    dw2, ds2 = ni.noise_inject_bwd(w, s, seed, cot)
    assert torch.equal(_int_view(dw2), _int_view(dw))
    assert torch.equal(_int_view(ds2), _int_view(ds))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("row_scale,k_dim", [(True, 1), (False, 1),
                                             (False, 0), (True, 0)])
@pytest.mark.parametrize("k,n", TRAIN_SHAPES)
def test_fake_quant_bwd_equals_plain(dev, k, n, row_scale, k_dim, dtype):
    """B8's backward kernel, bitwise the plain version (-0 and NaN
    included) on every layout, one launch a call, run to run."""
    from repro_torch.kernels import fake_quant as fq
    g = torch.Generator(device=dev).manual_seed(k + n + 7 * k_dim)
    shape = (k, n) if k_dim == 0 else (n, k)
    x = (torch.randn(shape, generator=g, device=dev) * 2).to(dtype)
    pb = torch.tensor([1.0, 2.0, 4.0], device=dev)[torch.randint(
        0, 3, (k // 16,), generator=g, device=dev)]
    if row_scale:
        scale = quant.abs_max_scale(x, dim=k_dim).reshape(n) * 0.5
    else:
        xk = x if k_dim == 0 else x.t()
        scale = quant.per_group_weight_scale(xk, 16) * 0.5
    cot = torch.randn(shape, generator=g, device=dev).to(dtype)
    cot[1, 1] = float("nan")
    kernels.reset_launch_counts()
    dx = fq.fake_quant_bwd(x, pb, scale.contiguous(), cot,
                           row_scale=row_scale, k_dim=k_dim)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fake_quant_bwd"] == 1
    want = fq.fake_quant_bwd_plain(x, pb, scale, cot, row_scale=row_scale,
                                   k_dim=k_dim)
    assert dx.dtype == dtype and torch.equal(dx.isnan(), want.isnan())
    fin = ~want.isnan()
    assert torch.equal(_int_view(dx)[fin], _int_view(want)[fin])
    assert (dx == 0).any() and (dx != 0).any()   # both sides of the range
    again = fq.fake_quant_bwd(x, pb, scale.contiguous(), cot,
                              row_scale=row_scale, k_dim=k_dim)
    assert torch.equal(_int_view(again), _int_view(dx))


def test_full_width_train_step_repeats_bitwise(dev):
    """Two layers of h2o-danube-1.8b at full width, bf16 compute: a Phase-I
    and a Phase-II step run on the kernels and give bitwise the same
    losses and gradient norms twice from the same seed."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic
    from repro_torch.train import loop
    from repro_torch.train import state as state_lib
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b"), num_layers=2)
    tcfg = state_lib.TrainConfig(t1=1, t2=2, warmup=1)

    def run():
        stream = synthetic.TokenStream(synthetic.TokenStreamConfig(
            vocab_size=cfg.vocab_size, seq_len=64, batch_size=4, seed=0))
        kernels.reset_launch_counts()
        out = loop.train(cfg, tcfg, stream.batches(), device=dev)
        counts = kernels.launch_counts()
        assert counts["noise_inject"] > 0 and counts["fake_quant"] > 0
        assert counts["noise_inject_bwd"] > 0 and counts["fake_quant_bwd"] > 0
        return [(m["loss"], m["grad_norm"]) for m in out["history"]]

    first, second = run(), run()
    assert all(np.isfinite(v) for pair in first for v in pair)
    assert first == second


def test_hoisted_step_is_the_unhoisted_step_on_the_card(dev):
    """Two layers of h2o-danube-1.8b at full width, bf16 compute, mixed
    1/2/4-bit precisions, a 2-microbatch QAT step hoisted and unhoisted:
    bitwise the same loss, gradient norm and parameters; the hoisted step
    launches B8 once a weight (14) and once an activation a microbatch and
    recompute (56), its backward once a weight and once an activation a
    microbatch (14 + 28); the unhoisted one 112 and 56."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic
    from repro_torch.models import lm
    from repro_torch.train import state as state_lib
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b"),
                              num_layers=2).with_quant_mode("qat")
    batch = next(synthetic.TokenStream(synthetic.TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=64, batch_size=4,
        seed=0)).batches())
    gen = torch.Generator().manual_seed(3)

    def run(hoist):
        tcfg = state_lib.TrainConfig(t1=0, t2=4, warmup=1,
                                     num_microbatches=2,
                                     hoist_weight_quant=hoist)
        model = lm.init_params(cfg, seed=1, device=dev)
        gen.manual_seed(3)
        for name, buf in model.named_buffers():
            if name.endswith("pbits"):
                buf.copy_(torch.tensor([1, 2, 4], dtype=buf.dtype)[
                    torch.randint(0, 3, buf.shape, generator=gen)])
        st = state_lib.init_state(cfg, tcfg, model=model)
        kernels.reset_launch_counts()
        st, met = state_lib.train_step(st, batch, cfg, tcfg)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        return (float(met["loss"]), float(met["grad_norm"]),
                [p.detach().clone() for p in model.parameters()],
                (counts["fake_quant"], counts["fake_quant_bwd"]))

    h, u = run(True), run(False)
    assert np.isfinite(h[0]) and h[:2] == u[:2]
    assert all(torch.equal(a, b) for a, b in zip(h[2], u[2]))
    assert h[3] == (14 + 56, 14 + 28) and u[3] == (112, 56)


def test_checkpoint_round_trip_on_the_card(dev, tmp_path):
    """A full-width two-layer Phase-I state on the card (moments and
    compression error set) saved and restored: parameters, moments and
    errors bitwise, back on the card."""
    import dataclasses
    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.train import checkpoint
    from repro_torch.train import state as state_lib
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b"),
                              num_layers=2).with_quant_mode("noise")
    tcfg = state_lib.TrainConfig(grad_compress=True)
    st = state_lib.init_state(cfg, tcfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    for tree in (st["opt"]["mu"], st["opt"]["nu"], st["err"]):
        for t in tree.values():
            t.copy_(torch.randn(t.shape, generator=gen, device=dev))
    st["opt"]["count"], st["step"] = 7, 7
    d = str(tmp_path / "ck")
    checkpoint.async_save(interop.state_to_tree(st), d, 7).join()
    tree, step = checkpoint.restore(d)
    back = interop.state_from_tree(tree, cfg, dev)
    assert step == 7 and back["step"] == 7 and back["opt"]["count"] == 7
    for (n, a), (m, b) in zip(st["model"].named_parameters(),
                              back["model"].named_parameters()):
        assert n == m and b.is_cuda and torch.equal(a, b), n
    for key in ("mu", "nu"):
        for n, t in st["opt"][key].items():
            assert torch.equal(t, back["opt"][key][n]), (key, n)
    for n, t in st["err"].items():
        assert torch.equal(t, back["err"][n]), n


# ------------------------------------------------------- expert banks ----
def _bank_operands(e, k, n, gen, dev):
    w = torch.rand((e, k, n), generator=gen, device=dev) * 4.4 - 2.2
    w[:, 0, :4] = torch.tensor([2.5, -2.5, 1.999, -1.0], device=dev)
    s = torch.randn((e, k // 16), generator=gen, device=dev) * 2.0 - 0.5
    s[:, 0] = 8.0
    seeds = torch.randint(0, 1 << 32, (e,), generator=gen, device=dev)
    return w, s, seeds


@pytest.mark.parametrize("e,k,n", [(3, 64, 96), (4, 128, 70), (2, 32, 8)])
def test_noise_inject_bank_bitwise_plain_and_per_expert(dev, e, k, n):
    """One B9 launch over a bank and one backward launch: bitwise the bank
    plain version and E single-weight launches (dw bitwise, ds within
    ``ds_bound`` of the plain version and bitwise the per-expert
    launches)."""
    from repro_torch.kernels import noise_inject as ni
    gen = torch.Generator(device=dev).manual_seed(e * k + n)
    w, s, seeds = _bank_operands(e, k, n, gen, dev)
    g = torch.randn(w.shape, generator=gen, device=dev)
    kernels.reset_launch_counts()
    out = ni.noise_inject(w, s, seeds)
    dw, ds = ni.noise_inject_bwd(w, s, seeds, g)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["noise_inject"] == 1 and counts["noise_inject_bwd"] == 1
    assert torch.equal(out, ni.noise_inject_plain(w, ni.group_sigma(s),
                                                  seeds))
    dw_p, ds_p = ni.noise_inject_bwd_plain(w, s, seeds, g)
    assert torch.equal(_int_view(dw), _int_view(dw_p))
    assert ((ds - ds_p).abs() <= ni.ds_bound(w, s, seeds, g)).all()
    for i in range(e):
        one = ni.noise_inject(w[i].contiguous(), s[i], seeds[i:i + 1])
        dwi, dsi = ni.noise_inject_bwd(w[i].contiguous(), s[i],
                                       seeds[i:i + 1], g[i].contiguous())
        assert torch.equal(out[i], one)
        assert torch.equal(_int_view(dw[i]), _int_view(dwi))
        assert torch.equal(ds[i], dsi)


@pytest.mark.parametrize("k", [96, 12])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["weight", "per_tensor", "per_token"])
def test_fake_quant_bank_bitwise_plain_and_per_expert(dev, layout, dtype, k):
    """B8 and its backward over a bank in one launch each: bitwise the
    bank plain versions and E launches on the slices, each expert with its
    own mixed precisions and scales (K = 12: one group narrower than
    16)."""
    from repro_torch.kernels import fake_quant as fq
    gen = torch.Generator(device=dev).manual_seed(len(layout))
    e, r, group = 3, 40, min(k, 16)
    pb = torch.tensor([1.0, 2.0, 4.0], device=dev)[torch.randint(
        0, 3, (e, k // group), generator=gen, device=dev)]
    if layout == "weight":
        x = (torch.randn((e, k, r), generator=gen, device=dev) * 0.1
             ).to(dtype)
        sc = quant.per_group_weight_scale(x.float(), group)
        kw = dict(row_scale=False, k_dim=0, group_size=group)
    else:
        x = (torch.randn((e, r, k), generator=gen, device=dev)
             * torch.tensor([1.0, 10.0, 0.1], device=dev)[:, None, None]
             ).to(dtype)
        x[0, -3:] = 0
        dims = (1, 2) if layout == "per_tensor" else (2,)
        m = x.float().abs().amax(dim=dims, keepdim=True).expand(e, r, 1)
        sc = (torch.clamp(m, min=quant.ACT_SCALE_EPS) / 1.875).reshape(
            e, r).contiguous()
        kw = dict(row_scale=True, group_size=group)
    g = torch.randn(x.shape, generator=gen, device=dev).to(dtype)
    kernels.reset_launch_counts()
    y = fq.fake_quant(x, pb, sc, **kw)
    dx = fq.fake_quant_bwd(x, pb, sc, g, **kw)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["fake_quant"] == 1 and counts["fake_quant_bwd"] == 1
    assert torch.equal(_int_view(y), _int_view(fq.fake_quant_plain(
        x, pb, sc, **kw)))
    assert torch.equal(_int_view(dx), _int_view(fq.fake_quant_bwd_plain(
        x, pb, sc, g, **kw)))
    for i in range(e):
        yi = fq.fake_quant(x[i].contiguous(), pb[i].contiguous(),
                           sc[i].contiguous(), **kw)
        dxi = fq.fake_quant_bwd(x[i].contiguous(), pb[i].contiguous(),
                                sc[i].contiguous(), g[i].contiguous(), **kw)
        assert torch.equal(_int_view(y[i]), _int_view(yi))
        assert torch.equal(_int_view(dx[i]), _int_view(dxi))


def test_moe_train_steps_repeat_bitwise(dev):
    """Two layers of deepseek-moe-16b (the dense layer and one MoE layer
    of 64 experts) at full width: a Phase-I and a Phase-II step through
    the bank kernels, one launch a bank, give bitwise the same losses,
    load-balancing losses and gradient norms twice from the same seed."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic
    from repro_torch.train import loop
    from repro_torch.train import state as state_lib
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"), num_layers=2)
    tcfg = state_lib.TrainConfig(t1=1, t2=2, warmup=1)

    def run():
        stream = synthetic.TokenStream(synthetic.TokenStreamConfig(
            vocab_size=cfg.vocab_size, seq_len=64, batch_size=4, seed=0))
        kernels.reset_launch_counts()
        out = loop.train(cfg, tcfg, stream.batches(), device=dev)
        counts = kernels.launch_counts()
        assert counts["noise_inject"] > 0 and counts["fake_quant"] > 0
        hist = [(m["loss"], m["moe_aux"], m["grad_norm"])
                for m in out["history"]]
        del out
        torch.cuda.empty_cache()
        return hist

    first, second = run(), run()
    assert all(np.isfinite(v) for row in first for v in row)
    assert first == second


# ----------------------------------------------------------------- CNN ----
def _conv_operands(k, cin, cout, gen, dev):
    """A conv weight HWIO [k, k, Cin, Cout] and its [Cin, k * k * Cout]
    rows (``cnn.conv_rows``: a view for k = 1, a copy for k = 3), a few
    elements beyond the clip and on rounding ties."""
    from repro_torch.models import cnn
    w = torch.rand((k, k, cin, cout), generator=gen, device=dev) * 2.2 - 1.1
    w[0, 0, 0, :3] = torch.tensor([2.5, -2.5, 0.125], device=dev)
    rows = cnn.conv_rows(w)
    assert (rows.data_ptr() == w.data_ptr()) == (k == 1)
    return w, rows


@pytest.mark.parametrize("k", [1, 3])
def test_conv_rows_through_b9_and_b8_bitwise_plain(dev, k):
    """B9 and B8 with their backward kernels on a conv's rows (a 1x1 view,
    a 3x3 copy), as the CNN's Phase-I and Phase-II rules call them:
    forward and dw/dx bitwise the plain versions, ds within
    ``ni.ds_bound``, one launch each."""
    from repro_torch.kernels import fake_quant as fq
    from repro_torch.kernels import noise_inject as ni
    g = torch.Generator(device=dev).manual_seed(40 + k)
    _w, rows = _conv_operands(k, 128, 96, g, dev)
    rows = rows.contiguous()
    s = torch.randn((128 // 16,), generator=g, device=dev) * 2.0
    seed = torch.randint(0, 1 << 32, (1,), generator=g, device=dev)
    cot = torch.randn(rows.shape, generator=g, device=dev)
    kernels.reset_launch_counts()
    out = ni.noise_inject(rows, s, seed)
    dw, ds = ni.noise_inject_bwd(rows, s, seed, cot)
    torch.cuda.synchronize()
    assert torch.equal(out, ni.noise_inject_plain(rows, ni.group_sigma(s),
                                                  seed))
    dw_p, ds_p = ni.noise_inject_bwd_plain(rows, s, seed, cot)
    assert torch.equal(_int_view(dw), _int_view(dw_p))
    assert ((ds - ds_p).abs() <= ni.ds_bound(rows, s, seed, cot)).all()
    pb = torch.tensor([1.0, 2.0, 4.0], device=dev)[torch.randint(
        0, 3, (128 // 16,), generator=g, device=dev)]
    sc = quant.per_group_weight_scale(rows, 16)
    wq = fq.fake_quant(rows, pb, sc, row_scale=False, k_dim=0)
    dx = fq.fake_quant_bwd(rows, pb, sc, cot, row_scale=False, k_dim=0)
    torch.cuda.synchronize()
    assert torch.equal(wq, fq.fake_quant_plain(rows, pb, sc, row_scale=False,
                                               k_dim=0))
    assert torch.equal(_int_view(dx), _int_view(fq.fake_quant_bwd_plain(
        rows, pb, sc, cot, row_scale=False, k_dim=0)))
    counts = kernels.launch_counts()
    assert [counts[n] for n in ("noise_inject", "noise_inject_bwd",
                                "fake_quant", "fake_quant_bwd")] == \
        [1, 1, 1, 1]


@pytest.mark.parametrize("k", [1, 3])
def test_pack_conv_on_the_card_equals_the_cpu(dev, k):
    """``pack_conv`` of a 1x1 and a 3x3 conv on the card: one B7 launch,
    every serve leaf bitwise the CPU's."""
    from repro_torch.api import transforms
    g = torch.Generator(device=dev).manual_seed(50 + k)
    w, _rows = _conv_operands(k, 128, 64, g, dev)
    pb = torch.tensor([1, 2, 4], dtype=torch.int8, device=dev)[torch.randint(
        0, 3, (128 // 16,), generator=g, device=dev)]
    qcfg = QuantConfig(mode="qat")
    kernels.reset_launch_counts()
    got = transforms.pack_conv({"w": w, "pbits": pb}, qcfg)
    assert kernels.launch_counts()["quantize_pack"] == 1
    want = transforms.pack_conv({"w": w.cpu(), "pbits": pb.cpu()}, qcfg)
    assert got["w4"].shape[1:] == (k, k, 64)
    for name, t in want.items():
        assert t.dtype == got[name].dtype and torch.equal(got[name].cpu(), t)


def test_cnn_steps_repeat_bitwise_on_the_card(dev):
    """Two Phase-I and two Phase-II steps of a CIFAR-shaped CNN on the card,
    twice: losses and parameters bitwise (the convs take deterministic
    cuDNN algorithms), B9 and B8 launched."""
    from repro_torch.models import cnn
    from repro_torch.optim import adamw

    def run():
        cfg = cnn.CNNConfig(channels=(128, 256), blocks_per_stage=1,
                            quant=QuantConfig(mode="noise"))
        model = cnn.cnn_init(cfg, seed=0, device=dev)
        model.requires_grad_(True)
        opt = adamw.init_state(model)
        ocfg = adamw.AdamWConfig(lr=3e-3, weight_decay=1e-4, s_lr_mult=25.0)
        g = torch.Generator(device=dev).manual_seed(1)
        x = torch.randn((16, 32, 32, 3), generator=g, device=dev)
        y = torch.randint(0, 10, (16,), generator=g, device=dev)
        losses = []
        for step in range(4):
            if step == 2:
                from repro_torch.api import transforms
                transforms.freeze_qat(model, cfg.quant)
                cfg = cnn.CNNConfig(channels=(128, 256),
                                    quant=QuantConfig(mode="qat"))
                opt = adamw.init_state(model)
            from repro_torch.core import smol
            noise = smol.StepNoise((0, step)) if step < 2 else None
            loss, _ = cnn.xent_loss(model, {"x": x, "y": y}, cfg, noise)
            params = adamw.trainable(model)
            grads = torch.autograd.grad(loss, [p for _, p in params])
            adamw.apply_updates(model, {n: gr for (n, _), gr in
                                        zip(params, grads)}, opt, ocfg)
            losses.append(loss.detach())
        return torch.stack(losses), [p.detach().clone()
                                     for p in model.parameters()]

    kernels.reset_launch_counts()
    l1, p1 = run()
    counts = kernels.launch_counts()
    assert counts["noise_inject"] > 0 and counts["fake_quant"] > 0
    l2, p2 = run()
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))


@pytest.mark.parametrize("k,n", [(2560, 10576), (5120, 2560)],
                         ids=["in_proj", "out_proj"])
def test_ssm_linears_b7_bitwise_and_b1_within_bound(dev, k, n):
    """mamba2-2.7b's serve linears: in_proj (N = 10576 = 2 * 5120 + 2 * 128
    + 80, a partial column tile of B1's 32 and of B7's 128) and out_proj
    (K = 5120). B7 bitwise its plain version in one launch; B1 on its
    carriers at M = 4, 16 and 32 within the fp32 reordering bound, one
    launch; the draft launch over the [K2|K1] slice bitwise the same
    launch on x's columns from K4 on."""
    g = torch.Generator(device=dev).manual_seed(k + n)
    w, perm, sc, segs = _pack_operands((k, n), g, dev)
    kernels.reset_launch_counts()
    carriers = qp.quantize_pack_segments(w, perm, sc, segments=segs)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["quantize_pack"] == 1
    for a, b in zip(carriers, qp.quantize_pack_segments_plain(
            w, perm, sc, segments=segs)):
        assert a.shape == b.shape and torch.equal(a, b)
    ops, off = [], 0
    for wp, p, kp in zip(carriers, (4, 2, 1), segs):
        if kp:
            ops.append((wp, sc[off // 16:(off + kp) // 16].contiguous(), p,
                        off))
            off += kp
    for m in (4, 16, 32):
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        x[0, :k // 2] *= 40.0                      # an outlier row
        sx = quant.abs_max_scale(x, dim=-1).float().contiguous()
        kernels.reset_launch_counts()
        got = pm.segments_matmul(x, ops, sx=sx)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["fused_act_segment_matmul"] == 1
        want = pm.segments_matmul_plain(x, ops, sx=sx)
        xq = torch.cat([pm.act_quant(x[:, o:o + wp.shape[0] * 8 // p], sx, p)
                        for wp, _s, p, o in ops], dim=-1)
        wd = torch.cat([pm.unpack_dequant(wp, p, s) for wp, s, p, _o in ops])
        assert torch.isfinite(got).all() and got.shape == (m, n)
        assert _within_reorder_bound(got, want, xq, wd)
    draft = backend.draft_segments(ops, 2, bits_of=lambda op: op[2])
    k0 = draft[0][3]
    assert k0 > 0
    got = pm.segments_matmul(x, draft, sx=sx)
    at0 = pm.segments_matmul(x[:, k0:], [(wp, s, p, o - k0)
                                         for wp, s, p, o in draft], sx=sx)
    torch.cuda.synchronize()
    assert torch.equal(got, at0)


@pytest.mark.parametrize("k,n", [(1024, 4096), (4096, 1024)],
                         ids=["fc1", "fc2"])
def test_whisper_encoder_linears_b1_at_6000_rows(dev, k, n):
    """whisper-medium's encoder MLP linears at M = 6000 (batch 4 x 1500
    frames: 1500 row tiles over one column tile's carriers; M * K = 24.6 M
    at fc2): B7 bitwise its plain version, B1 within the fp32 reordering
    bound of its plain version, one launch; rows 0..15 bitwise the same
    rows computed alone (a row tile does not depend on the others)."""
    g = torch.Generator(device=dev).manual_seed(k * 7 + n)
    w, perm, sc, segs = _pack_operands((k, n), g, dev)
    carriers = qp.quantize_pack_segments(w, perm, sc, segments=segs)
    for a, b in zip(carriers, qp.quantize_pack_segments_plain(
            w, perm, sc, segments=segs)):
        assert torch.equal(a, b)
    ops, off = [], 0
    for wp, p, kp in zip(carriers, (4, 2, 1), segs):
        if kp:
            ops.append((wp, sc[off // 16:(off + kp) // 16].contiguous(), p,
                        off))
            off += kp
    m = 6000
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    x[-1, : k // 2] *= 40.0                        # an outlier row, last
    sx = quant.abs_max_scale(x, dim=-1).float().contiguous()
    kernels.reset_launch_counts()
    got = pm.segments_matmul(x, ops, sx=sx)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fused_act_segment_matmul"] == 1
    want = pm.segments_matmul_plain(x, ops, sx=sx)
    xq = torch.cat([pm.act_quant(x[:, o:o + wp.shape[0] * 8 // p], sx, p)
                    for wp, _s, p, o in ops], dim=-1)
    wd = torch.cat([pm.unpack_dequant(wp, p, s) for wp, s, p, _o in ops])
    assert torch.isfinite(got).all() and got.shape == (m, n)
    assert _within_reorder_bound(got, want, xq, wd)
    alone = pm.segments_matmul(x[:16].contiguous(), ops,
                               sx=sx[:16].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(alone, got[:16])


@pytest.mark.parametrize("s", [1, 4, 8])
def test_whisper_cross_attention_b4(dev, s):
    """B4 on whisper-medium's cross K/V (batch 4, T = 1500 encoder
    entries: not a multiple of the 32-entry tile; Hk = 16, G = 1, D = 64)
    as the decoder reads it: every stored key position 0, the query
    position 2^30, so every entry is attended. Within the bound of its
    plain version, finite, and each of S = 4 (verify) or 8 (prefill)
    lanes bitwise the S = 1 call on its query."""
    from repro_torch.kernels import attn_decode as ad
    from repro_torch.models.attention import CROSS_QUERY_POS
    from repro_torch.serve import kv_quant
    g = torch.Generator(device=dev).manual_seed(1500 + s)
    b, t, hk, gq, d = 4, 1500, 16, 1, 64
    q = torch.randn((b, s, hk, gq, d), generator=g, device=dev)
    kc, ks = _kv_codes(g, (b, t, hk, d), dev)
    vc, vs = _kv_codes(g, (b, t, hk, d), dev)
    kv_pos = torch.zeros((b, t), dtype=torch.int32, device=dev)
    q_pos = torch.full((b, s), CROSS_QUERY_POS, dtype=torch.int32,
                       device=dev)
    kernels.reset_launch_counts()
    got = ad.qkv_attn_decode(q, kc, vc, ks, vs, kv_pos, q_pos)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["qkv_attn_decode"] == 1
    want = ad.qkv_attn_decode_plain(q, kc, vc, ks, vs, kv_pos, q_pos)
    k = kv_quant.dequantize_kv(kc, ks, torch.float32)
    v = kv_quant.dequantize_kv(vc, vs, torch.float32)
    bound = ad.error_bound(q, k, v, kv_pos, q_pos)
    assert torch.isfinite(got).all()
    assert ((got.double() - want.double()).abs() <= bound).all()
    for j in range(s):
        lane = ad.qkv_attn_decode(q[:, j:j + 1].contiguous(), kc, vc, ks,
                                  vs, kv_pos, q_pos[:, j:j + 1].contiguous())
        torch.cuda.synchronize()
        assert torch.equal(lane[:, 0], got[:, j]), j

