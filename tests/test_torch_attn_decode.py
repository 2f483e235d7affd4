"""Port parity for the decode attention kernels B4 (packed 4-bit ring) and
B5 (page pool): their plain versions, which the CPU path runs, against
the JAX package's Pallas kernels in interpret mode, at rtol = atol = 1e-5
(the reference sums in fp32; the port in float64 with one rounding).
Cases: no window and a small window, masked query lanes, empty ring
entries, unmapped pages and a page shared by two slots. The card runs
the kernels against the same plain versions (tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import attn_decode as jad
from repro.serve import kv_quant as jkq

from repro_torch.backend import base as backend
from repro_torch.kernels import attn_decode as pad
from repro_torch.serve import kv_pool, kv_quant

TOL = dict(rtol=1e-5, atol=1e-5)


def _ring(rng, b, s, hk, g, d, t):
    q = rng.standard_normal((b, s, hk, g, d)).astype(np.float32)
    k = rng.standard_normal((b, t, hk, d)).astype(np.float32) * 2.0
    v = rng.standard_normal((b, t, hk, d)).astype(np.float32)
    kc, ks = jkq.quantize_kv(jnp.asarray(k))
    vc, vs = jkq.quantize_kv(jnp.asarray(v))
    # Ring positions: row 0 wrapped (t..2t-1 rotated), row 1 partly empty.
    kv_pos = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    kv_pos[0] = (np.arange(t) + t + 3) % (2 * t)
    kv_pos[0][kv_pos[0] < t // 2] += 2 * t
    kv_pos[1 % b, t // 2:] = -1
    top = int(kv_pos.max())
    q_pos = (top - s + 1 + np.arange(s, dtype=np.int32))[None].repeat(b, 0)
    q_pos[-1, 0] = -1                      # a masked lane
    q_pos[1 % b] -= t // 3                 # causal mask cuts the row
    return (q, np.array(kc), np.array(vc), np.array(ks), np.array(vs),
            kv_pos, q_pos.astype(np.int32))


def _torch(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("s", [1, 3])
def test_plain_b4_matches_pallas_kernel(window, s):
    ops = _ring(np.random.default_rng(s), 3, s, 2, 2, 16, 16)
    want = np.asarray(jad.qkv_attn_decode(*(jnp.asarray(a) for a in ops),
                                          window=window, block_t=8,
                                          interpret=True))
    got = pad.qkv_attn_decode(*_torch(ops), window=window)
    assert got.dtype == torch.float32 and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # The backend op takes the cache dict; the masked lane averages.
    cache = dict(zip(("k_codes", "v_codes", "k_scale", "v_scale", "pos"),
                     _torch(ops[1:6])))
    via_op = backend.qkv_attn_decode(torch.from_numpy(ops[0]), cache,
                                     torch.from_numpy(ops[6]),
                                     window=window)
    assert torch.equal(via_op, got)


def _pool(rng, b, s, hk, g, d, ps, npg, npages):
    """A pool whose tables are shuffled, hold unmapped pages, and share
    one page between slots 0 and 1."""
    q = rng.standard_normal((b, s, hk, g, d)).astype(np.float32)
    k = rng.standard_normal((npages, ps, hk, d)).astype(np.float32)
    v = rng.standard_normal((npages, ps, hk, d)).astype(np.float32)
    kc, ks = (np.array(a) for a in jkq.quantize_kv(jnp.asarray(k)))
    vc, vs = (np.array(a) for a in jkq.quantize_kv(jnp.asarray(v)))
    for a in (kc, ks, vc, vs):
        a[0] = 0                               # the null page
    pos = np.full((npages, ps), -1, np.int32)
    table = np.full((b, npg), -1, np.int32)
    ids = list(rng.permutation(np.arange(1, npages)))
    for bi in range(b):
        for lp in range(npg):
            if (bi + lp) % 3 == 2:
                continue                       # unmapped hole
            pid = ids.pop()
            table[bi, lp] = pid
            fill = ps if lp < npg - 1 else ps - 2
            pos[pid, :fill] = lp * ps + np.arange(fill)
    table[1, 0] = table[0, 0]                  # a page two slots share
    q_pos = (npg * ps - s + np.arange(s, dtype=np.int32))[None].repeat(b, 0)
    q_pos[-1, -1] = -1
    return (q, kc, vc, ks, vs, pos, table, q_pos.astype(np.int32))


@pytest.mark.parametrize("window", [None, 7])
def test_plain_b5_matches_pallas_kernel(window):
    ops = _pool(np.random.default_rng(3), 3, 2, 2, 2, 16, 4, 4, 14)
    want = np.asarray(jad.qkv_attn_decode_paged(
        *(jnp.asarray(a) for a in ops), window=window, block_t=2,
        interpret=True))
    got = pad.qkv_attn_decode_paged(*_torch(ops), window=window)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # The same content as a dense ring gives the same rows bitwise: the
    # plain versions share one oracle.
    cache = dict(zip(("k_codes", "v_codes", "k_scale", "v_scale", "pos",
                      "page_table"), _torch(ops[1:7])))
    k, v, k_pos = kv_pool.gather_paged(cache)
    assert torch.equal(
        backend.qkv_attn_decode_paged(torch.from_numpy(ops[0]), cache,
                                      torch.from_numpy(ops[7]),
                                      window=window),
        pad.qkv_attn_ref(torch.from_numpy(ops[0]), k, v, k_pos,
                         torch.from_numpy(ops[7]), window))


def test_all_masked_row_is_the_uniform_average():
    ops = _ring(np.random.default_rng(5), 1, 1, 1, 2, 8, 6)
    q_pos = np.full((1, 1), -1, np.int32)
    out = pad.qkv_attn_decode(*_torch(ops[:6] + (q_pos,)))
    v = kv_quant.dequantize_kv(torch.from_numpy(ops[2]),
                               torch.from_numpy(ops[4]), torch.float32)
    want = v.double().mean(dim=1).float()              # [1, Hk, D]
    for g in range(2):
        torch.testing.assert_close(out[0, 0, :, g], want[0], rtol=1e-6,
                                   atol=1e-7)


def test_wrappers_raise_off_cpu_and_cuda():
    ops = _torch(_ring(np.random.default_rng(6), 1, 1, 1, 1, 8, 4))
    meta = [t.to("meta") for t in ops]
    with pytest.raises(ValueError, match="unsupported device"):
        pad.qkv_attn_decode(*meta)
    pool = _torch(_pool(np.random.default_rng(7), 2, 1, 1, 1, 8, 2, 2, 5))
    with pytest.raises(ValueError, match="unsupported device"):
        pad.qkv_attn_decode_paged(*[t.to("meta") for t in pool])


# ------------------------------------------- the kernels' split and fold ----
def _chunked(q, k, v, k_pos, q_pos, window):
    """The kernels' order of sums, modelled in float64: ``split_entries``
    cuts the T entries into chunks; each chunk's state (m, l, acc) comes
    from its own masked scores; the states are folded left in chunk order
    (m2 = max, l = l * exp(m - m2) + l' * exp(m' - m2), acc likewise);
    one rounding to fp32. q [B, S, Hk, G, D], k/v [B, T, Hk, D]."""
    t = k.shape[1]
    chunk, count = pad.split_entries(t)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q.double(), k.double())
    scores = scores * (1.0 / np.sqrt(q.shape[-1]))
    mask = pad.attention_mask(q_pos, k_pos, window)[:, None, None]
    scores = torch.where(mask, scores,
                         torch.tensor(pad.NEG_INF, dtype=torch.float64))
    state = None
    for c in range(count):
        part = slice(c * chunk, min((c + 1) * chunk, t))
        s = scores[..., part]
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        cur = (m, p.sum(-1, keepdim=True),
               torch.einsum("bhgqk,bkhd->bhgqd", p, v[:, part].double()))
        if state is None:
            state = cur
            continue
        top = torch.maximum(state[0], m)
        a, a2 = torch.exp(state[0] - top), torch.exp(m - top)
        state = (top, state[1] * a + cur[1] * a2, state[2] * a + cur[2] * a2)
    out = state[2] / state[1].clamp(min=1e-30)
    return out.permute(0, 3, 1, 2, 4).float()


def _dense(ops):
    k = kv_quant.dequantize_kv(torch.from_numpy(ops[1]),
                               torch.from_numpy(ops[3]), torch.float32)
    v = kv_quant.dequantize_kv(torch.from_numpy(ops[2]),
                               torch.from_numpy(ops[4]), torch.float32)
    return k, v


def _held(model, plain, q, k, v, k_pos, q_pos, window, jax_out):
    bound = pad.error_bound(q, k, v, k_pos, q_pos, window)
    assert torch.isfinite(model).all()
    assert ((model.double() - plain.double()).abs() <= bound).all()
    np.testing.assert_allclose(model.numpy(), jax_out, **TOL)


def test_split_depends_on_the_entry_count_alone():
    import inspect
    assert list(inspect.signature(pad.split_entries).parameters) == ["n"]
    assert pad.split_entries(20) == (32, 1)
    assert pad.split_entries(256) == (32, 8)
    assert pad.split_entries(272) == (32, 9)
    assert pad.split_entries(2048) == (32, 64)
    assert pad.split_entries(4096) == (64, 64)
    for n in list(range(1, 6000, 7)) + [2 ** 15, 2 ** 17 + 5]:
        chunk, count = pad.split_entries(n)
        assert chunk % pad.TILE == 0 and 1 <= count <= pad.MAX_CHUNKS
        assert (count - 1) * chunk < n <= count * chunk
        # The shortest chunk of whole tiles that keeps the count in bound.
        assert chunk == pad.TILE or (chunk - pad.TILE) * pad.MAX_CHUNKS < n
    with pytest.raises(ValueError):
        pad.split_entries(0)


@pytest.mark.parametrize("t,window,s", [
    (200, 20, 1),      # leading chunks fully masked (7 chunks of 32)
    (100, 45, 3),      # T not a multiple of the chunk; the window ends
                       # mid-chunk; a masked lane (uniform average)
    (20, None, 2),     # T shorter than one chunk
])
def test_chunked_fold_matches_plain_and_pallas_ring(t, window, s):
    ops = _ring(np.random.default_rng(t), 3, s, 2, 2, 16, t)
    q, q_pos, kv_pos = (torch.from_numpy(ops[0]), torch.from_numpy(ops[6]),
                        torch.from_numpy(ops[5]))
    k, v = _dense(ops)
    model = _chunked(q, k, v, kv_pos, q_pos, window)
    plain = pad.qkv_attn_decode(*_torch(ops), window=window)
    want = np.asarray(jad.qkv_attn_decode(*(jnp.asarray(a) for a in ops),
                                          window=window, block_t=4,
                                          interpret=True))
    _held(model, plain, q, k, v, kv_pos, q_pos, window, want)
    # The masked lane (last row, first query) is the uniform average.
    uniform = v.double().mean(dim=1).float()[-1]
    torch.testing.assert_close(model[-1, 0], uniform[:, None].expand(
        model.shape[2:]), rtol=1e-6, atol=1e-7)


def test_chunked_fold_matches_plain_at_a_long_ring():
    """2,100 entries: chunks of 64 (33 of them), the last one partial."""
    ops = _ring(np.random.default_rng(9), 2, 2, 1, 2, 8, 2100)
    q, q_pos, kv_pos = (torch.from_numpy(ops[0]), torch.from_numpy(ops[6]),
                        torch.from_numpy(ops[5]))
    k, v = _dense(ops)
    for window in (None, 700):
        model = _chunked(q, k, v, kv_pos, q_pos, window)
        plain = pad.qkv_attn_decode(*_torch(ops), window=window)
        bound = pad.error_bound(q, k, v, kv_pos, q_pos, window)
        assert ((model.double() - plain.double()).abs() <= bound).all()


@pytest.mark.parametrize("window", [None, 50])
def test_chunked_fold_matches_plain_and_pallas_paged(window):
    """Pages of 4, 40 a slot (160 entries: 5 chunks of 32, 8 pages each),
    with an unmapped page in the first and in the last chunk of slot 0."""
    ops = list(_pool(np.random.default_rng(11), 2, 2, 2, 2, 16, 4, 40, 82))
    ops[6] = ops[6].copy()
    ops[6][0, [1, 39]] = -1
    ops = tuple(ops)
    cache = dict(zip(("k_codes", "v_codes", "k_scale", "v_scale", "pos",
                      "page_table"), _torch(ops[1:7])))
    k, v, k_pos = kv_pool.gather_paged(cache)
    q, q_pos = torch.from_numpy(ops[0]), torch.from_numpy(ops[7])
    model = _chunked(q, k, v, k_pos, q_pos, window)
    plain = pad.qkv_attn_decode_paged(*_torch(ops), window=window)
    want = np.asarray(jad.qkv_attn_decode_paged(
        *(jnp.asarray(a) for a in ops), window=window, block_t=2,
        interpret=True))
    _held(model, plain, q, k, v, k_pos, q_pos, window, want)
