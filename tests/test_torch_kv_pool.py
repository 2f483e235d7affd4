"""Port parity for the paged KV cache (``repro_torch.serve.kv_pool``)
against the JAX package: the same seeded allocator programs drive both
``PagePool`` copies, whose state and emitted ``StepOps`` must be equal
after every operation (and ``check()`` must pass); the device-side ops
(paged write, gather, copy-on-write/wipe application, poison) must leave
bit-equal caches."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import kv_pool as jkp
from repro.serve.scheduler import Request as JRequest

from repro_torch.serve import kv_pool as pkp
from repro_torch.serve.scheduler import Request as PRequest


def _state(pool):
    return (list(pool.free), pool.refcount.tolist(), pool.table.tolist(),
            dict(pool.page_hash), dict(pool.prefix_map),
            list(pool.cached.items()), pool.lookups, pool.hits,
            pool.peak_resident, dict(pool._pending),
            dict(pool._target_pages))


def _ops(ops):
    return (list(ops.wipes), [tuple(c) for c in ops.copies],
            list(ops.poisons))


def _both(pools, fn):
    """Run ``fn(pool, module, Request)`` on both pools; their results, and
    any exception type, must agree."""
    out = []
    for pool, mod, req in zip(pools, (jkp, pkp), (JRequest, PRequest)):
        try:
            out.append(("ok", fn(pool, mod, req)))
        except (RuntimeError, AssertionError) as e:
            out.append((type(e).__name__, None))
    assert out[0][0] == out[1][0], out
    return out[0][0] == "ok", out[1][1]


@pytest.mark.parametrize("seed", range(6))
def test_pool_programs_match_jax(seed):
    """Seeded admit / feed / rollback / cancel / release programs on a
    tight pool with shared prompt prefixes (so prefix hits, copy-on-write
    and ring wraps all happen)."""
    num_pages, ps, pps, max_batch = 9, 4, 3, 3
    rng = np.random.default_rng(seed)
    pools = [jkp.PagePool(num_pages, ps, pps, max_batch,
                          poison=bool(seed % 2)),
             pkp.PagePool(num_pages, ps, pps, max_batch,
                          poison=bool(seed % 2))]
    stem = rng.integers(0, 50, (ps * 2,)).astype(np.int32)
    prompts = [np.concatenate([stem[:int(n)], rng.integers(
        0, 50, (int(m),)).astype(np.int32)])
        for n, m in zip(rng.integers(0, 2 * ps + 1, 5),
                        rng.integers(1, ps + 2, 5))]
    active = {}
    rid = 0
    copies = 0
    for _ in range(120):
        kind = rng.choice(["admit", "feed", "release", "cancel"],
                          p=[0.3, 0.5, 0.1, 0.1])
        ops = [jkp.StepOps(), pkp.StepOps()]
        if kind == "admit" and len(active) < max_batch:
            slot = next(s for s in range(max_batch) if s not in active)
            prompt = prompts[int(rng.integers(0, len(prompts)))]
            ok, adm = _both(pools, lambda p, m, R: p.admissible(
                R(prompt=prompt, max_new_tokens=4, request_id=rid)))
            if not adm:
                continue
            _both(pools, lambda p, m, R: p.note_submit(rid, prompt))
            _, shared = _both(pools, lambda p, m, R: p.admit(
                slot, R(prompt=prompt, max_new_tokens=4, request_id=rid)))
            active[slot] = [prompt, shared]
            rid += 1
        elif kind == "feed" and active:
            slot = int(rng.choice(sorted(active)))
            prompt, n_fed = active[slot]
            width = int(rng.integers(1, ps + 2))
            ok, _ = _both(pools, lambda p, m, R: p.prepare(
                slot, n_fed, width, ops[0 if m is jkp else 1]))
            if ok:
                assert pkp.step_ops_violations(pools[1], ops[1]) == \
                    jkp.step_ops_violations(pools[0], ops[0]) == []
                fed = n_fed + width
                if fed <= pps * ps and rng.random() < 0.3:
                    committed = int(rng.integers(n_fed, fed + 1))
                    _both(pools, lambda p, m, R: p.rollback(
                        slot, committed, fed, ops[0 if m is jkp else 1]))
                    fed = committed
                active[slot][1] = fed
                _both(pools, lambda p, m, R: p.note_filled(slot, prompt,
                                                           fed))
        elif kind == "cancel" and active:
            slot = int(rng.choice(sorted(active)))
            prompt, n_fed = active.pop(slot)
            _both(pools, lambda p, m, R: p.note_filled(slot, prompt, n_fed))
            _both(pools, lambda p, m, R: p.release(
                slot, ops[0 if m is jkp else 1]))
        elif kind == "release" and active:
            slot = int(rng.choice(sorted(active)))
            active.pop(slot)
            _both(pools, lambda p, m, R: p.release(
                slot, ops[0 if m is jkp else 1]))
        assert _state(pools[1]) == _state(pools[0])
        assert _ops(ops[1]) == _ops(ops[0])
        copies += len(ops[1].copies)
        assert pkp.invariant_violations(pools[1]) == []
        pools[1].check()
    assert pools[1].hits > 0 and copies > 0


def _toy(num_pages=7, ps=4, npg=3, b=2, hk=2, d=8, kv_bits=4):
    j = jkp.init_paged_cache(num_pages, ps, npg, b, hk, d, kv_bits=kv_bits,
                             dtype=jnp.float32)
    p = pkp.init_paged_cache(num_pages, ps, npg, b, hk, d, device="cpu",
                             kv_bits=kv_bits, dtype=torch.float32)
    return j, p


def _same(p, j):
    assert set(p) == set(j)
    for name in j:
        np.testing.assert_array_equal(p[name].numpy(), np.asarray(j[name]),
                                      name)


def test_device_ops_match_jax():
    _device_ops_match_jax(kv_bits=4)


def test_fp_device_ops_match_jax():
    """The same on the fp pool (kv_bits=None): k/v stored as they are,
    NaN poison."""
    _device_ops_match_jax(kv_bits=None)


def _device_ops_match_jax(kv_bits):
    """Paged writes (masked lanes, unmapped pages), the gather, copy-on-
    write and wipes, the poison and the payload bytes a page."""
    rng = np.random.default_rng(0)
    jc, pc = _toy(kv_bits=kv_bits)
    apply_ops = jax.jit(jkp.apply_step_ops)
    update = jax.jit(jkp.update_paged_cache)
    _same(pc, jc)
    table = np.array([[3, 1, -1], [2, -1, 5]], np.int32)
    jc = apply_ops(jc, table, np.array([3, 1, 2, 5], np.int32),
                   np.zeros(2, np.int32), np.zeros(2, np.int32))
    pkp.apply_step_ops(pc, table, [3, 1, 2, 5], [0, 0], [0, 0])
    _same(pc, jc)
    for pos in (np.array([[0, 1, 2, -1], [4, 5, 6, 7]], np.int32),
                np.array([[3, 4, -1, -1], [8, 9, 10, 11]], np.int32),
                np.array([9, 12], np.int32)):
        shape = pos.shape + (2, 8) if pos.ndim == 2 else (2, 1, 2, 8)
        k = (rng.standard_normal(shape) * 3).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        jc = update(jc, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
        pkp.update_paged_cache(pc, torch.from_numpy(k), torch.from_numpy(v),
                               torch.from_numpy(pos))
        _same(pc, jc)
    for got, want in zip(pkp.gather_paged(pc), jkp.gather_paged(jc)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # Copy-on-write 1 -> 4 and a wipe of 2 in one batch, then a poison.
    table[0, 1] = 4
    jc = apply_ops(jc, table, np.array([2], np.int32),
                   np.array([1], np.int32), np.array([4], np.int32))
    pkp.apply_step_ops(pc, table, [2], [1], [4])
    _same(pc, jc)
    jc = jkp.apply_poison(jc, np.array([1, 1], np.int32))
    pkp.apply_poison(pc, [1, 1])
    for name in jc:
        got, want = pc[name].float().numpy(), np.asarray(
            jc[name]).astype(np.float32)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want), name)
        np.testing.assert_array_equal(np.nan_to_num(got),
                                      np.nan_to_num(want), name)
    assert pkp.paged_payload_bytes_per_page({"layers": [{"kv": pc}] * 3}) \
        == jkp.paged_payload_bytes_per_page({"layers": [{"kv": jc}] * 3})


def test_pages_for_and_geometry():
    for t in range(0, 20):
        assert pkp.pages_for(t, 4) == jkp.pages_for(t, 4)
    with pytest.raises(ValueError):
        pkp.init_paged_cache(1, 4, 2, 1, 1, 8, device="cpu")
