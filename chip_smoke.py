#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py          # from the repository root, one H100

Phases (none catches an error; any failure exits non-zero):
  1. Card and build: the card's name and power limit, then every CUDA
     kernel of the serve path built with nvcc for sm_90a (one nvcc per
     source, all started together; timed).
  2. Segment kernels against their plain PyTorch versions on the card, at
     the main path's shapes (h2o-danube-1.8b: K = 2560 / 6912 split into
     [K4|K2|K1] segments, N in {640, 2560, 6912}, bf16 activations, M = 4
     decode rows and M = 32 prefill rows): quantize_pack bit-equal; the
     segment GEMMs within the fp32 reordering bound
     |kernel - plain| <= 1e-5 * (|xq| @ |wd|) + 1e-6. Each is timed with
     CUDA events beside its plain version and a torch.matmul of the same
     dequantized operands.
  3. Decode attention over the packed 4-bit KV cache against the plain
     versions, at the full width (Hk = 8, G = 4, D = 80, batch 4): B4 on
     rings of T = 256 and T = 4096 (window 1024, so the window binds), B5
     on a page pool (page_size 16, 16 pages a slot, shuffled tables,
     unmapped pages, a page two slots share), each at S = 1 and S = 8 with
     masked lanes, held to |kernel - plain| <= 1e-6 * (P @ |V|) + 1e-12;
     B5's rows equal B4's on the same content laid out as a ring. Timed
     with CUDA events beside the plain versions and one
     scaled_dot_product_attention on the dequantized fp32 K/V.
  4. Serve: DecodeEngine on full-width, full-depth h2o-danube-1.8b (random
     weights from a seed, default mix), fp ring KV cache, greedy; packing
     and serving must go through quantize_pack and the driver-scale
     segment GEMM; a second run gives the same tokens; lockstep equals
     continuous; the card agrees with the plain versions on the CPU in
     fp32: the reduced config end to end, and two full-width layers
     teacher-forced at every serve linear (each op held on its own;
     flipped activation codes counted).
  5. U4: the same arch at depth 2 with every group at 4 bits, which must
     go through the self-scale segment GEMM; lockstep equals continuous.
  6. 4-bit KV serve at full width and depth: the ring DecodeEngine (built
     from the QAT weights, so it packs), the LockstepEngine and the paged
     DecodeEngine on requests that share a 224-token prompt prefix and
     wrap the 256-entry ring, so the prefix map hits and shared pages are
     copied on write. Greedy tokens must be identical across the three;
     the ring runs must go through B4 and the paged run through B5; the
     pool's invariants must hold. Decode step times and tokens/s of each.
  7. Summary: a ``kernels`` JSON line, the nvidia-smi line, and last the
     ``{"ok": true, ...}`` line.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.core import smol  # noqa: E402
from repro_torch.core.qtypes import U4, QuantConfig  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import attn_decode as ad  # noqa: E402
from repro_torch.kernels import packed_matmul as pm  # noqa: E402
from repro_torch.kernels import quant_pack as qp  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import engine, kv_pool, kv_quant  # noqa: E402
from repro_torch.serve.scheduler import DECODE, Request  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
ARCH = "h2o-danube-1.8b"
SEED = 0
B1, B2, B7 = ("fused_act_segment_matmul", "fused_act_selfscale_matmul",
              "quantize_pack")
B4, B5 = "qkv_attn_decode", "qkv_attn_decode_paged"
SOURCES = {B1: "src/repro_torch/csrc/segment_gemm.cu",
           B2: "src/repro_torch/csrc/segment_gemm.cu",
           B4: "src/repro_torch/csrc/attn_decode.cu",
           B5: "src/repro_torch/csrc/attn_decode.cu",
           B7: "src/repro_torch/csrc/quant_pack.cu"}
REPLACES = {B1: "src/repro/kernels/packed_matmul.py:108",
            B2: "src/repro/kernels/packed_matmul.py:121",
            B4: "src/repro/kernels/attn_decode.py:54",
            B5: "src/repro/kernels/attn_decode.py:155",
            B7: "src/repro/kernels/quant_pack.py:21"}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# ---------------------------------------------------------------- shapes ----
def layer_linears(cfg):
    """(name, K, N) of one decoder layer's seven linears."""
    d, f = cfg.d_model, cfg.d_ff
    hq, hk = cfg.num_heads * cfg.hd, cfg.num_kv_heads * cfg.hd
    return [("wq", d, hq), ("wk", d, hk), ("wv", d, hk), ("wo", hq, d),
            ("gate", d, f), ("up", d, f), ("down", f, d)]


def segment_shapes(qcfg, k):
    """[(p, k_off, kp, g_off)] of the non-empty segments of a K-dim."""
    out, off = [], 0
    for p, kp in zip((4, 2, 1), qcfg.segments(k)):
        if kp:
            out.append((p, off, kp, off // 16))
            off += kp
    return out


class LayerOperands:
    """Random operands of one layer's segment GEMMs at batch M."""

    def __init__(self, cfg, qcfg, m, gen, dev):
        self.calls = []
        for _name, k, n in layer_linears(cfg):
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            x[0, : k // 2] *= 40.0                     # an outlier row
            sx = quant.abs_max_scale(x, dim=-1)
            wscale = torch.rand((k // 16,), generator=gen, device=dev) \
                * 0.02 + 0.001
            for p, off, kp, goff in segment_shapes(qcfg, k):
                wp = torch.randint(0, 256, (kp * p // 8, n), generator=gen,
                                   device=dev, dtype=torch.uint8)
                sc = wscale[goff:goff + kp // 16].contiguous()
                self.calls.append(dict(x=x[:, off:off + kp], sx=sx, wp=wp,
                                       scales=sc, p=p, n=n, kp=kp))


def check_segment_gemm(name, ops_list):
    """Kernel vs plain for every call; returns the max |error|."""
    worst = 0.0
    for ops in ops_list:
        for c in ops.calls:
            if name == B1:
                got = pm.fused_act_segment_matmul(c["x"], c["sx"], c["wp"],
                                                  c["scales"], p=c["p"])
                want = pm.fused_act_segment_matmul_plain(
                    c["x"], c["sx"], c["wp"], c["scales"], p=c["p"])
                xq = pm.act_quant(c["x"], c["sx"], c["p"])
            else:
                got = pm.fused_act_selfscale_matmul(c["x"], c["wp"],
                                                    c["scales"], p=c["p"])
                want = pm.fused_act_selfscale_matmul_plain(
                    c["x"], c["wp"], c["scales"], p=c["p"])
                xq = pm.act_quant(c["x"], quant.abs_max_scale(c["x"], -1),
                                  c["p"])
            torch.cuda.synchronize()
            wd = pm.unpack_dequant(c["wp"], c["p"], c["scales"])
            mag = xq.abs().double() @ wd.abs().double()
            err = (got.double() - want.double()).abs()
            if not torch.isfinite(got).all():
                raise AssertionError(f"{name}: non-finite output")
            over = err > 1e-5 * mag + 1e-6
            if over.any():
                raise AssertionError(
                    f"{name} {tuple(c['x'].shape)}x{tuple(c['wp'].shape)} "
                    f"p={c['p']}: |err| {err.max().item():.3e} over the "
                    f"fp32 reordering bound")
            worst = max(worst, err.max().item())
    return worst


def time_segment_gemm(name, sets, reps=20):
    """ms of one layer's calls (rotating operand sets so the weights come
    from device memory, as in a 24-layer step), plain and library ms."""
    def run(fn):
        def go():
            for ops in sets:
                for c in ops.calls:
                    fn(c)
        return go

    if name == B1:
        kern = run(lambda c: pm.fused_act_segment_matmul(
            c["x"], c["sx"], c["wp"], c["scales"], p=c["p"]))
        plain = run(lambda c: pm.fused_act_segment_matmul_plain(
            c["x"], c["sx"], c["wp"], c["scales"], p=c["p"]))
    else:
        kern = run(lambda c: pm.fused_act_selfscale_matmul(
            c["x"], c["wp"], c["scales"], p=c["p"]))
        plain = run(lambda c: pm.fused_act_selfscale_matmul_plain(
            c["x"], c["wp"], c["scales"], p=c["p"]))
    lib_ops = []
    for ops in sets:
        for c in ops.calls:
            sx = c["sx"] if name == B1 else quant.abs_max_scale(c["x"], -1)
            lib_ops.append((pm.act_quant(c["x"], sx, c["p"]).contiguous(),
                            pm.unpack_dequant(c["wp"], c["p"], c["scales"])))

    def library():
        for xq, wd in lib_ops:
            torch.matmul(xq, wd)

    n = len(sets)
    ms = time_ms(kern, reps) / n
    plain_ms = time_ms(plain, 2) / n
    library_ms = time_ms(library, reps) / n
    c0 = sets[0].calls
    nbytes = sum(c["x"].shape[0] * c["kp"] * 2 + c["x"].shape[0] * 4
                 + c["wp"].numel() + c["scales"].numel() * 4
                 + 2 * c["x"].shape[0] * c["n"] * 4 for c in c0)
    flops = sum(2 * c["x"].shape[0] * c["kp"] * c["n"] for c in c0)
    b_ms, b_by = bound(nbytes, flops)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=b_ms, bound_by=b_by)


def phase_quant_pack(cfg, qcfg, gen, dev, reps=10):
    """B7 vs plain (bit-equal) on one layer's segments; times one layer's
    packing (rotating 4 weight sets: 4 x 278 MB of fp32 weights)."""
    sets = []
    for _ in range(4):
        calls = []
        for _name, k, n in layer_linears(cfg):
            w = torch.randn((k, n), generator=gen, device=dev) * 0.02
            sc = quant.per_group_weight_scale(w, 16)
            for p, off, kp, goff in segment_shapes(qcfg, k):
                calls.append((w[off:off + kp].contiguous(),
                              sc[goff:goff + kp // 16].contiguous(), p))
        sets.append(calls)
    for w, sc, p in sets[0]:
        got = qp.quantize_pack(w, sc, p=p)
        want = qp.quantize_pack_plain(w, sc, p=p)
        if not torch.equal(got, want):
            diff = (got != want).sum().item()
            raise AssertionError(f"quantize_pack {tuple(w.shape)} p={p}: "
                                 f"{diff} bytes differ from the plain "
                                 f"version")
    kern = lambda: [qp.quantize_pack(w, sc, p=p)  # noqa: E731
                    for calls in sets for w, sc, p in calls]
    plain = lambda: [qp.quantize_pack_plain(w, sc, p=p)  # noqa: E731
                     for calls in sets for w, sc, p in calls]
    ms = time_ms(kern, reps) / 4
    plain_ms = time_ms(plain, 2) / 4
    nbytes = sum(w.numel() * 4 + sc.numel() * 4 + w.numel() * p // 8
                 for w, sc, p in sets[0])
    flops = sum(6 * w.numel() for w, _sc, _p in sets[0])
    b_ms, b_by = bound(nbytes, flops)
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=b_ms, bound_by=b_by)


# ------------------------------------------------------ decode attention ----
class RingOperands:
    """B4 operands at full width: batch 4, a ring of T entries (row 0
    wrapped, row 1 half empty), S query rows at the newest positions (a
    masked lane in row 3)."""

    def __init__(self, cfg, s, t, window, gen, dev, b=4):
        hk, g, d = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, \
            cfg.hd
        self.window = window
        self.q = torch.randn((b, s, hk, g, d), generator=gen, device=dev)
        k = torch.randn((b, t, hk, d), generator=gen, device=dev) * 2.0
        v = torch.randn((b, t, hk, d), generator=gen, device=dev)
        self.kc, self.ks = kv_quant.quantize_kv(k)
        self.vc, self.vs = kv_quant.quantize_kv(v)
        pos = torch.arange(t, device=dev, dtype=torch.int32).repeat(b, 1)
        pos[0] = (pos[0] + t // 3) % t + t
        pos[1, t // 2:] = -1
        self.kv_pos = pos
        qp_ = torch.arange(s, device=dev, dtype=torch.int32) \
            + int(pos.max()) - s + 1
        self.q_pos = qp_.repeat(b, 1)
        self.q_pos[3, 0] = -1

    def args(self):
        return (self.q, self.kc, self.vc, self.ks, self.vs, self.kv_pos,
                self.q_pos)

    def dense(self):
        return (kv_quant.dequantize_kv(self.kc, self.ks, torch.float32),
                kv_quant.dequantize_kv(self.vc, self.vs, torch.float32),
                self.kv_pos)

    def nbytes(self):
        b, t = self.kv_pos.shape
        return (2 * self.kc.numel() + 2 * self.ks.numel() * 2 + b * t * 4
                + 2 * self.q.numel() * 4 + self.q_pos.numel() * 4)

    def flops(self):
        return 4 * self.q.numel() * self.kv_pos.shape[1]


class PagedOperands:
    """B5 operands at full width: batch 4, ``npg`` pages of 16 a slot from
    a shuffled pool, slot 0's page 3 unmapped, slot 1's page 0 shared with
    slot 0's, positions stamped as a ring of npg * 16 entries."""

    def __init__(self, cfg, s, npg, window, gen, dev, b=4, ps=16):
        hk, g, d = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, \
            cfg.hd
        npages = b * npg + 1
        self.window = window
        self.q = torch.randn((b, s, hk, g, d), generator=gen, device=dev)
        k = torch.randn((npages, ps, hk, d), generator=gen, device=dev) * 2.0
        v = torch.randn((npages, ps, hk, d), generator=gen, device=dev)
        self.kc, self.ks = kv_quant.quantize_kv(k)
        self.vc, self.vs = kv_quant.quantize_kv(v)
        for x in (self.kc, self.ks, self.vc, self.vs):
            x[0] = 0                                   # the null page
        perm = torch.randperm(npages - 1, generator=gen, device=dev) + 1
        table = perm[:b * npg].reshape(b, npg).to(torch.int32)
        table[0, 3] = -1
        table[1, 0] = table[0, 0]
        self.table = table
        pos = torch.full((npages, ps), -1, dtype=torch.int32, device=dev)
        lp = torch.arange(npg, device=dev)[:, None] * ps \
            + torch.arange(ps, device=dev)[None]
        for bi in range(b):
            live = table[bi] >= 0
            pos[table[bi][live].long()] = lp[live].to(torch.int32)
        self.pool_pos = pos
        qp_ = torch.arange(s, device=dev, dtype=torch.int32) + npg * ps - s
        self.q_pos = qp_.repeat(b, 1)
        self.q_pos[3, 0] = -1

    def args(self):
        return (self.q, self.kc, self.vc, self.ks, self.vs, self.pool_pos,
                self.table, self.q_pos)

    def cache(self):
        return {"k_codes": self.kc, "v_codes": self.vc, "k_scale": self.ks,
                "v_scale": self.vs, "pos": self.pool_pos,
                "page_table": self.table}

    def dense(self):
        return kv_pool.gather_paged(self.cache())

    def ring_args(self):
        """The same content as a [B, NP * ps] ring (B4's operands)."""
        safe = self.table.long().clamp(min=0)
        b, npg = self.table.shape
        ring = [x[safe].reshape((b, npg * x.shape[1]) + x.shape[2:])
                .contiguous() for x in (self.kc, self.vc, self.ks, self.vs)]
        return (self.q, *ring, self.dense()[2].contiguous(), self.q_pos)

    def nbytes(self):
        pages = torch.unique(self.table.clamp(min=0)).numel()
        ps = self.pool_pos.shape[1]
        per_page = ps * (2 * self.kc[0, 0].numel() + 2 * 2
                         * self.ks[0, 0].numel() + 4)
        return (pages * per_page + self.table.numel() * 4
                + 2 * self.q.numel() * 4 + self.q_pos.numel() * 4)

    def flops(self):
        return 4 * self.q.numel() * self.table.shape[1] \
            * self.pool_pos.shape[1]


def check_attention(name, ops):
    """Kernel vs plain on one operand set; returns the max |error|."""
    if name == B4:
        got = ad.qkv_attn_decode(*ops.args(), window=ops.window)
        want = ad.qkv_attn_decode_plain(*ops.args(), window=ops.window)
    else:
        got = ad.qkv_attn_decode_paged(*ops.args(), window=ops.window)
        want = ad.qkv_attn_decode_paged_plain(*ops.args(),
                                              window=ops.window)
    torch.cuda.synchronize()
    k, v, k_pos = ops.dense()
    bound = ad.error_bound(ops.q, k, v, k_pos, ops.q_pos, ops.window)
    err = (got.double() - want.double()).abs()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    if (err > bound).any():
        raise AssertionError(f"{name} {tuple(ops.q.shape)}: |err| "
                             f"{err.max().item():.3e} over the bound")
    if name == B5:
        ring = ad.qkv_attn_decode(*ops.ring_args(), window=ops.window)
        if not torch.equal(ring, got):
            raise AssertionError("B5 rows differ from B4's on the same "
                                 "content laid out as a ring")
    return err.max().item()


def time_attention(name, ops, reps=50):
    """ms of the kernel, its plain version and one
    scaled_dot_product_attention on the dequantized fp32 K/V under the
    same mask (heads expanded beforehand; timing only), with the bound."""
    import torch.nn.functional as F
    fn = ad.qkv_attn_decode if name == B4 else ad.qkv_attn_decode_paged
    plain = ad.qkv_attn_decode_plain if name == B4 \
        else ad.qkv_attn_decode_paged_plain
    args = ops.args()
    ms = time_ms(lambda: fn(*args, window=ops.window), reps)
    plain_ms = time_ms(lambda: plain(*args, window=ops.window), 5)
    k, v, k_pos = ops.dense()
    b, s, hk, g, d = ops.q.shape
    q4 = ops.q.reshape(b, s, hk * g, d).transpose(1, 2).contiguous()
    k4 = k.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    v4 = v.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    mask = ad.attention_mask(ops.q_pos, k_pos, ops.window)[:, None]
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask), reps)
    b_ms, b_by = bound(ops.nbytes(), ops.flops())
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=b_ms, bound_by=b_by)


def phase_attention(cfg, gen, dev):
    """B4 and B5 against their plain versions on every listed shape;
    times at the decode shape (S = 1) of the serve phase (T = 256) and of
    the model's window (T = 4096)."""
    results = {}
    for name, shapes in (
            (B4, [(s, t, w) for t, w in ((256, None), (4096, 1024))
                  for s in (1, 8)]),
            (B5, [(s, 16, w) for w in (None, 100) for s in (1, 8)])):
        worst = 0.0
        timed = {}
        for s, t, w in shapes:
            ops = RingOperands(cfg, s, t, w, gen, dev) if name == B4 \
                else PagedOperands(cfg, s, t, w, gen, dev)
            err = check_attention(name, ops)
            worst = max(worst, err)
            log(f"[3] {name} S={s} {'T' if name == B4 else 'pages'}={t} "
                f"window={w}: max |err| {err:.3e} within the bound")
            if s == 1 and w in (None, 1024):
                timed[t] = time_attention(name, ops)
                log(f"[3] {name} S=1 {'T' if name == B4 else 'pages'}={t}: "
                    f"{timed[t]}")
        head = timed[256] if name == B4 else timed[16]
        results[name] = dict(head, max_abs_err=worst)
        if name == B4:
            results[name]["ms_t4096_window1024"] = timed[4096]["ms"]
    return results


# ----------------------------------------------------------------- serve ----
def requests(vocab, rng, n=8, lo=16, hi=64, new=16):
    return [Request(prompt=rng.integers(0, vocab, int(rng.integers(lo, hi + 1))
                                        ).astype(np.int32),
                    max_new_tokens=new, seed=i) for i in range(n)]


def serve_all(eng, reqs):
    eng.reset()
    t0 = time.perf_counter()
    out = {c.request_id: c for c in eng.serve(
        [dataclasses.replace(r) for r in reqs])}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    base = min(out)
    return [out[base + i] for i in range(len(reqs))], wall


def decode_step_ms(eng, steps=10):
    """Host-clock time of one greedy decode step at batch max_batch."""
    b = eng.ecfg.max_batch
    cache = eng.init_cache(b)
    tokens = np.arange(1, b + 1, dtype=np.int32)
    times = []
    for t in range(steps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = lm.decode_step(eng.model, eng.cfg, cache, tokens,
                                       np.full(b, 64 + t))
        tokens = logits.argmax(-1).cpu().numpy().astype(np.int32)
        times.append(time.perf_counter() - t0)
    return float(np.median(times[2:]) * 1e3)


def profile_decode(eng, steps=3):
    """Device view of greedy decode steps at batch max_batch (torch
    profiler): kernels launched, device busy time and the top kernels by
    device time, per step."""
    from torch.profiler import ProfilerActivity, profile
    b = eng.ecfg.max_batch
    state = {"cache": eng.init_cache(b),
             "tokens": np.arange(1, b + 1, dtype=np.int32)}

    def step(t):
        logits, state["cache"] = lm.decode_step(
            eng.model, eng.cfg, state["cache"], state["tokens"],
            np.full(b, 64 + t))
        state["tokens"] = logits.argmax(-1).cpu().numpy().astype(np.int32)

    step(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for t in range(steps):
            step(1 + t)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    busy = sum(e.device_time_total for e in kern) / steps / 1e3
    top = sorted(kern, key=lambda e: -e.device_time_total)[:4]
    return {"kernels_per_step": sum(e.count for e in kern) / steps,
            "device_busy_ms_per_step": busy,
            "top": [(e.key[:48], round(e.device_time_total / steps / 1e3, 3))
                    for e in top]}


def check_lockstep_equals_continuous(eng, cfg, ecfg, vocab, rng, s0, new):
    lock = engine.LockstepEngine(eng.model, cfg, ecfg, already_serve=True,
                                 device=eng.device)
    prompts = rng.integers(0, vocab, (ecfg.max_batch, s0)).astype(np.int32)
    a = lock.generate(prompts, new)
    b = eng.generate(prompts, new)
    if not np.array_equal(a, b):
        raise AssertionError(f"lockstep != continuous:\n{a}\n{b}")


def _prefill_then_decode(model, cfg, dev):
    """Logits of a 4 x 8 prefill chunk and of one decode step after it."""
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (4, 9)).astype(np.int32)
    pos = np.tile(np.arange(8), (4, 1))
    cache = lm.init_cache(cfg, 4, 64, torch.float32, device=dev)
    a, cache = lm.prefill_step(model, cfg, cache, tokens[:, :8], pos,
                               np.full(4, 7))
    b, _ = lm.decode_step(model, cfg, cache, tokens[:, 8], np.full(4, 8))
    return [a.double().cpu(), b.double().cpu()]


def rel_l2(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return ((a - b).norm() / b.norm()).item()


class LinearTape:
    """Hooks on every serve linear of a model, recording each call's input
    and output in call order. With ``feed`` (another tape's inputs) each
    call runs on the fed input; the input the model's own ops made is
    still what the tape records."""

    def __init__(self, model, feed=None):
        self.inputs, self.outputs, self.feed = [], [], feed
        self.handles = []
        for name, mod in model.named_modules():
            if isinstance(mod, smol.SmolLinear):
                self.handles += [
                    mod.register_forward_pre_hook(self._pre(name)),
                    mod.register_forward_hook(self._post)]

    def _pre(self, name):
        def hook(mod, args):
            self.inputs.append((name, mod, args[0].detach()))
            if self.feed is None:
                return None
            fed_name, _mod, x = self.feed[len(self.inputs) - 1]
            if fed_name != name:
                raise AssertionError(f"call order: {name} vs {fed_name}")
            return (x.to(args[0].device),) + tuple(args[1:])
        return hook

    def _post(self, mod, args, out):
        self.outputs.append(out.detach())

    def close(self):
        for h in self.handles:
            h.remove()


def code_coords(lin, x, qcfg):
    """A serve linear's input in activation code units, as
    ``backend.base.packed_matmul`` quantizes it: the channel perm, the
    per-token scale, then t = (u / h + 2^p - 1) / 2 at
    each channel's precision p (h = 2^(1-p)); the code is t rounded half
    to even and clipped to [0, 2^p - 1]. Returns (codes, t)."""
    xp = x.reshape(-1, x.shape[-1]).float().cpu().index_select(
        -1, lin.perm.cpu())
    k = xp.shape[-1]
    p = quant.expand_groups(lin.pbits_sorted.float().cpu(), k,
                            qcfg.eff_group_size(k))
    u = xp / quant.abs_max_scale(xp, dim=-1)
    t = (u / torch.exp2(1.0 - p) + (torch.exp2(p) - 1.0)) / 2.0
    return quant.quantize_to_int(u, p), t


def check_against_cpu(qat_cfg, ecfg, dev, full_layers=2):
    """The kernels on the card against the plain versions on the CPU, fp32.

    (1) Reduced h2o-danube-1.8b end to end: the logits of a prefill chunk
    and a decode step within relative L2 1e-5.
    (2) Full width, ``full_layers`` layers, a prefill chunk and a decode
    step, teacher-forced: the CPU runs them and records every serve
    linear's input; the card runs them with each linear fed the CPU's
    input to it. No activation the card computes then reaches a later
    requantization, so a code that flips cannot cascade, and every op of
    the card's path is held on its own: each linear's output on the CPU's
    input (the segment kernels); each linear's input as the card's own
    ops made it (norms, RoPE, ring write, attention, SwiGLU, residual
    adds); and the logits. Each within relative L2 1e-5. Where a card
    input quantizes to another code than the CPU's, both values must sit
    within 1e-3 of a code step of each other, across the rounding boundary
    between them: a knife edge, not a fault (ROADMAP.md §C).
    Returns the numbers."""
    out = {}
    small = dataclasses.replace(qat_cfg.reduced(), dtype="float32")
    eng = engine.DecodeEngine(lm.init_params(small, seed=SEED + 1,
                                             device=dev), small, ecfg,
                            device=dev)
    card = _prefill_then_decode(eng.model, eng.cfg, dev)
    cpu = _prefill_then_decode(copy.deepcopy(eng.model).to("cpu"), eng.cfg,
                               "cpu")
    out["reduced_logits_rel_l2"] = max(
        rel_l2(a, b) for a, b in zip(card, cpu))
    wide = dataclasses.replace(qat_cfg, num_layers=full_layers,
                               dtype="float32")
    eng = engine.DecodeEngine(lm.init_params(wide, seed=SEED + 1,
                                             device=dev), wide, ecfg,
                            device=dev)
    host = copy.deepcopy(eng.model).to("cpu")
    qcfg = eng.cfg.quant
    tape_cpu = LinearTape(host)
    logits_cpu = _prefill_then_decode(host, eng.cfg, "cpu")
    tape_cpu.close()
    tape_card = LinearTape(eng.model, feed=tape_cpu.inputs)
    logits_card = _prefill_then_decode(eng.model, eng.cfg, dev)
    tape_card.close()
    calls = len(tape_cpu.inputs)
    if len(tape_card.inputs) != calls or calls != 7 * full_layers * 2:
        raise AssertionError(f"linear calls: card {len(tape_card.inputs)}, "
                             f"CPU {calls}")
    worst_in = worst_out = worst_dt = 0.0
    flips = []
    for (name, lin, x_card), (_n, _l, x_cpu), y_card, y_cpu in zip(
            tape_card.inputs, tape_cpu.inputs, tape_card.outputs,
            tape_cpu.outputs):
        worst_out = max(worst_out, rel_l2(y_card, y_cpu))
        worst_in = max(worst_in, rel_l2(x_card, x_cpu))
        c_card, t_card = code_coords(lin, x_card, qcfg)
        c_cpu, t_cpu = code_coords(lin, x_cpu, qcfg)
        flip = c_card != c_cpu
        if flip.any():
            flips.append((name, int(flip.sum())))
            worst_dt = max(worst_dt,
                           (t_card - t_cpu)[flip].abs().max().item())
    out.update(full_width_calls=calls,
               full_width_linear_out_rel_l2=worst_out,
               full_width_linear_in_rel_l2=worst_in,
               full_width_logits_rel_l2=max(
                   rel_l2(a, b) for a, b in zip(logits_card, logits_cpu)),
               flipped_codes=flips, flipped_max_code_step=worst_dt)
    held = (out["reduced_logits_rel_l2"] <= 1e-5 and worst_out <= 1e-5
            and worst_in <= 1e-5 and out["full_width_logits_rel_l2"] <= 1e-5
            and worst_dt <= 1e-3)
    if not held:
        raise AssertionError(f"card vs CPU: {out}")
    return out


def shared_prefix_requests(vocab, rng, prefix=224, tail=16, waves=(8, 32),
                           per_wave=4):
    """Two waves of same-length prompts sharing a ``prefix``-token system
    prompt: the first (short answers) registers the prefix pages, the
    second maps them and decodes past the ring's end."""
    system = rng.integers(0, vocab, prefix).astype(np.int32)
    reqs = []
    for new in waves:
        for _ in range(per_wave):
            prompt = np.concatenate(
                [system, rng.integers(0, vocab, tail).astype(np.int32)])
            reqs.append(Request(prompt=prompt, max_new_tokens=new,
                                seed=len(reqs)))
    return reqs


def timed_serve(eng, reqs):
    """Serve ``reqs`` step by step: (completions in request order, wall
    seconds, median host-clock ms of the steps where every active slot
    decodes, with the pool checked after every step)."""
    eng.reset()
    for r in reqs:
        eng.submit(dataclasses.replace(r))
    out, decode_ms = {}, []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.sched.has_work():
        decoding = bool(eng.sched.slots) and not eng.sched.pending and all(
            st.phase == DECODE for st in eng.sched.slots.values())
        t1 = time.perf_counter()
        done = eng.step()
        torch.cuda.synchronize()
        if decoding:
            decode_ms.append((time.perf_counter() - t1) * 1e3)
        for c in done:
            out[c.request_id] = c
        if eng.pool is not None:
            eng.pool.check()
    wall = time.perf_counter() - t0
    base = min(out)
    return ([out[base + i] for i in range(len(reqs))], wall,
            float(np.median(decode_ms)))


def phase_kv4_serve(qat_cfg, vocab, dev, rng, launches):
    """Full-width 4-bit KV serving, ring (continuous and lockstep) and
    paged, with identical greedy tokens. Returns the per-engine numbers."""
    kw = dict(max_batch=4, cache_len=256, prefill_chunk=8, kv_bits=4)
    reqs = shared_prefix_requests(vocab, rng)
    stats = {}
    params = lm.init_params(qat_cfg, seed=SEED + 3, device=dev)
    kernels.reset_launch_counts()
    ring = engine.DecodeEngine(params, qat_cfg, engine.EngineConfig(**kw))
    del params
    torch.cuda.empty_cache()
    ring_out, wall, step = timed_serve(ring, reqs)
    counts = kernels.launch_counts()
    launches[B4] = counts[B4]
    log(f"[6] ring kv4 launches {counts}")
    if counts[B4] == 0 or counts[B5] != 0 or counts[B1] == 0:
        raise AssertionError(f"kv4 ring path launches {counts}")
    new = sum(c.new_tokens.size for c in ring_out)
    stats["ring"] = dict(tok_s=new / wall, decode_step_ms=step,
                         fresh_cache_step_ms=decode_step_ms(ring),
                         steps=ring.sched.step_count)
    cache = ring.init_cache(4)
    stats["ring"]["kv_payload_bytes"] = kv_quant.cache_payload_bytes(cache)
    del cache
    stats["ring"]["profile"] = profile_decode(ring)
    log(f"[6] ring DecodeEngine: {new} tokens in {wall:.2f} s; "
        f"{stats['ring']}")

    lock = engine.LockstepEngine(ring.model, ring.cfg,
                                 engine.EngineConfig(**kw),
                                 already_serve=True, device=dev)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for w in range(0, len(reqs), 4):
        group = reqs[w:w + 4]
        got = lock.generate(np.stack([r.prompt for r in group]),
                            group[0].max_new_tokens)
        for r, row, c in zip(group, got, ring_out[w:w + 4]):
            if not np.array_equal(row, c.tokens):
                raise AssertionError(f"kv4 lockstep != ring continuous "
                                     f"(request {c.request_id})")
    wall = time.perf_counter() - t0
    if kernels.launch_counts()[B4] == 0:
        raise AssertionError("kv4 lockstep ran no B4 launch")
    stats["lockstep"] = dict(tok_s=new / wall,
                             fresh_cache_step_ms=decode_step_ms(lock))
    log(f"[6] LockstepEngine == ring DecodeEngine; {stats['lockstep']}")

    paged = engine.DecodeEngine(ring.model, ring.cfg, engine.EngineConfig(
        kv_layout="paged", page_size=16, **kw), already_serve=True,
        device=dev)
    kernels.reset_launch_counts()
    paged_out, wall, step = timed_serve(paged, reqs)
    counts = kernels.launch_counts()
    launches[B5] = counts[B5]
    log(f"[6] paged kv4 launches {counts}")
    if counts[B5] == 0 or counts[B4] != 0:
        raise AssertionError(f"kv4 paged path launches {counts}")
    for a, b in zip(ring_out, paged_out):
        if not np.array_equal(a.tokens, b.tokens):
            raise AssertionError(f"kv4 paged != ring (request "
                                 f"{a.request_id})")
    pool_stats = paged.paged_kv_stats()
    if pool_stats["prefix_hits"] == 0 or pool_stats["cow_copies"] == 0:
        raise AssertionError(f"prefix map / copy-on-write idle: "
                             f"{pool_stats}")
    paged.pool.check()
    stats["paged"] = dict(tok_s=new / wall, decode_step_ms=step,
                          steps=paged.sched.step_count, pool=pool_stats)
    log(f"[6] paged DecodeEngine == ring: {new} tokens in {wall:.2f} s; "
        f"{stats['paged']}")
    for c in ring_out[:2] + ring_out[4:6]:
        log(f"[6] request {c.request_id}: {c.new_tokens[:8].tolist()}")
    return stats


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"[1] card: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    built = _build.build()
    log(f"[1] built {sorted(built)} in {time.perf_counter() - t0:.2f} s "
        f"(per source: { {k: round(v, 2) for k, v in built.items()} })")
    for src in _build.SOURCES:
        report = _build.ptxas_report(src) or ""
        for line in report.splitlines():
            if "Used" in line or "spill" in line:
                log(f"    ptxas {src}: {line.strip()}")

    # -------------------------------------------------------- phase 2 ----
    cfg = get_config(ARCH)
    mixed = QuantConfig(mode="qat")
    u4 = U4
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    results = {B7: phase_quant_pack(cfg, mixed, gen, dev)}
    log(f"[2] quantize_pack bit-equal; {results[B7]}")
    for name, qcfg in ((B1, mixed), (B2, u4)):
        decode_sets = [LayerOperands(cfg, qcfg, 4, gen, dev)
                       for _ in range(4)]
        prefill = LayerOperands(cfg, qcfg, 32, gen, dev)
        err = check_segment_gemm(name, decode_sets[:1] + [prefill])
        res = time_segment_gemm(name, decode_sets)
        res["max_abs_err"] = err
        res["prefill_ms"] = time_segment_gemm(name, [prefill])["ms"]
        results[name] = res
        log(f"[2] {name} within the fp32 bound (max |err| {err:.3e}); "
            f"one layer at M=4: {res}")
        del decode_sets, prefill
    torch.cuda.empty_cache()

    # -------------------------------------------------------- phase 3 ----
    results.update(phase_attention(cfg, gen, dev))
    torch.cuda.empty_cache()

    # -------------------------------------------------------- phase 4 ----
    launches = {}
    qat_cfg = cfg.with_quant_mode("qat")
    ecfg = engine.EngineConfig(max_batch=4, cache_len=256, prefill_chunk=8)
    params = lm.init_params(qat_cfg, seed=SEED, device=dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    eng = engine.DecodeEngine(params, qat_cfg, ecfg)
    del params
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED)
    reqs = requests(cfg.vocab_size, rng)
    first, wall1 = serve_all(eng, reqs)
    counts = kernels.launch_counts()
    launches[B1], launches[B7] = counts[B1], counts[B7]
    log(f"[4] packed {cfg.num_layers} layers in {pack_s:.2f} s "
        f"({engine.packed_model_bytes(eng.model):,} bytes); launches "
        f"{counts}")
    if counts[B1] == 0 or counts[B7] == 0 or counts[B2] != 0:
        raise AssertionError(f"main path launches {counts}")
    for c in first:
        if c.new_tokens.size != 16 or not (
                (c.new_tokens >= 0) & (c.new_tokens < cfg.vocab_size)).all():
            raise AssertionError(f"bad completion {c.new_tokens}")
    second, wall2 = serve_all(eng, reqs)
    for a, b in zip(first, second):
        if not np.array_equal(a.tokens, b.tokens):
            raise AssertionError("second identical run gave other tokens")
    new = sum(c.new_tokens.size for c in second)
    step_ms = decode_step_ms(eng)
    log(f"[4] served {len(reqs)} requests ({new} new tokens) in "
        f"{eng.sched.step_count} steps: {new / wall2:.2f} tok/s "
        f"(first run {wall1:.2f} s, second {wall2:.2f} s); decode step at "
        f"batch 4: {step_ms:.2f} ms; tokens[0] {second[0].new_tokens[:8]}")
    prof = profile_decode(eng)
    log(f"[4] decode step profile (batch 4): {prof}; device idle share "
        f"{1 - prof['device_busy_ms_per_step'] / step_ms:.3f} of the "
        f"unprofiled {step_ms:.2f} ms step")
    check_lockstep_equals_continuous(eng, qat_cfg, ecfg, cfg.vocab_size,
                                     rng, 16, 8)
    log("[4] lockstep == continuous on same-length prompts")
    del eng
    torch.cuda.empty_cache()
    log(f"[4] card kernels vs CPU plain versions (fp32, relative L2): "
        f"{check_against_cpu(qat_cfg, ecfg, dev)}")
    torch.cuda.empty_cache()

    # -------------------------------------------------------- phase 5 ----
    u4_cfg = dataclasses.replace(cfg, num_layers=2, quant=u4)
    params = lm.init_params(u4_cfg, seed=SEED + 2, device=dev)
    kernels.reset_launch_counts()
    eng = engine.DecodeEngine(params, u4_cfg, ecfg)
    del params
    done, wall = serve_all(eng, requests(cfg.vocab_size, rng, n=4))
    counts = kernels.launch_counts()
    launches[B2] = counts[B2]
    log(f"[5] U4 depth 2: {sum(c.new_tokens.size for c in done)} tokens in "
        f"{wall:.2f} s; launches {counts}")
    if counts[B2] == 0 or counts[B1] != 0:
        raise AssertionError(f"U4 path launches {counts}")
    check_lockstep_equals_continuous(eng, u4_cfg, ecfg, cfg.vocab_size, rng,
                                     12, 6)
    log("[5] lockstep == continuous")

    del eng
    torch.cuda.empty_cache()

    # -------------------------------------------------------- phase 6 ----
    kv4 = phase_kv4_serve(qat_cfg, cfg.vocab_size, dev, rng, launches)

    # -------------------------------------------------------- phase 7 ----
    work = {B7: "one h2o-danube-1.8b layer of packing (21 segments)",
            B1: "one h2o-danube-1.8b layer of decode GEMMs at M=4",
            B2: "one h2o-danube-1.8b layer of decode GEMMs at M=4",
            B4: "one decode attention call: B=4, S=1, Hk=8, G=4, D=80, "
                "T=256 (the kv4 serve ring)",
            B5: "one decode attention call: B=4, S=1, Hk=8, G=4, D=80, "
                "16 pages of 16 a slot"}
    rows = []
    for name in (B1, B2, B4, B5, B7):
        r = results[name]
        rows.append({"name": name, "route": "cuda", "source": SOURCES[name],
                     "replaces": REPLACES[name], "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "work": work[name]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"kv4_serve": {
        k: {n: x for n, x in v.items() if n != "profile"}
        for k, v in kv4.items()}}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
