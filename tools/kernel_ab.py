#!/usr/bin/env python3
"""Time the segment GEMM kernels (B1, B2, B3, B6), the decode attention
kernels (B4, B5), the backward passes of the training ops (B9, B8) and
the full-width training step of one checkout of the PyTorch port on the
card, so two checkouts, or two builds of one, can be compared in one call:

    python3 tools/kernel_ab.py --src /path/to/parent/src --label parent
    python3 tools/kernel_ab.py --src src --label change
    python3 tools/kernel_ab.py --src src --label cluster1 \\
        --set MAX_CLUSTER=1
    python3 tools/kernel_ab.py --src src --label attn --only attn
    python3 tools/kernel_ab.py --src src --label change --only train

``--only gemm``, ``attn``, ``train``, ``b8``, ``step``, ``pack``,
``load`` or ``serve`` times one family; with no ``--only`` the first two
run (the others are timed only when asked for). ``--set NAME=VALUE``
times a scratch build of the source (``csrc/segment_gemm.cu``,
``csrc/attn_decode.cu``, ``csrc/quant_pack.cu`` or, with ``train`` and
``b8``, ``csrc/fake_quant.cu``) that declares ``constexpr int NAME`` (one
of the launch-shape constants at the top of each source, none of which
changes a bit of the result) with NAME set to VALUE, compiled into the
checkout's build directory.

Work per row, at full width with random operands from a fixed seed (the
same in every checkout): the segment GEMMs of one h2o-danube-1.8b layer
(7 linears, default mix; B1 with the driver's scale, B3 on x as it is) and
of one uniform 4-bit layer (B2), at M = 4 (decode) and M = 32 (a prefill
chunk), and each linear of the B1 layer at M = 4; B6 over one
deepseek-moe-16b layer's three expert projections (E = 64, T = 4 and
T = 32 rows each, every row live). A checkout whose ``packed_matmul`` has
``segments_matmul`` launches once per linear (or projection), else once
per segment. Rotating operand sets keep the carriers coming from device
memory. Each row has two readings, both with CUDA events: ``device_ms``
with the host's launches queued ahead while the card sleeps (the kernels
back to back) and ``loop_ms`` as a loop of calls (host launch gaps
included), the two timers of ``chip_smoke.py``. Attention rows add
``host_ms``: the host clock of one call while the card sleeps (the
wrapper's checks and the ctypes launch).

Attention rows, one call each at batch 4, S = 1, full width, the same
operands every call (the codes stay in L2, as in ``chip_smoke.py``):
h2o-danube-1.8b (Hk = 8, G = 4, D = 80) B4 on rings of T = 256 and
T = 4096 (window 1024), B5 on 16 and 256 pages of 16 a slot (the latter
with window 1024); deepseek-moe-16b (Hk = 16, G = 1, D = 128) B4 at
T = 256 and B5 on 16 pages of 16. Rings hold one wrapped and one half-empty
row, each query at its row's newest position; tables are shuffled.
B8 forward rows (``--only train`` and ``--only b8``): the kernel through
its wrapper, on both rulers, beside torch's ``clone`` of the same tensors
(``*_clone_device_ms``: one read and one write of each, the bytes alone):
one h2o-danube-1.8b layer (7 fp32 weights, per-group scales, and their
[1024, K] bf16 activations, per-row scales), one whisper-medium encoder
and one decoder layer (16 weights; activations at 12,000 rows for the
encoder and the cross wk/wv), one mamba2-2.7b layer (in_proj, out_proj)
and one deepseek-moe-16b MoE layer's serve-step activation banks ([64, 4,
K]); each layer's operands exceed the L2. Then ``B8_sass`` (the static
SASS count of the forward's main loop per element, by template instance:
``tools/sass_count.py``) and ``B8_ptxas`` (registers and spills).
``--only b8`` adds ``B8_call_*``: each distinct whisper call alone over
copies of its operands that exceed the L2, beside ``clone``.

Training rows (``--only train``): the backward of one h2o-danube-1.8b
layer's training ops through autograd (``torch.autograd.grad`` of a
forward kept alive), so a checkout whose backward is plain torch and one
whose backward is a kernel are timed alike: ``B9_bwd`` over the 7 weights
(dw and ds), ``B8_bwd`` over the 7 fp32 weights and the 7 bf16
activations at 8 x 128 tokens (dx), on both rulers; then the same ops
forward (``*_bank_layer_*``) and backward (``*_bank_bwd_layer_*``) over
the three expert banks of one deepseek-moe-16b MoE layer (E = 64, one
launch a bank each way; activations [64, 120, K] bf16).

Step rows (``--only step``): full-width, 24-layer h2o-danube-1.8b training
as ``chip_smoke.py`` phase 8 runs it (TokenStream(batch 8, seq 128, seed
0), Phase I steps 0-2, the freeze, Phase II steps 3-5): the host-clock ms
of every step and a device profile of steps 1, 3 and 5
(``tools/step_profile.py``: busy ms, kernels, the plain ops split by the
op that launched them).

Pack rows (``--only pack``): deploy packing through the public
``repro_torch.api.transforms.convert_tree`` (as ``DecodeEngine`` calls it,
rebudget on), so checkouts whose packing drivers differ are timed alike,
on the QAT leaves of one full-width h2o-danube-1.8b layer (7 linears) and
of one full-width deepseek-moe-16b MoE layer (q/k/v/o, the shared
experts, the three [64, K, N] routed banks), each from ``lm.init_params``
at seed 0: ``host_ms`` (host clock of a call, synchronized), ``loop_ms``
(CUDA events around a loop of calls), ``device_ms`` (the device busy time
of one call under torch.profiler), ``kernels`` (device events a call),
``b7_launches`` and ``by_op`` (``step_profile.load_summary``). ``B7_h2o``
times the B7 kernels alone on one h2o layer (4 rotating weight sets), as
the checkout's driver launches them: one launch a linear reading rows
through the channel perm where the checkout has ``quantize_pack_segments``,
else one a segment on sorted copies; both rulers.

Load rows (``--only load``): the whole load of ``DecodeEngine`` at full
width and depth, h2o-danube-1.8b (24 layers) and deepseek-moe-16b (28
layers, 60.8 GiB of fp32 QAT weights): ``pack_s`` (host clock of the
engine's construction), its B7 launches, peak memory and a digest of the
packed model (``tree_digest``), then a second,
profiled construction: busy ms, device events and the split by op. A
load of a two-layer reduced model comes first (``first_load_s``: the
process's one-time costs), so ``pack_s`` is steady state.

Serve rows (``--only serve``): the fp-ring serve steps of
``DecodeEngine`` at full width and depth, h2o-danube-1.8b (24 layers) and
deepseek-moe-16b (28 layers), random QAT weights of seed 0, batch 4:
``*_prefill_ms`` (host clock of one 4 x 8 prefill chunk, the logits'
argmax on the host included; median of chunks 2-7 of a 64-token prompt)
and ``*_decode_ms`` (the same of a greedy decode step after it; median of
steps 2-11), then a device profile of 3 chunks and of 3 decode steps
(``*_prefill_profile``, ``*_decode_profile``: kernels, busy ms and fp32
GEMM ms a step, ``step_profile.device_summary``'s top kernels). The
readout and the MoE router are the serve path's fp32 GEMMs.

Prints one JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import gc
import hashlib
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path


def loop_ms(torch, fn, reps):
    """Mean time of ``fn`` over ``reps`` calls in a loop (after a
    warm-up), host launch gaps included."""
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


def queued_ms(torch, fn, reps):
    """The same with the stream first sleeping ~0.1 s on the card while
    the host enqueues every launch: (device ms, the kernels back to back;
    host ms, the enqueue of one call on the host clock)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, host


def device_ms(torch, fn, reps):
    return queued_ms(torch, fn, reps)[0]


def build_variant(_build, mod, settings):
    """Compile ``mod.SOURCE`` with each ``NAME=VALUE`` of ``settings``
    replacing ``constexpr int NAME = ...;`` and make it the library ``mod``
    launches."""
    text = (_build.CSRC / mod.SOURCE).read_text()
    for item in settings:
        name, value = item.split("=")
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {int(value)};", text)
        if n != 1:
            raise SystemExit(f"no constant {name} in {mod.SOURCE}")
    stem = Path(mod.SOURCE).stem + "-" + hashlib.sha256(
        (text + " ".join(_build.NVCC_FLAGS)).encode()).hexdigest()[:16]
    src = _build.BUILD_DIR / f"{stem}.cu"
    out = _build.BUILD_DIR / f"{stem}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src.write_text(text)
        tmp = out.with_name(f"{stem}.{os.getpid()}.tmp.so")
        done = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                               "-o", str(tmp), str(src)], check=True,
                              capture_output=True, text=True,
                              timeout=_build.BUILD_TIMEOUT_S)
        out.with_suffix(".ptxas.txt").write_text(done.stdout + done.stderr)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    mod._bind(lib)
    _build._LIBS[mod.SOURCE] = lib


def declares(_build, mod, name):
    return re.search(rf"constexpr int {name} = \d+;",
                     (_build.CSRC / mod.SOURCE).read_text()) is not None


def attention_rows(torch, ad, kv_quant, get_config, dev, gen, rows):
    """B4 and B5 at the decode shapes of the two serve configurations, on
    both rulers."""
    def ring(cfg, t, b=4):
        hk, g, d = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, \
            cfg.hd
        q = torch.randn((b, 1, hk, g, d), generator=gen, device=dev)
        kc, ks = kv_quant.quantize_kv(
            torch.randn((b, t, hk, d), generator=gen, device=dev) * 2.0)
        vc, vs = kv_quant.quantize_kv(
            torch.randn((b, t, hk, d), generator=gen, device=dev))
        pos = torch.arange(t, device=dev, dtype=torch.int32).repeat(b, 1)
        pos[0] = (pos[0] + t // 3) % t + t
        pos[1, t // 2:] = -1
        q_pos = pos.amax(dim=1, keepdim=True).contiguous()  # each newest
        return ad.qkv_attn_decode, (q, kc, vc, ks, vs, pos, q_pos)

    def paged(cfg, npg, b=4, ps=16):
        hk, g, d = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, \
            cfg.hd
        npages = b * npg + 1
        q = torch.randn((b, 1, hk, g, d), generator=gen, device=dev)
        kc, ks = kv_quant.quantize_kv(
            torch.randn((npages, ps, hk, d), generator=gen, device=dev))
        vc, vs = kv_quant.quantize_kv(
            torch.randn((npages, ps, hk, d), generator=gen, device=dev))
        perm = torch.randperm(npages - 1, generator=gen, device=dev) + 1
        table = perm[:b * npg].reshape(b, npg).to(torch.int32)
        pos = torch.full((npages, ps), -1, dtype=torch.int32, device=dev)
        lp = (torch.arange(npg, device=dev)[:, None] * ps
              + torch.arange(ps, device=dev)[None]).to(torch.int32)
        for bi in range(b):
            pos[table[bi].long()] = lp
        q_pos = torch.full((b, 1), npg * ps - 1, dtype=torch.int32,
                           device=dev)
        return ad.qkv_attn_decode_paged, (q, kc, vc, ks, vs, pos, table,
                                          q_pos)

    h2o = get_config("h2o-danube-1.8b")
    moe = get_config("deepseek-moe-16b")
    for key, (fn, args), window in (
            ("B4_h2o_T256", ring(h2o, 256), None),
            ("B4_h2o_T4096_w1024", ring(h2o, 4096), 1024),
            ("B5_h2o_16x16", paged(h2o, 16), None),
            ("B5_h2o_256x16_w1024", paged(h2o, 256), 1024),
            ("B4_deepseek_T256", ring(moe, 256), None),
            ("B5_deepseek_16x16", paged(moe, 16), None)):
        call = (lambda f, a, w: lambda: f(*a, window=w))(fn, args, window)
        rows[f"{key}_device_ms"], rows[f"{key}_host_ms"] = queued_ms(
            torch, call, 50)
        rows[f"{key}_loop_ms"] = loop_ms(torch, call, 50)


def _b8_layer(torch, quant, dev, gen, shapes):
    """B8's operands for training linears (K, N, M): the fp32 weight [K,
    N] with per-group scales and mixed 1/2/4-bit groups, and its bf16
    activations [M, K] with per-row abs-max / 1.875 scales."""
    calls = []
    for k, n, m in shapes:
        pb = torch.tensor([1.0, 2.0, 4.0], device=dev)[torch.randint(
            0, 3, (k // 16,), generator=gen, device=dev)]
        w = torch.randn((k, n), generator=gen, device=dev) * 0.02
        calls.append(((w, pb, quant.per_group_weight_scale(w, 16)),
                      dict(row_scale=False, k_dim=0)))
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        calls.append(((x, pb, quant.abs_max_scale(x, dim=1).reshape(m)),
                      dict(row_scale=True)))
    return calls


def b8_call_rows(torch, fq, quant, dev, gen, shapes, rows):
    """Each distinct call of a layer set alone: device ms a call over
    enough copies of its operands to exceed the L2 (so every call finds
    its operands cold), beside ``clone`` of the same tensors (the bytes
    alone: one read and one write)."""
    seen = {}
    for k, n, m in shapes:
        seen.setdefault((k, n, m), None)
    for k, n, m in seen:
        one = _b8_layer(torch, quant, dev, gen, [(k, n, m)])
        for (args, kw), kind in zip(one, ("w", "x")):
            nbytes = args[0].numel() * args[0].element_size()
            copies = [args] + [(args[0].clone(),) + tuple(args[1:])
                               for _ in range(-(-100_000_000 // nbytes) - 1)]
            fn = (lambda c, kw_: lambda: [fq.fake_quant(*a, **kw_)
                                          for a in c])(copies, kw)
            cl = (lambda c: lambda: [a[0].clone() for a in c])(copies)
            key = f"B8_call_{kind}_{k}x{n}x{m}"
            rows[f"{key}_device_ms"] = device_ms(torch, fn, 5) / len(copies)
            rows[f"{key}_clone_device_ms"] = device_ms(torch, cl, 5) / len(
                copies)
            del copies, fn, cl
        del one
        torch.cuda.empty_cache()


def b8_rows(torch, fq, quant, _build, settings, get_config, dev, gen,
            rows, detail=False):
    """B8's forward kernel alone (the wrapper ``fake_quant.fake_quant``)
    on both rulers: one h2o-danube-1.8b layer (7 weights and their [1024,
    K] activations), one whisper-medium encoder layer and one decoder
    layer (16 weights; activations at 12,000 rows for the encoder and the
    cross wk/wv, 1,024 else), one mamba2-2.7b layer (in_proj, out_proj)
    and the MoE serve step's activation banks of one deepseek-moe-16b
    layer ([64, 4, K] bf16, a scale an expert); each layer's operands
    exceed the 50 MB L2, so a call finds its operands cold. Then the
    static SASS count of the forward's main loop per element of each
    instance (``tools/sass_count.py``) and the build's ``ptxas -v``."""
    import sass_count
    h2o = get_config("h2o-danube-1.8b")
    d, f = h2o.d_model, h2o.d_ff
    hq, hk = h2o.num_heads * h2o.hd, h2o.num_kv_heads * h2o.hd
    h2o_shapes = [(k, n, 1024) for k, n in
                  [(d, hq), (d, hk), (d, hk), (hq, d), (d, f), (d, f),
                   (f, d)]]
    wh = get_config("whisper-medium")
    d, f = wh.d_model, wh.d_ff
    enc, dec = 8 * 1500, 8 * 128
    sq = [(d, d)] * 4
    whisper_shapes = ([(k, n, enc) for k, n in sq + [(d, f), (f, d)]]
                      + [(k, n, dec) for k, n in sq]
                      + [(d, d, dec), (d, d, enc), (d, d, enc), (d, d, dec)]
                      + [(k, n, dec) for k, n in [(d, f), (f, d)]])
    ssm_shapes = [(2560, 10576, 1024), (5120, 2560, 1024)]
    for key, shapes in (("B8_h2o_layer", h2o_shapes),
                        ("B8_whisper_layers", whisper_shapes),
                        ("B8_ssm_layer", ssm_shapes)):
        calls = _b8_layer(torch, quant, dev, gen, shapes)
        fn = (lambda c: lambda: [fq.fake_quant(*a, **kw)
                                 for a, kw in c])(calls)
        rows[f"{key}_device_ms"] = device_ms(torch, fn, 10)
        rows[f"{key}_loop_ms"] = loop_ms(torch, fn, 10)
        cl = (lambda c: lambda: [a[0].clone() for a, _kw in c])(calls)
        rows[f"{key}_clone_device_ms"] = device_ms(torch, cl, 10)
        del calls, fn
        torch.cuda.empty_cache()
    if detail:
        b8_call_rows(torch, fq, quant, dev, gen, whisper_shapes, rows)
    moe = get_config("deepseek-moe-16b")
    e, d, f = moe.num_experts, moe.d_model, moe.d_ff
    calls = []
    for k in (d, d, f):
        pb = torch.tensor([1.0, 2.0, 4.0], device=dev)[torch.randint(
            0, 3, (e, k // 16), generator=gen, device=dev)]
        x = torch.randn((e, 4, k), generator=gen, device=dev).to(
            torch.bfloat16)
        sx = quant.abs_max_scale(x, dim=(1, 2)).expand(e, 4, 1)
        calls.append((x, pb, sx.reshape(-1).contiguous()))
    fn = lambda: [fq.fake_quant(*a, row_scale=True) for a in calls]  # noqa
    rows["B8_moe_serve_device_ms"] = device_ms(torch, fn, 50)
    rows["B8_moe_serve_loop_ms"] = loop_ms(torch, fn, 50)
    lib = Path(_build.target(fq.SOURCE))
    text = (_build.CSRC / fq.SOURCE).read_text()
    if settings:
        lib = Path(_build._LIBS[fq.SOURCE]._name)
        text = lib.with_suffix(".cu").read_text()
    try:
        rows["B8_sass"] = sass_count.kernel_counts(
            str(lib), "fake_quant_kernel",
            sass_count.fake_quant_per_pass(text))
    except (RuntimeError, subprocess.SubprocessError) as err:
        rows["B8_sass"] = f"not measured: {err}"
    ptxas = lib.with_suffix(".ptxas.txt")
    rows["B8_ptxas"] = sass_count.ptxas_lines(
        ptxas.read_text() if ptxas.exists() else "", "fake_quant_kernel")


def train_rows(torch, backend, get_config, dev, gen, rows):
    """The backward of one h2o-danube-1.8b layer's noise_inject (B9) and
    fake_quant (B8) through autograd, on both rulers."""
    cfg = get_config("h2o-danube-1.8b")
    d, f = cfg.d_model, cfg.d_ff
    hq, hk = cfg.num_heads * cfg.hd, cfg.num_kv_heads * cfg.hd
    shapes = [(d, hq), (d, hk), (d, hk), (hq, d), (d, f), (d, f), (f, d)]
    b9, b8 = [], []
    for k, n in shapes:
        w = (torch.rand((k, n), generator=gen, device=dev) * 2.2
             - 1.1).requires_grad_()
        s = (torch.randn((k // 16,), generator=gen, device=dev) * 2.0
             - 0.5).requires_grad_()
        seed = torch.randint(0, 1 << 32, (1,), generator=gen, device=dev)
        b9.append((backend.noise_inject(w, s, seed), (w, s),
                   torch.randn((k, n), generator=gen, device=dev)))
        pb = torch.tensor([1.0, 2.0, 4.0], device=dev)[torch.randint(
            0, 3, (k // 16,), generator=gen, device=dev)]
        wq = (torch.randn((k, n), generator=gen, device=dev)
              * 0.02).requires_grad_()
        sw = (wq.detach().abs().reshape(k // 16, -1).amax(1) / 1.875)
        b8.append((backend.fake_quant_weight(wq, pb, sw), (wq,),
                   torch.randn((k, n), generator=gen, device=dev)))
        x = torch.randn((8 * 128, k), generator=gen, device=dev).to(
            torch.bfloat16).requires_grad_()
        sx = x.detach().float().abs().amax(-1, keepdim=True) / 1.875
        b8.append((backend.fake_quant(x, pb, sx), (x,),
                   torch.randn((8 * 128, k), generator=gen, device=dev).to(
                       torch.bfloat16)))
    for key, calls in (("B9_bwd", b9), ("B8_bwd", b8)):
        fn = (lambda c: lambda: [torch.autograd.grad(y, ins, g,
                                                     retain_graph=True)
                                 for y, ins, g in c])(calls)
        rows[f"{key}_layer_device_ms"] = device_ms(torch, fn, 10)
        rows[f"{key}_layer_loop_ms"] = loop_ms(torch, fn, 10)
    del b9, b8
    torch.cuda.empty_cache()
    bank_rows(torch, backend, get_config, dev, gen, rows)


def bank_rows(torch, backend, get_config, dev, gen, rows):
    """The three expert banks of one deepseek-moe-16b MoE layer (E = 64:
    up and gate [E, 2048, 1408], down [E, 1408, 2048]) through the
    training ops, forward and backward, on both rulers: B9 with a seed and
    logits an expert, B8 on the weights (per-group scales an expert) and
    on the dispatch buffer's activations [E, C, K] (C = 120, the capacity
    of 8 x 128 tokens at top-6; bf16; a per-tensor scale an expert). A
    checkout whose ops take no bank runs them expert by expert
    (``bank_per_expert`` true)."""
    cfg = get_config("deepseek-moe-16b")
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    cap = -(-8 * 128 * cfg.top_k * 5 // (e * 4))
    b9, b8 = [], []
    for k, n in ((d, f), (d, f), (f, d)):
        w = (torch.rand((e, k, n), generator=gen, device=dev) * 2.2
             - 1.1).requires_grad_()
        s = (torch.randn((e, k // 16), generator=gen, device=dev) * 2.0
             - 0.5).requires_grad_()
        seeds = torch.randint(0, 1 << 32, (e,), generator=gen, device=dev)
        b9.append(((w, s, seeds), (w, s)))
        pb = torch.tensor([1.0, 2.0, 4.0], device=dev)[torch.randint(
            0, 3, (e, k // 16), generator=gen, device=dev)]
        wq = (torch.randn((e, k, n), generator=gen, device=dev)
              * 0.02).requires_grad_()
        sw = wq.detach().abs().reshape(e, k // 16, -1).amax(-1) / 1.875
        b8.append(("w", (wq, pb, sw), (wq,)))
        x = torch.randn((e, cap, k), generator=gen, device=dev).to(
            torch.bfloat16).requires_grad_()
        sx = x.detach().float().abs().amax(dim=(1, 2), keepdim=True) / 1.875
        b8.append(("x", (x, pb, sx), (x,)))
    try:
        backend.noise_inject(*b9[0][0])
        per_expert = False
    except (ValueError, RuntimeError):     # a 2-D wrapper refuses a bank
        per_expert = True
    rows["bank_per_expert"] = per_expert

    def b9_fwd(w, s, seeds):
        if not per_expert:
            return backend.noise_inject(w, s, seeds)
        return torch.stack([backend.noise_inject(w[i], s[i], seeds[i:i + 1])
                            for i in range(e)])

    def b8_fwd(kind, a):
        op = backend.fake_quant_weight if kind == "w" else backend.fake_quant
        if not per_expert:
            return op(*a)
        return torch.stack([op(a[0][i], a[1][i], a[2][i]) for i in range(e)])

    fwd = {"B9_bank": lambda: [b9_fwd(*a) for a, _ins in b9],
           "B8_bank": lambda: [b8_fwd(kind, a) for kind, a, _ins in b8]}
    for key, fn in fwd.items():
        with torch.no_grad():
            rows[f"{key}_layer_device_ms"] = device_ms(torch, fn, 5)
            rows[f"{key}_layer_loop_ms"] = loop_ms(torch, fn, 5)
    outs9 = [(b9_fwd(*a), ins) for a, ins in b9]
    outs8 = [(b8_fwd(kind, a), ins) for kind, a, ins in b8]
    for key, calls in (("B9_bank_bwd", outs9), ("B8_bank_bwd", outs8)):
        cots = [torch.randn(y.shape, generator=gen, device=dev).to(y.dtype)
                for y, _ins in calls]
        fn = (lambda c, g_: lambda: [
            torch.autograd.grad(y, ins, g, retain_graph=True)
            for (y, ins), g in zip(c, g_)])(calls, cots)
        rows[f"{key}_layer_device_ms"] = device_ms(torch, fn, 5)
        rows[f"{key}_layer_loop_ms"] = loop_ms(torch, fn, 5)


def step_rows(torch, dev, rows):
    """Full-width training steps with a device profile of steps 1, 3, 5."""
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic
    from repro_torch.models import lm
    from repro_torch.train import loop
    from repro_torch.train import state as state_lib
    import step_profile
    cfg = get_config("h2o-danube-1.8b")
    tcfg = state_lib.TrainConfig(t1=3, t2=6, warmup=1, seed=0)
    stream = synthetic.TokenStream(synthetic.TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=128, batch_size=8, seed=0))
    steps, profiles = [], {}

    def hook(step, _state, met):
        steps.append(dict(step=step, phase=met["phase"], loss=met["loss"],
                          ms=met["wall"] * 1e3))
        prof.step()

    def on_ready(p):
        profiles[steps[-1]["step"]] = step_profile.device_summary(p)

    model = lm.init_params(cfg.with_quant_mode("noise"), seed=0,
                           device=dev)
    undo = step_profile.install_spans()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=1, warmup=0, active=1,
                                       repeat=3),
                     on_trace_ready=on_ready) as prof:
            loop.train(cfg, tcfg, stream.batches(), model=model, device=dev,
                       hooks=[hook])
    finally:
        undo()
    rows["train_steps"] = steps
    rows["train_profiles"] = profiles


def _pack_operands(torch, qp, quant, k, n, qcfg, gen, dev, perm_on=True,
                   scaled=True):
    """One linear's B7 calls as the checkout's driver makes them: one
    ``quantize_pack_segments`` over (w, perm, sorted scales), or one
    ``quantize_pack`` a segment of a sorted copy. ``perm_on`` / ``scaled``
    False (one-launch entry only): the identity order / no scales."""
    w = torch.randn((k, n), generator=gen, device=dev) * 0.02
    gperm = torch.randperm(k // 16, generator=gen, device=dev)
    perm = (gperm[:, None] * 16 + torch.arange(16, device=dev)).reshape(-1)
    perm = perm.to(torch.int32)
    w_sorted = w.index_select(0, perm)
    sc = quant.per_group_weight_scale(w_sorted, 16)
    segs = qcfg.segments(k)
    if hasattr(qp, "quantize_pack_segments"):
        perm = perm if perm_on else None
        sc = sc if scaled else None
        return [lambda: qp.quantize_pack_segments(w, perm, sc,
                                                  segments=segs)]
    calls, off = [], 0
    for p, kp in zip((4, 2, 1), segs):
        if kp:
            ws = w_sorted[off:off + kp].contiguous()
            ss = sc[off // 16:(off + kp) // 16].contiguous()
            calls.append((lambda a, b, c: lambda: qp.quantize_pack(
                a, b, p=c))(ws, ss, p))
            off += kp
    return calls


def _profiled(torch, fn):
    """(result, ``step_profile.load_summary`` of one profiled call)."""
    from torch.profiler import ProfilerActivity, profile
    import step_profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, step_profile.load_summary(prof)


def pack_rows(torch, dev, gen, rows):
    """Deploy packing of one full-width layer through ``convert_tree``
    (h2o-danube-1.8b; deepseek-moe-16b's first MoE layer), and B7 alone on
    one h2o layer."""
    import dataclasses
    from repro_torch import kernels
    from repro_torch.api import transforms
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    for key, arch, nl, idx in (("h2o_layer", "h2o-danube-1.8b", 1, 0),
                               ("moe_layer", "deepseek-moe-16b", 2, 1)):
        cfg = get_config(arch).with_quant_mode("qat")
        model = lm.init_params(dataclasses.replace(cfg, num_layers=nl),
                               seed=0, device=dev)
        tree = model.tree()["blocks"][idx]
        del model
        qcfg = cfg.quant.with_mode("serve")
        fn = (lambda t, q: lambda: transforms.convert_tree(
            t, q, rebudget=True))(tree, qcfg)
        fn()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        rows[f"{key}_host_ms"] = (time.perf_counter() - t0) * 1e3 / 5
        rows[f"{key}_b7_launches"] = kernels.launch_counts()[
            "quantize_pack"] // 5
        rows[f"{key}_loop_ms"] = loop_ms(torch, fn, 5)
        _out, summary = _profiled(torch, fn)
        rows[f"{key}_device_ms"] = summary["device_busy_ms"]
        rows[f"{key}_kernels"] = summary["device_events"]
        rows[f"{key}_by_op"] = summary["by_op"]
        del tree, fn, _out
        torch.cuda.empty_cache()
    b7_rows(torch, dev, gen, rows)


def b7_rows(torch, dev, gen, rows, detail=False):
    """The B7 kernels alone on one h2o-danube-1.8b layer (4 rotating weight
    sets), both rulers; ``detail``: also each linear's device ms and the
    layer without the perm and without the scales (one-launch entry)."""
    from repro_torch.configs import get_config
    from repro_torch.core import quant
    from repro_torch.core.qtypes import QuantConfig
    from repro_torch.kernels import quant_pack as qp
    h2o = get_config("h2o-danube-1.8b")
    d, f = h2o.d_model, h2o.d_ff
    hq, hk = h2o.num_heads * h2o.hd, h2o.num_kv_heads * h2o.hd
    mixed = QuantConfig(mode="qat")
    shapes = ((d, hq), (d, hk), (d, hk), (hq, d), (d, f), (d, f), (f, d))
    variants = [("", True, True)]
    if detail and hasattr(qp, "quantize_pack_segments"):
        variants += [("_noperm", False, True), ("_noscale", True, False)]
    for tag, perm_on, scaled in variants:
        sets = [[c for k, n in shapes
                 for c in _pack_operands(torch, qp, quant, k, n, mixed, gen,
                                         dev, perm_on, scaled)]
                for _ in range(4)]
        run = lambda: [c() for calls in sets for c in calls]  # noqa: E731
        rows[f"B7_h2o{tag}_launches"] = len(sets[0])
        rows[f"B7_h2o{tag}_device_ms"] = device_ms(torch, run, 10) / 4
        if not tag:
            rows["B7_h2o_loop_ms"] = loop_ms(torch, run, 10) / 4
        if detail and not tag and len(sets[0]) == len(shapes):
            for i in range(len(shapes)):
                rows[f"B7_h2o_linear{i}_device_ms"] = device_ms(
                    torch, lambda: [calls[i]() for calls in sets], 20) / 4
        del sets
        torch.cuda.empty_cache()
    if detail:
        # A yardstick of the read stream alone: torch's abs-max reduction
        # over the same weights.
        ws = [[torch.randn((k, n), generator=gen, device=dev)
               for k, n in shapes] for _ in range(4)]
        rows["read_h2o_device_ms"] = device_ms(torch, lambda: [
            torch.linalg.vector_norm(w, ord=float("inf"))
            for layer in ws for w in layer], 10) / 4
        del ws
        torch.cuda.empty_cache()


def tree_digest(torch, tree) -> str:
    """A digest of every tensor of a (serve) tree, computed on its device:
    per leaf, the bytes as int64 weighted by their position mod 65,521,
    summed; two checkouts that pack the same weights bitwise give the same
    digest."""
    import hashlib
    h = hashlib.sha256()

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}/{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")
        elif isinstance(node, torch.Tensor):
            b = node.detach().contiguous().reshape(-1).view(torch.uint8)
            total = 0
            for off in range(0, b.numel(), 1 << 24):    # 16 MiB a chunk
                part = b[off:off + (1 << 24)].long()
                weight = (torch.arange(off, off + part.numel(),
                                       device=b.device) % 65521 + 1)
                total += int((part * weight).sum())
            h.update(f"{path}:{node.dtype}:{tuple(node.shape)}:"
                     f"{total}".encode())

    walk(tree, "")
    return h.hexdigest()[:16]


def load_rows(torch, dev, rows):
    """The whole load of ``DecodeEngine`` at full width and depth: host
    clock, B7 launches and peak memory of one construction, then the
    device profile of a second."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve import engine
    import dataclasses
    ecfg = engine.EngineConfig(max_batch=4, cache_len=256, prefill_chunk=8)
    # The process's first load pays one-time costs (library loads, lazy
    # CUDA initialisation of the ops it runs): time it apart, on a
    # two-layer reduced model, so the full loads below are steady state.
    small = dataclasses.replace(get_config("deepseek-moe-16b").reduced(),
                                num_layers=2).with_quant_mode("qat")
    params = lm.init_params(small, seed=0, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.DecodeEngine(params, small, ecfg, device=dev)
    torch.cuda.synchronize()
    rows["first_load_s"] = time.perf_counter() - t0
    del params
    for key, arch in (("h2o", "h2o-danube-1.8b"),
                      ("moe", "deepseek-moe-16b")):
        cfg = get_config(arch).with_quant_mode("qat")
        params = lm.init_params(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        eng = engine.DecodeEngine(params, cfg, ecfg, device=dev)
        torch.cuda.synchronize()
        rows[f"{key}_pack_s"] = time.perf_counter() - t0
        rows[f"{key}_b7_launches"] = kernels.launch_counts()["quantize_pack"]
        rows[f"{key}_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        rows[f"{key}_packed_bytes"] = engine.packed_model_bytes(eng.model)
        rows[f"{key}_digest"] = tree_digest(torch, eng.model.tree())
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        eng, summary = _profiled(torch, lambda: engine.DecodeEngine(
            params, cfg, ecfg, device=dev))
        rows[f"{key}_device_ms"] = summary["device_busy_ms"]
        rows[f"{key}_kernels"] = summary["device_events"]
        rows[f"{key}_idle_share"] = 1 - summary["device_busy_ms"] / (
            rows[f"{key}_pack_s"] * 1e3)
        rows[f"{key}_by_op"] = summary["by_op"]
        del eng, params
        gc.collect()
        torch.cuda.empty_cache()


def serve_rows(torch, dev, rows):
    """Host-clock and profiled device times of the fp-ring prefill chunk
    and decode step of whole full-width models (see the module doc)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    import step_profile
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve import engine
    b, c, prompt_len = 4, 8, 64
    ecfg = engine.EngineConfig(max_batch=b, cache_len=256, prefill_chunk=c)
    for key, arch in (("h2o", "h2o-danube-1.8b"),
                      ("moe", "deepseek-moe-16b")):
        cfg = get_config(arch).with_quant_mode("qat")
        params = lm.init_params(cfg, seed=0, device=dev)
        eng = engine.DecodeEngine(params, cfg, ecfg, device=dev)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        prompt = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (b, prompt_len)).astype(np.int32)
        state = {}

        def chunk(i):
            pos = np.tile(np.arange(i * c, (i + 1) * c), (b, 1))
            logits, state["cache"] = lm.prefill_step(
                eng.model, eng.cfg, state["cache"],
                prompt[:, i * c:(i + 1) * c], pos, np.full(b, c - 1))
            state["tok"] = logits.argmax(-1).cpu().numpy().astype(np.int32)

        def step(t):
            logits, state["cache"] = lm.decode_step(
                eng.model, eng.cfg, state["cache"], state["tok"],
                np.full(b, prompt_len + t))
            state["tok"] = logits.argmax(-1).cpu().numpy().astype(np.int32)

        def timed(fn, n):
            times = []
            for i in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(i)
                times.append(time.perf_counter() - t0)
            return float(np.median(times[2:]) * 1e3)

        def profiled(fn, first, n):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for i in range(first, first + n):
                    fn(i)
                torch.cuda.synchronize()
            summ = step_profile.device_summary(prof)
            return {"kernels": summ["kernels"] / n,
                    "device_busy_ms": summ["device_busy_ms"] / n,
                    "gemm_ms": summ["gemm_ms"] / n, "top": summ["top"]}

        state["cache"] = eng.init_cache(b)
        rows[f"{key}_prefill_ms"] = timed(chunk, prompt_len // c)
        rows[f"{key}_decode_ms"] = timed(step, 12)
        state["cache"] = eng.init_cache(b)
        chunk(0)
        rows[f"{key}_prefill_profile"] = profiled(chunk, 1, 3)
        rows[f"{key}_decode_profile"] = profiled(step, 0, 3)
        del eng, state
        gc.collect()
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--set", action="append", default=[],
                    help="NAME=VALUE: a launch-shape constant of the "
                         "timed family's source")
    ap.add_argument("--only", choices=("gemm", "attn", "train", "step",
                                       "pack", "load", "b7", "serve",
                                       "b8"),
                    default=None, help="time one kernel family")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import quant
    from repro_torch.core.qtypes import U4, QuantConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels import attn_decode as ad
    from repro_torch.kernels import packed_matmul as pm
    from repro_torch.serve import kv_quant

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    if args.only in ("pack", "load", "b7"):
        from repro_torch.kernels import quant_pack
        _build.build([quant_pack.SOURCE])
        for item in args.set:
            if not declares(_build, quant_pack, item.split("=")[0]):
                raise SystemExit(f"no constant {item} in "
                                 f"{quant_pack.SOURCE}")
        if args.set:
            build_variant(_build, quant_pack, args.set)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        rows = {}
        if args.only == "pack":
            pack_rows(torch, dev, gen, rows)
        elif args.only == "b7":
            b7_rows(torch, dev, gen, rows, detail=True)
        else:
            load_rows(torch, dev, rows)
        return report(args, rows, None)
    if args.only == "serve":
        if args.set:
            raise SystemExit("--set takes no constant of the serve path")
        _build.build()
        rows = {}
        serve_rows(torch, dev, rows)
        return report(args, rows, None)
    if args.only in ("train", "b8", "step"):
        from repro_torch.backend import base as backend
        from repro_torch.kernels import fake_quant, noise_inject
        _build.build([noise_inject.SOURCE, fake_quant.SOURCE])
        for item in args.set:
            if args.only == "step" or not declares(
                    _build, fake_quant, item.split("=")[0]):
                raise SystemExit(f"no constant {item} in "
                                 f"{fake_quant.SOURCE}")
        if args.set:
            build_variant(_build, fake_quant, args.set)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        rows = {}
        if args.only in ("train", "b8"):
            b8_rows(torch, fake_quant, quant, _build, args.set, get_config,
                    dev, gen, rows, detail=args.only == "b8")
        if args.only == "train":
            train_rows(torch, backend, get_config, dev, gen, rows)
        elif args.only == "step":
            step_rows(torch, dev, rows)
        return report(args, rows, None)
    families = [m for m, name in ((pm, "gemm"), (ad, "attn"))
                if args.only in (None, name)]
    _build.build([m.SOURCE for m in families])
    for item in args.set:
        if not any(declares(_build, m, item.split("=")[0])
                   for m in families):
            raise SystemExit(f"no constant {item} in the timed sources")
    for mod in families:
        mine = [s for s in args.set
                if declares(_build, mod, s.split("=")[0])]
        if mine:
            build_variant(_build, mod, mine)
    multi = hasattr(pm, "segments_matmul")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def linears(cfg):
        d, f = cfg.d_model, cfg.d_ff
        hq, hk = cfg.num_heads * cfg.hd, cfg.num_kv_heads * cfg.hd
        return [(d, hq), (d, hk), (d, hk), (hq, d), (d, f), (d, f), (f, d)]

    def leaf_ops(k, n, qcfg, lead=()):
        ops, off = [], 0
        wscale = torch.rand(lead + (k // 16,), generator=gen, device=dev) \
            * 0.02 + 0.001
        for p, kp in zip((4, 2, 1), qcfg.segments(k)):
            if kp:
                wp = torch.randint(0, 256, lead + (kp * p // 8, n),
                                   generator=gen, device=dev,
                                   dtype=torch.uint8)
                ops.append((wp, wscale[..., off // 16:(off + kp) // 16],
                            p, off))
                off += kp
        return ops

    def layer(cfg, qcfg, m):
        out = []
        for k, n in linears(cfg):
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            sx = quant.abs_max_scale(x, dim=-1).float().contiguous()
            out.append((x, sx, leaf_ops(k, n, qcfg),
                        torch.zeros((m, n), device=dev)))
        return out

    def run_layer(sets, mode):
        for calls in sets:
            for x, sx, ops, y in calls:
                if multi:
                    pm.segments_matmul(
                        x, ops, sx=sx if mode == "fused" else None,
                        self_scale=mode == "self", out=y)
                    continue
                for wp, sc, p, off in ops:
                    xs = x[:, off:off + wp.shape[0] * 8 // p]
                    sc = sc.contiguous()
                    if mode == "fused":
                        pm.fused_act_segment_matmul(xs, sx, wp, sc, p=p,
                                                    out=y)
                    elif mode == "self":
                        pm.fused_act_selfscale_matmul(xs, wp, sc, p=p,
                                                      out=y)
                    else:
                        pm.packed_segment_matmul(xs, wp, sc, p=p, out=y)

    def run_grouped(sets):
        for projs in sets:
            for x, ops, y in projs:
                if multi:
                    pm.segments_matmul(x, ops, out=y)
                    continue
                for wp, sc, p, off in ops:
                    pm.packed_segment_matmul_grouped(
                        x[:, :, off:off + wp.shape[1] * 8 // p], wp, sc,
                        p=p, out=y)

    def both(key, fn, reps, per):
        rows[f"{key}_device_ms"] = device_ms(torch, fn, reps) / per
        rows[f"{key}_loop_ms"] = loop_ms(torch, fn, reps) / per

    rows = {}
    if ad in families:
        attention_rows(torch, ad, kv_quant, get_config, dev, gen, rows)
    if pm not in families:
        return report(args, rows, None)
    h2o = get_config("h2o-danube-1.8b")
    moe = get_config("deepseek-moe-16b")
    mixed = QuantConfig(mode="qat")
    for m in (4, 32):
        for name, qcfg, mode in (("B1", mixed, "fused"), ("B2", U4, "self"),
                                 ("B3", mixed, "plain")):
            sets = [layer(h2o, qcfg, m) for _ in range(4)]
            both(f"{name}_M{m}", lambda: run_layer(sets, mode), 20, 4)
            if name == "B1" and m == 4:
                for i in range(7):
                    rows[f"B1_M4_linear{i}_device_ms"] = device_ms(
                        torch, lambda: run_layer(
                            [[calls[i]] for calls in sets], mode), 20) / 4
            del sets
            torch.cuda.empty_cache()
    for t_rows in (4, 32):
        sets = []
        for _ in range(2):
            projs = []
            for k, n in ((moe.d_model, moe.d_ff), (moe.d_model, moe.d_ff),
                         (moe.d_ff, moe.d_model)):
                x = torch.randn((moe.num_experts, t_rows, k), generator=gen,
                                device=dev).to(torch.bfloat16)
                projs.append((x, leaf_ops(k, n, mixed, (moe.num_experts,)),
                              torch.zeros((moe.num_experts, t_rows, n),
                                          device=dev)))
            sets.append(projs)
        both(f"B6_T{t_rows}", lambda: run_grouped(sets), 10, 2)
        del sets
        torch.cuda.empty_cache()
    return report(args, rows, multi)


def report(args, rows, multi):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"label": args.label, "set": args.set,
                      "card": smi, "launch_per_linear": multi, "ms": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
