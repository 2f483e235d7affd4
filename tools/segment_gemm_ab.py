#!/usr/bin/env python3
"""Time the segment GEMM kernels (B1, B2, B3, B6) of one checkout of the
PyTorch port on the card, so two checkouts, or two builds of one, can be
compared in one call:

    python3 tools/segment_gemm_ab.py --src /path/to/parent/src --label parent
    python3 tools/segment_gemm_ab.py --src src --label change
    python3 tools/segment_gemm_ab.py --src src --label cluster1 \\
        --set MAX_CLUSTER=1

``--set NAME=VALUE`` times a scratch build of ``csrc/segment_gemm.cu``
with ``constexpr int NAME`` (one of the launch-shape constants at the top
of the source, none of which changes a bit of the result) set to VALUE,
compiled into the checkout's build directory.

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
included), the two timers of ``chip_smoke.py``. Prints one JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys
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


def device_ms(torch, fn, reps):
    """The same with the stream first sleeping ~0.1 s on the card while
    the host enqueues every launch: the kernels back to back."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def build_variant(_build, pm, settings):
    """Compile segment_gemm.cu with each ``NAME=VALUE`` of ``settings``
    replacing ``constexpr int NAME = ...;`` and make it the library ``pm``
    launches."""
    text = (_build.CSRC / pm.SOURCE).read_text()
    for item in settings:
        name, value = item.split("=")
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {int(value)};", text)
        if n != 1:
            raise SystemExit(f"no constant {name} in {pm.SOURCE}")
    stem = "segment_gemm-" + hashlib.sha256(
        (text + " ".join(_build.NVCC_FLAGS)).encode()).hexdigest()[:16]
    src = _build.BUILD_DIR / f"{stem}.cu"
    out = _build.BUILD_DIR / f"{stem}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src.write_text(text)
        tmp = out.with_name(f"{stem}.{os.getpid()}.tmp.so")
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                        str(tmp), str(src)], check=True,
                       capture_output=True, timeout=_build.BUILD_TIMEOUT_S)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    pm._bind(lib)
    _build._LIBS[pm.SOURCE] = lib


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--set", action="append", default=[],
                    help="NAME=VALUE: a launch-shape constant of the "
                         "segment GEMM build")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import quant
    from repro_torch.core.qtypes import U4, QuantConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels import packed_matmul as pm

    if not torch.cuda.is_available():
        print("segment_gemm_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    if args.set:
        build_variant(_build, pm, args.set)
    else:
        _build.build([pm.SOURCE])
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

    h2o = get_config("h2o-danube-1.8b")
    moe = get_config("deepseek-moe-16b")
    mixed = QuantConfig(mode="qat")
    rows = {}
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"label": args.label, "set": args.set,
                      "card": smi, "launch_per_linear": multi, "ms": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
