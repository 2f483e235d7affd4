"""Serving launcher of the port: packed-weight continuous batching behind
a request queue, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b

Initializes random QAT weights from ``--seed`` (or loads the JAX
package's checkpoint with ``--ckpt``), packs them to the 1/2/4-bit serve
format through the ``quantize_pack`` kernel, and streams a mixed-length
synthetic workload through the continuous-batching ``DecodeEngine``.
``--lockstep`` runs the fixed-batch baseline instead. ``--device cpu``
runs the kernels' plain versions (use with ``--reduced``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serve import engine
from repro_torch.serve.scheduler import Request


def build_requests(args, vocab_size: int, rng) -> list:
    """Mixed-length synthetic workload: prompt lengths in
    [prompt_len/2, prompt_len], generation lengths in [new_tokens/2,
    new_tokens], staggered arrivals."""
    reqs = []
    for i in range(args.requests):
        plen = int(rng.integers(max(args.prompt_len // 2, 1),
                                args.prompt_len + 1))
        new = int(rng.integers(max(args.new_tokens // 2, 1),
                               args.new_tokens + 1))
        reqs.append(Request(
            prompt=rng.integers(0, vocab_size, (plen,)).astype(np.int32),
            max_new_tokens=new, temperature=args.temperature, seed=i,
            arrival_step=i // max(args.max_batch, 1)))
    return reqs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint of the JAX package (npz file or dir)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--prefill-chunk", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--lockstep", action="store_true",
                    help="run the fixed-batch baseline engine instead")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = cfg.with_quant_mode("qat")
    if args.ckpt:
        params = interop.load_npz(args.ckpt, cfg, dev)
    else:
        params = lm.init_params(cfg, seed=args.seed, device=dev)
    ecfg = engine.EngineConfig(max_batch=args.max_batch,
                               cache_len=args.cache_len,
                               temperature=args.temperature,
                               prefill_chunk=args.prefill_chunk)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {name}, arch {cfg.name}, {cfg.num_layers} layers")
    rng = np.random.default_rng(args.seed)

    if args.lockstep:
        eng = engine.LockstepEngine(params, cfg, ecfg, device=dev)
        del params
        print(f"packed model: {engine.packed_model_bytes(eng.model):,} "
              f"bytes")
        prompts = rng.integers(0, cfg.vocab_size,
                               (args.requests, args.prompt_len)
                               ).astype(np.int32)
        t0 = time.perf_counter()
        gen = None
        if args.temperature > 0:
            gen = torch.Generator(device=dev)
            gen.manual_seed(args.seed)
        out = eng.generate(prompts, args.new_tokens, gen)
        dt = time.perf_counter() - t0
        total_new = args.requests * args.new_tokens
        print(f"[lockstep] {total_new} tokens in {dt:.2f}s "
              f"({total_new / dt:.1f} tok/s)")
        for i, row in enumerate(out):
            print(f"req {i}: {row[:args.prompt_len].tolist()} -> "
                  f"{row[args.prompt_len:].tolist()}")
        return

    eng = engine.DecodeEngine(params, cfg, ecfg, device=dev)
    del params
    print(f"packed model: {engine.packed_model_bytes(eng.model):,} bytes")
    reqs = build_requests(args, cfg.vocab_size, rng)
    t0 = time.perf_counter()
    total_new = 0
    for c in eng.serve(reqs):
        total_new += c.new_tokens.size
        print(f"req {c.request_id} [{c.finish_reason} @ step "
              f"{c.finished_step}]: {c.request.prompt.tolist()} -> "
              f"{c.new_tokens.tolist()}")
    dt = time.perf_counter() - t0
    print(f"[continuous] {total_new} tokens in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s, {eng.sched.step_count} engine "
          f"steps, max_batch {args.max_batch})")


if __name__ == "__main__":
    main()
