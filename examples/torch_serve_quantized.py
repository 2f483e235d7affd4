"""Serve a SONIQ-quantized LM through the port's continuous-batching
engine.

    PYTHONPATH=src python examples/torch_serve_quantized.py           # the card
    PYTHONPATH=src python examples/torch_serve_quantized.py --device cpu \
        --steps 4                                                     # the CPU

Trains a tiny LM briefly (QAT), converts it to packed 1/2/4-bit weights,
then streams a mixed-length request set through the request-level
``DecodeEngine`` (admission queue, slot reuse, chunked prefill); reports
the packed-size win and each request's completion as it finishes. The
port has no kernel-backend switch: on the card the engine runs the
hand-written kernels, on the CPU their plain versions.
"""
import argparse
import sys

sys.path.insert(0, "src")

import numpy as np                                    # noqa: E402

from repro_torch import soniq                         # noqa: E402
from repro_torch.configs.base import ArchConfig       # noqa: E402
from repro_torch.data import synthetic                # noqa: E402
from repro_torch.train import loop, state as state_lib  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30, help="QAT steps")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    quant = soniq.QuantConfig(mode=soniq.Phase.QAT)
    cfg = ArchConfig(
        name="serve-demo", family="dense", num_layers=2, d_model=128,
        num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=512, head_dim=32,
        dtype="float32", param_dtype="float32", quant=quant, q_block=64)

    # quick QAT-only training (t1=0 -> no Phase I, mix from config)
    tcfg = state_lib.TrainConfig(t1=0, t2=args.steps, warmup=3)
    stream = synthetic.TokenStream(synthetic.TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=64, batch_size=8))
    result = loop.train(cfg, tcfg, stream.batches(), device=args.device)
    model = result["state"]["model"]
    fp_bytes = sum(p.numel() * 4 for p in model.parameters())

    # 2 slots serving 4 requests: the engine reuses slots as requests
    # finish instead of padding everyone to the longest prompt.
    eng = soniq.DecodeEngine(
        model, cfg, soniq.EngineConfig(max_batch=2, cache_len=128,
                                       prefill_chunk=4), device=args.device)
    print(f"device: {eng.device}")
    q_bytes = soniq.packed_bytes(eng.model)
    print(f"model bytes: fp32 {fp_bytes:,} -> packed {q_bytes:,} "
          f"({fp_bytes / q_bytes:.1f}x smaller)")

    prompts = [[1, 7, 3, 1], [2, 9, 9, 4, 30, 12], [5, 5, 5],
               [11, 3, 7, 2, 8]]
    requests = [soniq.Request(prompt=np.asarray(p, np.int32),
                              max_new_tokens=6 + 3 * i, seed=i)
                for i, p in enumerate(prompts)]
    done = 0
    for c in eng.serve(requests):
        done += 1
        print(f"request {c.request_id} [{c.finish_reason}, "
              f"{c.steps} steps in slot]: prompt={c.request.prompt.tolist()} "
              f"-> {c.new_tokens.tolist()}")
    return 0 if done == len(requests) else 1


if __name__ == "__main__":
    sys.exit(main())
