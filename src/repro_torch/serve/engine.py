"""Serve engines over packed SONIQ weights. Counterpart of
``repro.serve.engine`` for the fp ring layout.

* :class:`LockstepEngine` — fixed-batch generation: full-batch token-level
  prefill, every row decodes until the longest request finishes.
* :class:`DecodeEngine` — request-level continuous batching: admission
  queue, slot-based batch state, chunked prefill beside decoding slots,
  per-slot sampling, completions streamed as requests finish. Rows are
  independent (per-token activation scales, row-invariant kernels), so its
  temperature-0 tokens equal the lockstep engine's.

Both pack the trained model at construction (``convert_tree`` — the
``quantize_pack`` kernel on the card) unless handed a packed one. The
4-bit KV cache, the paged layout and speculative decoding are later port
slices; their ``EngineConfig`` values raise.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.api import transforms as lifecycle
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import lm

from .scheduler import Completion, Request, Scheduler


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 8
    cache_len: int = 256
    temperature: float = 0.0        # 0 = greedy (default for generate())
    cache_dtype: str = "float32"
    # Prompt tokens fed per slot per prefill step (1 = token-level).
    prefill_chunk: int = 8
    # Fused activation quantization in the segment-GEMM prologue. False is
    # the two-pass reference form, which has no CUDA kernel yet.
    fuse_act_quant: bool = True
    # Later port slices (they raise until ported): None / "ring" / 0.
    kv_bits: Optional[int] = None
    kv_layout: str = "ring"
    spec_tokens: int = 0


def _check_ported(ecfg: EngineConfig) -> None:
    if ecfg.kv_layout not in ("ring", "paged"):
        raise ValueError(f"unknown kv_layout {ecfg.kv_layout!r} "
                         f"(expected 'ring' or 'paged')")
    if ecfg.kv_bits is not None:
        raise NotImplementedError(
            "kv_bits=4 (serve/kv_quant.py + kernel B4) is the next port "
            "slice")
    if ecfg.kv_layout == "paged":
        raise NotImplementedError(
            "kv_layout='paged' (serve/kv_pool.py + kernel B5) is a later "
            "port slice")
    if ecfg.spec_tokens:
        raise NotImplementedError(
            "speculative decoding (spec_tokens > 0) is a later port slice")


def _sample_seed(seed: int, n: int) -> int:
    """Per-(request, token index) generator seed: a request's t-th token
    always draws from the same stream, whatever the batch schedule."""
    return (int(seed) * 1_000_003 + int(n)) % (2 ** 63)


def _sample(logits: torch.Tensor, temperature: float, seed: int,
            n: int) -> int:
    g = torch.Generator(device=logits.device)
    g.manual_seed(_sample_seed(seed, n))
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return int(torch.multinomial(probs, 1, generator=g))


class _PackedEngine:
    """Packed-model plumbing shared by both engines."""

    def __init__(self, params: lm.LM, arch_cfg, ecfg: EngineConfig, *,
                 already_serve: bool = False, device: DeviceLike = None):
        _check_ported(ecfg)
        self.device = resolve_device(device)
        quant = arch_cfg.quant.with_mode("serve")
        if not ecfg.fuse_act_quant:
            quant = dataclasses.replace(quant, fuse_act_quant=False)
        if quant.act_scale_mode == "per_tensor":
            # Per-tensor scales couple batch rows; serving needs every
            # request's tokens independent of batch composition.
            quant = dataclasses.replace(quant, act_scale_mode="per_token")
        self.cfg = dataclasses.replace(arch_cfg, quant=quant)
        self.ecfg = ecfg
        params = params.to(self.device)
        if already_serve:
            self.model = params
        else:
            self.model = lm.LM(self.cfg, lifecycle.convert_tree(
                params.tree(), self.cfg.quant, rebudget=True))

    def init_cache(self, batch: int):
        return lm.init_cache(self.cfg, batch, self.ecfg.cache_len,
                             getattr(torch, self.ecfg.cache_dtype),
                             device=self.device)


class LockstepEngine(_PackedEngine):
    """Fixed-batch generation loop (greedy, or temperature sampling from
    one shared generator): the pre-continuous-batching baseline."""

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, max_new_tokens: int,
                 generator: Optional[torch.Generator] = None) -> np.ndarray:
        """prompts [B, S0] -> [B, S0 + max_new] (greedy unless temperature
        > 0 and a generator is given)."""
        prompts = np.asarray(prompts, np.int32)
        b, s0 = prompts.shape
        cache = self.init_cache(b)
        out = [prompts]
        logits = None
        for t in range(s0):
            logits, cache = lm.decode_step(self.model, self.cfg, cache,
                                           prompts[:, t], np.full(b, t))
        cur = self._sample(logits, generator)
        for t in range(max_new_tokens):
            out.append(cur[:, None])
            if t == max_new_tokens - 1:
                break
            logits, cache = lm.decode_step(self.model, self.cfg, cache, cur,
                                           np.full(b, s0 + t))
            cur = self._sample(logits, generator)
        return np.concatenate(out, axis=1)

    def _sample(self, logits: torch.Tensor, generator) -> np.ndarray:
        if self.ecfg.temperature <= 0 or generator is None:
            return logits.argmax(-1).to(torch.int32).cpu().numpy()
        probs = torch.softmax(logits.float() / self.ecfg.temperature, -1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            torch.int32).cpu().numpy()


class DecodeEngine(_PackedEngine):
    """Request-level continuous-batching engine (fp ring layout).

    Usage — streaming::

        eng = DecodeEngine(model, cfg, EngineConfig(max_batch=8))
        for completion in eng.serve(requests):   # yields as they finish
            ...
    """

    def __init__(self, params: lm.LM, arch_cfg, ecfg: EngineConfig, *,
                 already_serve: bool = False, device: DeviceLike = None):
        super().__init__(params, arch_cfg, ecfg,
                         already_serve=already_serve, device=device)
        self.chunk = max(ecfg.prefill_chunk, 1)
        b = ecfg.max_batch
        self._seeds = np.zeros((b,), np.int64)
        self._temps = np.zeros((b,), np.float32)
        self.sched = Scheduler(b)
        self.cache = None

    # --------------------------------------------------------- requests ----
    def submit(self, request: Request) -> int:
        return self.sched.submit(request)

    def reset(self):
        """Drop all queued/active requests and cache state."""
        self.sched = Scheduler(self.ecfg.max_batch)
        self.cache = None

    # ------------------------------------------------------------- step ----
    @torch.inference_mode()
    def step(self) -> List[Completion]:
        """Admit arrived requests into free slots (wiping their cache
        rows), feed every active slot (a prefill chunk, or one token),
        sample, and return any completions."""
        b = self.ecfg.max_batch
        if self.cache is None:
            self.cache = self.init_cache(b)
        admitted = self.sched.admit()
        if admitted:
            lm.reset_cache_slots(self.cache, [s for s, _ in admitted])
            for slot, req in admitted:
                self._seeds[slot] = req.seed
                self._temps[slot] = req.temperature
        plan = self.sched.plan(self.chunk)
        if not plan:                       # idle: let queued arrivals age in
            return self.sched.advance({}, {})
        widths = {s: len(t) for s, t in plan.items()}
        if max(widths.values()) > 1:
            c = self.chunk                 # fixed width
            tokens = np.zeros((b, c), np.int32)
            pos = np.full((b, c), -1, np.int64)
            last = np.zeros((b,), np.int64)
            for slot, toks in plan.items():
                n = widths[slot]
                tokens[slot, :n] = toks
                pos[slot, :n] = self.sched.slots[slot].n_fed + np.arange(n)
                last[slot] = n - 1
            logits, self.cache = lm.prefill_step(
                self.model, self.cfg, self.cache, tokens, pos, last)
        else:
            tokens = np.zeros((b,), np.int32)
            pos = np.zeros((b,), np.int64)
            active = np.zeros((b,), bool)
            for slot, toks in plan.items():
                tokens[slot] = toks[0]
                pos[slot] = self.sched.slots[slot].n_fed
                active[slot] = True
            logits, self.cache = lm.decode_step(
                self.model, self.cfg, self.cache, tokens, pos, active=active)
        sampled = self._pick(logits, plan)
        return self.sched.advance(widths, sampled)

    def _pick(self, logits: torch.Tensor, plan) -> dict:
        """Per-slot sampling: greedy argmax at temperature 0 (one [B]-int
        transfer per step), else a draw seeded by (request seed, token
        index)."""
        greedy = logits.argmax(-1).cpu().numpy()
        out = {}
        for slot in plan:
            temp = float(self._temps[slot])
            if temp > 0:
                n = len(self.sched.slots[slot].generated)
                out[slot] = _sample(logits[slot], temp,
                                    int(self._seeds[slot]), n)
            else:
                out[slot] = int(greedy[slot])
        return out

    # ----------------------------------------------------- cancellation ----
    def cancel(self, request_id: int) -> Optional[Completion]:
        """Cancel a queued or active request; returns its "evicted"
        Completion, or None when the id is unknown or finished. Call
        between engine steps (the slot's rows are wiped at its next
        admission)."""
        comp = self.sched.cancel(request_id)
        if comp is not None:
            return comp
        slot = next((s for s, st in self.sched.slots.items()
                     if st.request.request_id == request_id), None)
        if slot is None:
            return None
        return self.sched.evict(slot)

    # -------------------------------------------------------- streaming ----
    def run(self) -> Iterator[Completion]:
        """Drive steps until queue and slots drain, yielding completions
        in finish order."""
        while self.sched.has_work():
            yield from self.step()

    def serve(self, requests: Iterable[Request]) -> Iterator[Completion]:
        """Submit all requests, then stream completions."""
        for r in requests:
            self.submit(r)
        return self.run()

    def generate(self, prompts: np.ndarray, max_new_tokens: int,
                 seed: Optional[int] = None) -> np.ndarray:
        """Lockstep-compatible batch call: same-length prompts [B, S0] ->
        [B, S0 + max_new]. Resets in-flight state. Greedy unless the
        engine temperature > 0 and a ``seed`` is given (request i then
        samples with seed + i)."""
        self.reset()
        prompts = np.asarray(prompts, np.int32)
        temp = self.ecfg.temperature if seed is not None else 0.0
        base = 0 if seed is None else int(seed)
        reqs = [Request(prompt=p, max_new_tokens=max_new_tokens,
                        temperature=temp, seed=base + i)
                for i, p in enumerate(prompts)]
        out = {c.request_id - reqs[0].request_id: c.tokens
               for c in self.serve(reqs)}
        return np.stack([out[i] for i in range(len(reqs))])


# Leaf-name vocabulary for packed_model_bytes: packed carriers count one
# byte per element, fp leaves their dtype size, metadata is excluded.
_PACKED_LEAVES = frozenset({"w4", "w2", "w1"})
_FP_LEAVES = frozenset({"w", "table", "wscale", "b", "g"})
_META_LEAVES = frozenset({"perm", "pbits_sorted", "pbits"})


def packed_model_bytes(model) -> int:
    """Total packed weight bytes (the paper's network-size metric) of an
    :class:`LM` or its tree. Unknown leaf names raise ``ValueError``."""
    tree = model.tree() if isinstance(model, lm.LM) else model
    total = 0

    def walk(node, name=""):
        nonlocal total
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, k)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v, name)
        elif node is not None:
            if name in _PACKED_LEAVES:
                total += node.numel()
            elif name in _FP_LEAVES:
                total += node.numel() * node.element_size()
            elif name not in _META_LEAVES:
                raise ValueError(f"packed_model_bytes: unknown leaf name "
                                 f"{name!r}")

    walk(tree)
    return int(total)
