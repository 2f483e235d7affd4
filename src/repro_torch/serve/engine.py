"""Serve engines over packed SONIQ weights. Counterpart of
``repro.serve.engine``.

* :class:`LockstepEngine` — fixed-batch generation: full-batch token-level
  prefill, every row decodes until the longest request finishes.
* :class:`DecodeEngine` — request-level continuous batching: admission
  queue, slot-based batch state, chunked prefill beside decoding slots,
  per-slot sampling, completions streamed as requests finish. Rows are
  independent (per-token activation scales, row-invariant kernels), so its
  temperature-0 tokens equal the lockstep engine's.

Both pack the trained model at construction (``convert_tree`` — the
``quantize_pack`` kernel on the card) unless handed a packed one. The KV
cache is an fp ring, a packed 4-bit ring (``kv_bits=4``, kernel B4) or,
for the ``DecodeEngine``, a page pool (``kv_layout="paged"``; 4-bit
through kernel B5, or fp) whose host ``PagePool`` shares prompt-prefix
pages between requests with copy-on-write. Both serve the dense and the
MoE decoders (expert banks through the grouped segment GEMM, kernel B6).
The ``DecodeEngine`` also decodes self-speculatively (``spec_tokens``,
DESIGN.md §14): k drafts from the low-bit [K2|K1] slice of the same
packed carriers, verified in one full-mix step of k + 1 lanes; greedy
tokens equal the spec-off tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.api import transforms as lifecycle
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import lm

from . import kv_pool
from .scheduler import DECODE, Completion, Request, Scheduler


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 8
    cache_len: int = 256
    temperature: float = 0.0        # 0 = greedy (default for generate())
    cache_dtype: str = "float32"
    # Prompt tokens fed per slot per prefill step (1 = token-level).
    prefill_chunk: int = 8
    # Fused activation quantization in the segment-GEMM prologue. False is
    # the two-pass reference form (fake_quant, then the plain segment
    # GEMM), which gives bitwise the same tokens.
    fuse_act_quant: bool = True
    # KV-cache precision: None = fp ring in ``cache_dtype``; 4 = packed
    # 4-bit codes + fp16 scales (~4x fewer payload bytes than fp16).
    kv_bits: Optional[int] = None
    # "ring" reserves max_batch x cache_len entries up front; "paged"
    # (DecodeEngine, fp or 4-bit) draws ``page_size``-token pages from a
    # pool on demand, sharing prompt prefixes. ``page_size`` must divide
    # the effective ring length (cache_len clipped to the window).
    kv_layout: str = "ring"
    page_size: int = 16
    # Pool pages including the null page 0; None sizes for full per-slot
    # residency (max_batch * pages_per_seq + 1). Smaller pools gate
    # admission on free pages (head-of-line, FIFO kept).
    num_pages: Optional[int] = None
    # Self-speculative decoding (DecodeEngine only). 0 disables; k > 0
    # drafts k tokens a round with the low-slice forward (the segments at
    # or below ``spec_draft_bits`` of the same packed carriers), then
    # verifies them in one full-mix step of k + 1 lanes and commits the
    # longest matching prefix plus the verify step's own token. Greedy
    # tokens equal spec_tokens=0; temperature > 0 runs rejection sampling
    # on a host rng (distribution-correct, not bitwise the spec-off draw).
    spec_tokens: int = 0
    # Precision bound of the draft slice: segments above it are skipped.
    spec_draft_bits: int = 2


def _check_layout(ecfg: EngineConfig) -> None:
    if ecfg.kv_layout not in ("ring", "paged"):
        raise ValueError(f"unknown kv_layout {ecfg.kv_layout!r} "
                         f"(expected 'ring' or 'paged')")
    if ecfg.kv_bits not in (None, 4):
        raise ValueError(f"kv_bits must be None or 4, got {ecfg.kv_bits}")


def _paged_geometry(arch_cfg, ecfg: EngineConfig):
    """(page_size, pages_per_seq, num_pages) of the paged layout, the
    engine-side mirror of ``blocks.block_cache_init`` (the table length
    is the effective ring length in pages)."""
    clen = min(ecfg.cache_len, arch_cfg.window) if arch_cfg.window \
        else ecfg.cache_len
    ps = ecfg.page_size
    if clen % ps:
        raise ValueError(
            f"page_size {ps} must divide the effective ring length {clen} "
            f"(cache_len clipped to the window) so paged rollover wraps "
            f"where the ring layout does")
    pps = clen // ps
    npages = ecfg.num_pages if ecfg.num_pages is not None \
        else ecfg.max_batch * pps + 1
    return ps, pps, npages


def _sample_seed(seed: int, n: int) -> int:
    """Per-(request, token index) generator seed: a request's t-th token
    always draws from the same stream, whatever the batch schedule."""
    return (int(seed) * 1_000_003 + int(n)) % (2 ** 63)


def _softmax(x: np.ndarray) -> np.ndarray:
    """Host softmax over the last axis in float64 (the speculative
    acceptance rule runs on the host)."""
    x = np.asarray(x, np.float64)
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


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
        _check_layout(ecfg)
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
        ecfg = self.ecfg
        kwargs = {}
        if ecfg.kv_layout == "paged":
            ps, _pps, npages = _paged_geometry(self.cfg, ecfg)
            kwargs = dict(kv_layout="paged", page_size=ps,
                          num_pages=npages)
        return lm.init_cache(self.cfg, batch, ecfg.cache_len,
                             getattr(torch, ecfg.cache_dtype),
                             device=self.device, kv_bits=ecfg.kv_bits,
                             **kwargs)


class LockstepEngine(_PackedEngine):
    """Fixed-batch generation loop (greedy, or temperature sampling from
    one shared generator): the pre-continuous-batching baseline."""

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, max_new_tokens: int,
                 generator: Optional[torch.Generator] = None) -> np.ndarray:
        """prompts [B, S0] -> [B, S0 + max_new] (greedy unless temperature
        > 0 and a generator is given)."""
        if self.ecfg.kv_layout != "ring":
            raise ValueError(
                "LockstepEngine only supports kv_layout='ring': the paged "
                "layout needs the DecodeEngine's host-side PagePool to "
                "drive page allocation")
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
    """Request-level continuous-batching engine (fp or 4-bit KV, ring or
    page pool), optionally self-speculative (``spec_tokens``).

    Usage — streaming::

        eng = DecodeEngine(model, cfg, EngineConfig(max_batch=8))
        for completion in eng.serve(requests):   # yields as they finish
            ...
    """

    def __init__(self, params: lm.LM, arch_cfg, ecfg: EngineConfig, *,
                 already_serve: bool = False, device: DeviceLike = None):
        super().__init__(params, arch_cfg, ecfg,
                         already_serve=already_serve, device=device)
        self.caps = lm.serve_capabilities(self.cfg)
        self.chunk = max(ecfg.prefill_chunk, 1)
        # A speculative round drafts with the low-slice forward (same
        # packed weights, high-bit carriers skipped) and verifies k + 1
        # lanes with the full mix.
        self.spec_width = ecfg.spec_tokens + 1
        if ecfg.spec_tokens > 0:
            if not self.caps.spec_capable:
                raise ValueError(
                    f"spec_tokens > 0 is not supported for arch family "
                    f"{self.caps.family!r}"
                    + (f": {self.caps.note}" if self.caps.note else "")
                    + " (lm.serve_capabilities)")
            if self.spec_width > ecfg.cache_len:
                raise ValueError(
                    f"spec_tokens={ecfg.spec_tokens} cannot exceed "
                    f"cache_len-1={ecfg.cache_len - 1}")
            self.draft_cfg = dataclasses.replace(
                self.cfg, quant=dataclasses.replace(
                    self.cfg.quant, draft_slice_bits=ecfg.spec_draft_bits))
        b = ecfg.max_batch
        self._seeds = np.zeros((b,), np.int64)
        self._temps = np.zeros((b,), np.float32)
        self._init_host_state()
        self.cache = None

    def _init_host_state(self):
        """(Re)build the scheduler and, in the paged layout, the page-pool
        allocator that gates its admission."""
        b = self.ecfg.max_batch
        if self.ecfg.kv_layout == "paged":
            ps, pps, npages = _paged_geometry(self.cfg, self.ecfg)
            self.pool = kv_pool.PagePool(npages, ps, pps, b)
            self.sched = Scheduler(b, can_admit=self.pool.admissible)
            self._table_dirty = True       # first flush uploads the table
        else:
            self.pool = None
            self.sched = Scheduler(b)
        self.cow_copies = 0
        # Speculation telemetry: rounds drafted, drafts proposed/accepted.
        self.spec_rounds = 0
        self.spec_drafted = 0
        self.spec_accepted = 0

    # --------------------------------------------------------- requests ----
    def submit(self, request: Request) -> int:
        """Queue a request; returns its request_id. In the paged layout a
        prompt whose page demand can never fit the pool is rejected here
        (ValueError) rather than deadlocking the admission queue, and the
        prompt's page digests are memoized for the prefix-map lookup at
        admission."""
        if self.pool is not None:
            plen = int(np.asarray(request.prompt).reshape(-1).shape[0])
            if plen and self.pool.target_pages(plen) > self.pool.capacity:
                raise ValueError(
                    f"prompt needs {self.pool.target_pages(plen)} KV pages "
                    f"but the pool only has {self.pool.capacity} "
                    f"allocatable pages — it could never be admitted. "
                    f"Raise EngineConfig.num_pages or shorten the prompt.")
        rid = self.sched.submit(request)
        if self.pool is not None and request.max_new_tokens > 0:
            self.pool.note_submit(rid, request.prompt)
        return rid

    def reset(self):
        """Drop all queued/active requests and cache state."""
        self._init_host_state()
        self.cache = None

    # ---------------------------------------------------------- paging ----
    def _flush_pool_ops(self, ops: kv_pool.StepOps):
        """Apply one batch of allocator decisions to the device cache:
        copy-on-write copies, fresh-page wipes and the host page table
        (:func:`kv_pool.apply_step_ops`), then any debug poisons. No-op
        when nothing changed."""
        if ops.any() or self._table_dirty:
            src = [a for a, _b in ops.copies]
            dst = [b for _a, b in ops.copies]
            kv_pool.apply_step_ops(self.cache, self.pool.table, ops.wipes,
                                   src, dst)
            self.cow_copies += len(ops.copies)
            self._table_dirty = False
        if ops.poisons:
            kv_pool.apply_poison(self.cache, ops.poisons)

    # ------------------------------------------------------------- step ----
    @torch.inference_mode()
    def step(self) -> List[Completion]:
        """Admit arrived requests into free slots (wiping their cache
        rows), feed every active slot (a prefill chunk, or one token),
        sample, and return any completions.

        Paged layout: admission maps prefix-map hits into the slot's page
        table (those prompt tokens skip prefill; the last prompt token is
        always re-fed); before the device step the allocator makes every
        page the step writes private (fresh pages wiped, shared or
        registered pages copied); after it, completed prompt pages
        register in the prefix map and finished slots release their
        pages.

        ``spec_tokens > 0`` runs a speculative round instead
        (:meth:`_spec_step`): the same admission and completions, 1 to
        k + 1 tokens committed a decoding slot."""
        b = self.ecfg.max_batch
        if self.cache is None:
            self.cache = self.init_cache(b)
            if self.pool is not None:
                self._table_dirty = True
        admitted = self.sched.admit()
        if admitted:
            lm.reset_cache_slots(self.cache, [s for s, _ in admitted])
            for slot, req in admitted:
                self._seeds[slot] = req.seed
                self._temps[slot] = req.temperature
                if self.pool is not None:
                    shared = self.pool.admit(slot, req)
                    if shared:
                        # Prefix hit: those tokens are already in mapped
                        # pages; prefill starts after them.
                        self.sched.slots[slot].n_fed = shared
                        self._table_dirty = True
        if self.ecfg.spec_tokens > 0:
            return self._spec_step()
        plan = self.sched.plan(self.chunk)
        if not plan:                       # idle: let queued arrivals age in
            return self.sched.advance({}, {})
        widths = {s: len(t) for s, t in plan.items()}
        if self.pool is not None:
            ops = kv_pool.StepOps()
            for slot, n in widths.items():
                self.pool.prepare(slot, self.sched.slots[slot].n_fed, n,
                                  ops)
            if ops.any():
                self._table_dirty = True
            self._flush_pool_ops(ops)
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
        slot_of = {st.request.request_id: s
                   for s, st in self.sched.slots.items()}
        # Post-step fed counts, captured before advance() pops finished
        # slots: note_filled's wrapped-through guard needs the true fed
        # count (prompt + generated - 1), not the prompt length.
        fed_of = {st.request.request_id: st.n_fed + widths.get(s, 0)
                  for s, st in self.sched.slots.items()}
        done = self.sched.advance(widths, sampled)
        if self.pool is not None:
            self._paged_after_advance(done, slot_of, fed_of, plan,
                                      kv_pool.StepOps())
        return done

    def _paged_after_advance(self, done, slot_of, fed_of, plan, ops):
        """Post-advance pool bookkeeping: register finished prompts' full
        pages (before release parks them in the cached LRU) and release
        their pages, register freshly completed prompt pages of the
        still-active slots, then flush the device ops."""
        for c in done:
            slot = slot_of.get(c.request_id)
            if slot is None:               # zero-generation immediate
                continue
            self.pool.note_filled(slot, c.request.prompt,
                                  fed_of[c.request_id])
            self.pool.release(slot, ops)
            self._table_dirty = True
        for slot in plan:
            st = self.sched.slots.get(slot)
            if st is not None:
                self.pool.note_filled(slot, st.request.prompt, st.n_fed)
        self._flush_pool_ops(ops)

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

    # ------------------------------------------------------ speculative ----
    def _spec_rng(self, st, tag: int) -> np.random.Generator:
        """Host rng of temperature > 0 speculation, keyed by (request
        seed, purpose tag, generated count) as the reference keys it: a
        request's stream depends on its own state only, never on the
        batch."""
        return np.random.default_rng(
            (int(st.request.seed) & 0x7FFFFFFF, tag, len(st.generated)))

    def _accept(self, st, drafts, dprobs, targets, lg_rows, rng):
        """One slot's committed tokens from its k drafts, the verify
        argmaxes ``targets`` [k + 1] and (temperature > 0) the verify
        logits ``lg_rows`` [k + 1, V], lane j scoring the token after
        draft j: the accepted prefix and one bonus or correction token.

        Temperature 0: the drafts that match the verify argmaxes, then the
        argmax at the first mismatch (or after the last draft), exactly
        the token-by-token greedy stream. Temperature > 0: rejection
        sampling; accept draft d with probability min(1, q(d) / p(d)), on
        a reject sample the residual max(q - p, 0), after k accepts sample
        the bonus from q."""
        t = st.request.temperature
        committed = []
        if t <= 0:
            a = 0
            while a < len(drafts) and drafts[a] == int(targets[a]):
                committed.append(drafts[a])
                a += 1
            committed.append(int(targets[a]))
            return committed
        for j, d in enumerate(drafts):
            q = _softmax(lg_rows[j] / t)
            p = dprobs[j]
            if rng.random() < q[d] / max(p[d], 1e-30):
                committed.append(d)
                continue
            resid = np.maximum(q - p, 0.0)
            tot = resid.sum()
            probs = resid / tot if tot > 0 else q
            committed.append(int(rng.choice(len(q), p=probs)))
            return committed
        q = _softmax(lg_rows[len(drafts)] / t)
        committed.append(int(rng.choice(len(q), p=q)))
        return committed

    def _spec_step(self) -> List[Completion]:
        """One speculative round: k drafts a decoding slot with the
        low-slice forward, one full-mix :func:`lm.verify_step` of width
        k + 1 (also the prefill feed of prompt-phase slots), the accepted
        prefix and the verify step's own token committed, the rejected
        suffix rolled back (ring: nothing to do, its entries carry future
        positions that the causal mask hides until they are rewritten;
        pages: the pages holding only rejected entries are released).

        A slot whose round would wrap the ring does not draft (the wrap
        would overwrite history that a reject could not restore); it
        rides the verify step with its one token, a plain full-mix decode
        step."""
        b = self.ecfg.max_batch
        k = self.ecfg.spec_tokens
        c = self.spec_width
        plan = self.sched.plan(c)
        if not plan:                       # idle: let queued arrivals age in
            return self.sched.advance({}, {})
        clen = min(self.ecfg.cache_len, self.cfg.window) \
            if self.cfg.window else self.ecfg.cache_len
        slots = self.sched.slots
        base_fed = {s: slots[s].n_fed for s in plan}
        decode_slots = [s for s in plan if slots[s].phase == DECODE]
        draft_slots = [s for s in decode_slots if base_fed[s] + c <= clen]
        if self.pool is not None:
            ops = kv_pool.StepOps()
            for s in plan:
                w = c if s in draft_slots else \
                    (1 if s in decode_slots else len(plan[s]))
                self.pool.prepare(s, base_fed[s], w, ops)
            if ops.any():
                self._table_dirty = True
            self._flush_pool_ops(ops)

        # Drafts: decode-phase slots only (a draft written at a prompt
        # position would never be rewritten by the verify step).
        cur = np.zeros((b,), np.int32)
        for s in decode_slots:
            cur[s] = int(plan[s][0])
        hot = [s for s in decode_slots if slots[s].request.temperature > 0]
        round_rng = {s: self._spec_rng(slots[s], 0x5EC) for s in hot}
        drafts = {s: [] for s in draft_slots}
        dprobs = {s: [] for s in draft_slots}
        active = np.zeros((b,), bool)
        active[draft_slots] = True
        for j in range(k if draft_slots else 0):
            pos = np.zeros((b,), np.int64)
            for s in draft_slots:
                pos[s] = base_fed[s] + j
            lg, self.cache = lm.decode_step(self.model, self.draft_cfg,
                                            self.cache, cur, pos,
                                            active=active)
            greedy = lg.argmax(-1).cpu().numpy()
            lgh = lg.float().cpu().numpy() if hot else None
            for s in draft_slots:
                temp = slots[s].request.temperature
                if temp > 0:
                    p = _softmax(lgh[s] / temp)
                    tok = int(round_rng[s].choice(len(p), p=p))
                    dprobs[s].append(p)
                else:
                    tok = int(greedy[s])
                drafts[s].append(tok)
                cur[s] = tok

        # One batched full-mix verify (and prefill feed) step.
        tokens = np.zeros((b, c), np.int32)
        pos = np.full((b, c), -1, np.int64)
        for s, toks in plan.items():
            feed = [int(toks[0])] + drafts[s] if s in draft_slots \
                else [int(x) for x in toks[:c]]
            tokens[s, :len(feed)] = feed
            pos[s, :len(feed)] = base_fed[s] + np.arange(len(feed))
        lg, self.cache = lm.verify_step(self.model, self.cfg, self.cache,
                                        tokens, pos)
        greedy = lg.argmax(-1).cpu().numpy()                  # [B, C]
        need_lg = bool(hot) or any(slots[s].request.temperature > 0
                                   for s in plan if s not in decode_slots)
        lgh = lg.float().cpu().numpy() if need_lg else None   # [B, C, V]

        # Acceptance and commit, on the host.
        fed, sampled = {}, {}
        for s, toks in plan.items():
            st = slots[s]
            if s not in decode_slots:
                n = len(toks)
                fed[s] = n
                if st.n_fed + n >= len(st.request.prompt):
                    # The prompt completes: its last lane seeds sampling.
                    sampled[s] = int(greedy[s, n - 1]) \
                        if st.request.temperature <= 0 \
                        else self._sample_row(st, lgh[s, n - 1])
                continue
            committed = self._accept(st, drafts.get(s, []),
                                     dprobs.get(s, []), greedy[s],
                                     None if lgh is None else lgh[s],
                                     round_rng.get(s))
            a = len(committed) - 1          # accepted drafts
            fed[s] = 1 + a
            sampled[s] = committed
            if s in draft_slots:
                self.spec_rounds += 1
                self.spec_drafted += k
                self.spec_accepted += a

        # Paged rollback of the pages holding only rejected entries, then
        # advance.
        slot_of = {st.request.request_id: s for s, st in slots.items()}
        fed_of = {st.request.request_id: st.n_fed + fed.get(s, 0)
                  for s, st in slots.items()}
        ops = kv_pool.StepOps()
        if self.pool is not None:
            for s in draft_slots:
                if fed[s] < c:
                    self.pool.rollback(s, base_fed[s] + fed[s],
                                       base_fed[s] + c, ops)
                    self._table_dirty = True
        done = self.sched.advance(fed, sampled)
        if self.pool is not None:
            self._paged_after_advance(done, slot_of, fed_of, plan, ops)
        return done

    def _sample_row(self, st, lg_row) -> int:
        """One token from a host fp32 logits row with the slot's
        temperature, on the speculative host rng."""
        p = _softmax(lg_row / st.request.temperature)
        return int(self._spec_rng(st, 0x9EF).choice(len(p), p=p))

    def spec_stats(self) -> dict:
        """Speculation telemetry: rounds drafted, draft tokens proposed
        and accepted, and the mean accepted draft length a round."""
        return {
            "spec_tokens": self.ecfg.spec_tokens,
            "rounds": self.spec_rounds,
            "drafted": self.spec_drafted,
            "accepted": self.spec_accepted,
            "mean_accepted": (self.spec_accepted / self.spec_rounds
                              if self.spec_rounds else 0.0),
        }

    # ----------------------------------------------------- cancellation ----
    @torch.inference_mode()
    def cancel(self, request_id: int) -> Optional[Completion]:
        """Cancel a queued or active request; returns its "evicted"
        Completion, or None when the id is unknown or finished. A queued
        request leaves the admission queue (paged: its memoized digests
        and any admission reservation are dropped); an active one frees
        its slot and, paged, releases its pages with the table re-uploaded
        at once. Call between engine steps."""
        comp = self.sched.cancel(request_id)
        if comp is not None:
            if self.pool is not None:
                self.pool.forget_submit(request_id)
            return comp
        slot = next((s for s, st in self.sched.slots.items()
                     if st.request.request_id == request_id), None)
        if slot is None:
            return None
        if self.pool is not None:
            ops = kv_pool.StepOps()
            # A cancelled slot's finished prompt pages still register
            # (valid shared-prefix content for later requests).
            st = self.sched.slots[slot]
            self.pool.note_filled(slot, st.request.prompt, st.n_fed)
            self.pool.release(slot, ops)
            self._table_dirty = True
            if self.cache is not None:
                self._flush_pool_ops(ops)
        return self.sched.evict(slot)

    # ---------------------------------------------------------- metrics ----
    def paged_kv_stats(self) -> dict:
        """Occupancy and sharing of the paged KV pool. Byte figures count
        K/V payload only (codes and scales, or fp k and v), as
        ``kv_quant.cache_payload_bytes`` does for the ring; a page spans
        every layer. ``cow_copies`` counts copy-on-write page copies."""
        if self.pool is None:
            raise ValueError("paged_kv_stats needs kv_layout='paged'")
        if self.cache is None:
            raise ValueError("run at least one step first")
        per_page = kv_pool.paged_payload_bytes_per_page(self.cache)
        pool = self.pool
        return {
            "page_size": pool.page_size,
            "num_pages": pool.num_pages,
            "page_payload_bytes": per_page,
            "resident_pages": pool.resident_pages,
            "peak_resident_pages": pool.peak_resident,
            "resident_payload_bytes": pool.resident_pages * per_page,
            "peak_resident_payload_bytes": pool.peak_resident * per_page,
            "reserved_payload_bytes": pool.capacity * per_page,
            "prefix_hits": pool.hits,
            "prefix_lookups": pool.lookups,
            "prefix_hit_rate": pool.prefix_hit_rate,
            "cow_copies": self.cow_copies,
        }

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
