"""Request-level continuous-batching scheduler (DESIGN.md §10).

A copy of ``repro.serve.scheduler`` (pure Python): the port imports
nothing of the JAX package.

The scheduler owns the *host-side* state machine of the serve engine:

  * an **admission queue** of :class:`Request` objects ordered by
    ``(arrival_step, submit order)``;
  * a **free-list** of the engine's ``max_batch`` batch slots;
  * per-slot :class:`SlotState` tracking where each admitted request is in
    its lifecycle (``PREFILL`` — prompt tokens still being fed into the KV
    cache — then ``DECODE`` — sampling new tokens — then eviction).

It is deliberately jax-free: the engine (``serve/engine.py``) asks the
scheduler *what to feed each slot this step* and tells it *what was
sampled*; all device work (decode step, sampling) stays in the engine.
Invariants (pinned by ``tests/test_serve_scheduler.py``):

  * a request's token stream depends only on its own prompt, seed and
    sampling params — never on batch composition (slot rows are
    independent), so continuous batching is token-parity with the lockstep
    engine at temperature 0;
  * a slot is reset (KV rows wiped, ``pos = -1``) at admission, never
    lazily, so an evicted request can leave garbage behind;
  * admission happens at step start: a slot freed by a completion in step
    ``t`` is reusable in step ``t + 1``;
  * requests are admitted in ``(arrival_step, submit order)`` order — no
    reordering, no starvation.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

PREFILL = "prefill"
DECODE = "decode"


@dataclasses.dataclass
class Request:
    """One generation request.

    ``prompt`` is a 1-D int32 token array; ``seed`` drives the per-request
    sampling rng (folded with the generated-token index, so the stream is
    reproducible under any batch schedule); ``arrival_step`` lets synthetic
    workloads model staggered traffic — the scheduler will not admit a
    request before its arrival step.
    """
    prompt: np.ndarray
    max_new_tokens: int
    temperature: float = 0.0
    seed: int = 0
    arrival_step: int = 0
    eos_id: Optional[int] = None
    request_id: Optional[int] = None     # (re)assigned at every submit()

    def __post_init__(self):
        # Degenerate requests (empty prompt, max_new_tokens <= 0) are
        # handled at Scheduler.submit() — rejected or completed
        # immediately — not here: a bare Request is a value object, and
        # `assert` validation disappears under `python -O`, which is how
        # they used to slip into the prefill->decode state machine and
        # never finish.
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)


@dataclasses.dataclass
class Completion:
    """A finished request, streamed back by the engine."""
    request_id: int
    request: Request
    tokens: np.ndarray          # [S0 + num generated] prompt + generated
    new_tokens: np.ndarray      # [num generated]
    finish_reason: str          # "length" | "eos" | "evicted"
    finished_step: int          # engine step at which the request finished
    steps: int                  # engine steps the request occupied a slot


@dataclasses.dataclass
class SlotState:
    request: Request
    n_fed: int = 0              # tokens fed into the cache so far
    generated: Optional[List[int]] = None
    admitted_step: int = 0

    def __post_init__(self):
        if self.generated is None:
            self.generated = []

    @property
    def phase(self) -> str:
        return PREFILL if self.n_fed < len(self.request.prompt) else DECODE

    def next_tokens(self, chunk: int) -> np.ndarray:
        """The (up to ``chunk``) tokens this slot feeds next step: remaining
        prompt tokens while prefilling, else the last sampled token."""
        prompt = self.request.prompt
        if self.n_fed < len(prompt):
            return prompt[self.n_fed:self.n_fed + chunk]
        return np.asarray([self.generated[-1]], np.int32)

    @property
    def samples_this_step(self) -> bool:
        """Whether the logits of this slot's last fed token are consumed
        (true once the final prompt token has entered the cache)."""
        return self.n_fed >= len(self.request.prompt)


class Scheduler:
    """Admission queue + slot free-list + per-slot lifecycle state.

    ``can_admit``: optional capacity callback consulted at admission time
    for the request at the head of the queue — a free batch slot alone is
    not always enough (the paged KV engine also needs the page pool to
    cover the prompt's pages, DESIGN.md §13). When it returns False,
    admission stops for this step (head-of-line blocking, preserving
    FIFO) and retries next step once capacity frees up.
    """

    def __init__(self, max_batch: int,
                 can_admit: Optional[Callable[[Request], bool]] = None):
        assert max_batch > 0
        self.max_batch = max_batch
        self.can_admit = can_admit
        self._queue: List[Tuple[int, int, Request]] = []   # heap
        self._ticket = itertools.count()
        self._next_id = itertools.count()
        self.free_slots: List[int] = list(range(max_batch))[::-1]
        self.slots: Dict[int, SlotState] = {}
        self._immediate: List[Completion] = []
        self.step_count = 0

    # ------------------------------------------------------------ queue ----
    def submit(self, request: Request) -> int:
        """Queue a request. Degenerate requests never enter the
        prefill->decode state machine (where they could not finish): an
        empty prompt is rejected with ``ValueError``; ``max_new_tokens <=
        0`` completes immediately with zero generated tokens (the
        completion is delivered by the next ``advance()``)."""
        if request.prompt.size == 0:
            raise ValueError(
                "empty prompt: a request must carry at least one token to "
                "prefill")
        # Always assign a fresh id: a re-submitted Request object (e.g.
        # after an engine reset) must not collide with this scheduler's
        # freshly issued ids.
        request.request_id = next(self._next_id)
        if request.max_new_tokens <= 0:
            self._immediate.append(Completion(
                request_id=request.request_id, request=request,
                tokens=request.prompt.copy(),
                new_tokens=np.zeros((0,), np.int32),
                finish_reason="length", finished_step=self.step_count,
                steps=0))
            return request.request_id
        heapq.heappush(self._queue,
                       (request.arrival_step, next(self._ticket), request))
        return request.request_id

    @property
    def pending(self) -> int:
        return len(self._queue)

    @property
    def num_active(self) -> int:
        return len(self.slots)

    def has_work(self) -> bool:
        return bool(self._queue) or bool(self.slots) \
            or bool(self._immediate)

    # -------------------------------------------------------- admission ----
    def admit(self) -> List[Tuple[int, Request]]:
        """Move arrived requests from the queue into free slots (call at
        step start). Returns [(slot, request)] for the engine to reset the
        KV rows of."""
        admitted = []
        while self.free_slots and self._queue \
                and self._queue[0][0] <= self.step_count:
            if self.can_admit is not None \
                    and not self.can_admit(self._queue[0][2]):
                break                      # head-of-line waits for capacity
            _, _, req = heapq.heappop(self._queue)
            slot = self.free_slots.pop()
            self.slots[slot] = SlotState(req, admitted_step=self.step_count)
            admitted.append((slot, req))
        return admitted

    # ------------------------------------------------------- step plan  ----
    def plan(self, prefill_chunk: int) -> Dict[int, np.ndarray]:
        """{slot: tokens to feed this step} (1 token for decoding slots, up
        to ``prefill_chunk`` for prefilling ones)."""
        return {s: st.next_tokens(max(prefill_chunk, 1))
                for s, st in self.slots.items()}

    # ------------------------------------------------------ advancement ----
    def advance(self, fed: Dict[int, int], sampled: Dict[int, object]
                ) -> List[Completion]:
        """Commit one engine step: ``fed[slot]`` tokens entered the cache,
        ``sampled[slot]`` is the token drawn from the slot's last-token
        logits (ignored for slots still mid-prefill) — or, in a
        speculative round (DESIGN.md §14), the ordered LIST of committed
        tokens (accepted drafts + the verify bonus/correction token).
        Each committed token is checked against eos / ``max_new_tokens``
        in order; a terminal token truncates the rest of the list. One
        call is one engine step regardless of how many tokens it commits.
        Returns completions (including any immediately-completed
        zero-generation submissions); their slots go back on the
        free-list (reusable next step)."""
        done: List[Completion] = self._immediate
        self._immediate = []
        for slot, n in fed.items():
            st = self.slots[slot]
            st.n_fed += n
            if not st.samples_this_step:
                continue                       # still prefilling
            req = st.request
            reason = None
            for tok in np.atleast_1d(np.asarray(sampled[slot], np.int64)):
                st.generated.append(int(tok))
                eos = req.eos_id is not None and int(tok) == req.eos_id
                if eos or len(st.generated) >= req.max_new_tokens:
                    reason = "eos" if eos else "length"
                    break
            if reason is not None:
                done.append(self._finish(slot, reason))
        self.step_count += 1
        return done

    def _finish(self, slot: int, reason: str, *,
                in_step: bool = True) -> Completion:
        st = self.slots.pop(slot)
        self.free_slots.append(slot)
        new = np.asarray(st.generated, np.int32)
        # ``steps`` counts the engine steps the slot was occupied for.
        # Finishing DURING a step (advance), step_count has not yet been
        # incremented for the step that just ran — hence the +1. Between
        # steps (evict), step_count already covers every step the slot
        # ran; a +1 there would count a step the slot never ran.
        return Completion(
            request_id=st.request.request_id, request=st.request,
            tokens=np.concatenate([st.request.prompt, new]),
            new_tokens=new, finish_reason=reason,
            finished_step=self.step_count,
            steps=self.step_count - st.admitted_step + (1 if in_step else 0))

    def evict(self, slot: int) -> Completion:
        """Force-finish a slot (admin path: cancellation / preemption).
        Called BETWEEN engine steps — never from inside ``advance``."""
        return self._finish(slot, "evicted", in_step=False)

    def cancel(self, request_id: int) -> Optional[Completion]:
        """Remove a still-QUEUED request (never admitted): its "evicted"
        zero-generation Completion, or None when the id is not in the
        queue (already admitted, finished, or unknown — an admitted
        request is cancelled through the engine, which must release the
        slot's cache resources before calling :meth:`evict`)."""
        for i, (_, _, req) in enumerate(self._queue):
            if req.request_id == request_id:
                self._queue.pop(i)
                heapq.heapify(self._queue)
                return Completion(
                    request_id=request_id, request=req,
                    tokens=req.prompt.copy(),
                    new_tokens=np.zeros((0,), np.int32),
                    finish_reason="evicted",
                    finished_step=self.step_count, steps=0)
        return None
