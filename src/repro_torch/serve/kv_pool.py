"""Paged KV cache: the page pool on the device and its host allocator.
Counterpart of ``repro.serve.kv_pool`` (DESIGN.md §13).

* **Device side** — per-layer cache dicts whose payload leaves are pools
  ``[P, page_size, Hk, ...]``: ``k_codes``/``v_codes``/``k_scale``/
  ``v_scale`` of the packed 4-bit family, or fp ``k``/``v``
  ``[P, page_size, Hk, D]`` in the cache dtype; plus pool-wide position
  stamps ``pos [P, page_size]`` (-1 = empty) and the per-slot page table
  ``page_table [B, NP]`` (physical page per logical page, -1 =
  unmapped). Physical page 0 is the reserved null page: never allocated,
  payload zero, ``pos`` -1 forever, so readers clamp unmapped ids to it.
  Every layer maps the same page ids, so all layers share one table
  tensor. The device ops are plain torch indexing, in place.
* **Host side** — :class:`PagePool`, a copy of the reference's pure
  Python allocator: free list, per-page refcounts, copy-on-write for
  shared pages and a sha1 chain-digest prefix map with a cached LRU. It
  emits :class:`StepOps` that the engine applies with
  :func:`apply_step_ops`.

Ring parity: logical page ``(pos // page_size) % NP`` at offset
``pos % page_size`` is the ring slot ``pos % cache_len`` when
``page_size`` divides the ring length, so the paged ``DecodeEngine`` is
token-identical to the ring engine. Lanes with ``pos < 0`` or an unmapped
page are dropped from the write.

``SONIQ_KV_POISON=1`` (or ``PagePool(poison=True)``) returns freed pages
poisoned (NaN fp payload and scales, 0xFF codes, ``pos`` stamps kept), so
a stale page-table reference turns the attention output NaN.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import kv_quant

POISON_ENV = "SONIQ_KV_POISON"

_Q4_PAYLOAD = ("k_codes", "v_codes", "k_scale", "v_scale")
_FP_PAYLOAD = ("k", "v")

# Live-lane write index of a paged cache: (batch rows, lanes, physical
# pages, in-page offsets).
PagedWrite = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def pages_for(tokens: int, page_size: int) -> int:
    """Pages needed to hold ``tokens`` tokens (ceil)."""
    return -(-tokens // page_size)


# ===================================================== device layout ====
def init_paged_cache(num_pages: int, page_size: int, pages_per_seq: int,
                     batch: int, num_kv_heads: int, head_dim: int, *,
                     device, kv_bits: Optional[int] = None,
                     dtype=torch.bfloat16,
                     table: Optional[torch.Tensor] = None) -> Dict:
    """One layer's paged cache: payload pools (fp ``k``/``v`` in ``dtype``
    for ``kv_bits=None``, packed 4-bit codes and fp16 scales for 4), pos
    stamps and the page table (``table``, when given, is shared with
    other layers). ``num_pages`` includes the reserved null page 0."""
    if num_pages < 2:
        raise ValueError("the pool needs the null page and at least one "
                         "usable page")
    p, ps = num_pages, page_size
    if kv_bits is None:
        fp = (p, ps, num_kv_heads, head_dim)
        out = {"k": torch.zeros(fp, dtype=dtype, device=device),
               "v": torch.zeros(fp, dtype=dtype, device=device)}
    elif kv_bits == 4:
        if head_dim % 2:
            raise ValueError(f"head_dim {head_dim} must be even")
        codes = (p, ps, num_kv_heads, head_dim // 2)
        scales = (p, ps, num_kv_heads, 1)
        out = {
            "k_codes": torch.zeros(codes, dtype=torch.uint8, device=device),
            "v_codes": torch.zeros(codes, dtype=torch.uint8, device=device),
            "k_scale": torch.zeros(scales, dtype=torch.float16,
                                   device=device),
            "v_scale": torch.zeros(scales, dtype=torch.float16,
                                   device=device),
        }
    else:
        raise ValueError(f"kv_bits must be None or 4, got {kv_bits}")
    if table is None:
        table = torch.full((batch, pages_per_seq), -1, dtype=torch.int32,
                           device=device)
    out["pos"] = torch.full((p, ps), -1, dtype=torch.int32, device=device)
    out["page_table"] = table
    return out


def paged_write_index(pos, table, page_size: int, device) -> PagedWrite:
    """Host positions [B, S] (or [B]) and page table [B, NP] -> device
    (batch, lane, page, offset) index tensors of the lanes that write:
    ``pos >= 0`` and a mapped page ``table[b, (pos // page_size) % NP]``
    at offset ``pos % page_size``. One host computation per step, shared
    by every layer."""
    pos = kv_quant.host_array(pos).astype(np.int64)
    if pos.ndim == 1:
        pos = pos[:, None]
    table = kv_quant.host_array(table)
    bi, si = np.nonzero(pos >= 0)
    p = pos[bi, si]
    pid = table[bi, (p // page_size) % table.shape[1]].astype(np.int64)
    live = pid >= 0
    bi, si, p, pid = bi[live], si[live], p[live], pid[live]
    return tuple(torch.as_tensor(a, dtype=torch.int64, device=device)
                 for a in (bi, si, pid, p % page_size))


def update_paged_cache(cache: Dict, k_new: torch.Tensor,
                       v_new: torch.Tensor, pos, *,
                       write: Optional[PagedWrite] = None) -> Dict:
    """Write a chunk of new K/V (``k_new``/``v_new`` [B, S, H, D]) into
    the pages the table maps for positions ``pos`` ([B] or [B, S]), in
    place: quantized for the 4-bit pool, as they are (cast to the pool's
    dtype) for the fp pool. The host allocator has already made every
    written page private and mapped; masked lanes and unmapped pages are
    dropped. ``write`` is the precomputed :func:`paged_write_index`."""
    if write is None:
        write = paged_write_index(pos, cache["page_table"],
                                  cache["pos"].shape[1], cache["pos"].device)
    bi, si, pid, off = write
    if "k_codes" in cache:
        return kv_quant.write_codes(cache, k_new, v_new, pos, (bi, si),
                                    (pid, off))
    posb = torch.as_tensor(pos, device=cache["pos"].device)
    if posb.dim() == 1:
        posb = posb[:, None]
    cache["k"][pid, off] = k_new[bi, si].to(cache["k"].dtype)
    cache["v"][pid, off] = v_new[bi, si].to(cache["v"].dtype)
    cache["pos"][pid, off] = posb[bi, si].to(cache["pos"].dtype)
    return cache


def gather_paged(cache: Dict, dtype=torch.float32):
    """Dense view of a paged layer cache: -> (k [B, T, Hk, D], v,
    pos [B, T]) in ``dtype`` with T = NP * page_size, entry ``pos %
    T`` of a row where the ring would hold it. Unmapped entries clamp to
    the null page (payload zero) and read ``pos`` -1."""
    table = cache["page_table"].long()                       # [B, NP]
    b, n_logical = table.shape
    safe = table.clamp(min=0)
    ps = cache["pos"].shape[1]
    t = n_logical * ps
    pos = cache["pos"][safe]                                 # [B, NP, ps]
    pos = torch.where(table[..., None] >= 0, pos,
                      torch.full((), -1, dtype=pos.dtype, device=pos.device))

    def take(name):
        leaf = cache[name][safe]                             # [B, NP, ps, ..]
        return leaf.reshape((b, t) + leaf.shape[3:])

    if "k_codes" in cache:
        k = kv_quant.dequantize_kv(take("k_codes"), take("k_scale"), dtype)
        v = kv_quant.dequantize_kv(take("v_codes"), take("v_scale"), dtype)
    else:
        k, v = take("k").to(dtype), take("v").to(dtype)
    return k, v, pos.reshape(b, t)


# =============================================== device op application ====
def paged_layers(cache) -> List[Dict]:
    """Every paged layer dict (one with a ``page_table`` leaf) of a cache
    tree."""
    out: List[Dict] = []

    def walk(node):
        if isinstance(node, dict):
            if "page_table" in node:
                out.append(node)
                return
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(cache)
    return out


def _ids(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int64).reshape(-1),
                           device=device)


def apply_step_ops(cache, table, wipe, copy_src, copy_dst):
    """Apply one step's allocator decisions to every paged dict of the
    cache tree, in place:

    * ``copy_src``/``copy_dst`` — copy-on-write: page ``dst`` becomes a
      full copy of ``src`` (payload and pos stamps);
    * ``wipe`` — freshly allocated pages: payload zero, pos -1;
    * ``table`` [B, NP] — the new page tables.

    Copies run before wipes. (0, 0) copies and wipes of the null page are
    no-ops, so padded id vectors are accepted as the reference pads them.
    """
    layers = paged_layers(cache)
    if not layers:
        return cache
    dev = layers[0]["pos"].device
    src, dst, wipe = (_ids(a, dev) for a in (copy_src, copy_dst, wipe))
    table_t = torch.as_tensor(np.asarray(table), dtype=torch.int32,
                              device=dev)
    done = set()
    for d in layers:
        if id(d["page_table"]) not in done:
            d["page_table"].copy_(table_t)
            done.add(id(d["page_table"]))
        for name, leaf in d.items():
            if name == "page_table":
                continue
            if src.numel():
                leaf[dst] = leaf[src]
            if wipe.numel():
                leaf[wipe] = -1 if name == "pos" else 0
    return cache


def apply_poison(cache, pids):
    """Poison freed pages (debug mode): NaN fp payload and fp16 scales,
    0xFF codes, ``pos`` stamps kept, so a stale page-table reference turns
    the attention output NaN. Allocation wipes the poison before reuse."""
    for d in paged_layers(cache):
        idx = _ids(pids, d["pos"].device)
        for name in _Q4_PAYLOAD + _FP_PAYLOAD:
            if name in d:
                d[name][idx] = 0xFF if name.endswith("_codes") \
                    else float("nan")
    return cache


def paged_payload_bytes_per_page(cache) -> int:
    """Payload bytes of ONE pool page summed over every paged layer of the
    cache tree (a page id maps in all layers at once): resident bytes are
    ``pages_in_use x this``. Payload is the codes and scales of a 4-bit
    pool, ``k``/``v`` of an fp pool."""
    per_page = 0
    for d in paged_layers(cache):
        npages = d["pos"].shape[0]
        for name in _Q4_PAYLOAD + _FP_PAYLOAD:
            if name in d:
                leaf = d[name]
                per_page += leaf.numel() * leaf.element_size() // npages
    return per_page


# ======================================================= host allocator ====
def invariant_violations(pool) -> List[str]:
    """The PagePool state invariants as one shared, assert-free definition
    (DESIGN.md §16), consumed by :meth:`PagePool.check` and the port's
    allocator tests. Returns human-readable violation
    strings; empty means the state is sound.

    * the free list, cached LRU and mapped set partition the non-null
      pages (no double-free, no lost pages, no overlap);
    * the null page 0 is never on any list and never mapped;
    * ``refcount[p]`` equals the number of page-table references to ``p``;
    * every cached-LRU page is registered in the prefix map, and the
      prefix map and per-page hashes agree.
    """
    out: List[str] = []
    every = set(range(1, pool.num_pages))
    free = set(pool.free)
    cached = set(pool.cached)
    mapped = {int(p) for p in np.unique(pool.table[pool.table >= 0])}
    if len(free) != len(pool.free):
        dupes = sorted(p for p in free if pool.free.count(p) > 1)
        out.append(f"duplicate page(s) on free list: {dupes}")
    if 0 in free | cached | mapped:
        out.append("null page 0 leaked into free/cached/mapped")
    for a, b, an, bn in ((free, cached, "free", "cached"),
                         (free, mapped, "free", "mapped"),
                         (cached, mapped, "cached", "mapped")):
        both = a & b
        if both:
            out.append(f"page(s) in both {an} and {bn}: {sorted(both)}")
    lost = every - (free | cached | mapped)
    if lost:
        out.append(f"lost page(s) (free/cached/mapped cover nothing): "
                   f"{sorted(lost)}")
    want = np.zeros(pool.num_pages, np.int64)
    pids, counts = np.unique(pool.table[pool.table >= 0],
                             return_counts=True)
    want[pids] = counts
    if not (want == pool.refcount).all():
        drift = [(int(p), int(want[p]), int(pool.refcount[p]))
                 for p in np.nonzero(want != pool.refcount)[0]]
        out.append(f"refcount drift (pid, table refs, refcount): {drift}")
    for pid in sorted(cached):
        if pid not in pool.page_hash:
            out.append(f"cached page {pid} is not registered")
    for digest, pid in pool.prefix_map.items():
        if pool.page_hash.get(pid) != digest:
            out.append(f"prefix map / page hash drift at page {pid}")
    return out


def step_ops_violations(pool, ops: "StepOps") -> List[str]:
    """Check one engine-step batch of accumulated :class:`StepOps` against
    the no-shared-write and poison-cancel contracts, AFTER the allocator
    calls that filled it (shared definition for the fuzz harness and the
    model checker):

    * a wiped (freshly allocated) page must be exclusively ours
      (refcount 1) and not registered prefix content;
    * a COW destination likewise — COW exists precisely so shared or
      registered pages are never in-place write targets;
    * no page is both wiped and poisoned in one batch: the engine applies
      poisons after wipes, so a page freed and reallocated within the
      same batch must have had its poison cancelled (:meth:`_alloc`) or
      the stale poison corrupts the fresh allocation.
    """
    out: List[str] = []
    for pid in ops.wipes:
        if pool.refcount[pid] != 1:
            out.append(f"wiped page {pid} has refcount "
                       f"{int(pool.refcount[pid])} (must be exclusive)")
        if pid in pool.page_hash:
            out.append(f"wiped page {pid} is registered prefix content")
    for _src, dst in ops.copies:
        if pool.refcount[dst] != 1:
            out.append(f"COW destination {dst} has refcount "
                       f"{int(pool.refcount[dst])} (must be exclusive)")
        if dst in pool.page_hash:
            out.append(f"COW destination {dst} is registered prefix "
                       f"content")
    stale = set(ops.poisons) & set(ops.wipes)
    if stale:
        out.append(f"page(s) both wiped and poisoned in one batch "
                   f"(poison-cancel missed): {sorted(stale)}")
    return out


@dataclasses.dataclass
class StepOps:
    """Device work one or more allocator calls accumulated: applied by the
    engine through :func:`apply_step_ops` / :func:`apply_poison`."""
    wipes: List[int] = dataclasses.field(default_factory=list)
    copies: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    poisons: List[int] = dataclasses.field(default_factory=list)

    def any(self) -> bool:
        return bool(self.wipes or self.copies)


class PagePool:
    """Host-side page allocator: free-list + refcounts + COW + prefix map.

    Pure Python on numpy state (the ``Scheduler`` split, DESIGN.md §10): all
    decisions happen here on numpy state; device effects are emitted as
    :class:`StepOps`. Invariants:

    * every non-null page is in exactly one of {free list, cached LRU,
      mapped (refcount > 0)} — no double-free, no lost pages;
    * ``refcount[p]`` equals the number of page-table references to ``p``;
    * a page that is shared (refcount > 1) or registered in the prefix
      map is never handed out for in-place writes — rollover into it
      triggers copy-on-write;
    * the null page 0 is never allocated, never freed, never written.

    Prefix sharing: full prompt pages are content-hashed (a chain digest,
    so page i's hash commits to pages 0..i) and registered once fully
    written; a later request whose leading pages hash-match maps them
    refcounted instead of re-prefilling (the last prompt token is always
    re-fed — its logits seed sampling — so at most ``len(prompt) - 1``
    tokens resolve from the prefix map). Registered pages whose refcount
    drops to 0 are parked in a cached LRU and revived on the next hit;
    they are evicted (and unregistered) only when the free list runs dry.
    """

    def __init__(self, num_pages: int, page_size: int, pages_per_seq: int,
                 max_batch: int, *, poison: Optional[bool] = None):
        assert num_pages >= 2, "pool needs the null page + >= 1 usable page"
        assert page_size > 0 and pages_per_seq > 0
        self.num_pages = num_pages
        self.page_size = page_size
        self.pages_per_seq = pages_per_seq
        self.max_batch = max_batch
        if poison is None:
            poison = os.environ.get(POISON_ENV, "0") not in ("", "0")
        self.poison = bool(poison)
        # pop() hands out low ids first (nicer to read in tests/dumps)
        self.free: List[int] = list(range(num_pages - 1, 0, -1))
        self.refcount = np.zeros(num_pages, np.int64)
        self.table = np.full((max_batch, pages_per_seq), -1, np.int32)
        self.page_hash: Dict[int, bytes] = {}     # registered pid -> digest
        self.prefix_map: Dict[bytes, int] = {}    # digest -> canonical pid
        self.cached: "OrderedDict[int, bytes]" = OrderedDict()  # LRU
        self.lookups = 0
        self.hits = 0
        self.peak_resident = 0
        self._hash_memo: Dict[int, Tuple[bytes, ...]] = {}
        self._slot_hashes: Dict[int, Tuple[bytes, ...]] = {}
        self._target_pages: Dict[int, int] = {}
        # request_id -> net page demand reserved by an admissible() pass
        # that returned True; consumed by the matching admit().
        self._pending: Dict[int, int] = {}

    # -------------------------------------------------------- geometry ----
    @property
    def capacity(self) -> int:
        """Allocatable pages (the null page is reserved)."""
        return self.num_pages - 1

    @property
    def resident_pages(self) -> int:
        """Pages holding live data: mapped (refcount > 0) + cached-LRU
        prefix pages. Free (even poisoned) pages hold nothing."""
        return self.capacity - len(self.free)

    def target_pages(self, prompt_len: int) -> int:
        """Page demand of a prompt, capped at the per-sequence table
        length (longer prompts wrap the logical ring, reusing pages)."""
        return min(pages_for(prompt_len, self.page_size),
                   self.pages_per_seq)

    # --------------------------------------------------------- hashing ----
    def page_hashes(self, prompt) -> Tuple[bytes, ...]:
        """Chain digests of the prompt's FULL pages: hash of page i
        commits to the tokens of pages 0..i, so equal digests mean equal
        whole prefixes, never just an equal middle page."""
        toks = np.asarray(prompt, np.int32).reshape(-1)
        ps = self.page_size
        out = []
        h = b"soniq-paged-kv"
        for i in range(len(toks) // ps):
            h = hashlib.sha1(h + toks[i * ps:(i + 1) * ps].tobytes()).digest()
            out.append(h)
        return tuple(out)

    def _shareable(self, prompt, hashes) -> int:
        """How many leading pages an admission could map from the prefix
        map right now. Capped so the final prompt token is always re-fed
        (its logits seed sampling) and page demand never exceeds the
        table; the scan stops at the first miss (a prefix is contiguous
        by construction)."""
        plen = int(np.asarray(prompt).reshape(-1).shape[0])
        cap = min((plen - 1) // self.page_size, self.pages_per_seq - 1)
        n = 0
        for i in range(min(len(hashes), cap)):
            if hashes[i] not in self.prefix_map:
                break
            n += 1
        return n

    # ------------------------------------------------------- admission ----
    def note_submit(self, request_id: int, prompt) -> int:
        """Prefix-hash lookup at submit() time: memoize the prompt's page
        digests for admission and return how many pages would hit the
        prefix map today (observability; the authoritative mapping
        happens at :meth:`admit`)."""
        hashes = self.page_hashes(prompt)
        self._hash_memo[request_id] = hashes
        return self._shareable(prompt, hashes)

    def _outstanding_prompt_pages(self) -> int:
        """Prompt pages promised but not yet allocated: admitted slots
        whose prefills are still running, plus requests an
        :meth:`admissible` pass reserved for this step (their
        :meth:`admit` has not run yet)."""
        total = sum(self._pending.values())
        for slot, target in self._target_pages.items():
            mapped = int((self.table[slot] >= 0).sum())
            total += max(0, target - mapped)
        return total

    def admissible(self, request) -> bool:
        """Can the pool cover this request's prompt pages right now?
        Counts free + evictable-cached pages, minus pages already
        promised to in-flight prefills — the ``Scheduler.admit`` capacity
        callback (head-of-line blocking: FIFO order is preserved, the
        queue just waits for pages).

        A True return RESERVES the request's net page demand (keyed by
        ``request_id``) until the matching :meth:`admit` consumes it:
        ``Scheduler.admit`` checks each head-of-queue request in a loop
        before the engine runs any ``admit()``, so without the
        reservation the second request of a step would not see the
        first's demand and a tight pool could be overcommitted.

        Cached-LRU pages this request's own prefix would REVIVE must not
        also count as evictable: admit() takes a reference on each
        shareable page, so a parked (refcount 0) prefix hit leaves the
        LRU the moment the request is admitted — subtracting it from
        ``need`` as shareable while counting it in ``avail`` as
        evictable double-counts the page, and on a tight pool
        (free = 0, cached = the prefix pages) that admits a request
        whose first fresh allocation then dies with the mid-step
        pool-exhausted RuntimeError."""
        prompt = np.asarray(request.prompt).reshape(-1)
        rid = getattr(request, "request_id", None)
        hashes = self._hash_memo.get(rid)
        if hashes is None:
            hashes = self.page_hashes(prompt)
        shareable = self._shareable(prompt, hashes)
        revived = sum(
            1 for i in range(shareable)
            if self.refcount[self.prefix_map[hashes[i]]] == 0)
        need = self.target_pages(len(prompt)) - shareable
        avail = len(self.free) + (len(self.cached) - revived) \
            - self._outstanding_prompt_pages()
        ok = need <= avail
        if ok and rid is not None:
            self._pending[rid] = need
        return ok

    def admit(self, slot: int, request) -> int:
        """Map the request's shared prefix pages into ``slot``'s table and
        return the number of prompt tokens they already hold (the engine
        starts the prefill there). No pages are allocated here — writes
        allocate lazily through :meth:`prepare`."""
        assert (self.table[slot] < 0).all(), \
            f"slot {slot} admitted with a dirty table (missing release?)"
        prompt = np.asarray(request.prompt).reshape(-1)
        rid = getattr(request, "request_id", None)
        # The slot's _target_pages entry takes over capacity tracking
        # from the admissible() reservation.
        self._pending.pop(rid, None)
        hashes = self._hash_memo.pop(rid, None)
        if hashes is None:
            hashes = self.page_hashes(prompt)
        self._slot_hashes[slot] = hashes
        self._target_pages[slot] = self.target_pages(len(prompt))
        shared = self._shareable(prompt, hashes)
        for i in range(shared):
            self.lookups += 1
            self.hits += 1
            self._ref_page(self.prefix_map[hashes[i]])
            self.table[slot, i] = self.prefix_map[hashes[i]]
        if shared < len(hashes):
            self.lookups += 1                    # the probe that missed
        return shared * self.page_size

    # ------------------------------------------------------ allocation ----
    def _ref_page(self, pid: int):
        if self.refcount[pid] == 0:
            # Reviving a cached registered page: it leaves the LRU.
            self.cached.pop(pid, None)
        self.refcount[pid] += 1
        self.peak_resident = max(self.peak_resident, self.resident_pages)

    def _unref(self, pid: int, ops: StepOps):
        assert self.refcount[pid] > 0, f"double free of page {pid}"
        self.refcount[pid] -= 1
        if self.refcount[pid]:
            return
        if pid in self.page_hash:
            # Registered prefix pages park in the cached LRU (revivable).
            self.cached[pid] = self.page_hash[pid]
            self.cached.move_to_end(pid)
            return
        self.free.append(pid)
        if self.poison:
            ops.poisons.append(pid)

    def _alloc(self, ops: StepOps, *, wipe: bool) -> int:
        if self.free:
            pid = self.free.pop()
            if pid in ops.poisons:
                # Freed and reallocated within the same op batch: the
                # engine applies poisons after wipes, so a stale poison
                # would corrupt the fresh allocation — drop it (the wipe
                # clears the page either way).
                ops.poisons.remove(pid)
        elif self.cached:
            # Evict the least-recently-parked prefix page: it leaves the
            # prefix map for good (its bytes are about to be overwritten).
            pid, _digest = self.cached.popitem(last=False)
            self._unregister(pid)
        else:
            raise RuntimeError(
                "KV page pool exhausted mid-step: every page is mapped by "
                "an active request. Admission only reserves prompt pages; "
                "size the pool for decode growth (EngineConfig.num_pages "
                ">= max_batch * pages_per_seq + 1, the default) or lower "
                "max_batch.")
        self.refcount[pid] = 1
        if wipe:
            ops.wipes.append(pid)
        self.peak_resident = max(self.peak_resident, self.resident_pages)
        return pid

    def _unregister(self, pid: int) -> None:
        """Drop a page's prefix-map registration (its content is about to
        stop being canonical prompt bytes)."""
        digest = self.page_hash.pop(pid)
        if self.prefix_map.get(digest) == pid:
            del self.prefix_map[digest]

    def prepare(self, slot: int, start: int, width: int,
                ops: StepOps) -> None:
        """Make every page touched by the token positions
        ``[start, start + width)`` of ``slot`` privately writable before
        the device step: unmapped logical pages allocate (and wipe);
        mapped pages that are shared (refcount > 1) or registered
        (immutable prefix content) copy-on-write. Accumulates the device
        work into ``ops`` and updates the host table.

        One COW case degrades gracefully instead of raising: when the
        page is ours alone (refcount 1) and only registered, and the pool
        has no spare page anywhere (free and cached both empty — e.g. a
        full-residency slot's decode wrapping the logical ring with the
        default ``num_pages`` sizing), the canonical is unregistered and
        the page written in place — exactly where the ring layout would
        wrap. Future prompts with that prefix simply re-prefill."""
        assert width > 0
        ps, npg = self.page_size, self.pages_per_seq
        for lp_abs in range(start // ps, (start + width - 1) // ps + 1):
            lp = lp_abs % npg
            pid = int(self.table[slot, lp])
            if pid < 0:
                self.table[slot, lp] = self._alloc(ops, wipe=True)
            elif self.refcount[pid] > 1 or pid in self.page_hash:
                if self.refcount[pid] == 1 and not self.free \
                        and not self.cached:
                    self._unregister(pid)     # write in place (wrap)
                    continue
                new = self._alloc(ops, wipe=False)
                ops.copies.append((pid, new))
                self.table[slot, lp] = new
                self._unref(pid, ops)

    def note_filled(self, slot: int, prompt, n_fed: int) -> None:
        """Register ``slot``'s fully written prompt pages into the prefix
        map (call after each engine step advances). Only exact, final
        content registers: wrapped prompts (longer than the logical ring)
        never do — their early pages were overwritten — and a page whose
        digest already has a canonical copy is left private rather than
        remapped."""
        prompt = np.asarray(prompt).reshape(-1)
        plen = len(prompt)
        if plen > self.pages_per_seq * self.page_size:
            return
        hashes = self._slot_hashes.get(slot)
        if hashes is None:
            hashes = self.page_hashes(prompt)
        full = min(n_fed, plen) // self.page_size
        # Decode growth wrapping the logical ring overwrites the early
        # pages in place (registered pages COW away first, but a private
        # unregistered page is legally rewritten): page i no longer holds
        # prompt content once the wrap reached it, so it must not enter
        # the prefix map.
        wrapped_through = ((n_fed - 1) // self.page_size
                           - self.pages_per_seq
                           if n_fed > self.pages_per_seq * self.page_size
                           else -1)
        for i in range(min(full, len(hashes))):
            if i <= wrapped_through:
                continue
            pid = int(self.table[slot, i])
            if pid < 0 or pid in self.page_hash:
                continue                        # unmapped / already known
            if hashes[i] in self.prefix_map:
                continue                        # another copy is canonical
            self.prefix_map[hashes[i]] = pid
            self.page_hash[pid] = hashes[i]

    def forget_submit(self, request_id: int) -> None:
        """Cancellation of a still-queued request: drop its memoized page
        digests and any :meth:`admissible` reservation — the matching
        :meth:`admit` will never run to consume them, and a dangling
        reservation would hold back capacity forever."""
        self._hash_memo.pop(request_id, None)
        self._pending.pop(request_id, None)

    def rollback(self, slot: int, committed: int, touched: int,
                 ops: StepOps) -> None:
        """Speculative rollback (DESIGN.md §14): a verify pass rejected a
        draft suffix, so the slot's committed content ends at fed count
        ``committed`` while this round's writes reached positions
        ``[0, touched)``. Unmap (and unref) every logical page WHOLLY
        beyond the committed content that the round touched — those hold
        only rejected-draft KV. The boundary page (partially committed)
        stays mapped: its stale tail entries carry future position
        stamps, which the causal mask excludes until the positions are
        legitimately rewritten (the same argument that makes the ring
        layout's rollback pure accounting).

        Only valid when the round did not wrap the logical ring
        (``touched <= pages_per_seq * page_size`` — the engine's spec
        guard): after a wrap, a "stale" logical page also holds the only
        copy of older in-window history and must not be dropped. Every
        page touched this round came out of :meth:`prepare` private and
        unregistered, so the unref frees it outright (COW guarantees a
        shared prefix page was never written in the first place)."""
        assert 0 <= committed <= touched
        assert touched <= self.pages_per_seq * self.page_size, \
            (touched, self.pages_per_seq * self.page_size)
        first_stale = pages_for(committed, self.page_size)
        for lp in range(first_stale, pages_for(touched, self.page_size)):
            pid = int(self.table[slot, lp])
            if pid >= 0:
                self._unref(pid, ops)
                self.table[slot, lp] = -1

    def release(self, slot: int, ops: StepOps) -> None:
        """Drop every page reference of a finished/evicted slot.
        Unregistered pages go back on the free list (poisoned in debug
        mode); registered prefix pages park in the cached LRU for future
        hits."""
        for lp in range(self.pages_per_seq):
            pid = int(self.table[slot, lp])
            if pid >= 0:
                self._unref(pid, ops)
            self.table[slot, lp] = -1
        self._target_pages.pop(slot, None)
        self._slot_hashes.pop(slot, None)

    # ----------------------------------------------------- observability --
    @property
    def prefix_hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def check(self) -> None:
        """Assert the allocator invariants (test hook): the free list,
        cached LRU and mapped set partition the non-null pages, and
        refcounts equal table reference counts. The invariants themselves
        live in the module-level :func:`invariant_violations` so the fuzz
        harness and the model checker share the exact same definition."""
        bad = invariant_violations(self)
        assert not bad, "; ".join(bad)
