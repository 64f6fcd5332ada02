"""RAB — Remapping Address Block (HERO's software-managed accelerator MMU),
adapted to serving as the *paged KV-cache translation layer*.

HERO's RAB translates PMCA virtual addresses to physical DRAM addresses via
a tiny, software-managed two-level TLB: a single-cycle fully-associative L1
and a multi-cycle set-associative, banked L2.  Misses are queued; the core
that missed sleeps; a handler walks the page table, configures a replacement
entry, and wakes the core (Vogel et al. [28-30]).

The serving adaptation: the "virtual address space" is the *logical token-page
space* of a serving request (SVM between the host scheduler and the model),
and "physical addresses" are slots in the paged KV pool consumed by
``kernels/paged_attention``.  The translation table the kernel reads (the
block table) is exactly HERO's RAB table; the miss path is on-demand page
allocation during decode; hit-under-miss, replacement, and the wake protocol
are preserved and observable through the event tracer (§3.4 reproduction).

This is a host-side state machine (the RAB is managed *in software* in HERO
too); the device-side consumer is the block-table array it maintains.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.tracing import EventType, TraceBuffer


@dataclasses.dataclass(frozen=True)
class RABConfig:
    l1_entries: int = 32          # Tab.1: 4..64
    l2_entries: int = 1024        # Tab.1: 0..2048
    l2_assoc: int = 32            # Tab.1: 16/32/64
    l2_banks: int = 4             # Tab.1: 1/2/4/8
    l1_lookup_cycles: int = 1     # single-cycle hit (§3.4a)
    l2_cycles_per_way: int = 1    # multi-cycle search (§3.4b)
    miss_handler_cycles: int = 50  # page-table walk cost model

    def __post_init__(self):
        assert self.l2_entries % max(self.l2_banks, 1) == 0
        sets = self.l2_entries // max(self.l2_assoc, 1)
        assert sets >= 1


class RABMiss(Exception):
    """Raised on a translation miss when no handler runs inline."""

    def __init__(self, vpage: int, requester: int):
        super().__init__(f"RAB miss vpage={vpage} requester={requester}")
        self.vpage = vpage
        self.requester = requester


class RAB:
    """Two-level software TLB with miss queue + wake list."""

    def __init__(self, cfg: RABConfig, tracer: Optional[TraceBuffer] = None):
        self.cfg = cfg
        self.l1: "OrderedDict[int, int]" = OrderedDict()   # vpage -> ppage, LRU
        n_sets = max(1, cfg.l2_entries // max(cfg.l2_assoc, 1))
        self.l2: List["OrderedDict[int, int]"] = [OrderedDict()
                                                  for _ in range(n_sets)]
        self.miss_queue: deque = deque()
        self.sleeping: Dict[int, int] = {}                 # requester -> vpage
        self.tracer = tracer
        self.stats = {"l1_hits": 0, "l2_hits": 0, "misses": 0,
                      "evictions_l1": 0, "evictions_l2": 0, "wakes": 0,
                      "cycles": 0}

    # ------------------------------------------------------------------ util
    def _trace(self, etype: EventType, a: int = 0, b: int = 0):
        if self.tracer is not None:
            self.tracer.record_host(etype, a, b)

    def _l2_set(self, vpage: int) -> "OrderedDict[int, int]":
        return self.l2[vpage % len(self.l2)]

    # ----------------------------------------------------------------- logic
    def lookup(self, vpage: int, requester: int = 0) -> Tuple[Optional[int], int]:
        """Translate vpage.  Returns (ppage | None, cycles).

        None means miss: the request was queued and the requester 'sleeps'
        (HERO: the core is clock-gated until the VMM handler wakes it).
        """
        cyc = self.cfg.l1_lookup_cycles
        if vpage in self.l1:
            self.l1.move_to_end(vpage)
            self.stats["l1_hits"] += 1
            self.stats["cycles"] += cyc
            self._trace(EventType.TLB_L1_HIT, requester, vpage)
            return self.l1[vpage], cyc

        s = self._l2_set(vpage)
        # multi-cycle associative search (§3.4b: L2 searched while L1 serves
        # other cores — hit-under-miss is possible because state is per-set)
        cyc += self.cfg.l2_cycles_per_way * max(1, min(len(s), self.cfg.l2_assoc))
        if vpage in s:
            ppage = s.pop(vpage)
            self.stats["l2_hits"] += 1
            self.stats["cycles"] += cyc
            self._promote_l1(vpage, ppage)
            self._trace(EventType.TLB_L2_HIT, requester, vpage)
            return ppage, cyc

        self.stats["misses"] += 1
        self.stats["cycles"] += cyc
        self.miss_queue.append((vpage, requester))
        self.sleeping[requester] = vpage
        self._trace(EventType.TLB_MISS, requester, vpage)
        self._trace(EventType.CORE_SLEEP, requester, vpage)
        return None, cyc

    def _promote_l1(self, vpage: int, ppage: int):
        if len(self.l1) >= self.cfg.l1_entries:
            old_v, old_p = self.l1.popitem(last=False)     # LRU
            self.stats["evictions_l1"] += 1
            self._insert_l2(old_v, old_p)
        self.l1[vpage] = ppage

    def _insert_l2(self, vpage: int, ppage: int):
        s = self._l2_set(vpage)
        if len(s) >= self.cfg.l2_assoc:
            s.popitem(last=False)
            self.stats["evictions_l2"] += 1
        s[vpage] = ppage

    def handle_misses(self, page_table: Dict[int, int]) -> List[int]:
        """VMM handler: walk `page_table`, configure entries, wake cores.

        Returns the requesters woken.  (HERO §2.2.4: handler dequeues the
        miss, walks the host page table, selects a replacement entry,
        configures it, and wakes the sleeping core.)
        """
        woken = []
        while self.miss_queue:
            vpage, requester = self.miss_queue.popleft()
            if vpage not in page_table:
                raise KeyError(f"page fault: vpage {vpage} unmapped")
            self.stats["cycles"] += self.cfg.miss_handler_cycles
            self._trace(EventType.MISS_HANDLED, requester, vpage)
            self._promote_l1(vpage, page_table[vpage])
            if self.sleeping.get(requester) == vpage:
                del self.sleeping[requester]
                self.stats["wakes"] += 1
                self._trace(EventType.CORE_WAKE, requester, vpage)
                woken.append(requester)
        return woken

    def invalidate(self, vpage: Optional[int] = None):
        if vpage is None:
            self.l1.clear()
            for s in self.l2:
                s.clear()
        else:
            self.l1.pop(vpage, None)
            self._l2_set(vpage).pop(vpage, None)

    def resident(self) -> Dict[int, int]:
        out = dict(self.l1)
        for s in self.l2:
            out.update(s)
        return out


# ===========================================================================
# Paged KV pool (the "physical memory" behind the RAB)
# ===========================================================================

class PagedKVPool:
    """Fixed pool of KV pages + per-sequence logical page tables, with
    shared-prefix caching and copy-on-write.

    The device-side consumable is ``block_table(seq_ids)``: an int32 array
    (B, max_pages) of physical page indices (the RAB table image the
    paged_attention kernel reads).  -1 marks unmapped logical pages.

    Page *sharing* reproduces HERO's central SVM property (§2.2, §3.4):
    because translation is software-managed, a physical page can be mapped
    into several logical address spaces at once and remapped or reclaimed
    without touching the data path.  Concretely:

    * every physical page carries a refcount (number of (seq, lpage)
      mappings pointing at it);
    * pages whose content is a pure prompt prefix are registered in a
      prefix index keyed by the exact token prefix they hold (a chain of
      token blocks; the key for logical page *i* is the token tuple up to
      the end of that page), so a later request with the same prefix maps
      the already-filled pages instead of re-prefilling them;
    * appending into a shared page triggers *copy-on-write* through the
      ordinary allocation path: a fresh page is mapped for the writer, the
      old refcount is decremented, and the engine is told to copy the page
      payload device-side (``drain_cow``);
    * a released page that is still prefix-indexed parks on a *cached-free*
      LRU list instead of the free list — reusable as a prefix hit until
      capacity pressure evicts it;
    * with ``spill_enabled`` (PR 8, the HERO SVM ladder), capacity pressure
      does not *lose* the entry: the key moves to a ``spilled`` side index
      and the page id + key are queued on ``pending_demote`` for the engine
      to park the payload in a host/disk backing tier.  An admission-time
      ``match_prefix_tiered`` hit on a spilled entry re-enters the device
      index via :meth:`adopt_spilled` (the engine promotes the payload
      back).  Every entry carries a stable ``key_ids`` id so demote /
      promote trace events chain per entry across its whole lifetime.
    """

    def __init__(self, num_pages: int, page_size: int, max_pages_per_seq: int,
                 rab: Optional[RAB] = None):
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_pages = max_pages_per_seq
        self.free = list(range(num_pages - 1, -1, -1))
        self.page_table: Dict[Tuple[int, int], int] = {}   # (seq, lpage) -> p
        self.seq_len: Dict[int, int] = {}
        self.reserved: Dict[int, int] = {}                 # seq -> pages held
        self.refcount: Dict[int, int] = {}                 # ppage -> mappings
        self.page_key: Dict[int, Tuple[int, ...]] = {}     # ppage -> prefix
        self.prefix_index: Dict[Tuple[int, ...], int] = {}  # prefix -> ppage
        self.cached_free: "OrderedDict[int, None]" = OrderedDict()  # LRU
        self.pending_cow: List[Tuple[int, int, int, int]] = []
        self.rab = rab
        # --- tiered spill state (engine drives the payload movement) ---
        self.spill_enabled = False
        self.spilled: Dict[Tuple[int, ...], int] = {}      # key -> entry id
        self.key_ids: Dict[Tuple[int, ...], int] = {}      # key -> stable id
        self._next_key_id = 0
        self.key_id_step = 1       # sharded pools interleave id namespaces
        self.pending_demote: List[Tuple[int, Tuple[int, ...]]] = []
        self.pending_spill_drop: List[Tuple[int, ...]] = []
        self.stats = {"prefix_hit_pages": 0, "prefix_hit_tokens": 0,
                      "cow": 0, "cache_evictions": 0, "swapped_out": 0,
                      "swapped_in": 0, "spec_trimmed_pages": 0,
                      "cache_demoted": 0, "cache_promoted": 0}

    # ------------------------------------------------------------ capacity --
    def available(self) -> int:
        """Pages obtainable right now (free + evictable cached) minus
        admission-time reservations."""
        return len(self.free) + len(self.cached_free) \
            - sum(self.reserved.values())

    def free_pages(self) -> int:
        """Pages not referenced by any live mapping (free + cached-free)."""
        return len(self.free) + len(self.cached_free)

    def can_alloc(self, n: int = 1) -> bool:
        return self.available() >= n

    def reserve(self, seq: int, n: int):
        """Hold ``n`` pages for ``seq`` so lazy mid-stream allocation can
        never fail after admission (chunked prefill allocates many pages per
        engine iteration; without the reservation, a later admit could eat
        pages this sequence still needs)."""
        if self.available() < n:
            raise MemoryError(f"cannot reserve {n} pages "
                              f"({self.available()} available)")
        self.reserved[seq] = self.reserved.get(seq, 0) + n

    def _take_page(self) -> int:
        """Pop a physical page: free list first, then evict the LRU
        cached-free page.  Without spill the evicted prefix-index entry is
        dropped; with spill the entry demotes — its key moves to the
        ``spilled`` index and ``(page, key)`` is queued so the engine parks
        the payload down-tier *before* anything overwrites the page."""
        if self.free:
            return self.free.pop()
        if self.cached_free:
            p, _ = self.cached_free.popitem(last=False)
            key = self.page_key.get(p)
            if self.spill_enabled and key is not None:
                del self.page_key[p]
                if self.prefix_index.get(key) == p:
                    del self.prefix_index[key]
                self.spilled[key] = self.key_ids[key]
                self.pending_demote.append((p, key))
                self.stats["cache_demoted"] += 1
            else:
                self._unregister(p)
            self.stats["cache_evictions"] += 1
            return p
        raise MemoryError("KV pool exhausted")

    def _draw_reservation(self, seq: int):
        """Charge one page to ``seq``: draw down its reservation, or — when
        none remains — take from the unreserved residue.  An unreserved
        allocation may not eat into pages other sequences reserved at
        admission; that would break the never-fail-after-admission
        guarantee ``reserve`` documents."""
        if self.reserved.get(seq, 0) > 0:
            self.reserved[seq] -= 1
        elif self.available() < 1:
            raise MemoryError("KV pool exhausted (remaining pages reserved)")

    # ---------------------------------------------------------- alloc/free --
    def alloc_page(self, seq: int, lpage: int) -> int:
        self._draw_reservation(seq)
        p = self._take_page()
        self.page_table[(seq, lpage)] = p
        self.refcount[p] = 1
        self._invalidate(seq, lpage)
        return p

    def share_page(self, seq: int, lpage: int, ppage: int):
        """Map an already-filled physical page into ``seq``'s table (a
        prefix-cache hit): RAB entry installed lazily on first translate,
        refcount bumped, no data movement."""
        assert (seq, lpage) not in self.page_table
        if ppage in self.cached_free:      # revive a parked page
            del self.cached_free[ppage]
        self.page_table[(seq, lpage)] = ppage
        self.refcount[ppage] = self.refcount.get(ppage, 0) + 1
        self.stats["prefix_hit_pages"] += 1
        self._invalidate(seq, lpage)

    def unmap_page(self, seq: int, lpage: int):
        """Drop one mapping; the page is freed (or parked on the cached-free
        list if still prefix-indexed) when its last reference goes."""
        p = self.page_table.pop((seq, lpage))
        self.refcount[p] -= 1
        if self.refcount[p] == 0:
            del self.refcount[p]
            if p in self.page_key:
                self.cached_free[p] = None
                self.cached_free.move_to_end(p)
            else:
                self.free.append(p)
        self._invalidate(seq, lpage)

    def append_token(self, seq: int) -> Tuple[int, int]:
        """Account one new token; allocates a page at page boundaries.

        Appending into a *shared* page (refcount > 1) copy-on-writes it:
        the writer gets a private page through the normal allocation path
        and the (src, dst) payload copy is queued on ``pending_cow`` for
        the engine to apply device-side.  Appending in place into a page
        that is prefix-indexed un-registers it (its content is about to
        diverge from the indexed prefix).

        Returns (lpage, slot_in_page)."""
        t = self.seq_len.get(seq, 0)
        lpage, slot = divmod(t, self.page_size)
        if slot == 0:
            self.alloc_page(seq, lpage)
        else:
            p = self.page_table[(seq, lpage)]
            if self.refcount[p] > 1:
                self._cow(seq, lpage, p)
            elif p in self.page_key:
                self._unregister(p)
        self.seq_len[seq] = t + 1
        return lpage, slot

    def _cow(self, seq: int, lpage: int, src: int) -> int:
        """Copy-on-write ``(seq, lpage)`` off shared page ``src``."""
        self._draw_reservation(seq)
        dst = self._take_page()
        self.refcount[src] -= 1
        self.refcount[dst] = 1
        self.page_table[(seq, lpage)] = dst
        self.pending_cow.append((seq, lpage, src, dst))
        self.stats["cow"] += 1
        self._invalidate(seq, lpage)
        return dst

    def drain_cow(self) -> List[Tuple[int, int, int, int]]:
        """Hand the queued (seq, lpage, src, dst) payload copies to the
        engine (which owns the device-side KV arrays) and clear the queue."""
        out, self.pending_cow = self.pending_cow, []
        return out

    def trim(self, seq: int, new_len: int) -> int:
        """Roll ``seq`` back to ``new_len`` tokens (speculative-decode
        rollback): pages wholly beyond the kept length are unmapped through
        the ordinary release path — a trimmed page that other sequences
        still share merely drops this mapping's refcount, and one that is
        prefix-indexed parks on the cached-free list — and every page this
        trim *frees back* is re-credited to ``seq``'s reservation, because
        the lifetime page budget reserved at admission still has to cover
        re-appending the rolled-back positions.  Returns pages unmapped.

        Only whole pages are unmapped; a kept page whose tail slots held
        rejected drafts keeps them in place — they sit beyond ``seq_len``,
        the attention kernels mask by length, and the next append
        overwrites them (same contract as the trash-page scatter)."""
        old = self.seq_len.get(seq, 0)
        assert 0 <= new_len <= old, (seq, new_len, old)
        if new_len == old:
            return 0
        keep = -(-new_len // self.page_size) if new_len else 0
        freed = 0
        for lp in range(keep, -(-old // self.page_size)):
            if (seq, lp) in self.page_table:
                self.unmap_page(seq, lp)
                freed += 1
        if new_len:
            self.seq_len[seq] = new_len
        else:
            self.seq_len.pop(seq, None)
        if freed:
            self.reserved[seq] = self.reserved.get(seq, 0) + freed
        self.stats["spec_trimmed_pages"] += freed
        return freed

    def release(self, seq: int):
        for (s, lp) in [k for k in self.page_table if k[0] == seq]:
            self.unmap_page(s, lp)
        self.seq_len.pop(seq, None)
        self.reserved.pop(seq, None)

    def seq_pages(self, seq: int) -> List[Tuple[int, int]]:
        """Sorted [(lpage, ppage)] currently mapped for ``seq``."""
        return sorted((lp, p) for (s, lp), p in self.page_table.items()
                      if s == seq)

    # ------------------------------------------------------- prefix cache --
    def prefix_key(self, tokens, lpage: int) -> Tuple[int, ...]:
        """Index key for logical page ``lpage`` of a prompt: the exact token
        prefix up to the end of that page (chained full blocks; the final
        partial block keys the whole prompt)."""
        return tuple(tokens[:min((lpage + 1) * self.page_size, len(tokens))])

    def register_page(self, seq: int, lpage: int, tokens):
        """Publish ``seq``'s page ``lpage`` (whose KV holds exactly the
        prompt prefix ``tokens[:end-of-page]``) in the prefix index.  A
        freshly prefilled on-device copy supersedes a spilled one: the key
        is re-registered here and queued on ``pending_spill_drop`` so the
        engine releases the stale down-tier payload (an entry is resident
        in exactly one tier)."""
        p = self.page_table[(seq, lpage)]
        key = self.prefix_key(tokens, lpage)
        if key in self.prefix_index or p in self.page_key:
            return
        if key not in self.key_ids:
            self.key_ids[key] = self._next_key_id
            self._next_key_id += self.key_id_step
        self.prefix_index[key] = p
        self.page_key[p] = key
        if key in self.spilled:
            del self.spilled[key]
            self.pending_spill_drop.append(key)

    def _unregister(self, p: int):
        key = self.page_key.pop(p, None)
        if key is not None and self.prefix_index.get(key) == p:
            del self.prefix_index[key]

    def match_prefix(self, tokens) -> Tuple[List[int], int]:
        """Longest cached prefix of ``tokens``: ([physical pages], tokens
        covered).  Full pages chain block-by-block; a final partial page
        matches only on the exact whole-prompt key."""
        pages: List[int] = []
        n = 0
        while n < len(tokens):
            key = self.prefix_key(tokens, len(pages))
            p = self.prefix_index.get(key)
            if p is None:
                break
            pages.append(p)
            n = min(n + self.page_size, len(tokens))
        return pages, n

    def match_prefix_tiered(self, tokens
                            ) -> Tuple[List[Tuple[str, object]], int]:
        """Longest cached prefix of ``tokens`` across *all* tiers:
        ``([("device", ppage) | ("spilled", key)], tokens covered)``.
        Device-resident pages chain seamlessly with spilled entries — a
        prefix can be half on-device, half parked down-tier; the engine
        promotes the spilled half at admission."""
        entries: List[Tuple[str, object]] = []
        n = 0
        while n < len(tokens):
            key = self.prefix_key(tokens, len(entries))
            p = self.prefix_index.get(key)
            if p is not None:
                entries.append(("device", p))
            elif key in self.spilled:
                entries.append(("spilled", key))
            else:
                break
            n = min(n + self.page_size, len(tokens))
        return entries, n

    def adopt_spilled(self, seq: int, lpage: int, key: Tuple[int, ...]) -> int:
        """Promote a spilled entry back on-device for ``seq``: draw a fresh
        physical page through the ordinary (reservation-charged) allocation
        path, map it at ``lpage``, and re-register the key on it.  The
        engine owns uploading the fetched payload into the returned page."""
        assert key in self.spilled, key
        del self.spilled[key]
        p = self.alloc_page(seq, lpage)
        self.prefix_index[key] = p
        self.page_key[p] = key
        self.stats["cache_promoted"] += 1
        self.stats["prefix_hit_pages"] += 1
        return p

    def drop_spilled(self, key: Tuple[int, ...]):
        """Forget a spilled entry (its backing payload was lost or its
        fetch faulted unrecoverably) — the prefix is simply no longer
        cached."""
        self.spilled.pop(key, None)

    def drain_demotions(self) -> List[Tuple[int, Tuple[int, ...]]]:
        """Hand queued (ppage, key) demotions to the engine — it must pull
        the page payloads D2H and park them *before* the step that reuses
        those pages scatters over them — and clear the queue."""
        out, self.pending_demote = self.pending_demote, []
        return out

    def drain_spill_drops(self) -> List[Tuple[int, ...]]:
        """Keys whose spilled payload was superseded by an on-device
        re-registration; the engine drops them from the backing store."""
        out, self.pending_spill_drop = self.pending_spill_drop, []
        return out

    # ---------------------------------------------------------- translate --
    def _invalidate(self, seq: int, lpage: int):
        if self.rab is not None:
            self.rab.invalidate(self._vpage(seq, lpage))

    # ---------------------------------------------------------- invariants --
    def check_invariants(self):
        """Assert the pool's conservation laws (used by the property suite):

        * refcount conservation: sum of refcounts == number of mappings;
        * free / cached-free / referenced partitions the physical pool
          exactly (no double-free, no leak);
        * a page reachable from two sequences has refcount > 1;
        * prefix index and page_key are a consistent bijection;
        * reservations never exceed obtainable pages.
        """
        mapped = list(self.page_table.values())
        assert sum(self.refcount.values()) == len(mapped), \
            "refcount conservation violated"
        per_page: Dict[int, int] = {}
        for p in mapped:
            per_page[p] = per_page.get(p, 0) + 1
        assert per_page == self.refcount, "refcount drifted from mappings"
        owners: Dict[int, set] = {}
        for (s, _lp), p in self.page_table.items():
            owners.setdefault(p, set()).add(s)
        for p, ss in owners.items():
            assert len(ss) <= self.refcount[p], \
                f"page {p} reachable from {len(ss)} seqs, refcount " \
                f"{self.refcount[p]}"
        pool = sorted(self.free) + sorted(self.cached_free) \
            + sorted(self.refcount)
        assert sorted(pool) == list(range(self.num_pages)), \
            f"free/cached/referenced does not partition the pool: {pool}"
        assert len(set(self.free)) == len(self.free), "double-free"
        assert not (set(self.cached_free) & set(self.refcount))
        for key, p in self.prefix_index.items():
            assert self.page_key.get(p) == key, "index/page_key mismatch"
        for p in self.page_key:
            assert p in self.refcount or p in self.cached_free, \
                f"indexed page {p} is on the raw free list"
        assert not (set(self.spilled) & set(self.prefix_index)), \
            "entry resident in two tiers (device-indexed AND spilled)"
        for key, eid in self.spilled.items():
            assert self.key_ids.get(key) == eid, \
                f"spilled entry {key} lost its stable id"
        assert self.available() >= 0, "reservations exceed capacity"
        for (s, lp) in self.page_table:
            n = self.seq_len.get(s, 0)
            assert n > 0 and lp < -(-n // self.page_size), \
                f"mapping ({s},{lp}) beyond seq_len {n}"

    def translate(self, seq: int, lpage: int) -> int:
        """RAB-mediated translation (miss -> handler walk -> retry)."""
        if self.rab is None:
            return self.page_table[(seq, lpage)]
        key = self._vpage(seq, lpage)
        ppage, _ = self.rab.lookup(key, requester=seq)
        if ppage is None:
            flat = {self._vpage(s, lp): p
                    for (s, lp), p in self.page_table.items()}
            self.rab.handle_misses(flat)
            ppage, _ = self.rab.lookup(key, requester=seq)
            assert ppage is not None
        return ppage

    def _vpage(self, seq: int, lpage: int) -> int:
        return seq * self.max_pages + lpage

    def block_table(self, seq_ids: List[int]) -> np.ndarray:
        """(B, max_pages) int32 physical page indices; -1 = unmapped."""
        bt = np.full((len(seq_ids), self.max_pages), -1, np.int32)
        for i, s in enumerate(seq_ids):
            n = self.seq_len.get(s, 0)
            for lp in range(-(-n // self.page_size) if n else 0):
                bt[i, lp] = self.translate(s, lp)
        return bt

    def lengths(self, seq_ids: List[int]) -> np.ndarray:
        return np.array([self.seq_len.get(s, 0) for s in seq_ids], np.int32)


# ===========================================================================
# Multi-cluster pool: C per-cluster pools, each behind its own RAB
# ===========================================================================

class ClusterPagedPool:
    """C independent ``PagedKVPool`` shards, one per PMCA cluster.

    HERO §2.2: every cluster sits behind its own RAB port into the shared
    SVM fabric.  The serving adaptation gives every cluster its own page
    shard (cluster-local free list, refcounts and prefix index) and its own
    ``RAB`` instance; a sequence lives entirely inside one cluster, so its
    block table holds *cluster-local* physical page ids and the owning
    cluster id rides alongside (``cluster_of``).  The global physical page
    namespace is ``cluster * (num_pages + 1) + local`` — the ``+ 1``
    accounts for each cluster's trash page in the fused device slab — and
    ``check_invariants`` proves the shards partition it (no page owned by
    two clusters).
    """

    def __init__(self, clusters: int, num_pages: int, page_size: int,
                 max_pages_per_seq: int, rab_cfg: Optional[RABConfig] = None,
                 tracer: Optional[TraceBuffer] = None):
        assert clusters >= 1
        self.clusters = clusters
        self.num_pages = num_pages            # per cluster
        self.page_size = page_size
        self.max_pages = max_pages_per_seq
        self.rabs = [RAB(rab_cfg or RABConfig(), tracer)
                     for _ in range(clusters)]
        self.pools = [PagedKVPool(num_pages, page_size, max_pages_per_seq,
                                  rab) for rab in self.rabs]
        for c, pool in enumerate(self.pools):
            # interleaved prefix-entry id namespaces: demote/promote trace
            # events stay globally unambiguous across cluster shards
            pool._next_key_id = c
            pool.key_id_step = clusters
        self.cluster_of: Dict[int, int] = {}          # seq -> cluster

    # ------------------------------------------------------------ routing --
    def place(self, seq: int, cluster: int):
        assert 0 <= cluster < self.clusters
        prev = self.cluster_of.get(seq)
        assert prev is None or prev == cluster, \
            f"seq {seq} already placed on cluster {prev}"
        self.cluster_of[seq] = cluster

    def forget(self, seq: int):
        self.cluster_of.pop(seq, None)

    def pool_for(self, seq: int) -> PagedKVPool:
        return self.pools[self.cluster_of[seq]]

    def least_loaded(self) -> int:
        """Cluster with the most obtainable pages (ties: lowest id) —
        HERO-style least-loaded placement."""
        return max(range(self.clusters),
                   key=lambda c: (self.pools[c].available(), -c))

    # ----------------------------------------------------------- global ids --
    def global_page(self, cluster: int, local: int) -> int:
        """Local physical page -> global slab index (incl. trash pages)."""
        return cluster * (self.num_pages + 1) + local

    def occupancy(self) -> List[int]:
        """Pages referenced by live mappings, per cluster."""
        return [p.num_pages - p.free_pages() for p in self.pools]

    # ------------------------------------------------------------- stats --
    @property
    def stats(self) -> Dict[int, int]:
        """Aggregated per-cluster pool stats (same keys as PagedKVPool)."""
        out: Dict = {}
        for p in self.pools:
            for k, v in p.stats.items():
                out[k] = out.get(k, 0) + v
        return out

    def free_pages(self) -> int:
        return sum(p.free_pages() for p in self.pools)

    def available(self) -> int:
        return sum(p.available() for p in self.pools)

    # ---------------------------------------------------------- invariants --
    def check_invariants(self):
        """Per-cluster conservation laws plus the cross-cluster partition:

        * every cluster pool individually satisfies its invariants;
        * a sequence is resident in exactly the cluster ``cluster_of``
          says, and in no other cluster's page table or seq_len map;
        * the global page namespace is partitioned — translating every
          cluster's pages to global ids yields disjoint sets that exactly
          tile ``clusters * num_pages`` (no page owned by two clusters).
        """
        seen_global: Dict[int, int] = {}
        for c, pool in enumerate(self.pools):
            pool.check_invariants()
            for s in set(pool.seq_len) | {k[0] for k in pool.page_table}:
                assert self.cluster_of.get(s) == c, \
                    f"seq {s} resident on cluster {c} but routed to " \
                    f"{self.cluster_of.get(s)}"
            for local in (set(pool.free) | set(pool.cached_free)
                          | set(pool.refcount)):
                g = self.global_page(c, local)
                assert g not in seen_global, \
                    f"global page {g} owned by clusters " \
                    f"{seen_global[g]} and {c}"
                seen_global[g] = c
        expect = {self.global_page(c, p) for c in range(self.clusters)
                  for p in range(self.num_pages)}
        assert set(seen_global) == expect, \
            "cluster shards do not partition the global page namespace"
