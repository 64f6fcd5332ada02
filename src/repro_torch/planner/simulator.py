"""Deterministic discrete-event simulator of the paged serving engine.

The planner's centerpiece: a token-free replica of the scheduler state
machine in ``runtime/server.py`` / ``runtime/sharded_server.py`` /
``runtime/frontdoor.py``.  It admits, chunks, decodes, speculates,
preempts nothing it should not, and charges per-iteration time on a
real :class:`~repro_torch.runtime.clock.VirtualClock` — but never touches a
model, a device array or a wall clock, so simulating a config costs
microseconds instead of an engine run.

What is mirrored EXACTLY (same branch structure as the engine):

* the front-door serve loop — submit due arrivals, one ``step()``,
  charge ``iteration time`` only when an iteration ran, stamp
  first-token/finish at the post-charge clock, jump to the next arrival
  when idle;
* ``step()`` — admission before the iteration, lane-ordered active set,
  policy-planned prefill chunking with the forced-progress rule, one
  token per decode lane, first token emitted in the same iteration the
  final prompt chunk is fed, finish frees the lane within the
  iteration;
* admission — FIFO within priority, page-fit against
  ``available() >= need + cached_hits`` with reservation accounting,
  the CoW donor budget, cache-affine least-loaded cluster scoring
  ``(usable, available, -cluster)``, and the no-hit fallback plan;
* the page pool — lazy per-token page allocation, full-prompt-page
  prefix registration, refcounted sharing, cached-free LRU parking and
  eviction, host/disk demotion with capacity caps, and asynchronous
  promotion latency (``promote_latency_s * ceil(pages /
  prefetch_depth)``) gating the admitted lane on the virtual clock.

What is a MODEL (documented divergences from the engine):

* speculation — the drafter is assumed to always have a proposal and
  to hit ``WorkloadSpec.spec_acceptance_rate`` via a deterministic
  per-lane acceptance accumulator; the real n-gram drafter proposes
  only on history matches, so predicted speculative iteration counts
  are approximate (reported, not gated);
* priorities — bench workloads are single-priority, where the engine
  never preempts; the simulator models that case (a head that does not
  fit waits) and does not model cross-priority preemption.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.runtime.api import EngineConfig, FINISH_LENGTH
from repro_torch.runtime.clock import VirtualClock
from repro_torch.runtime.frontdoor import (
    GreedyChunkPolicy, RequestRecord, latency_report,
)
from repro_torch.planner.workload import SampledRequest

__all__ = ["IterationStats", "simulate", "SimReport"]


# ===========================================================================
# iteration cost interface
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class IterationStats:
    """What one engine iteration did — the cost model's pricing input."""
    prefill_tokens: int         # prompt tokens fed this iteration
    decode_lanes: int           # lanes that advanced one token
    spec_tokens: int            # draft+bonus positions verified
    context_tokens: int         # KV tokens resident across active lanes
    active_clusters: int


#: seconds charged for one iteration
IterationCost = Callable[[IterationStats], float]


# ===========================================================================
# pool / tier model
# ===========================================================================

class _Page:
    __slots__ = ("key", "refs")

    def __init__(self):
        self.key: Optional[tuple] = None
        self.refs = 0


class _SimTiers:
    """Host -> disk cache spill, LRU per tier, capacity-capped."""

    def __init__(self, host_pages: int, disk_pages: int):
        self.host_cap = host_pages
        self.disk_cap = disk_pages
        self.host: "OrderedDict[tuple, None]" = OrderedDict()
        self.disk: "OrderedDict[tuple, None]" = OrderedDict()
        self.dropped = 0

    def __contains__(self, key) -> bool:
        return key in self.host or key in self.disk

    def tier_of(self, key) -> str:
        return "host" if key in self.host else "disk"

    def demote(self, key):
        if len(self.host) >= self.host_cap:
            old, _ = self.host.popitem(last=False)
            if self.disk_cap and len(self.disk) < self.disk_cap:
                self.disk[old] = None
            elif self.disk_cap:
                self.disk.popitem(last=False)
                self.disk[old] = None
                self.dropped += 1
            else:
                self.dropped += 1
        self.host[key] = None

    def promote(self, key) -> str:
        tier = self.tier_of(key)
        if key in self.host:
            del self.host[key]
        else:
            del self.disk[key]
        return tier


class _SimPool:
    """Refcounted page pool: free counter + cached-free LRU + prefix
    index, with admission-time reservations — the allocator semantics
    of ``core.rab.PagedKVPool`` without payloads."""

    def __init__(self, num_pages: int, page_size: int,
                 tiers: Optional[_SimTiers]):
        self.num_pages = num_pages
        self.page_size = page_size
        self.free = num_pages
        self.cached_free: "OrderedDict[tuple, _Page]" = OrderedDict()
        self.index: Dict[tuple, _Page] = {}
        self.reserved: Dict[int, int] = {}
        self.tiers = tiers
        self.stats = {"evictions": 0, "demoted": 0, "promoted": 0,
                      "cow": 0, "prefix_hit_tokens": 0}

    def available(self) -> int:
        return self.free + len(self.cached_free) \
            - sum(self.reserved.values())

    def occupancy(self) -> int:
        return self.num_pages - self.free - len(self.cached_free)

    def _take_page(self) -> _Page:
        if self.free > 0:
            self.free -= 1
            return _Page()
        if self.cached_free:
            key, pg = self.cached_free.popitem(last=False)
            del self.index[key]
            if self.tiers is not None:
                self.tiers.demote(key)
                self.stats["demoted"] += 1
            self.stats["evictions"] += 1
            pg.key = None
            pg.refs = 0
            return pg
        raise MemoryError("sim KV pool exhausted")

    def _draw_reservation(self, rid: int):
        if self.reserved.get(rid, 0) > 0:
            self.reserved[rid] -= 1
        elif self.available() < 1:
            raise MemoryError("sim KV pool exhausted (reserved)")

    def alloc_page(self, rid: int) -> _Page:
        self._draw_reservation(rid)
        pg = self._take_page()
        pg.refs = 1
        return pg

    def share_page(self, key: tuple) -> _Page:
        pg = self.index[key]
        if key in self.cached_free:
            del self.cached_free[key]
        pg.refs += 1
        return pg

    def drop_ref(self, pg: _Page):
        pg.refs -= 1
        if pg.refs == 0:
            if pg.key is not None and self.index.get(pg.key) is pg:
                self.cached_free[pg.key] = pg
                self.cached_free.move_to_end(pg.key)
            else:
                self.free += 1

    def release(self, rid: int, pages: List[_Page]):
        for pg in pages:
            self.drop_ref(pg)
        self.reserved.pop(rid, None)

    def register(self, pg: _Page, key: tuple):
        if pg.key is None and key not in self.index and \
                (self.tiers is None or key not in self.tiers):
            pg.key = key
            self.index[key] = pg

    def unregister(self, pg: _Page):
        if pg.key is not None and self.index.get(pg.key) is pg:
            del self.index[pg.key]
        pg.key = None

    def match_prefix(self, page_keys: Sequence[tuple]
                     ) -> List[Tuple[str, tuple]]:
        hits: List[Tuple[str, tuple]] = []
        for key in page_keys:
            if key in self.index:
                hits.append(("device", key))
            elif self.tiers is not None and key in self.tiers:
                hits.append(("spilled", key))
            else:
                break
        return hits


# ===========================================================================
# sequence state
# ===========================================================================

class _SimSeq:
    def __init__(self, req: SampledRequest, arrival: int, page_size: int):
        self.rid = req.rid
        self.prompt = req.prompt
        self.plen = len(req.prompt)
        self.max_new = req.max_new
        self.arrival = arrival
        ps = page_size
        self.page_keys = [tuple(req.prompt[:(i + 1) * ps])
                          for i in range(self.plen // ps)]
        self.fed = 0
        self.out = 0
        self.written = 0
        self.lane = -1
        self.cluster = -1
        self.pages: List[_Page] = []
        self.promoting = False
        self.promote_due = 0.0
        self.done = False
        self.prefix_hit_tokens = 0
        self.spec_k_cur = 0
        self.spec_credit = 0.0

    @property
    def remaining(self) -> int:
        return self.max_new - self.out


# ===========================================================================
# the engine replica
# ===========================================================================

class _SimEngine:
    def __init__(self, engine: EngineConfig, *, spec_acceptance: float):
        cache = engine.cache
        self.clusters = engine.clusters
        self.lanes_per_cluster = engine.max_lanes
        self.max_lanes = engine.max_lanes * engine.clusters
        self.chunk = engine.chunk
        self.page_size = cache.page_size
        self.enable_prefix_cache = cache.enable_prefix_cache
        self.spec_k = engine.spec_k
        self.spec_acceptance = spec_acceptance
        self.policy = engine.scheduler_policy or GreedyChunkPolicy()
        self.prefetch_depth = cache.prefetch_depth
        self.promote_latency_s = cache.promote_latency_s
        tiers = None
        if cache.host_tier_pages > 0:
            tiers = [_SimTiers(cache.host_tier_pages, cache.disk_tier_pages)
                     for _ in range(self.clusters)]
        self.tiers = tiers
        self.pools = [_SimPool(cache.num_pages, cache.page_size,
                               tiers[c] if tiers else None)
                      for c in range(self.clusters)]
        self.lanes: List[Optional[_SimSeq]] = [None] * self.max_lanes
        self.queue: List[_SimSeq] = []
        self.clock = VirtualClock()
        self.iterations = 0
        self.peak_pages = [0] * self.clusters
        self.prefill_tokens = 0
        self.generated_tokens = 0
        self.hit_pages = {"device": 0, "host": 0, "disk": 0}
        self.spec_iterations = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.iteration_log: List[IterationStats] = []
        self._events: List[Tuple[int, int, Optional[str]]] = []
        self._arrival = 0

    # ----------------------------------------------------------- lifecycle --
    def submit(self, req: SampledRequest):
        seq = _SimSeq(req, self._arrival, self.page_size)
        self._arrival += 1
        if self.spec_k:
            seq.spec_k_cur = self.spec_k
        self.queue.append(seq)

    def _pages_needed(self, seq: _SimSeq) -> int:
        total = seq.plen + seq.max_new - 1
        return -(-total // self.page_size)

    def _cow_budget(self, seq: _SimSeq) -> int:
        return 1 if (self.enable_prefix_cache and seq.max_new > 1
                     and seq.plen % self.page_size) else 0

    # ------------------------------------------------------------ admission --
    def _plan(self, seq: _SimSeq, cluster: int) -> dict:
        pool = self.pools[cluster]
        total = self._pages_needed(seq) + self._cow_budget(seq)
        ps = self.page_size
        usable, hits = 0, []
        if self.enable_prefix_cache and seq.plen > 1:
            entries = pool.match_prefix(seq.page_keys)
            usable = min(len(entries) * ps, seq.plen - 1)
            hits = entries[:-(-usable // ps)] if usable else []
        full = usable // ps
        dev_full = sum(1 for i, (kind, _k) in enumerate(hits)
                       if kind == "device" and i < full)
        need = total - dev_full
        cached = sum(1 for kind, k in hits
                     if kind == "device" and k in pool.cached_free)
        plan = {"hits": hits, "usable": usable, "need": need,
                "cached_hits": cached, "cluster": cluster}
        if hits and not self._fits(plan):
            fallback = {"hits": [], "usable": 0, "need": total,
                        "cached_hits": 0, "cluster": cluster}
            if self._fits(fallback):
                return fallback
        return plan

    def _fits(self, plan: dict) -> bool:
        return self.pools[plan["cluster"]].available() >= \
            plan["need"] + plan["cached_hits"]

    def _free_lane(self, cluster: int) -> Optional[int]:
        lo = cluster * self.lanes_per_cluster
        for i in range(lo, lo + self.lanes_per_cluster):
            if self.lanes[i] is None:
                return i
        return None

    def _admit(self):
        while self.queue:
            self.queue.sort(key=lambda r: r.arrival)
            head = self.queue[0]
            best = None
            for c in range(self.clusters):
                lane = self._free_lane(c)
                if lane is None:
                    continue
                plan = self._plan(head, c)
                if not self._fits(plan):
                    continue
                score = (plan["usable"], self.pools[c].available(), -c)
                if best is None or score > best[0]:
                    best = (score, lane, plan)
            if best is None:
                break           # single-priority: no preemption, wait
            self.queue.pop(0)
            self._place(head, best[1], best[2])

    def _place(self, seq: _SimSeq, lane: int, plan: dict):
        c = plan["cluster"]
        pool = self.pools[c]
        seq.lane = lane
        seq.cluster = c
        self.lanes[lane] = seq
        if plan["need"] > 0:
            pool.reserved[seq.rid] = \
                pool.reserved.get(seq.rid, 0) + plan["need"]
        if plan["usable"]:
            promo = 0
            for kind, key in plan["hits"]:
                if kind == "device":
                    seq.pages.append(pool.share_page(key))
                    self.hit_pages["device"] += 1
                else:
                    tier = pool.tiers.promote(key)
                    pg = pool.alloc_page(seq.rid)
                    pg.key = key
                    pool.index[key] = pg
                    seq.pages.append(pg)
                    self.hit_pages[tier] += 1
                    pool.stats["promoted"] += 1
                    promo += 1
            seq.fed = plan["usable"]
            seq.written = plan["usable"]
            seq.prefix_hit_tokens = plan["usable"]
            pool.stats["prefix_hit_tokens"] += plan["usable"]
            if promo and self.promote_latency_s > 0:
                seq.promoting = True
                seq.promote_due = self.clock.now() + \
                    self.promote_latency_s * (-(-promo //
                                                self.prefetch_depth))

    def _land_promotions(self):
        now = self.clock.now()
        for seq in self.lanes:
            if seq is not None and seq.promoting and \
                    seq.promote_due <= now:
                seq.promoting = False

    def _runnable(self) -> List[_SimSeq]:
        return [r for r in self.lanes if r is not None and not r.promoting]

    def _promoting(self) -> List[_SimSeq]:
        return [r for r in self.lanes if r is not None and r.promoting]

    # ----------------------------------------------------------- appending --
    def _append_tokens(self, seq: _SimSeq, n: int):
        """Account ``n`` KV writes, page-granular, CoW/unregister-aware."""
        pool = self.pools[seq.cluster]
        ps = self.page_size
        for _ in range(n):
            lpage = seq.written // ps
            if lpage == len(seq.pages):
                seq.pages.append(pool.alloc_page(seq.rid))
            else:
                pg = seq.pages[lpage]
                if pg.refs > 1:
                    # appending into a shared page: copy-on-write
                    new = pool.alloc_page(seq.rid)
                    pool.drop_ref(pg)
                    seq.pages[lpage] = new
                    pool.stats["cow"] += 1
                elif pg.key is not None:
                    pool.unregister(pg)   # content diverges from index
            seq.written += 1

    def _register_prompt_pages(self, seq: _SimSeq):
        if not self.enable_prefix_cache:
            return
        pool = self.pools[seq.cluster]
        ps = self.page_size
        full = min(seq.fed, seq.plen) // ps
        for i in range(full):
            pool.register(seq.pages[i], seq.page_keys[i])

    def _emit(self, seq: _SimSeq, n: int) -> Optional[str]:
        seq.out += n
        self.generated_tokens += n
        reason = FINISH_LENGTH if seq.out >= seq.max_new else None
        self._events.append((seq.rid, n, reason))
        return reason

    def _finish(self, seq: _SimSeq):
        seq.done = True
        self.pools[seq.cluster].release(seq.rid, seq.pages)
        self.lanes[seq.lane] = None

    # ----------------------------------------------------------- iteration --
    def _spec_wanted(self, active: List[_SimSeq]) -> bool:
        return bool(self.spec_k) and not self.queue and \
            all(r.fed >= r.plen for r in active)

    def _spec_iteration(self, active: List[_SimSeq]) -> bool:
        """Expected-acceptance speculative verify; returns False when no
        lane has draft headroom (the engine falls back to plain decode)."""
        lanes_k = [(r, min(r.spec_k_cur, r.remaining - 1, self.spec_k))
                   for r in active]
        if all(k <= 0 for _r, k in lanes_k):
            return False
        self.spec_iterations += 1
        n_spec = 0
        n_ctx = sum(r.written for r in active)
        for r, k in lanes_k:
            if k <= 0:
                adv = 1
            else:
                self.spec_proposed += k
                r.spec_credit += self.spec_acceptance * k
                acc = min(k, int(r.spec_credit))
                r.spec_credit -= acc
                self.spec_accepted += acc
                adv = acc + 1
                if acc == k:
                    r.spec_k_cur += 1
                elif acc == 0:
                    r.spec_k_cur = max(1, r.spec_k_cur // 2)
                n_spec += k + 1
            self._append_tokens(r, adv)
            reason = self._emit(r, adv)
            if reason:
                self._finish(r)
        self.iteration_log.append(IterationStats(
            prefill_tokens=0, decode_lanes=len(active),
            spec_tokens=n_spec, context_tokens=n_ctx,
            active_clusters=len({r.cluster for r in active})))
        return True

    def _update_peaks(self, occ0: List[int]):
        for c, pool in enumerate(self.pools):
            self.peak_pages[c] = max(self.peak_pages[c], occ0[c],
                                     pool.occupancy())

    def step(self) -> bool:
        occ0 = [p.occupancy() for p in self.pools]
        self._land_promotions()
        self._admit()
        self._land_promotions()
        active = self._runnable()
        if not active and self._promoting():
            self.clock.hold_until(
                min(r.promote_due for r in self._promoting()))
            self._land_promotions()
            self._admit()
            active = self._runnable()
        if not active:
            return bool(self.queue) or bool(self._promoting())
        self.iterations += 1

        if self._spec_wanted(active) and self._spec_iteration(active):
            self._update_peaks(occ0)
            return True

        C = self.chunk
        prefill = [(r.lane, r.plen - r.fed) for r in active
                   if r.fed < r.plen]
        alloc: dict = {}
        if prefill:
            alloc = dict(self.policy.plan(
                tuple(prefill), len(active) - len(prefill), C))
            if len(prefill) == len(active) and \
                    not any(alloc.get(ln, rem) for ln, rem in prefill):
                alloc[prefill[0][0]] = min(C, prefill[0][1])
        n_prefill = 0
        n_decode = 0
        n_ctx = sum(r.written for r in active)
        for r in list(active):
            if r.fed < r.plen:
                n = min(C, r.plen - r.fed)
                n = max(0, min(n, int(alloc.get(r.lane, n))))
                if n:
                    self._append_tokens(r, n)
                    r.fed += n
                    self.prefill_tokens += n
                    n_prefill += n
                    self._register_prompt_pages(r)
                if r.fed == r.plen:
                    reason = self._emit(r, 1)
                    if reason:
                        self._finish(r)
            else:
                self._append_tokens(r, 1)
                n_decode += 1
                reason = self._emit(r, 1)
                if reason:
                    self._finish(r)
        self.iteration_log.append(IterationStats(
            prefill_tokens=n_prefill, decode_lanes=n_decode,
            spec_tokens=0, context_tokens=n_ctx,
            active_clusters=len({r.cluster for r in active
                                 if r.cluster >= 0})))
        self._update_peaks(occ0)
        return True


# ===========================================================================
# the serve loop + report
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class SimReport:
    """Predicted serving report: the latency summary plus the capacity
    metrics the bench publishes."""
    report: dict

    def __getitem__(self, k):
        return self.report[k]


def simulate(arrivals: Sequence[SampledRequest], engine: EngineConfig, *,
             iteration_cost: IterationCost,
             spec_acceptance: float = 0.0,
             slo_ttft_s: float = 0.25, slo_tpot_s: float = 0.05,
             max_iters: int = 100_000) -> dict:
    """Replay ``arrivals`` through the simulated engine and return the
    predicted report (latency percentiles, iterations, virtual
    duration, throughput, peak page occupancy, speculation counters).

    ``iteration_cost`` prices each iteration in virtual seconds —
    a constant (the front door's ``iter_time_s`` contract) or an
    analytic roofline model (see ``repro_torch.planner.costs``)."""
    sim = _SimEngine(engine, spec_acceptance=spec_acceptance)
    clock = sim.clock
    records: Dict[int, RequestRecord] = {}
    pending = sorted(arrivals, key=lambda a: (a.t, a.rid))
    for a in pending:
        if a.rid in records:
            raise ValueError(f"duplicate rid {a.rid}")
        records[a.rid] = RequestRecord(rid=a.rid, arrive_t=a.t)
    pending = list(pending)
    it = 0
    while True:
        now = clock.now()
        while pending and pending[0].t <= now:
            a = pending.pop(0)
            records[a.rid].submit_t = now
            sim.submit(a)
        before = sim.iterations
        busy = sim.step()
        if sim.iterations > before:
            dt = iteration_cost(sim.iteration_log[-1])
            if dt:
                clock.advance(dt)
        now = clock.now()
        for rid, n, reason in sim._events:
            rec = records[rid]
            if n and rec.first_token_t is None:
                rec.first_token_t = now
            rec.tokens += n
            if reason is not None:
                rec.finish_t = now
                rec.finish_reason = reason
        sim._events.clear()
        if not busy:
            if not pending:
                break
            clock.hold_until(pending[0].t)
            continue
        it += 1
        if it >= max_iters:
            break

    rep = latency_report(records, slo_ttft_s=slo_ttft_s,
                         slo_tpot_s=slo_tpot_s)
    duration = round(clock.now(), 9)
    rep["iterations"] = sim.iterations
    rep["virtual_duration_s"] = duration
    rep["throughput_rps"] = round(rep["completed"] / duration, 9) \
        if duration > 0 else 0.0
    rep["generated_tokens"] = sim.generated_tokens
    rep["prefill_tokens"] = sim.prefill_tokens
    rep["prefix_hit_tokens"] = sum(p.stats["prefix_hit_tokens"]
                                   for p in sim.pools)
    rep["iters_per_generated_token"] = (
        sim.iterations / sim.generated_tokens
        if sim.generated_tokens else 0.0)
    for c in range(sim.clusters):
        occ = sim.pools[c].occupancy()
        sim.peak_pages[c] = max(sim.peak_pages[c], occ)
    rep["peak_pages_per_cluster"] = _peaks(sim)
    rep["hits_device_pages"] = sim.hit_pages["device"]
    rep["hits_host_pages"] = sim.hit_pages["host"]
    rep["hits_disk_pages"] = sim.hit_pages["disk"]
    rep["demoted_pages"] = sum(p.stats["demoted"] for p in sim.pools)
    rep["promoted_pages"] = sum(p.stats["promoted"] for p in sim.pools)
    rep["spec_iterations"] = sim.spec_iterations
    rep["spec_proposed"] = sim.spec_proposed
    rep["spec_accepted"] = sim.spec_accepted
    return rep


def _peaks(sim: _SimEngine) -> List[int]:
    return list(sim.peak_pages)
