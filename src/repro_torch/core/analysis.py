"""Three-layer event analysis (HERO §2.3.1).

Layer 1 (generic): binary event rows -> time-sorted ``Event`` records with
platform metadata.
Layer 2 (platform): event-type specific decoding (memory accesses per core,
TLB protocol transitions, offload phases).
Layer 3 (application): user-defined analyses + *definable assertions*
(HERO §3.4b verifies hit-under-miss with exactly such assertions).

Copied from ``repro.core.analysis`` (pure numpy), against the port's
``EventType``.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np

from repro_torch.core.tracing import EventType


@dataclasses.dataclass(frozen=True)
class Event:
    ts: int
    tracer: int
    etype: EventType
    a0: int
    a1: int

    @property
    def core(self) -> int:       # platform decode: a0 is the requester/core
        return self.a0

    @property
    def vpage(self) -> int:      # platform decode: a1 is the address/page
        return self.a1


def layer1_decode(rows: np.ndarray, platform: Optional[Dict] = None
                  ) -> List[Event]:
    """Generic: rows (N,5) -> time-sorted Events (per tracer domain)."""
    events = [Event(int(r[0]), int(r[1]), EventType(int(r[2])),
                    int(r[3]), int(r[4])) for r in rows]
    return sorted(events, key=lambda e: (e.tracer, e.ts))


def layer2_per_core(events: Iterable[Event]) -> Dict[int, List[Event]]:
    """Platform: split protocol events by core (HERO Fig.6 view)."""
    out: Dict[int, List[Event]] = defaultdict(list)
    for e in events:
        out[e.core].append(e)
    return dict(out)


def layer2_tlb_transactions(events: Iterable[Event]) -> List[Dict]:
    """Platform: stitch TLB protocol transitions into transactions."""
    open_miss: Dict[int, Dict] = {}
    done: List[Dict] = []
    for e in events:
        if e.etype in (EventType.TLB_L1_HIT, EventType.TLB_L2_HIT):
            done.append({"core": e.core, "vpage": e.vpage, "ts": e.ts,
                         "kind": "hit_l1" if e.etype == EventType.TLB_L1_HIT
                                 else "hit_l2", "latency": 0})
        elif e.etype == EventType.TLB_MISS:
            open_miss[e.core] = {"core": e.core, "vpage": e.vpage,
                                 "ts": e.ts, "kind": "miss"}
        elif e.etype == EventType.CORE_WAKE and e.core in open_miss:
            tx = open_miss.pop(e.core)
            tx["latency"] = e.ts - tx["ts"]
            done.append(tx)
    done.extend(open_miss.values())
    return done


def layer2_request_lifecycles(events: Iterable[Event]) -> Dict[int, List[Dict]]:
    """Platform: per-request scheduler lifecycle — admit / preempt (with
    swap-out page counts) / re-admit / finish — stitched from the serving
    event stream.  a0 is the request id for all scheduler events."""
    out: Dict[int, List[Dict]] = defaultdict(list)
    for e in events:
        if e.etype == EventType.REQUEST_ADMIT:
            out[e.a0].append({"kind": "admit", "ts": e.ts, "lane": e.a1})
        elif e.etype == EventType.REQUEST_PREEMPT:
            out[e.a0].append({"kind": "preempt", "ts": e.ts,
                              "swapped_pages": e.a1})
        elif e.etype == EventType.SWAP_IN:
            out[e.a0].append({"kind": "swap_in", "ts": e.ts, "pages": e.a1})
        elif e.etype == EventType.REQUEST_FINISH:
            out[e.a0].append({"kind": "finish", "ts": e.ts, "tokens": e.a1})
    return dict(out)


def layer2_latency(events: Iterable[Event]) -> Dict:
    """Platform: request latency structure from the serving event stream.

    ``REQUEST_ARRIVE`` (rid, queue depth) marks a request entering the
    engine queue; ``REQUEST_ADMIT`` (rid, lane) its first/each placement;
    ``REQUEST_FINISH`` (rid, tokens) its exit.  Timestamps are the host
    tracer's logical clock (event counts, not seconds — the engine's
    *wall* latency lives on the injected Clock and is reported by
    ``runtime.frontdoor.latency_report``), so what this view exposes is
    the *ordering* structure: how much scheduler activity elapsed between
    arrival, first admission and finish.  Returns per-request
    ``queue_delay`` (arrive -> first admit), ``service`` (first admit ->
    finish) and ``e2e`` plus aggregate means/maxima."""
    per: Dict[int, Dict] = {}
    for e in events:
        if e.etype == EventType.REQUEST_ARRIVE:
            per.setdefault(e.a0, {"arrive_ts": e.ts, "admit_ts": None,
                                  "finish_ts": None, "admissions": 0,
                                  "queue_depth": e.a1, "tokens": 0})
        elif e.etype == EventType.REQUEST_ADMIT and e.a0 in per:
            r = per[e.a0]
            r["admissions"] += 1
            if r["admit_ts"] is None:
                r["admit_ts"] = e.ts
        elif e.etype == EventType.REQUEST_FINISH and e.a0 in per:
            per[e.a0]["finish_ts"] = e.ts
            per[e.a0]["tokens"] = e.a1
    rows = []
    for rid, r in sorted(per.items()):
        queue_delay = (r["admit_ts"] - r["arrive_ts"]
                       if r["admit_ts"] is not None else None)
        service = (r["finish_ts"] - r["admit_ts"]
                   if r["admit_ts"] is not None
                   and r["finish_ts"] is not None else None)
        e2e = (r["finish_ts"] - r["arrive_ts"]
               if r["finish_ts"] is not None else None)
        rows.append((rid, dict(r, queue_delay=queue_delay,
                               service=service, e2e=e2e)))
    qd = [v["queue_delay"] for _, v in rows if v["queue_delay"] is not None]
    sv = [v["service"] for _, v in rows if v["service"] is not None]
    return {
        "requests": dict(rows),
        "arrived": len(rows),
        "finished": sum(1 for _, v in rows if v["finish_ts"] is not None),
        "mean_queue_delay": sum(qd) / len(qd) if qd else 0.0,
        "max_queue_delay": max(qd) if qd else 0,
        "mean_service": sum(sv) / len(sv) if sv else 0.0,
        "max_service": max(sv) if sv else 0,
    }


def layer2_calibration(events: Iterable[Event],
                       iter_time_s: Optional[float] = None) -> Dict:
    """Planner calibration: per-iteration service structure from a trace.

    ``layer2_latency`` reports queue/service spans in *logical event
    counts*, which depend on how chatty the tracer was.  The capacity
    planner needs those spans in *engine iterations* — the unit its
    simulator steps in and the unit ``iter_time_s`` prices.  The engine
    emits exactly one ``D2H`` token-pull event per iteration, so D2H
    events serve as iteration ticks: this walks the stream once,
    counting D2H ticks, and stamps each request's arrive / first-admit /
    finish with the tick count at that point.  Within an iteration the
    tick fires after admission and before finishes, so ``service_iters``
    (first admit -> finish) counts the iterations the request was
    actually active, inclusive, and ``queue_delay_iters`` (arrive ->
    first admit) the full iterations it waited.  Caveat: preemption
    swap-outs and tier demotions also pull pages D2H, so calibrate from
    a trace without swap traffic (the smoke bench) or treat the result
    as an upper bound on the tick count.  When ``iter_time_s`` is
    given, also returns the seconds conversions (``mean_service_s``
    etc.) — exactly the :class:`repro.planner.costs.Calibration`
    input."""
    per: Dict[int, Dict] = {}
    it = 0
    for e in events:
        if e.etype == EventType.D2H:
            it += 1
        elif e.etype == EventType.REQUEST_ARRIVE:
            per.setdefault(e.a0, {"arrive_iter": it, "admit_iter": None,
                                  "finish_iter": None})
        elif e.etype == EventType.REQUEST_ADMIT and e.a0 in per:
            if per[e.a0]["admit_iter"] is None:
                per[e.a0]["admit_iter"] = it
        elif e.etype == EventType.REQUEST_FINISH and e.a0 in per:
            per[e.a0]["finish_iter"] = it
    rows: Dict[int, Dict] = {}
    for rid, r in sorted(per.items()):
        queue = (r["admit_iter"] - r["arrive_iter"]
                 if r["admit_iter"] is not None else None)
        service = (r["finish_iter"] - r["admit_iter"]
                   if r["admit_iter"] is not None
                   and r["finish_iter"] is not None else None)
        rows[rid] = dict(r, queue_delay_iters=queue, service_iters=service)
    qd = [v["queue_delay_iters"] for v in rows.values()
          if v["queue_delay_iters"] is not None]
    sv = [v["service_iters"] for v in rows.values()
          if v["service_iters"] is not None]
    out = {
        "requests": rows,
        "iterations": it,
        "arrived": len(rows),
        "finished": sum(1 for v in rows.values()
                        if v["finish_iter"] is not None),
        "mean_queue_delay_iters": sum(qd) / len(qd) if qd else 0.0,
        "max_queue_delay_iters": max(qd) if qd else 0,
        "mean_service_iters": sum(sv) / len(sv) if sv else 0.0,
        "max_service_iters": max(sv) if sv else 0,
    }
    if iter_time_s is not None:
        out["iter_time_s"] = iter_time_s
        out["mean_queue_delay_s"] = out["mean_queue_delay_iters"] * iter_time_s
        out["mean_service_s"] = out["mean_service_iters"] * iter_time_s
        out["duration_s"] = it * iter_time_s
    return out


def layer2_cluster_balance(events: Iterable[Event],
                           n_clusters: Optional[int] = None) -> Dict:
    """Platform: per-cluster placement balance for the sharded engine.

    CLUSTER_DISPATCH carries (rid, cluster); ALL_GATHER carries
    (iteration, active clusters).  Returns per-cluster dispatch counts and
    request sets plus a min/max balance ratio (1.0 = perfectly balanced,
    0.0 = some cluster never used while another was).  Pass ``n_clusters``
    so clusters that never dispatched count as zero — without it only
    clusters present in the event stream are visible."""
    per: Dict[int, Dict] = {}
    gathers = 0
    for e in events:
        if e.etype == EventType.CLUSTER_DISPATCH:
            c = per.setdefault(e.a1, {"dispatches": 0, "requests": set()})
            c["dispatches"] += 1
            c["requests"].add(e.a0)
        elif e.etype == EventType.ALL_GATHER:
            gathers += 1
    for c in range(n_clusters or 0):
        per.setdefault(c, {"dispatches": 0, "requests": set()})
    counts = [c["dispatches"] for c in per.values()]
    balance = (min(counts) / max(counts)) if counts and max(counts) else 1.0
    return {
        "clusters": {k: {"dispatches": v["dispatches"],
                         "requests": sorted(v["requests"])}
                     for k, v in sorted(per.items())},
        "all_gathers": gathers,
        "balance": balance,
    }


def layer2_speculation(events: Iterable[Event]) -> Dict:
    """Platform: speculative-decoding efficiency from the event stream.

    SPEC_PROPOSE / SPEC_ACCEPT / SPEC_ROLLBACK all carry (rid, tokens).
    Returns per-request and aggregate proposed/accepted/rolled-back token
    counts, the acceptance rate, and ``wasted_verify_tokens`` — positions
    the verify step scored and then rolled back (the price paid for the
    iterations saved)."""
    per: Dict[int, Dict[str, int]] = {}

    def row(rid: int) -> Dict[str, int]:
        return per.setdefault(rid, {"proposed": 0, "accepted": 0,
                                    "rolled_back": 0, "verify_rounds": 0})

    for e in events:
        if e.etype == EventType.SPEC_PROPOSE:
            r = row(e.a0)
            r["proposed"] += e.a1
            r["verify_rounds"] += 1
        elif e.etype == EventType.SPEC_ACCEPT:
            row(e.a0)["accepted"] += e.a1
        elif e.etype == EventType.SPEC_ROLLBACK:
            row(e.a0)["rolled_back"] += e.a1
    proposed = sum(r["proposed"] for r in per.values())
    accepted = sum(r["accepted"] for r in per.values())
    rolled = sum(r["rolled_back"] for r in per.values())
    return {
        "requests": dict(sorted(per.items())),
        "proposed": proposed,
        "accepted": accepted,
        "rolled_back": rolled,
        "acceptance_rate": accepted / proposed if proposed else 0.0,
        "wasted_verify_tokens": rolled,
    }


def assert_spec_conserves(events: List[Event]) -> bool:
    """Per request: accepted + rolled_back == proposed (every drafted
    token is either confirmed or undone — none vanish, none double)."""
    for r in layer2_speculation(events)["requests"].values():
        if r["accepted"] + r["rolled_back"] != r["proposed"]:
            return False
    return True


def layer2_fault_recovery(events: Iterable[Event]) -> Dict:
    """Platform: stitch the fault/recovery story from the event stream.

    ``FAULT_INJECT`` carries (rid, kind code 1=io/2=corrupt/3=stall, +8
    when persistent); ``REQUEST_TIMEOUT`` (rid, iteration);
    ``REQUEST_SHED`` (rid, queue depth); ``DEGRADE`` (subject, cause:
    1=drafter disabled, 2=watchdog abort, 3=straggler iteration).
    Returns aggregate fault counts by kind, timeout/shed/degrade tallies
    and the per-request fault exposure — including whether each faulted
    request still reached ``REQUEST_FINISH`` (the containment property
    :func:`assert_faults_contained` gates on)."""
    kinds = {1: "io", 2: "corrupt", 3: "stall"}
    causes = {1: "drafter", 2: "watchdog", 3: "straggler"}
    per: Dict[int, Dict] = {}

    def row(rid: int) -> Dict:
        return per.setdefault(rid, {"faults": 0, "kinds": [],
                                    "persistent": 0, "finished": False})

    out = {
        "faults": 0,
        "by_kind": {k: 0 for k in kinds.values()},
        "persistent_faults": 0,
        "timeouts": 0,
        "sheds": 0,
        "degrades": {c: 0 for c in causes.values()},
    }
    for e in events:
        if e.etype == EventType.FAULT_INJECT:
            kind = kinds.get(e.a1 & 7, "io")
            r = row(e.a0)
            r["faults"] += 1
            if kind not in r["kinds"]:
                r["kinds"].append(kind)
            out["faults"] += 1
            out["by_kind"][kind] += 1
            if e.a1 & 8:
                out["persistent_faults"] += 1
                r["persistent"] += 1
        elif e.etype == EventType.REQUEST_TIMEOUT:
            out["timeouts"] += 1
            row(e.a0)["timed_out"] = True
        elif e.etype == EventType.REQUEST_SHED:
            out["sheds"] += 1
        elif e.etype == EventType.DEGRADE:
            out["degrades"][causes.get(e.a1, "watchdog")] += 1
        elif e.etype == EventType.REQUEST_FINISH and e.a0 in per:
            per[e.a0]["finished"] = True
    out["requests"] = dict(sorted(per.items()))
    return out


def assert_faults_contained(events: List[Event]) -> bool:
    """Fault containment (layer-3, HERO §3.4b style): every request that
    ever saw an injected fault, deadline timeout or shed decision still
    reaches a ``REQUEST_FINISH`` event — faults demote or recover
    individual requests, they never lose one (and never kill the engine,
    which could not have kept emitting finishes)."""
    touched = set()
    finished = set()
    for e in events:
        if e.etype in (EventType.FAULT_INJECT, EventType.REQUEST_TIMEOUT,
                       EventType.REQUEST_SHED):
            touched.add(e.a0)
        elif e.etype == EventType.REQUEST_FINISH:
            finished.add(e.a0)
    return touched <= finished


def layer2_tier_residency(events: Iterable[Event]) -> Dict:
    """Platform: hierarchical prefix-cache tier story from the event
    stream.

    ``PAGE_DEMOTE`` / ``PAGE_PROMOTE`` carry ``(entry_id,
    src_tier * 4 + dst_tier)`` with tiers 0=device, 1=host, 2=disk,
    3=dropped.  Returns each entry's transition chain plus aggregate move
    counts by (src, dst), admission-hit tallies per serving tier
    (promotions back to device, split by where the payload came from) and
    the set of entries that ended dropped."""
    tiers = {0: "device", 1: "host", 2: "disk", 3: "dropped"}
    chains: Dict[int, List[Dict]] = defaultdict(list)
    moves: Dict[str, int] = defaultdict(int)
    promoted_from: Dict[str, int] = defaultdict(int)
    for e in events:
        if e.etype not in (EventType.PAGE_DEMOTE, EventType.PAGE_PROMOTE):
            continue
        src, dst = tiers[(e.a1 >> 2) & 3], tiers[e.a1 & 3]
        chains[e.a0].append({"ts": e.ts, "src": src, "dst": dst,
                             "kind": ("demote"
                                      if e.etype == EventType.PAGE_DEMOTE
                                      else "promote")})
        moves[f"{src}->{dst}"] += 1
        if e.etype == EventType.PAGE_PROMOTE:
            promoted_from[src] += 1
    residency: Dict[int, str] = {
        eid: chain[-1]["dst"] for eid, chain in chains.items()}
    return {
        "entries": dict(sorted(chains.items())),
        "moves": dict(sorted(moves.items())),
        "promoted_from": dict(sorted(promoted_from.items())),
        "residency": dict(sorted(residency.items())),
        "dropped": sorted(e for e, t in residency.items()
                          if t == "dropped"),
    }


def assert_tier_conservation(events: List[Event]) -> bool:
    """No indexed page is lost or duplicated across tiers: every entry's
    demote/promote chain is *contiguous* — each move departs from the tier
    the previous move arrived at.  An entry's first move must leave the
    device tier (entries are born on-device by registration), and after
    being dropped any tier may re-source it (a fresh on-device
    re-registration of the same prefix restarts the chain)."""
    where: Dict[int, int] = {}
    for e in events:
        if e.etype not in (EventType.PAGE_DEMOTE, EventType.PAGE_PROMOTE):
            continue
        src, dst = (e.a1 >> 2) & 3, e.a1 & 3
        cur = where.get(e.a0, 0)          # entries start on-device
        if cur != src and cur != 3:       # dropped -> re-registered: reset
            return False
        where[e.a0] = dst
    return True


def assert_swaps_balanced(events: List[Event]) -> bool:
    """Every page swapped out for a request that eventually finished was
    swapped back in first (no request completes on lost KV state)."""
    out_pages: Dict[int, int] = defaultdict(int)
    for e in events:
        if e.etype == EventType.SWAP_OUT:
            out_pages[e.a0] += e.a1
        elif e.etype == EventType.SWAP_IN:
            out_pages[e.a0] -= e.a1
        elif e.etype == EventType.REQUEST_FINISH:
            if out_pages.get(e.a0, 0) != 0:
                return False
    return True


@dataclasses.dataclass
class Assertion:
    """Layer-3 definable assertion over the event stream (HERO §3.4b)."""

    name: str
    predicate: Callable[[List[Event]], bool]
    description: str = ""

    def check(self, events: List[Event]) -> bool:
        return bool(self.predicate(events))


def assert_hit_under_miss(events: List[Event]) -> bool:
    """While a miss is outstanding on core A, hits by other cores must
    still complete (HERO §3.4b's exact property)."""
    outstanding = set()
    ok = True
    for e in events:
        if e.etype == EventType.TLB_MISS:
            outstanding.add(e.core)
        elif e.etype == EventType.CORE_WAKE:
            outstanding.discard(e.core)
        elif e.etype in (EventType.TLB_L1_HIT, EventType.TLB_L2_HIT):
            if e.core in outstanding:
                ok = False  # a sleeping core cannot issue translations
    return ok


def assert_wake_follows_handle(events: List[Event]) -> bool:
    handled = set()
    for e in events:
        if e.etype == EventType.MISS_HANDLED:
            handled.add((e.core, e.vpage))
        elif e.etype == EventType.CORE_WAKE:
            if (e.core, e.vpage) not in handled:
                return False
    return True


def layer3_run(events: List[Event], assertions: Iterable[Assertion]
               ) -> Dict[str, bool]:
    return {a.name: a.check(events) for a in assertions}


def render_timeline(events: List[Event], max_rows: int = 40) -> str:
    """Fig.6-style compressed per-core textual timeline."""
    lines = []
    for core, evs in sorted(layer2_per_core(events).items()):
        cells = []
        last_ts = None
        for e in evs[:max_rows]:
            if last_ts is not None and e.ts - last_ts > 1:
                cells.append("..")
            cells.append(f"{e.etype.name}@{e.ts}(p{e.vpage})")
            last_ts = e.ts
        lines.append(f"core {core:3d}: " + " ".join(cells))
    return "\n".join(lines)
