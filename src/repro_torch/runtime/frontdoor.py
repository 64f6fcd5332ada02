"""Host-side serving front door: continuous batching under live traffic.

The port of ``repro.runtime.frontdoor`` (pure Python, copied, its
arithmetic unchanged):

* **Scheduler policies** (:class:`SchedulerPolicy`) — the chunked-prefill
  / decode interleave as an object, asked per engine iteration how many
  prompt tokens each prefill-phase lane may feed (decode lanes always
  advance one).  :class:`GreedyChunkPolicy` is the engine's default;
  :class:`TokenBudgetPolicy` caps the tokens fed per iteration,
  decode-first.
* :class:`FrontDoor` — drives ``engine.step()`` against timed
  :class:`Arrival` s on the engine's clock: due requests are submitted,
  one iteration runs, a :class:`~repro_torch.runtime.clock.VirtualClock`
  is charged ``iter_time_s``, and the delta stream is folded into
  per-request :class:`RequestRecord` s (arrival, admission, first token,
  finish).
* :func:`latency_report` — p50/p95/p99 TTFT (from arrival) and TPOT
  (after the first token), and SLO goodput over all offered requests.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.runtime.api import (
    FINISH_LENGTH, FINISH_STOP, GenerationRequest,
)

__all__ = [
    "SchedulerPolicy", "GreedyChunkPolicy", "TokenBudgetPolicy",
    "Arrival", "RequestRecord", "FrontDoor", "latency_report",
]


class SchedulerPolicy:
    """Per-iteration prefill token allocation.

    ``plan(prefill, n_decode, chunk)`` receives the prefill-phase lanes as
    ``(lane, remaining_prompt_tokens)`` pairs (admission order), the count
    of decode-phase lanes (each of which always advances one token), and
    the engine's chunk size; it returns ``{lane: tokens}``.  The engine
    clips every entry to ``[0, min(chunk, remaining)]``, treats a missing
    lane as ``min(chunk, remaining)``, and guarantees forward progress
    when every active lane is prefill-phase and the policy allocated
    nothing."""

    def plan(self, prefill: Sequence[Tuple[int, int]], n_decode: int,
             chunk: int) -> Dict[int, int]:
        raise NotImplementedError


class GreedyChunkPolicy(SchedulerPolicy):
    """The historical interleave, unchanged: every prefill lane consumes
    ``min(chunk, remaining)`` — prefill and decode are not budget-coupled,
    so a prefill burst can lengthen running lanes' token cadence."""

    def plan(self, prefill, n_decode, chunk):
        return {lane: min(chunk, rem) for lane, rem in prefill}


class TokenBudgetPolicy(SchedulerPolicy):
    """Token-budget interleave: at most ``budget`` tokens are fed per
    engine iteration, decode lanes first (one token each — their latency
    is the SLO), then prompt chunks in admission order from whatever is
    left.  A prefill lane may receive 0 tokens this iteration; it simply
    resumes when budget frees up."""

    def __init__(self, budget: int):
        if budget < 1:
            raise ValueError("token budget must be >= 1")
        self.budget = budget

    def plan(self, prefill, n_decode, chunk):
        left = max(0, self.budget - n_decode)
        out: Dict[int, int] = {}
        for lane, rem in prefill:
            n = min(chunk, rem, left)
            out[lane] = n
            left -= n
        return out


# ===========================================================================
# the front door: timed arrivals -> per-iteration admission -> latency
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class Arrival:
    """One request due at clock time ``t``."""
    t: float
    request: GenerationRequest


@dataclasses.dataclass
class RequestRecord:
    """Per-request latency lifecycle, on the engine clock's axis."""
    rid: int
    arrive_t: float
    submit_t: Optional[float] = None
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    tokens: int = 0
    finish_reason: Optional[str] = None

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token, measured from *arrival* (queueing counts)."""
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.arrive_t

    @property
    def tpot_s(self) -> Optional[float]:
        """Time per output token after the first (0.0 for 1-token
        outputs — a single token has no inter-token cadence)."""
        if self.first_token_t is None or self.finish_t is None:
            return None
        if self.tokens <= 1:
            return 0.0
        return (self.finish_t - self.first_token_t) / (self.tokens - 1)


class FrontDoor:
    """Drive an engine against a live arrival schedule.

    ``engine`` is a built ``PagedServer`` whose
    :class:`~repro_torch.runtime.EngineConfig` carries the clock this front
    door reads; on a :class:`~repro_torch.runtime.clock.VirtualClock` each
    engine iteration is charged ``iter_time_s`` virtual seconds (a real
    :class:`~repro_torch.runtime.clock.MonotonicClock` flows by itself and
    ``iter_time_s`` is ignored).  ``serve(arrivals)`` submits each
    request when its arrival time comes due, steps the engine, folds the
    delta stream into :class:`RequestRecord` timings and returns them by
    rid.  When the engine idles before the next arrival the clock jumps
    straight to it — no busy-waiting, real or virtual."""

    def __init__(self, engine, *, iter_time_s: float = 0.0):
        self.engine = engine
        self.clock = engine.clock
        self.iter_time_s = float(iter_time_s)
        self.records: Dict[int, RequestRecord] = {}

    def _charge_iteration(self):
        advance = getattr(self.clock, "advance", None)
        if advance is not None and self.iter_time_s:
            advance(self.iter_time_s)

    def _fold_deltas(self):
        now = self.clock.now()
        for d in self.engine.poll_deltas():
            rec = self.records.get(d.rid)
            if rec is None:
                continue
            if d.tokens:
                if rec.first_token_t is None:
                    rec.first_token_t = now
                rec.tokens += len(d.tokens)
            if d.finish_reason is not None:
                rec.finish_t = now
                rec.finish_reason = d.finish_reason

    def serve(self, arrivals: Iterable[Arrival],
              max_iters: int = 100_000) -> Dict[int, RequestRecord]:
        pending = deque(sorted(arrivals, key=lambda a: (a.t, a.request.rid)))
        for a in pending:
            if a.request.rid in self.records:
                raise ValueError(f"duplicate rid {a.request.rid}")
            self.records[a.request.rid] = RequestRecord(
                rid=a.request.rid, arrive_t=a.t)
        it = 0
        while True:
            now = self.clock.now()
            while pending and pending[0].t <= now:
                a = pending.popleft()
                self.records[a.request.rid].submit_t = now
                self.engine.submit(a.request)
            before = self.engine.iterations
            busy = self.engine.step()
            if self.engine.iterations > before:
                self._charge_iteration()
            self._fold_deltas()
            if not busy:
                if not pending:
                    return self.records
                # idle until the next arrival: jump, don't spin
                self.clock.hold_until(pending[0].t)
                continue
            it += 1
            if it >= max_iters:
                self.engine._abort_all()
                self._fold_deltas()
                return self.records


def _percentile(xs: List[float], q: float) -> float:
    """Nearest-rank percentile on a sorted copy — pure-Python and
    platform-independent, so reports replay byte-identically."""
    if not xs:
        return 0.0
    s = sorted(xs)
    rank = -(-int(q) * len(s) // 100)           # ceil(q * n / 100)
    return s[max(0, min(len(s), rank) - 1)]


def latency_report(records: Dict[int, RequestRecord], *,
                   slo_ttft_s: float, slo_tpot_s: float,
                   ndigits: int = 9) -> dict:
    """Aggregate per-request records into the serving-latency summary.

    TTFT percentiles cover every request that produced a first token;
    TPOT percentiles cover every request that finished with at least one
    token.  ``slo_goodput`` divides by ALL offered requests: a shed,
    timed-out or errored request counts against goodput even though it
    has no latency sample — load you failed to serve is not neutral."""
    ttfts = sorted(round(r.ttft_s, ndigits) for r in records.values()
                   if r.ttft_s is not None)
    tpots = sorted(round(r.tpot_s, ndigits) for r in records.values()
                   if r.tpot_s is not None)
    good = sum(
        1 for r in records.values()
        if r.finish_reason in (FINISH_STOP, FINISH_LENGTH)
        and r.ttft_s is not None and r.ttft_s <= slo_ttft_s
        and r.tpot_s is not None and r.tpot_s <= slo_tpot_s)
    n = len(records)
    completed = sum(1 for r in records.values()
                    if r.finish_reason in (FINISH_STOP, FINISH_LENGTH))
    out = {
        "requests": n,
        "completed": completed,
        "slo": {"ttft_s": slo_ttft_s, "tpot_s": slo_tpot_s},
        "slo_goodput": round(good / n, ndigits) if n else 0.0,
    }
    for name, xs in (("ttft", ttfts), ("tpot", tpots)):
        for q in (50, 95, 99):
            out[f"{name}_p{q}_s"] = round(_percentile(xs, q), ndigits)
    return out
