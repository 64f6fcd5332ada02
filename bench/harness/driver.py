"""Offer a traffic mix to the engine on the host's monotonic clock.

The traffic starts on an idle, warmed-up engine; the window opens
``lead_in`` seconds later, so that it finds the engine in its steady
state, and lasts ``seconds``.  Times are window seconds (negative in the
lead-in).  Open loop: every request is submitted when its scheduled
arrival comes due, whatever the engine is doing.  Closed loop:
``clients`` clients send their first requests evenly spread over the
lead-in (client ``c`` at ``c / clients`` of it), so that the window finds
them out of step with each other, as a steady state has them, and each
sends its next one when its last one finishes.  Between arrivals the driver runs
``engine.step()`` and folds ``engine.poll_deltas()`` into per-request
records, with the timing rules of ``runtime.frontdoor.RequestRecord``:
time to first token counts from the scheduled arrival, so a stall delays
every request behind it.  Only iterations that start and end inside the
window are logged, only tokens emitted inside it count, and only requests
due inside it are attempted.  After each iteration inside the window the
driver reads the pool's page counts, so that the log holds the most pages
live requests held and the most live or cached.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from harness.traffic import Request

FINISHED_OK = ("length", "stop")


@dataclasses.dataclass
class Record:
    rid: int
    prompt: Tuple[int, ...]
    max_new: int
    arrive: float                   # scheduled arrival, window seconds
    prefix: int = -1
    hit: int = 0                    # prompt tokens served by the cache
    hit_t: Optional[float] = None   # when the engine reported the hit
    tokens: List[int] = dataclasses.field(default_factory=list)
    times: List[float] = dataclasses.field(default_factory=list)
    finish: Optional[float] = None
    reason: Optional[str] = None


@dataclasses.dataclass
class Iteration:
    t0: float
    t1: float
    prefill_fed: int                # prompt tokens fed (prefill counter)
    decode: List[Tuple[int, int]]   # (rid, visible KV tokens) per decode row
    traced: bool = False

    @property
    def ms(self) -> float:
        return (self.t1 - self.t0) * 1e3


@dataclasses.dataclass
class Log:
    """What a window produced, for the metric readers."""
    seconds: float
    records: Dict[int, Record]
    iterations: List[Iteration]     # those that ended inside the window
    late: float = 0.0               # most the open-loop offer ran behind
    fed_at_open: Dict[int, int] = dataclasses.field(default_factory=dict)
    fed_at_close: Dict[int, int] = dataclasses.field(default_factory=dict)
    queued_at_close: int = 0
    pages_live_peak: int = 0        # pages mapped by requests
    pages_held_peak: int = 0        # the same, or kept by the prefix cache


class Driver:
    def __init__(self, engine, mix: dict, offer: Iterator[Request],
                 make_request: Callable[[Request], object], seconds: float,
                 tracer=None, lead_in: float = 0.0):
        self.engine, self.mix, self.offer = engine, mix, offer
        self.make_request, self.seconds = make_request, float(seconds)
        self.lead_in = float(lead_in)
        self.tracer = tracer
        self.records: Dict[int, Record] = {}
        self.iterations: List[Iteration] = []
        self.client_of: Dict[int, int] = {}
        self.late = 0.0
        self.pages_live_peak = self.pages_held_peak = 0

    def _span(self, name: str):
        if self.tracer is None or not self.tracer.active:
            return contextlib.nullcontext()
        return self.tracer.span(name)

    def _submit(self, req: Request, arrive: float, client: int = -1):
        with self._span("bench.submit"):
            self.engine.submit(self.make_request(req))
        self.records[req.rid] = Record(
            rid=req.rid, prompt=req.prompt, max_new=req.max_new,
            arrive=arrive, prefix=req.prefix)
        if client >= 0:
            self.client_of[req.rid] = client

    def _fold(self, deltas, now: float) -> Tuple[List[Tuple[int, int]],
                                                 List[int]]:
        """Records take the deltas at ``now``; returns this iteration's
        (rid, visible KV tokens) of each decode row and the rids that
        finished."""
        rows, done = [], []
        for d in deltas:
            rec = self.records.get(d.rid)
            if rec is None:
                continue
            if d.event == "prefix_hit":
                rec.hit, rec.hit_t = d.data, now
            for tok in d.tokens:
                if rec.tokens:
                    rows.append((rec.rid, len(rec.prompt) + len(rec.tokens)))
                rec.tokens.append(int(tok))
                rec.times.append(now)
            if d.finish_reason is not None:
                rec.finish, rec.reason = now, d.finish_reason
                done.append(d.rid)
        return rows, done

    def run(self) -> Log:
        eng, S = self.engine, self.seconds
        closed = self.mix["loop"] == "closed"
        clock = time.monotonic
        t_open = clock() + self.lead_in
        if self.tracer is not None:
            self.tracer.clock = lambda: clock() - t_open
        nxt: Optional[Request] = None
        t_first = -self.lead_in
        starts: List[Tuple[float, int]] = []    # (first request due, client)
        if closed:
            n = int(self.mix["clients"])
            starts = [(t_first + c * self.lead_in / n, c) for c in range(n)]
        else:
            nxt = next(self.offer)
        fed_at_open = None
        while True:
            now = clock() - t_open
            if now >= S:
                break
            if fed_at_open is None and now >= 0:
                fed_at_open = {r.rid: r.fed for r in eng.lanes
                               if r is not None}
            if self.tracer is not None:
                self.tracer.tick(now)
            while starts and starts[0][0] <= now:
                due, c = starts.pop(0)
                self._submit(next(self.offer), due, client=c)
            while nxt is not None and nxt.t + t_first <= now:
                due = nxt.t + t_first
                self.late = max(self.late, now - due)
                self._submit(nxt, due)
                nxt = next(self.offer)
            p0, it0 = eng.prefill_tokens, eng.iterations
            traced = self.tracer is not None and self.tracer.active
            with self._span("bench.step"):
                eng.step()
            with self._span("bench.poll"):
                deltas = eng.poll_deltas()
            t1 = clock() - t_open
            if eng.iterations == it0:
                if traced:
                    self.tracer.note("idle", [])
                # idle until the next arrival or client start (a closed
                # loop has a request in flight from its first start on)
                due = [t for t in (nxt.t + t_first if nxt else None,
                                   starts[0][0] if starts else None)
                       if t is not None]
                if not due:
                    break
                with self._span("bench.wait"):
                    time.sleep(max(0.0, min(min(due), S) - t1))
                continue
            if t1 > S:
                if traced:
                    self.tracer.note("late", [])
                break
            rows, done = self._fold(deltas, t1)
            fed = eng.prefill_tokens - p0
            if traced:
                self.tracer.note("prefill" if fed else "decode",
                                 [c for _, c in rows])
            if now >= 0:
                self.iterations.append(Iteration(
                    t0=now, t1=t1, prefill_fed=fed, decode=rows,
                    traced=traced))
                pool = eng.pool
                free = pool.free_pages()
                self.pages_live_peak = max(self.pages_live_peak,
                                           pool.num_pages - free)
                self.pages_held_peak = max(
                    self.pages_held_peak,
                    pool.num_pages - free + len(pool.cached_free))
            if closed:
                for rid in done:
                    c = self.client_of[rid]
                    self._submit(next(self.offer), t1, client=c)
        if self.tracer is not None:
            self.tracer.close()
        fed = {r.rid: r.fed for r in eng.lanes if r is not None}
        return Log(seconds=S, records=self.records,
                   iterations=self.iterations, late=self.late,
                   fed_at_open=fed_at_open or {}, fed_at_close=fed,
                   queued_at_close=len(eng.queue),
                   pages_live_peak=self.pages_live_peak,
                   pages_held_peak=self.pages_held_peak)
