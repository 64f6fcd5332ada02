"""Injectable engine clock: one time source for the whole scheduler.

HERO separates the stable host-side runtime from the accelerator
engine; the host side owns *time* — deadlines, retry backoff, arrival
processes.  This module makes that time source explicit and injectable:
every scheduler-visible timestamp (``deadline_s`` binding, swap-retry
backoff deadlines, straggler EMA deltas, the front door's arrival clock)
flows through one :class:`Clock` object instead of raw ``time.monotonic()``
/ ``time.sleep()`` calls scattered through the tick path.

Two implementations:

* :class:`MonotonicClock` — production wall clock.  ``now()`` is
  ``time.monotonic()``; ``hold_until`` really waits (it is only ever
  called when the engine has nothing else to do — no active lane may be
  stalled behind it).
* :class:`VirtualClock` — deterministic test/bench clock.  Time moves
  only when somebody calls :meth:`VirtualClock.advance` (the front door
  charges a fixed ``iter_time_s`` per engine iteration) or
  ``hold_until`` jumps it forward.  Two runs with the same schedule of
  advances see byte-identical timestamps, so wall-clock-shaped metrics
  (TTFT, TPOT, deadline sweeps, retry backoff) replay exactly.
"""
from __future__ import annotations

import time

__all__ = ["Clock", "MonotonicClock", "VirtualClock"]


class Clock:
    """Engine time source.  ``now()`` returns seconds on an arbitrary
    monotonic axis; ``hold_until(t)`` parks the *caller* until ``now()``
    reaches ``t`` — the engine only calls it when fully idle (no active
    lane, every waiter deferred), so a hold can never stall live work."""

    def now(self) -> float:
        raise NotImplementedError

    def hold_until(self, t: float) -> None:
        raise NotImplementedError


class MonotonicClock(Clock):
    """Real wall clock (``time.monotonic``).  The default when an
    :class:`~repro_torch.runtime.EngineConfig` names no clock."""

    #: cap a single hold so a wildly future deadline cannot wedge the
    #: process; the engine re-polls and holds again if still idle
    max_hold_s = 0.05

    def now(self) -> float:
        return time.monotonic()

    def hold_until(self, t: float) -> None:
        dt = t - self.now()
        if dt > 0:
            time.sleep(min(dt, self.max_hold_s))


class VirtualClock(Clock):
    """Deterministic clock for tests and benchmarks: time is a number
    this object owns, moved only by :meth:`advance` / :meth:`hold_until`.
    Never moves backwards."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        """Move time forward by ``dt`` seconds and return the new time."""
        if dt < 0:
            raise ValueError("a clock cannot move backwards")
        self._t += dt
        return self._t

    def hold_until(self, t: float) -> None:
        if t > self._t:
            self._t = t
