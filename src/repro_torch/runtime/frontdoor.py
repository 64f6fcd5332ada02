"""Scheduler policies: the chunked-prefill / decode interleave as an object.

Ported from ``repro.runtime.frontdoor``: the policy protocol and
:class:`GreedyChunkPolicy`, which the engine uses by default.  The
``FrontDoor`` live-traffic loop, ``TokenBudgetPolicy`` and the latency
report are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

__all__ = ["SchedulerPolicy", "GreedyChunkPolicy"]


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
