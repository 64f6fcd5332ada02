"""Speculative-decoding drafters (the port of ``repro.runtime.speculative``).

A cheap drafter on the host proposes K continuation tokens per decoding
lane, and the target model verifies all K+1 positions in one chunked step
on the device (``PagedServer._spec_iteration``).  A lane advances
``accepted + 1`` tokens per iteration with greedy parity: the accepted
prefix plus the bonus token is exactly what plain greedy decode emits.

* :class:`NGramDrafter` — the reference's suffix-match drafter, copied
  (pure Python): no model cost, strong on the repetitive tails greedy
  decode produces.  The engine's default.
* :class:`DraftModelDrafter` — not ported yet: it runs a draft model's
  full-sequence forward, which comes with the training-path slice.

Drafters are stateless with respect to the engine: proposals are
recomputed from the request's token history each iteration, so
preemption, resume and rollback need no drafter bookkeeping.  Drafting is
greedy-lane-only: a draft is accepted iff it equals the greedy argmax at
its position.
"""
from __future__ import annotations

from typing import List, Protocol, Sequence


class Drafter(Protocol):
    """Proposes up to ``k`` continuation tokens for a token history."""

    def propose(self, ctx: Sequence[int], k: int) -> List[int]:
        """Return 0..k draft tokens continuing ``ctx`` (never padded)."""
        ...


class NGramDrafter:
    """Suffix-match drafter over the lane's own token history.

    For ``n`` from ``max_n`` down to ``min_n``, the last ``n`` tokens of
    the context are searched for earlier occurrences; the tokens that
    followed an occurrence are proposed (capped at ``k``).  Longest match
    wins.  Among occurrences of the winning n-gram, the most recent one
    with ``k`` tokens of continuation is preferred; when none has ``k``,
    the one with the longest continuation is used.
    """

    def __init__(self, max_n: int = 3, min_n: int = 1):
        if not 1 <= min_n <= max_n:
            raise ValueError(f"need 1 <= min_n <= max_n, got {min_n}, "
                             f"{max_n}")
        self.max_n = max_n
        self.min_n = min_n

    def propose(self, ctx: Sequence[int], k: int) -> List[int]:
        L = len(ctx)
        if k <= 0 or L < self.min_n + 1:
            return []
        for n in range(min(self.max_n, L - 1), self.min_n - 1, -1):
            tail = tuple(ctx[L - n:])
            best = None         # (continuation length, start) seen so far
            # scan from the most recent earlier occurrence backwards; the
            # match may not end at the final position (the tail itself)
            for i in range(L - n - 1, -1, -1):
                if tuple(ctx[i:i + n]) == tail:
                    avail = min(k, L - (i + n))
                    if avail >= k:
                        return list(ctx[i + n:i + n + k])
                    if avail > 0 and (best is None or avail > best[0]):
                        best = (avail, i)
            if best is not None:
                a, i = best
                return list(ctx[i + n:i + n + a])
        return []


class DraftModelDrafter:
    """Greedy k-token continuation from a small draft model: not ported
    yet.  It needs the draft model's full-sequence forward
    (``forward_fullseq``), which comes with the training-path slice."""

    def __init__(self, cfg, params, *, target_vocab=None, bucket: int = 32):
        raise NotImplementedError(
            "DraftModelDrafter is not ported to the PyTorch engine yet: it "
            "needs forward_fullseq, which comes with the training-path "
            "slice; use NGramDrafter")
