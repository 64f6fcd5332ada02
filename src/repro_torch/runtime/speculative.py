"""Speculative-decoding drafters (the port of ``repro.runtime.speculative``).

A cheap drafter on the host proposes K continuation tokens per decoding
lane, and the target model verifies all K+1 positions in one chunked step
on the device (``PagedServer._spec_iteration``).  A lane advances
``accepted + 1`` tokens per iteration with greedy parity: the accepted
prefix plus the bonus token is exactly what plain greedy decode emits.

* :class:`NGramDrafter` — the reference's suffix-match drafter, copied
  (pure Python): no model cost, strong on the repetitive tails greedy
  decode produces.  The engine's default.
* :class:`DraftModelDrafter` — greedy continuation from a draft model's
  full-sequence forward (``models.model.forward_fullseq``), whose every
  self-attention runs the flash-attention kernel on the card.

Drafters are stateless with respect to the engine: proposals are
recomputed from the request's token history each iteration, so
preemption, resume and rollback need no drafter bookkeeping.  Drafting is
greedy-lane-only: a draft is accepted iff it equals the greedy argmax at
its position.
"""
from __future__ import annotations

from typing import List, Optional, Protocol, Sequence

import torch

from repro_torch.models import layers as L
from repro_torch.models import model as M


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
    """Greedy k-token continuation from a (small) draft model.

    ``cfg``/``params`` come from the same ``configs`` + ``models``
    machinery as the target (the draft must share the target's
    vocabulary, checked against ``target_vocab`` when given); the draft
    runs on the device of its weights.  The context is right-padded to a
    multiple of ``bucket`` (the reference compiles once per bucket; here it
    keeps the kernel's shapes to a few); causal attention makes the
    padding invisible to the logits at the last real position."""

    def __init__(self, cfg, params, *, target_vocab: Optional[int] = None,
                 bucket: int = 32):
        if target_vocab is not None and cfg.vocab_size != target_vocab:
            raise ValueError(
                f"draft model vocab {cfg.vocab_size} != target vocab "
                f"{target_vocab}: draft tokens would be meaningless")
        self.cfg = cfg
        self.params = params
        self.bucket = bucket

    def propose(self, ctx: Sequence[int], k: int) -> List[int]:
        toks = list(ctx)
        out: List[int] = []
        for _ in range(max(k, 0)):
            pad = -len(toks) % self.bucket or self.bucket
            tokens = torch.tensor([toks + [0] * pad], dtype=torch.int32,
                                  device=self.params.device)
            nxt = int(_greedy_next(self.cfg, self.params, tokens, len(toks)))
            out.append(nxt)
            toks.append(nxt)
        return out


def _last_logits(cfg, params, tokens: torch.Tensor,
                 length: int) -> torch.Tensor:
    """(V,) float32 logits at position ``length - 1`` of the padded (1, S)
    ``tokens``."""
    with torch.inference_mode():
        h = M.forward_fullseq(cfg, params, tokens)
        return L.logits_from_hidden(cfg, params.embed,
                                    h[0, length - 1:length])[0]


def _greedy_next(cfg, params, tokens: torch.Tensor,
                 length: int) -> torch.Tensor:
    """Greedy next token after position ``length - 1`` of the padded
    ``tokens``."""
    return _last_logits(cfg, params, tokens, length).argmax()
