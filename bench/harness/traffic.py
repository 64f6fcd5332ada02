"""The one general traffic generator: a mix is a data file of parameters
(``bench/traffic/<mix>.json``) that this module reads.

Lengths, gaps and prefix choices come in blocks of ``block`` requests.
Each block holds the same stratified quantiles of every distribution (the
quantile at (i + 1/2) / block for i = 0 .. block - 1), so every seed
offers the same sizes and gaps; the seed only orders them within each
block and draws the token ids.  A window that covers whole blocks thus
carries the same work on every seed, and runs differ by order alone.

Mix keys:

* ``loop``: ``"open"`` (Poisson arrivals at the cell's ``rate_per_s``) or
  ``"closed"`` (``clients`` clients, each sending its next request when
  its last one finishes);
* ``block``: requests per stratified block (default: ``clients``);
* ``prompt`` / ``output``: ``{"dist": "lognormal", "median", "sigma",
  "min", "max"}`` or ``{"dist": "uniform", "min", "max"}`` (tokens, both
  ends included);
* ``prefix`` (optional): ``{"count", "tokens", "zipf_s", "block"}``:
  every prompt starts with one of ``count`` shared prompts of ``tokens``
  tokens, chosen by a Zipf law of exponent ``zipf_s`` (stratified over
  blocks of its own ``block`` requests, default the mix's); ``prompt``
  then sizes the request's own turn after it.
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import Iterator, List, Optional, Tuple

import numpy as np

_PHI_INV = NormalDist().inv_cdf

#: rng stream ids, so each kind of draw has a stream of its own
_ORDER, _TOKENS, _PREFIX, _WARM = 1, 2, 3, 4


@dataclasses.dataclass(frozen=True)
class Request:
    rid: int
    prompt: Tuple[int, ...]
    max_new: int
    t: float = 0.0              # scheduled arrival (open loop), seconds
    prefix: int = -1            # shared prompt index, -1 for none


def quantiles(spec: dict, n: int) -> List[int]:
    """The ``n`` stratified quantiles of a length distribution, as
    whole tokens clipped to ``[min, max]``."""
    lo, hi = int(spec["min"]), int(spec["max"])
    out = []
    for i in range(n):
        u = (i + 0.5) / n
        if spec["dist"] == "lognormal":
            x = round(spec["median"] * math.exp(spec["sigma"] * _PHI_INV(u)))
        elif spec["dist"] == "uniform":
            x = lo + math.floor(u * (hi - lo + 1))
        else:
            raise ValueError(f"unknown length distribution {spec['dist']!r}")
        out.append(min(hi, max(lo, x)))
    return out


def exp_gaps(rate: float, n: int) -> List[float]:
    """The ``n`` stratified quantiles of an exponential gap at ``rate``."""
    return [-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)]


def zipf_counts(count: int, s: float, n: int) -> List[int]:
    """How many of ``n`` requests take each of ``count`` shared prompts
    under a Zipf law of exponent ``s`` (largest remainders round)."""
    w = [1.0 / (k + 1) ** s for k in range(count)]
    exact = [n * x / sum(w) for x in w]
    out = [math.floor(e) for e in exact]
    rest = sorted(range(count), key=lambda k: out[k] - exact[k])
    for k in rest[:n - sum(out)]:
        out[k] += 1
    return out


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def shared_prompts(mix: dict, seed: int, vocab: int) -> List[np.ndarray]:
    spec = mix.get("prefix")
    if not spec:
        return []
    rng = _rng(seed, _PREFIX)
    return [rng.integers(0, vocab, int(spec["tokens"]))
            for _ in range(int(spec["count"]))]


def requests(mix: dict, seed: int, vocab: int,
             rate_per_s: Optional[float] = None) -> Iterator[Request]:
    """The mix's requests in offer order, without end.  Open loop: each
    carries its arrival time ``t`` (``rate_per_s`` is required)."""
    if mix["loop"] == "open" and not rate_per_s:
        raise ValueError("an open-loop mix needs the cell's rate_per_s")
    n = int(mix.get("block") or mix.get("clients"))
    prompt_q = quantiles(mix["prompt"], n)
    out_q = quantiles(mix["output"], n)
    gap_q = exp_gaps(rate_per_s, n) if mix["loop"] == "open" else [0.0] * n
    prefixes = shared_prompts(mix, seed, vocab)
    pn = int(mix["prefix"].get("block", n)) if prefixes else 1
    pre_q: List[int] = [-1] * pn
    if prefixes:
        counts = zipf_counts(len(prefixes), float(mix["prefix"]["zipf_s"]),
                             pn)
        pre_q = [k for k, c in enumerate(counts) for _ in range(c)]
    tok = _rng(seed, _TOKENS)
    t, rid, block = 0.0, 0, 0
    pres: List[int] = []
    while True:
        order = _rng(seed, _ORDER, block)
        lens = order.permutation(prompt_q)
        outs = order.permutation(out_q)
        gaps = order.permutation(gap_q)
        for i in range(n):
            if not pres:
                pres = list(_rng(seed, _PREFIX, rid).permutation(pre_q))
            t += float(gaps[i])
            own = tok.integers(0, vocab, int(lens[i]))
            k = int(pres.pop())
            prompt = own if k < 0 else np.concatenate([prefixes[k], own])
            yield Request(rid=rid, prompt=tuple(int(x) for x in prompt),
                          max_new=int(outs[i]), t=t, prefix=k)
            rid += 1
        block += 1


def warmup_prompts(seed: int, vocab: int, lanes: int,
                   chunk: int) -> List[Tuple[int, ...]]:
    """``lanes`` prompts of exactly ``chunk`` tokens, one per lane, so that
    one iteration runs the full (lanes, chunk) step and the next the
    (lanes, 1) decode step."""
    rng = _rng(seed, _WARM)
    return [tuple(int(x) for x in rng.integers(0, vocab, chunk))
            for _ in range(lanes)]


def longest(mix: dict) -> int:
    """The most tokens one request of the mix can hold (prompt, shared
    prefix and output)."""
    pre = int(mix["prefix"]["tokens"]) if mix.get("prefix") else 0
    return pre + int(mix["prompt"]["max"]) + int(mix["output"]["max"])
