"""The comparison that decides ``correct``.

Once the window has closed and the engine is freed, a sample of the
requests it finished, drawn from the seed and always holding the longest,
is run through the plain reference (``reference.Reference``) once per
request: the prompt followed by the tokens the engine served.  For every
served token the reference gives the gap by which that token's float32
logit lies below the reference's best at its position (0 where the engine
took the reference's own argmax).  The number compared is the widest gap.

The control (``control_gaps``) puts the reference in the program's place
in float8 e4m3 weights: at each position of the same prompts and tokens
it takes the token the float8 reference puts first and reads that token's
gap under the float32 reference.
"""
from __future__ import annotations

import random
from typing import Dict, List

import torch

from harness.driver import FINISHED_OK, Record
from harness.reference import Reference


def sample(records: Dict[int, Record], seed: int, min_tokens: int,
           max_requests: int) -> List[Record]:
    """The longest finished request (prompt and served tokens), then
    finished requests in an order drawn from ``seed`` until ``min_tokens``
    served tokens or ``max_requests`` requests are in."""
    done = sorted((r for r in records.values()
                   if r.reason in FINISHED_OK and r.tokens),
                  key=lambda r: r.rid)
    if not done:
        return []
    first = max(done, key=lambda r: (len(r.prompt) + len(r.tokens), -r.rid))
    rest = [r for r in done if r is not first]
    random.Random(int(seed)).shuffle(rest)
    out, n = [first], len(first.tokens)
    for r in rest:
        if n >= min_tokens or len(out) >= max_requests:
            break
        out.append(r)
        n += len(r.tokens)
    return out


def _rows(r: Record):
    seq = list(r.prompt) + r.tokens[:-1]
    rows = list(range(len(r.prompt) - 1, len(seq)))
    return seq, rows


def served_gaps(ref: Reference, picked: List[Record],
                drops: Dict[int, tuple]) -> torch.Tensor:
    """Every picked token's gap under ``ref``, in order."""
    out = []
    for r in picked:
        seq, rows = _rows(r)
        lg = ref.logits(seq, rows, drops.get(r.rid))
        tok = torch.tensor(r.tokens, device=lg.device)
        served = lg.gather(1, tok[:, None])[:, 0]
        out.append(lg.amax(-1) - served)
        del lg
    return torch.cat(out)


def control_gaps(ref: Reference, low: Reference, picked: List[Record],
                 drops: Dict[int, tuple]) -> torch.Tensor:
    """At each position of the picked sequences: the gap under ``ref`` of
    the token ``low`` puts first."""
    out = []
    for r in picked:
        seq, rows = _rows(r)
        pick = low.logits(seq, rows, drops.get(r.rid)).argmax(-1)
        lg = ref.logits(seq, rows, drops.get(r.rid))
        out.append(lg.amax(-1) - lg.gather(1, pick[:, None])[:, 0])
        del lg
    return torch.cat(out)


def judge(conf: dict, weights, picked: List[Record], limit: float,
          drops: Dict[int, tuple]) -> dict:
    """The number compared and its verdict."""
    if not picked:
        return {"correct": False, "max_gap": None, "tokens": 0,
                "requests": 0, "why": "no request finished in the window"}
    ref = Reference(conf, weights)
    gaps = served_gaps(ref, picked, drops)
    worst = float(gaps.max())
    out = {"correct": worst <= limit, "max_gap": worst,
           "tokens": int(gaps.numel()), "requests": len(picked)}
    if ref.routes_compared:
        out["route_agreement"] = ref.routes_agreed / ref.routes_compared
    return out


def control(conf: dict, weights, picked: List[Record],
            drops: Dict[int, tuple]) -> dict:
    """The control's number on the same sample: the widest gap, under the
    float32 reference, of the tokens the float8 reference puts first."""
    if not picked:
        return {"max_gap": None}
    low = Reference(conf, weights, "fp8")
    gaps = control_gaps(Reference(conf, weights), low, picked, drops)
    out = {"max_gap": float(gaps.max()), "tokens": int(gaps.numel())}
    if low.routes_compared:
        out["route_agreement"] = low.routes_agreed / low.routes_compared
    return out
