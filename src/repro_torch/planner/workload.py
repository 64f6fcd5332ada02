"""Workload and SLO schema shared by the load generator and the planner.

:class:`WorkloadSpec` is THE description of an open-loop serving
workload: Poisson arrivals at ``rate_rps``, uniform prompt/output
length distributions, an optional shared-prefix fraction and an
expected speculative acceptance rate.  ``launch/load_gen.py``
builds its arrival schedule from this spec and the planner's simulator
replays the *same* schedule analytically — one schema, two consumers,
so a prediction and a measurement always describe the same traffic.

Determinism contract: :meth:`WorkloadSpec.sample_arrivals` draws from
``numpy.random.default_rng(seed)`` in a fixed per-request order
(interarrival gap, prompt length, output budget, prompt tokens), which
for ``prefix_share_ratio == 0`` is bit-for-bit the order the historical
``load_gen.make_arrivals`` used — same seed, same schedule, byte-
identical ``--selfcheck`` reports.  A non-zero ``prefix_share_ratio``
adds draws (one shared-prefix block up front, one uniform per request)
without disturbing the zero-ratio stream.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

__all__ = ["WorkloadSpec", "SLOSpec", "SampledRequest"]


@dataclasses.dataclass(frozen=True)
class SampledRequest:
    """One sampled arrival: everything the engine-independent schedule
    knows about a request."""
    rid: int
    t: float                      # arrival time, virtual seconds
    prompt: Tuple[int, ...]
    max_new: int


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Frozen open-loop workload description.

    ``prefix_share_ratio`` is the fraction of requests whose prompt
    begins with one shared block of ``prompt_min`` tokens (a system-
    prompt population for the prefix cache); ``spec_acceptance_rate``
    is the drafter acceptance probability the speculation model should
    assume.  Both default to 0 — the plain load-gen workload."""
    rate_rps: float
    requests: int
    prompt_min: int
    prompt_max: int
    output_min: int
    output_max: int
    prefix_share_ratio: float = 0.0
    spec_acceptance_rate: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if self.rate_rps <= 0:
            raise ValueError("arrival rate must be > 0")
        if self.requests < 1:
            raise ValueError("need at least one request")
        if not (1 <= self.prompt_min <= self.prompt_max):
            raise ValueError("need 1 <= prompt_min <= prompt_max")
        if not (1 <= self.output_min <= self.output_max):
            raise ValueError("need 1 <= output_min <= output_max")
        if not (0.0 <= self.prefix_share_ratio <= 1.0):
            raise ValueError("prefix_share_ratio must be in [0, 1]")
        if not (0.0 <= self.spec_acceptance_rate <= 1.0):
            raise ValueError("spec_acceptance_rate must be in [0, 1]")

    # ------------------------------------------------------------ sampling --
    def sample_arrivals(self, vocab: int) -> List[SampledRequest]:
        """Seeded arrival schedule (see the module docstring for the
        draw-order contract)."""
        if vocab < 2:
            raise ValueError("vocab must be >= 2")
        rng = np.random.default_rng(self.seed)
        shared: Tuple[int, ...] = ()
        if self.prefix_share_ratio > 0:
            shared = tuple(int(x) for x in
                           rng.integers(1, vocab, size=self.prompt_min))
        out: List[SampledRequest] = []
        t = 0.0
        for rid in range(self.requests):
            t += float(rng.exponential(1.0 / self.rate_rps))
            plen = int(rng.integers(self.prompt_min, self.prompt_max + 1))
            max_new = int(rng.integers(self.output_min, self.output_max + 1))
            if shared and float(rng.random()) < self.prefix_share_ratio:
                head = shared[:min(plen, len(shared))]
                tail = tuple(int(x) for x in
                             rng.integers(1, vocab, size=plen - len(head)))
                prompt = head + tail
            else:
                prompt = tuple(int(x) for x in
                               rng.integers(1, vocab, size=plen))
            out.append(SampledRequest(rid=rid, t=round(t, 9),
                                      prompt=prompt, max_new=max_new))
        return out

    # -------------------------------------------------------- serialization --
    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "WorkloadSpec":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(f"unknown WorkloadSpec fields: {sorted(unknown)}")
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Serving service-level objective the planner inverts against.

    ``plan_capacity`` judges a candidate config by its *predicted*
    p95 TTFT/TPOT (and completion of every offered request) — both
    SLO-independent metrics of the simulated report, so tightening the
    SLO can only shrink the feasible set, never reorder it."""
    ttft_p95_s: float
    tpot_p95_s: float

    def __post_init__(self):
        if self.ttft_p95_s <= 0 or self.tpot_p95_s <= 0:
            raise ValueError("SLO bounds must be > 0")

    def met_by(self, report: dict) -> bool:
        return (report["completed"] == report["requests"]
                and report["ttft_p95_s"] <= self.ttft_p95_s
                and report["tpot_p95_s"] <= self.tpot_p95_s)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "SLOSpec":
        return cls(**d)
