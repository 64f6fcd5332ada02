"""``plan_capacity(workload, slo) -> EngineConfig`` — the inversion.

The lumos move (SNIPPETS.md: model the design space against budgets,
then ask "what should I build?") applied to the serving engine: span a
deterministic candidate grid over clusters / pages / chunk / spec_k /
kv_dtype, predict every candidate's serving report with the
discrete-event simulator, and return the CHEAPEST candidate whose
prediction meets the SLO, with the predicted report attached.

Cost is resource cost, not latency: each cluster pays its resident
weight bytes plus its KV pool bytes (int8 pools are literally cheaper
bytes), speculation pays a small drafter surcharge.  Candidates are
enumerated in one fixed order and simulated cheapest-first, so:

* the result is deterministic — same (workload, slo, model) inputs
  yield the same ``EngineConfig`` and the same predicted report;
* a tighter SLO can never pick a cheaper config — per-candidate
  predictions are SLO-independent (the feasibility check reads only
  p95 TTFT/TPOT and completion), so tightening the SLO only shrinks
  the feasible set and first-feasible-by-cost can only move later.

No wall clock anywhere: the simulator runs on a
:class:`~repro_torch.runtime.clock.VirtualClock` and the cost model is either
a calibrated constant or the analytic roofline model.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.roofline import kv_bytes_per_token
from repro_torch.planner.costs import (
    AnalyticCostModel, Calibration, FixedIterationCost, IterationStats,
)
from repro_torch.planner.simulator import simulate
from repro_torch.planner.workload import SLOSpec, WorkloadSpec
from repro_torch.runtime.api import CacheConfig, EngineConfig

__all__ = ["plan_capacity", "PlanResult", "candidate_grid", "config_cost"]

#: drafter surcharge per speculative depth step, in cost-bytes — small
#: enough to never outweigh a page, large enough to break ties toward
#: the simpler engine
_SPEC_COST_BYTES = 1024.0


@dataclasses.dataclass(frozen=True)
class PlanResult:
    """What the planner recommends and why."""
    engine: EngineConfig
    predicted: dict             # the winning candidate's simulated report
    cost: float                 # resource cost of the winner
    evaluated: int              # candidates simulated before the winner met
    workload: WorkloadSpec
    slo: SLOSpec


def config_cost(engine: EngineConfig, model_cfg) -> float:
    """Deterministic resource cost of a candidate, in bytes: per
    cluster, the resident weights plus the KV pool (priced at the
    pool's own ``kv_dtype``), plus the speculation surcharge."""
    from repro_torch.core.roofline import param_counts
    cache = engine.cache
    kv_bpt = kv_bytes_per_token(model_cfg, cache.kv_dtype, cache.page_size)
    pool_bytes = cache.num_pages * cache.page_size * kv_bpt
    weight_bytes = param_counts(model_cfg)["total"] * 2.0
    return engine.clusters * (weight_bytes + pool_bytes) \
        + engine.spec_k * _SPEC_COST_BYTES


def candidate_grid(workload: WorkloadSpec, *, page_size: int = 4,
                   max_clusters: int = 8) -> List[EngineConfig]:
    """The fixed search grid: clusters x lanes x pool margin x chunk x
    kv_dtype x spec_k, every candidate sized to admit the workload's
    longest possible request."""
    longest = workload.prompt_max + workload.output_max
    per_seq = -(-longest // page_size) + 1
    spec_ks: Tuple[int, ...] = (0,)
    if workload.spec_acceptance_rate > 0:
        spec_ks = (0, 4)
    out: List[EngineConfig] = []
    clusters = [c for c in (1, 2, 4, 8) if c <= max_clusters]
    for c in clusters:
        for lanes in (2, 4, 8):
            base = per_seq * lanes + 8
            for margin in (1, 2):
                for chunk in (4, 8, 16):
                    for kv in ("int8", "bf16"):
                        for sk in spec_ks:
                            out.append(EngineConfig(
                                cache=CacheConfig(
                                    num_pages=base * margin,
                                    page_size=page_size,
                                    max_pages_per_seq=per_seq,
                                    kv_dtype=kv),
                                max_lanes=lanes, chunk=chunk,
                                clusters=c, spec_k=sk,
                                use_kernel=False))
    return out


def _tiebreak(e: EngineConfig) -> tuple:
    return (e.clusters, e.max_lanes, e.cache.num_pages, e.chunk,
            e.spec_k, e.cache.kv_dtype)


def plan_capacity(workload: WorkloadSpec, slo: SLOSpec, *,
                  model_cfg=None, arch: str = "yi-6b",
                  page_size: int = 4, max_clusters: int = 8,
                  calibration: Optional[Calibration] = None,
                  vocab: int = 32768,
                  candidates: Optional[Sequence[EngineConfig]] = None,
                  ) -> PlanResult:
    """Recommend the cheapest engine config predicted to meet ``slo``.

    ``calibration`` switches iteration pricing from the analytic
    roofline model to the measured constant (the front door's
    ``iter_time_s`` contract) — use it whenever a trace of comparable
    hardware exists.  Raises ``ValueError`` when no candidate in the
    grid meets the SLO (the message carries the best prediction seen,
    so the caller learns how far off the grid was)."""
    if model_cfg is None:
        from repro_torch.configs import get_config
        model_cfg = get_config(arch).smoke()
    arrivals = workload.sample_arrivals(vocab)
    grid = list(candidates) if candidates is not None else \
        candidate_grid(workload, page_size=page_size,
                       max_clusters=max_clusters)
    ranked = sorted(((config_cost(e, model_cfg), _tiebreak(e), e)
                     for e in grid), key=lambda t: (t[0], t[1]))
    best_miss: Optional[dict] = None
    for n, (cost, _tb, engine) in enumerate(ranked, start=1):
        if calibration is not None:
            iter_cost = FixedIterationCost(calibration.iter_time_s)
        else:
            iter_cost = AnalyticCostModel.for_engine(model_cfg, engine)
        report = simulate(
            arrivals, engine, iteration_cost=iter_cost,
            spec_acceptance=workload.spec_acceptance_rate,
            slo_ttft_s=slo.ttft_p95_s, slo_tpot_s=slo.tpot_p95_s)
        if slo.met_by(report):
            return PlanResult(engine=engine, predicted=report, cost=cost,
                              evaluated=n, workload=workload, slo=slo)
        if best_miss is None or (report["ttft_p95_s"], report["tpot_p95_s"]) \
                < (best_miss["ttft_p95_s"], best_miss["tpot_p95_s"]):
            best_miss = report
    raise ValueError(
        "no candidate in the grid meets the SLO "
        f"(ttft_p95<={slo.ttft_p95_s}, tpot_p95<={slo.tpot_p95_s}); "
        f"best prediction: ttft_p95={best_miss['ttft_p95_s']}, "
        f"tpot_p95={best_miss['tpot_p95_s']}" if best_miss else
        "no candidates to evaluate")


# re-exported for callers that price their own iterations
IterationStats = IterationStats
