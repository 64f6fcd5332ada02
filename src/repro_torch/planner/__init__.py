"""Analytical capacity planner: predict the bench, then invert it (ported
from ``repro.planner``; pure Python on the port's API, clock and front
door, priced with H100 peaks).

Three layers (HERO's lumos-style design-space exploration, applied to
the serving engine):

* :mod:`repro_torch.planner.workload` — :class:`WorkloadSpec` / :class:`SLOSpec`,
  the frozen workload schema shared with ``launch/load_gen.py``;
* :mod:`repro_torch.planner.costs` + :mod:`repro_torch.core.roofline` — what one
  engine iteration costs (measured constant or analytic roofline);
* :mod:`repro_torch.planner.simulator` — a deterministic discrete-event
  replica of the scheduler on a virtual clock, composing step costs
  into a predicted serving report;
* :mod:`repro_torch.planner.capacity` — :func:`plan_capacity`, the search
  that inverts prediction into the cheapest SLO-meeting EngineConfig.

``simulate`` replays a schedule exactly as the engine serves it through
the front door on a ``VirtualClock`` at a fixed ``iter_time_s``.
"""
from repro_torch.planner.capacity import (
    PlanResult, candidate_grid, config_cost, plan_capacity,
)
from repro_torch.planner.costs import (
    AnalyticCostModel, Calibration, FixedIterationCost,
)
from repro_torch.planner.simulator import IterationStats, simulate
from repro_torch.planner.workload import SampledRequest, SLOSpec, WorkloadSpec

__all__ = [
    "AnalyticCostModel",
    "Calibration",
    "FixedIterationCost",
    "IterationStats",
    "PlanResult",
    "SLOSpec",
    "SampledRequest",
    "WorkloadSpec",
    "candidate_grid",
    "config_cost",
    "plan_capacity",
    "simulate",
]
