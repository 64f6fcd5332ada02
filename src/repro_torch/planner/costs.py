"""Iteration cost models: what one engine iteration costs in seconds.

Two ways to price the simulator's iterations:

* :class:`FixedIterationCost` — a constant per iteration.  This is the
  front door's own accounting contract (``FrontDoor(iter_time_s=...)``
  charges every iteration the same virtual quantum), so replaying a
  bench workload with the bench's ``iter_time_s`` predicts its latency
  report on exactly the bench's own terms.  Build one from a measured
  trace via :class:`Calibration`.

* :class:`AnalyticCostModel` — first-principles pricing from the
  roofline byte/FLOP terms (:mod:`repro_torch.core.roofline`): an iteration
  that feeds ``P`` prompt tokens, advances ``D`` decode lanes and
  verifies ``S`` speculative positions costs
  ``max(compute, memory)`` seconds where

  - compute = 2 * N_active * (P + D + S) / (devices * PEAK_FLOPS)
  - memory  = (weights/head-shard + context KV bytes / clusters) / HBM_BW

  with the peaks of one H100 (``repro_torch.launch.mesh``) and the KV
  term priced by the engine's OWN page geometry via
  :func:`repro_torch.core.roofline.kv_bytes_per_token` — so ``kv_dtype="int8"``
  halves the decode-side memory term exactly as the quantized engine's
  ``bytes_per_token`` does.  This is what ``plan_capacity`` uses to
  compare configs it has never run.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

from repro_torch.core.roofline import kv_bytes_per_token, param_counts
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
from repro_torch.planner.simulator import IterationStats

__all__ = ["Calibration", "FixedIterationCost", "AnalyticCostModel"]


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Measured per-iteration timing, the planner's calibration input.

    ``iter_time_s`` is the virtual quantum each engine iteration costs
    (the front door's knob, or a wall measurement divided by the
    iteration count); the iteration-domain service/queue split comes
    from a recorded trace via
    :func:`repro_torch.core.analysis.layer2_calibration`."""
    iter_time_s: float
    mean_service_iters: float = 0.0
    mean_queue_delay_iters: float = 0.0

    def __post_init__(self):
        if self.iter_time_s < 0:
            raise ValueError("iter_time_s must be >= 0")

    @classmethod
    def from_trace(cls, events: Iterable, *,
                   iter_time_s: float) -> "Calibration":
        """Build from a recorded trace-event stream: the per-request
        queue-delay / service split measured in engine iterations."""
        from repro_torch.core.analysis import layer2_calibration
        cal = layer2_calibration(events, iter_time_s=iter_time_s)
        return cls(iter_time_s=iter_time_s,
                   mean_service_iters=cal["mean_service_iters"],
                   mean_queue_delay_iters=cal["mean_queue_delay_iters"])

    def cost(self) -> "FixedIterationCost":
        return FixedIterationCost(self.iter_time_s)


@dataclasses.dataclass(frozen=True)
class FixedIterationCost:
    """Constant seconds per iteration (the FrontDoor contract)."""
    iter_time_s: float

    def __call__(self, st: IterationStats) -> float:
        return self.iter_time_s


@dataclasses.dataclass(frozen=True)
class AnalyticCostModel:
    """Roofline-derived iteration pricing for a concrete engine spec."""
    n_active: float             # active parameters (MoE-aware)
    n_total: float              # total parameters
    kv_bytes_token: float       # KV bytes per resident token, all layers
    clusters: int = 1
    heads: int = 1
    peak_flops: float = PEAK_FLOPS_BF16
    hbm_bw: float = HBM_BW
    overhead_s: float = 0.0     # fixed per-iteration dispatch overhead

    @classmethod
    def for_engine(cls, model_cfg, engine_cfg, *,
                   overhead_s: float = 0.0,
                   peak_flops: Optional[float] = None,
                   hbm_bw: Optional[float] = None) -> "AnalyticCostModel":
        counts = param_counts(model_cfg)
        cache = engine_cfg.cache
        return cls(
            n_active=counts["active"], n_total=counts["total"],
            kv_bytes_token=kv_bytes_per_token(
                model_cfg, cache.kv_dtype, cache.page_size),
            clusters=engine_cfg.clusters, heads=engine_cfg.heads,
            peak_flops=peak_flops or PEAK_FLOPS_BF16,
            hbm_bw=hbm_bw or HBM_BW,
            overhead_s=overhead_s)

    def __call__(self, st: IterationStats) -> float:
        devices = self.clusters * self.heads
        tokens = st.prefill_tokens + st.decode_lanes + st.spec_tokens
        t_comp = 2.0 * self.n_active * tokens / (devices * self.peak_flops)
        # weights stream once per iteration per head shard (serve
        # profile: replicated over clusters); each cluster reads only
        # its own lanes' resident KV
        w_bytes = self.n_total * 2.0 / self.heads
        kv_bytes = st.context_tokens * self.kv_bytes_token / self.clusters
        t_mem = (w_bytes + kv_bytes) / self.hbm_bw
        return max(t_comp, t_mem) + self.overhead_s
