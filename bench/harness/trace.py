"""The traced run: ``torch.profiler`` over a sub-window, and its reduction.

The profiler records the device's kernels, copies and sets, the host's
operators, and the benchmark's own spans (``bench.*``): around each
``submit``, ``step``, ``poll_deltas`` and idle wait of the driver, and,
for an MoE model, around the MoE layer's four parts, wrapped from here
(``models/moe.py``'s ``_route``, ``_dispatch``, ``_experts`` and
``_combine``; the package is not changed).  Each ``step`` ends in the
engine's one device-to-host pull, so every kernel of an iteration runs
inside that iteration's ``bench.step`` span on the host's clock, which is
how kernels are given to iterations.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

MOE_PARTS = ("_route", "_dispatch", "_experts", "_combine")


def mark_moe() -> None:
    """Wrap the MoE layer's parts in ``bench.moe.<part>`` spans."""
    from torch.profiler import record_function
    from repro_torch.models import moe as MOE
    for name in MOE_PARTS:
        fn = getattr(MOE, name)

        def wrapped(*a, fn=fn, label=f"bench.moe.{name}", **kw):
            with record_function(label):
                return fn(*a, **kw)
        setattr(MOE, name, wrapped)


@dataclasses.dataclass
class Step:
    kind: str                       # "idle", "decode" or "prefill"
    contexts: List[int]             # visible KV tokens of each decode row
    paged_ms: float                 # kernels whose names hold "paged_"
    moe_ms: float                   # kernels under the MoE parts' spans


@dataclasses.dataclass
class Reduced:
    window_s: float                 # traced window, host clock
    busy_s: float                   # union of device intervals
    steps: List[Step]
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


class Tracer:
    """Starts the profiler when the window reaches ``start`` (window
    seconds, as ``clock()`` reads them) and stops it ``length`` seconds
    after its start has returned, or when the window closes."""

    def __init__(self, start: float, length: float, clock=None):
        self.start, self.length, self.clock = start, length, clock
        self.stop = float("inf")
        self.prof = None
        self.active = False
        self.t_on: Optional[float] = None
        self.t_off: Optional[float] = None
        self.notes: List[Tuple[str, List[int]]] = []

    def tick(self, now: float):
        if self.prof is None and now >= self.start:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()
            self.t_on, self.active = self.clock(), True
            self.stop = self.t_on + self.length
        elif self.active and now >= self.stop:
            self.close()

    def close(self):
        if self.active:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.t_off, self.active = self.clock(), False
            self.prof.stop()

    def span(self, name: str):
        from torch.profiler import record_function
        return record_function(name)

    def note(self, kind: str, contexts: List[int]):
        """The kind (``idle``, ``decode``, ``prefill``) of the step whose
        ``bench.step`` span was just recorded, and the visible KV tokens
        of its decode rows."""
        self.notes.append((kind, contexts))

    def reduce(self, top: int = 10) -> Reduced:
        dev = torch.autograd.DeviceType.CUDA
        kernels, host, steps_cpu, moe = [], [], [], []
        for e in self.prof.events():
            tr = e.time_range
            if e.device_type == dev:
                if not e.name.startswith("bench."):
                    kernels.append((tr.start, tr.end, e.name))
            elif e.name == "bench.step":
                steps_cpu.append((tr.start, tr.end))
            elif e.name.startswith("bench.moe."):
                moe.append((tr.start, float(e.device_time_total)))
            else:
                host.append((tr.start, e.name))
        kernels.sort()
        host.sort()
        steps_cpu.sort()
        moe.sort()
        # union of device intervals, and the gaps between them
        merged: List[List[float]] = []
        for a, b, _ in kernels:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        busy_us = sum(b - a for a, b in merged)
        per_op: Dict[str, float] = collections.Counter()
        for a, b, name in kernels:
            per_op[name] += (b - a) / 1e6
        gaps: Dict[str, float] = collections.Counter()
        host_t = [t for t, _ in host]
        step_t = [a for a, _ in steps_cpu]
        for (_, b), (a2, _) in zip(merged, merged[1:]):
            gaps[self._label(b, host, host_t, steps_cpu, step_t)] += \
                (a2 - b) / 1e6
        # per step: paged-kernel ms, MoE busy ms
        k_start = [a for a, _, _ in kernels]
        m_start = [a for a, _ in moe]
        steps = []
        for (kind, ctx), (a, b) in zip(self.notes, steps_cpu):
            lo = bisect.bisect_left(k_start, a)
            hi = bisect.bisect_right(k_start, b)
            paged = sum(kb - ka for ka, kb, n in kernels[lo:hi]
                        if "paged_" in n) / 1e3
            mlo = bisect.bisect_left(m_start, a)
            mhi = bisect.bisect_right(m_start, b)
            moe_ms = sum(us for _, us in moe[mlo:mhi]) / 1e3
            steps.append(Step(kind, ctx, paged, moe_ms))
        return Reduced(
            window_s=self.t_off - self.t_on, busy_s=busy_us / 1e6,
            steps=steps,
            device_ops=sorted(per_op.items(), key=lambda kv: -kv[1])[:top],
            idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1])[:top])

    @staticmethod
    def _label(t: float, host, host_t, steps_cpu, step_t) -> str:
        """What the host was doing when the device went idle at ``t``:
        the driver's step span (or none) and the host operator started
        last before ``t``."""
        i = bisect.bisect_right(step_t, t) - 1
        where = "bench.step" if i >= 0 and steps_cpu[i][1] >= t else \
            "outside step"
        j = bisect.bisect_right(host_t, t) - 1
        op = host[j][1] if j >= 0 else "none"
        return f"{where}: after {op}"
