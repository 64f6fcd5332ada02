"""Seeded, deterministic fault injection for the serving stack (ported
from ``repro.runtime.faults``, unchanged: it is pure numpy).

HERO's validation story (§1, §3.4) is that a heterogeneous platform is
only trustworthy when its run-time behavior can be *perturbed and
re-tested* through fully automated runs — the same tracing that explains a
healthy run must explain a faulted one.  This module is the perturbation
half: a :class:`FaultInjector` hooks into the host backing store's swap
path (``core.offload.HostBackingStore``) and injects three fault kinds

* ``"io"``       — the swap op raises a :class:`BackingStoreError`
                   (transient unless the site is marked persistent, so the
                   engine's bounded retry+backoff can recover it);
* ``"corrupt"``  — the parked payload is silently bit-flipped *after* the
                   store checksums it; the damage surfaces at swap-in as a
                   checksum mismatch (always persistent: retrying cannot
                   un-rot host DRAM);
* ``"stall"``    — the op completes, but only after a configurable sleep
                   (a slow store; exercises deadline/watchdog paths).

Determinism contract: fault decisions are a pure function of the injector
seed and the *order* of backing-store operations.  The engine is
single-threaded and schedules deterministically, so a seeded fault storm
is exactly reproducible — the property the fault-storm benchmark's
survivor-parity check relies on.  Persistent faults are keyed by
``(op, rid, lpage)`` so every retry of the same swap op keeps failing.

Two planning modes compose:

* **rate mode** — each op draws from a seeded ``numpy`` Generator and
  fires one of ``kinds`` with probability ``rate``;
* **plan mode** — an explicit ``{op_index: FaultSpec}`` map pins faults to
  exact operations (unit tests; regression-exact storms).

Every injected fault is traced as ``EventType.FAULT_INJECT`` with
``a0 = rid`` and ``a1 = kind code (1=io, 2=corrupt, 3=stall) + 8 if
persistent``, so ``core.analysis.layer2_fault_recovery`` can stitch the
full injected-vs-recovered story from the trace alone.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.offload import BackingStoreError
from repro_torch.core.tracing import EventType, TraceBuffer

FAULT_IO = "io"
FAULT_CORRUPT = "corrupt"
FAULT_STALL = "stall"

KIND_CODES = {FAULT_IO: 1, FAULT_CORRUPT: 2, FAULT_STALL: 3}
CODE_KINDS = {v: k for k, v in KIND_CODES.items()}
PERSISTENT_FLAG = 8


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One plannable fault.  ``op`` restricts it to ``"put"``/``"pop"``
    (``"any"`` matches both); ``persistent`` pins the fault to its
    (op, rid, lpage) site so retries keep failing."""
    kind: str = FAULT_IO
    op: str = "any"
    persistent: bool = False
    stall_s: float = 0.0

    def __post_init__(self):
        if self.kind not in KIND_CODES:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.op not in ("put", "pop", "any"):
            raise ValueError(f"unknown fault op {self.op!r}")


class FaultInjector:
    """Deterministic fault plan over the backing store's swap ops.

    The store calls :meth:`before` ahead of every ``put``/``pop``; the
    injector either returns ``None`` (op proceeds), returns the
    :class:`FaultSpec` (corruption: the store mangles the payload after
    checksumming), sleeps (stall) or raises :class:`BackingStoreError`
    (I/O fault).  ``max_faults`` bounds a storm; counters and the
    optional ``tracer`` make every decision observable."""

    def __init__(self, *, seed: int = 0, rate: float = 0.0,
                 kinds: Tuple[FaultSpec, ...] = (FaultSpec(),),
                 plan: Optional[Dict[int, FaultSpec]] = None,
                 tracer: Optional[TraceBuffer] = None,
                 max_faults: Optional[int] = None):
        if not 0.0 <= rate <= 1.0:
            raise ValueError("rate must be within [0, 1]")
        self.rng = np.random.default_rng(seed)
        self.rate = rate
        self.kinds = tuple(kinds)
        self.plan = dict(plan or {})
        self.tracer = tracer
        self.max_faults = max_faults
        self.ops = 0                       # backing-store ops observed
        self.injected = 0                  # faults actually fired
        self.by_kind = {k: 0 for k in KIND_CODES}
        self._persistent: Dict[Tuple[str, int, int], FaultSpec] = {}

    # ------------------------------------------------------------------
    def _draw(self, idx: int, op: str) -> Optional[FaultSpec]:
        spec = self.plan.get(idx)
        if spec is None and self.rate and self.kinds:
            # both draws happen unconditionally so the rng stream depends
            # only on the op count, not on which faults fired before
            u = self.rng.random()
            j = int(self.rng.integers(len(self.kinds)))
            if u < self.rate:
                spec = self.kinds[j]
        if spec is None:
            return None
        if spec.op not in ("any", op):
            return None
        if spec.kind == FAULT_CORRUPT and op != "put":
            # corruption is a park-time phenomenon; on the restore side the
            # equivalent disruption is an I/O fault of the same persistence
            spec = FaultSpec(FAULT_IO, op, persistent=spec.persistent)
        return spec

    def before(self, op: str, rid: int, lpage: int) -> Optional[FaultSpec]:
        """Fault decision for one swap op.  Returns the spec for faults the
        *store* must apply (corruption), ``None`` for clean ops and stalls
        (which sleep here), and raises for I/O faults."""
        idx = self.ops
        self.ops += 1
        site = (op, rid, lpage)
        spec = self._persistent.get(site)
        if spec is None:
            if self.max_faults is not None and \
                    self.injected >= self.max_faults:
                return None
            spec = self._draw(idx, op)
            if spec is None:
                return None
            if spec.persistent:
                self._persistent[site] = spec
        self.injected += 1
        self.by_kind[spec.kind] += 1
        if self.tracer is not None:
            code = KIND_CODES[spec.kind] + \
                (PERSISTENT_FLAG if spec.persistent else 0)
            self.tracer.record_host(EventType.FAULT_INJECT, rid, code)
        if spec.kind == FAULT_STALL:
            if spec.stall_s > 0:
                time.sleep(spec.stall_s)
            return None
        if spec.kind == FAULT_CORRUPT:
            return spec
        raise BackingStoreError(rid, lpage, op, FAULT_IO,
                                transient=not spec.persistent,
                                detail="injected I/O fault")

    # ------------------------------------------------------------------
    def report(self) -> dict:
        return {
            "ops": self.ops,
            "injected": self.injected,
            "by_kind": dict(self.by_kind),
            "persistent_sites": len(self._persistent),
        }
