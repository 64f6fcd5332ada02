"""Event tracing (HERO §2.3.1), host side.

Ported from ``repro.core.tracing``: the event schema, the host tracer id
and the host half of ``TraceBuffer`` (``record_host`` / ``drain``).  The
reference's in-step device recorder (``device_init`` / ``record`` /
``tick``) is not ported yet; ``drain`` here returns host events only.

Event schema (int64 x 5): (timestamp, tracer_id, event_type, arg0, arg1).
"""
from __future__ import annotations

import enum
from typing import List, Tuple

import numpy as np


class EventType(enum.IntEnum):
    # device-side
    STEP_BEGIN = 1
    STEP_END = 2
    MEM_READ = 3
    MEM_WRITE = 4
    SYNC = 5
    # RAB / VMM protocol (§3.4)
    TLB_L1_HIT = 10
    TLB_L2_HIT = 11
    TLB_MISS = 12
    MISS_HANDLED = 13
    CORE_SLEEP = 14
    CORE_WAKE = 15
    # offload runtime (§2.2)
    OFFLOAD_BEGIN = 20
    OFFLOAD_COPY_TO = 21
    OFFLOAD_KERNEL_BEGIN = 22
    OFFLOAD_KERNEL_END = 23
    OFFLOAD_COPY_FROM = 24
    OFFLOAD_END = 25
    # scheduler / serving
    PAGE_ALLOC = 30
    PAGE_RELEASE = 31
    REQUEST_ADMIT = 32
    REQUEST_FINISH = 33
    # shared-prefix KV cache + preemption
    PAGE_COW = 34          # copy-on-write: (seq, new physical page)
    PREFIX_HIT = 35        # admission prefix-cache hit: (rid, tokens reused)
    REQUEST_PREEMPT = 36   # (rid, private pages swapped out)
    SWAP_OUT = 37          # D2H page reclamation: (rid, pages)
    SWAP_IN = 38           # H2D page restoration: (rid, pages)
    # host<->device transfers on the serving hot path
    H2D = 40
    D2H = 41
    # multi-cluster sharded serving
    CLUSTER_DISPATCH = 42  # request placed on a cluster: (rid, cluster)
    ALL_GATHER = 43        # cross-cluster token gather: (iter, active clusters)
    # speculative decoding
    SPEC_PROPOSE = 44      # drafter proposal: (rid, drafted tokens)
    SPEC_ACCEPT = 45       # verified acceptance: (rid, accepted tokens)
    SPEC_ROLLBACK = 46     # rejected drafts undone: (rid, rejected tokens)
    # fault tolerance
    FAULT_INJECT = 47      # injected fault: (rid, kind code | 8*persistent)
    REQUEST_TIMEOUT = 48   # deadline exceeded: (rid, engine iteration)
    REQUEST_SHED = 49      # admission-time load shed: (rid, queue depth)
    DEGRADE = 50           # graceful degradation: (subject, cause code
    #                        1=drafter disabled, 2=watchdog abort,
    #                        3=straggler iteration flagged)
    # live-traffic serving
    REQUEST_ARRIVE = 51    # request entered the queue: (rid, queue depth)
    # hierarchical prefix cache: args (entry_id, src_tier * 4 + dst_tier)
    PAGE_DEMOTE = 52       # cache entry moved down-tier (or dropped)
    PAGE_PROMOTE = 53      # cache entry restored to the device pool


HOST_TRACER_ID = 255


class TraceBuffer:
    """Host event buffer: one logical clock, one event list."""

    def __init__(self):
        self.host_events: List[Tuple[int, int, int, int, int]] = []
        self._host_clock = 0

    def record_host(self, etype: EventType, a0: int = 0, a1: int = 0):
        self._host_clock += 1
        self.host_events.append(
            (self._host_clock, HOST_TRACER_ID, int(etype), int(a0), int(a1)))

    def drain(self) -> np.ndarray:
        """Pull and clear the host events: an (N,5) int64 array sorted by
        (source, timestamp)."""
        if not self.host_events:
            return np.zeros((0, 5), np.int64)
        out = np.asarray(self.host_events, np.int64)
        self.host_events = []
        return out[np.lexsort((out[:, 0], out[:, 1]))]
