"""Event tracing (HERO §2.3.1): in-step device recorder + host tracer.

Ported from ``repro.core.tracing``: the event schema, the host tracer id
and ``TraceBuffer`` with both halves.  The device half is a dict of int32
tensors (``device_init``) that ``record`` / ``tick`` advance and return,
as the reference's pytree; ``record`` never synchronizes with the host
(the saturating row index is computed on the device and the row written
through a tensor index), so ``drain`` is the single sync.  Unlike the
reference's pure update, ``record`` writes the row into the events tensor
in place (no copy of the whole buffer per event); the returned dict is
the one to keep using.

Event schema (int64 x 5): (timestamp, tracer_id, event_type, arg0, arg1).
"""
from __future__ import annotations

import enum
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


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


Scalar = Union[int, torch.Tensor]


class TraceBuffer:
    """Fixed-capacity event buffer; the device part is a dict of tensors."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self.host_events: List[Tuple[int, int, int, int, int]] = []
        self._host_clock = 0
        self.dropped = 0

    # ------------------------------------------------------------- device --
    def device_init(self, device: DeviceLike = None
                    ) -> Dict[str, torch.Tensor]:
        dev = resolve_device(device)
        return {
            "events": torch.zeros((self.capacity, 5), dtype=torch.int32,
                                  device=dev),
            "count": torch.zeros((), dtype=torch.int32, device=dev),
            "clock": torch.zeros((), dtype=torch.int32, device=dev),
        }

    @staticmethod
    def record(dev: Dict[str, torch.Tensor], tracer_id: Scalar, etype: Scalar,
               a0: Scalar = 0, a1: Scalar = 0) -> Dict[str, torch.Tensor]:
        """In-step event record (saturating: past capacity the last row is
        overwritten and ``drain`` counts the drops).  Python ints become
        device scalars through ``full_like`` (a fill kernel, no copy from
        the host); tensor arguments stay on the device."""
        events, count, clock = dev["events"], dev["count"], dev["clock"]
        cap = events.shape[0]
        idx = torch.clamp(count, max=cap - 1)

        def scalar(v):
            if isinstance(v, torch.Tensor):
                return v.to(torch.int32).reshape(())
            return torch.full_like(clock, int(v))

        ev = torch.stack([clock, scalar(tracer_id), scalar(etype),
                          scalar(a0), scalar(a1)])
        events.index_copy_(0, idx.reshape(1).long(), ev[None, :])
        return {"events": events, "count": count + 1, "clock": clock + 1}

    @staticmethod
    def tick(dev: Dict[str, torch.Tensor], n: int = 1
             ) -> Dict[str, torch.Tensor]:
        """Advance the logical clock without recording (models latency)."""
        return dict(dev, clock=dev["clock"] + n)

    # --------------------------------------------------------------- host --
    def record_host(self, etype: EventType, a0: int = 0, a1: int = 0):
        self._host_clock += 1
        self.host_events.append(
            (self._host_clock, HOST_TRACER_ID, int(etype), int(a0), int(a1)))

    def drain(self, dev: Optional[Dict[str, torch.Tensor]] = None
              ) -> np.ndarray:
        """Freeze-and-drain: pull device events + host events, clear the
        host list.

        Returns an (N,5) int64 array sorted by (source, timestamp); device
        timestamps are kept in their own clock domain (tracer_id separates
        domains, as HERO's per-logger streams do).  Reading the device
        count is the recorder's one host sync.
        """
        rows: List[np.ndarray] = []
        if dev is not None:
            n = int(dev["count"])
            cap = dev["events"].shape[0]
            if n > cap:
                self.dropped += n - cap
                n = cap
            if n:
                rows.append(dev["events"][:n].cpu().numpy().astype(np.int64))
        if self.host_events:
            rows.append(np.asarray(self.host_events, np.int64))
            self.host_events = []
        if not rows:
            return np.zeros((0, 5), np.int64)
        out = np.concatenate(rows, axis=0)
        return out[np.lexsort((out[:, 0], out[:, 1]))]
