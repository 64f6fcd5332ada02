"""OpenMP-4.5-style offload runtime (HERO §2.2), copy-based vs zero-copy,
and the host-side backing store for reclaimed KV pages (HERO §2.2 SVM
page reclamation), ported from ``repro.core.offload``.

HERO encapsulates accelerator kernels in ``omp target`` regions; the RTE
plugin implements two offload semantics:

  * copy-based shared memory: inputs are serialized into a physically
    contiguous, uncached staging area (pointer-rich structures must be
    flattened and their pointers rewritten), copied to the accelerator,
    outputs copied back;
  * zero-copy SVM: host passes virtual-address *pointers*; the PMCA
    translates through the RAB at run time.

``OffloadTarget`` maps a ``target`` region to a Python callable run on one
device.  Copy mode stages through pageable host memory (serialize ->
contiguous numpy -> ``torch.from_numpy(x).to(device)`` -> run -> ``.cpu()``
back to numpy), synchronizing the device where the reference blocks until
ready.  Zero-copy mode passes SVM handles to device-resident tensors (no
host staging).  ``OffloadReport`` splits total time into offload vs
kernel, the Fig.5 measurement.  A host leaf of a type numpy lacks
(bfloat16) is staged and returned as a CPU tensor.

The serving engine parks a preempted request's page payloads in
``HostBackingStore`` (D2H) and restores them on re-admission (H2D).
Payloads are numpy arrays; the store checksums each at park and verifies
it at restore.  The disk tier is not ported yet.
"""
from __future__ import annotations

import collections
import dataclasses
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.svm import SVMSpace
from repro_torch.core.tracing import EventType, TraceBuffer
from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class OffloadReport:
    mode: str                 # "copy" | "zero_copy"
    offload_s: float          # host-side data preparation + transfers
    kernel_s: float           # device execution
    writeback_s: float        # copy-back (copy mode only)
    bytes_to: int = 0
    bytes_from: int = 0

    @property
    def total_s(self) -> float:
        return self.offload_s + self.kernel_s + self.writeback_s


def _tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` over the leaves of nested tuples, lists and dicts; ``None``
    is an empty subtree, as in ``jax.tree``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree: Any) -> list:
    out: list = []
    _tree_map(out.append, tree)
    return out


def _nbytes(tree: Any) -> int:
    return sum(x.nbytes if isinstance(x, torch.Tensor)
               else np.asarray(x).nbytes for x in _leaves(tree))


def _stage(x: Any) -> torch.Tensor:
    """Serialize one host leaf into contiguous host memory: a numpy copy
    viewed as a tensor, or a CPU tensor for a type numpy lacks."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError("copy-based offload takes host arrays; got a "
                             f"tensor on {x.device}")
        return x.contiguous()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _to_host(x: Any) -> Any:
    """Copy one output leaf back to host memory: numpy, or a CPU tensor
    for bfloat16 (numpy has no such type)."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.cpu()
    return x if x.dtype == torch.bfloat16 else x.numpy()


class BackingStoreError(RuntimeError):
    """Typed backing-store failure carrying the exact swap operation that
    broke: (rid, logical page, op).  ``transient`` distinguishes faults
    worth retrying (injected I/O hiccups) from persistent ones (missing
    page, double-park, checksum mismatch) which the engine must demote to
    a per-request ``"error"`` finish instead of retrying forever."""

    def __init__(self, rid: int, lpage: int, op: str, kind: str = "io",
                 *, transient: bool = False, detail: str = ""):
        msg = f"backing store {op} failed for rid={rid} lpage={lpage} " \
              f"[{kind}]"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)
        self.rid = rid
        self.lpage = lpage
        self.op = op
        self.kind = kind
        self.transient = transient


# Tier codes shared by the trace events (PAGE_DEMOTE / PAGE_PROMOTE pack
# ``src * 4 + dst`` into arg1) and ``core.analysis.layer2_tier_residency``.
TIER_DEVICE = 0
TIER_HOST = 1
TIER_DISK = 2
TIER_DROPPED = 3
TIER_NAMES = {TIER_DEVICE: "device", TIER_HOST: "host",
              TIER_DISK: "disk", TIER_DROPPED: "dropped"}
TIER_CODES = {v: k for k, v in TIER_NAMES.items()}


class BackingTier:
    """One level of the host-side backing hierarchy.

    A tier is a flat ``key -> payload`` map with a page-count capacity
    (``0`` = unbounded).  :class:`HostBackingStore` composes tiers into a
    spill chain and owns all policy — LRU ordering, checksums, cascade on
    overflow, fault injection — so a tier only needs dumb storage.  This is
    the HERO SVM ladder: scratchpad (device pool) -> host DRAM
    (:class:`HostTier`) -> storage (a disk tier, not ported yet), each
    level slower and larger than the one above it."""

    name = "tier"

    def __init__(self, capacity_pages: int = 0):
        self.capacity_pages = capacity_pages

    def store(self, key: Tuple, payload: np.ndarray) -> None:
        raise NotImplementedError

    def load(self, key: Tuple) -> np.ndarray:
        raise NotImplementedError

    def delete(self, key: Tuple) -> None:
        raise NotImplementedError

    def __contains__(self, key: Tuple) -> bool:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def close(self) -> None:
        pass


class HostTier(BackingTier):
    """Host-DRAM tier: plain in-memory dict."""

    name = "host"

    def __init__(self, capacity_pages: int = 0):
        super().__init__(capacity_pages)
        self._data: Dict[Tuple, np.ndarray] = {}

    def store(self, key, payload):
        self._data[key] = payload

    def load(self, key):
        return self._data[key]

    def delete(self, key):
        del self._data[key]

    def __contains__(self, key):
        return key in self._data

    def __len__(self):
        return len(self._data)

    def close(self):
        self._data.clear()


# Unified key space inside the store: preemption swap traffic and prefix
# cache spill traffic share the tier chain (and therefore the capacity
# pressure), but are distinguishable so only cache entries may ever be
# dropped off the bottom.
_SWAP = "swap"
_CACHE = "cache"


class HostBackingStore:
    """Tiered host-side backing store for reclaimed KV pages.

    When the serving scheduler preempts a sequence, its pages are dropped
    from the device pool (non-shared ones are thereby reclaimed): the
    payload crosses D2H into this store and crosses back H2D on
    re-admission.  This is HERO's SVM page
    reclamation (§2.2): because translation is software-managed, a physical
    page can be repurposed while its *content* survives in host memory, and
    the mapping is re-established later without the accelerator noticing
    anything but a RAB refill.

    Since PR 8 the store is a spill *chain* of :class:`BackingTier` levels
    (host DRAM, then optionally a lower tier) shared by two traffic classes:

      * **swap** payloads (``put``/``pop``/``repark``/``discard``) — a
        preempted request's private pages.  Never dropped: under pressure
        they demote down-tier, and the bottom tier may exceed its capacity
        rather than lose one.
      * **cache** payloads (``park_cache``/``fetch_cache``/``drop_cache``)
        — prefix-index entries evicted from the device pool.  Evictable:
        when the bottom tier overflows, the least-recently-used cache entry
        is dropped (and counted).

    The store only keeps host copies and byte counters; the engine owns the
    transfers themselves (and traces them as SWAP_OUT / SWAP_IN /
    PAGE_DEMOTE / PAGE_PROMOTE plus the underlying H2D / D2H events).
    Inter-tier cache moves are queued in ``drain_cache_moves()`` order so
    the engine can trace every transition (the tier-conservation assert in
    ``core.analysis`` checks no entry is lost or duplicated).

    Failure semantics: ``put``/``pop``/``fetch_cache`` raise
    :class:`BackingStoreError` (never a bare ``KeyError`` or a silent
    overwrite), every parked payload is checksummed at park time and
    verified on restore *whatever tier it comes back from* (a mismatch is a
    persistent ``corrupt`` fault), and an optional ``fault_injector``
    (``runtime.faults.FaultInjector``) perturbs the swap and
    cache-restore paths with seeded, deterministic I/O errors / corruption
    / stalls for chaos testing."""

    def __init__(self, fault_injector=None, *, host_pages: int = 0,
                 disk_tier: Optional[BackingTier] = None):
        self.tiers: List[BackingTier] = [HostTier(host_pages)]
        if disk_tier is not None:
            self.tiers.append(disk_tier)
        # key -> tier index, in LRU order (oldest first)
        self._where: "collections.OrderedDict[Tuple, int]" = \
            collections.OrderedDict()
        self._sums: Dict[Tuple, int] = {}
        self.faults = fault_injector
        self.bytes_out = 0       # device -> host (swap-out)
        self.bytes_in = 0        # host -> device (swap-in)
        self.peak_pages = 0
        # cache-tier accounting (CacheStats feeds on these)
        self.cache_bytes_demoted = 0
        self.cache_bytes_promoted = 0
        self.cache_hits = {"host": 0, "disk": 0}
        self.cache_dropped = 0
        self._moves: List[Tuple[int, int, int]] = []  # (entry, src, dst)

    # ------------------------------------------------------------ plumbing --
    def _tier_code(self, idx: int) -> int:
        return TIER_CODES[self.tiers[idx].name]

    def _insert(self, key: Tuple, arr: np.ndarray):
        self.tiers[0].store(key, arr)
        self._where[key] = 0
        self._where.move_to_end(key)
        self._balance()

    def _move_down(self, key: Tuple, src: int):
        arr = self.tiers[src].load(key)
        self.tiers[src].delete(key)
        self.tiers[src + 1].store(key, arr)
        self._where[key] = src + 1
        if key[0] == _CACHE:
            self.cache_bytes_demoted += arr.nbytes
            self._moves.append((key[1], self._tier_code(src),
                                self._tier_code(src + 1)))

    def _drop(self, key: Tuple, src: int):
        self.tiers[src].delete(key)
        del self._where[key]
        del self._sums[key]
        if key[0] == _CACHE:
            self.cache_dropped += 1
            self._moves.append((key[1], self._tier_code(src), TIER_DROPPED))

    def _balance(self):
        """Cascade LRU overflow down the tier chain; drop LRU *cache*
        entries off the bottom (swap payloads may overflow the last tier
        rather than be lost)."""
        for i, tier in enumerate(self.tiers):
            if tier.capacity_pages <= 0:
                continue
            last = i == len(self.tiers) - 1
            while len(tier) > tier.capacity_pages:
                victim = None
                for key, where in self._where.items():   # oldest first
                    if where != i:
                        continue
                    if last and key[0] != _CACHE:
                        continue                         # swap: never drop
                    victim = key
                    break
                if victim is None:
                    break
                if last:
                    self._drop(victim, i)
                else:
                    self._move_down(victim, i)

    def _fetch(self, key: Tuple, rid: int, lpage: int) -> np.ndarray:
        idx = self._where.pop(key)
        arr = self.tiers[idx].load(key)
        self.tiers[idx].delete(key)
        crc = self._sums.pop(key)
        if zlib.crc32(np.ascontiguousarray(arr).tobytes()) != crc:
            raise BackingStoreError(
                rid, lpage, "pop", "corrupt", transient=False,
                detail=f"checksum mismatch on restore from "
                       f"{self.tiers[idx].name}")
        return arr

    def drain_cache_moves(self) -> List[Tuple[int, int, int]]:
        """Inter-tier cache transitions (entry_id, src, dst) since the last
        drain, in order — the engine traces them as PAGE_DEMOTE events."""
        moves, self._moves = self._moves, []
        return moves

    # ---------------------------------------------------------- swap class --
    def put(self, seq: int, lpage: int, payload: np.ndarray):
        key = (_SWAP, seq, lpage)
        if key in self._where:
            raise BackingStoreError(
                seq, lpage, "put", "overwrite",
                detail="page is already parked (double swap-out)")
        arr = np.ascontiguousarray(np.asarray(payload))
        spec = None
        if self.faults is not None:
            spec = self.faults.before("put", seq, lpage)   # may raise/stall
        self._sums[key] = zlib.crc32(arr.tobytes())
        if spec is not None and spec.kind == "corrupt":
            # silent bit-rot after the checksum was taken: the damage is
            # only discovered at swap-in, as a checksum mismatch
            arr = arr.copy()
            arr.view(np.uint8).reshape(-1)[0] ^= 0xFF
        self._insert(key, arr)
        self.bytes_out += arr.nbytes
        self.peak_pages = max(self.peak_pages, len(self))

    def pop(self, seq: int, lpage: int) -> np.ndarray:
        key = (_SWAP, seq, lpage)
        if key not in self._where:
            raise BackingStoreError(
                seq, lpage, "pop", "missing",
                detail="page was never parked (or already restored)")
        if self.faults is not None:
            self.faults.before("pop", seq, lpage)          # may raise/stall
        arr = self._fetch(key, seq, lpage)
        self.bytes_in += arr.nbytes
        return arr

    def repark(self, seq: int, lpage: int, payload: np.ndarray):
        """Undo a successful :meth:`pop` whose *batch* failed: the engine
        popped several pages for one swap-in, a later page faulted
        transiently, and the whole resume is being deferred — the
        already-popped payloads go back exactly as they were.  No fault
        injection (the op already succeeded once; re-parking is engine
        bookkeeping, not new I/O) and the ``bytes_in`` the pop counted is
        credited back, so a deferred attempt costs no phantom traffic."""
        key = (_SWAP, seq, lpage)
        if key in self._where:
            raise BackingStoreError(
                seq, lpage, "repark", "overwrite",
                detail="page is already parked (repark without pop)")
        arr = np.ascontiguousarray(np.asarray(payload))
        self._sums[key] = zlib.crc32(arr.tobytes())
        self._insert(key, arr)
        self.bytes_in -= arr.nbytes
        self.peak_pages = max(self.peak_pages, len(self))

    def discard(self, seq: int):
        """Drop every parked page of ``seq`` without counting swap-in
        traffic (the abort path: payload is released, never restored) —
        across **all** tiers, so a cancelled request that was pushed down
        to disk under host pressure cannot strand files there."""
        for key in [k for k in self._where if k[0] == _SWAP and k[1] == seq]:
            idx = self._where.pop(key)
            self.tiers[idx].delete(key)
            self._sums.pop(key, None)

    def __len__(self) -> int:
        """Number of parked *swap* pages (cache entries are accounted via
        :meth:`cache_resident`)."""
        return sum(1 for k in self._where if k[0] == _SWAP)

    # --------------------------------------------------------- cache class --
    def park_cache(self, entry_id: int, payload: np.ndarray):
        """Park a demoted prefix-cache page (device -> host tier).  Engine
        bookkeeping like :meth:`repark` — no fault injection on the way
        down; the checksum taken here is verified whenever (and from
        whatever tier) the entry is promoted back."""
        key = (_CACHE, entry_id)
        if key in self._where:       # same entry re-demoted: replace
            idx = self._where.pop(key)
            self.tiers[idx].delete(key)
            self._sums.pop(key, None)
        arr = np.ascontiguousarray(np.asarray(payload))
        self._sums[key] = zlib.crc32(arr.tobytes())
        self._insert(key, arr)
        self.cache_bytes_demoted += arr.nbytes

    def fetch_cache(self, entry_id: int, rid: int) -> Tuple[np.ndarray, str]:
        """Fetch (and remove) a spilled cache entry for promotion on behalf
        of request ``rid``.  Returns ``(payload, tier_name)`` so the engine
        can trace which tier served the hit.  The fault injector sees this
        as a ``pop`` — tiered restores get the same chaos coverage as swap
        restores."""
        key = (_CACHE, entry_id)
        if key not in self._where:
            raise BackingStoreError(
                rid, entry_id, "pop", "missing",
                detail="cache entry is not parked (dropped or never spilled)")
        tier_name = self.tiers[self._where[key]].name
        if self.faults is not None:
            self.faults.before("pop", rid, entry_id)       # may raise/stall
        arr = self._fetch(key, rid, entry_id)
        self.cache_bytes_promoted += arr.nbytes
        self.cache_hits[tier_name] = self.cache_hits.get(tier_name, 0) + 1
        return arr, tier_name

    def drop_cache(self, entry_id: int):
        """Silently forget a spilled entry (fetch fault fallback, or the
        entry was re-registered on-device and the spill copy superseded)."""
        key = (_CACHE, entry_id)
        if key in self._where:
            self._drop(key, self._where[key])

    def cache_tier(self, entry_id: int) -> Optional[str]:
        idx = self._where.get((_CACHE, entry_id))
        return None if idx is None else self.tiers[idx].name

    def cache_resident(self) -> Dict[str, int]:
        """Cache entries resident per tier name."""
        out = {t.name: 0 for t in self.tiers}
        for key, idx in self._where.items():
            if key[0] == _CACHE:
                out[self.tiers[idx].name] += 1
        return out

    # ------------------------------------------------------------- hygiene --
    def check_invariants(self):
        """Every tracked key lives in exactly the tier the index says, has
        a checksum, and appears in no other tier."""
        for key, idx in self._where.items():
            assert key in self.tiers[idx], (key, idx)
            assert key in self._sums, key
            for j, tier in enumerate(self.tiers):
                if j != idx:
                    assert key not in tier, (key, idx, j)
        tracked = len(self._where)
        stored = sum(len(t) for t in self.tiers)
        assert tracked == stored, (tracked, stored)

    def close(self):
        """Release every tier (disk tiers delete their files; an owned temp
        directory is removed)."""
        self._where.clear()
        self._sums.clear()
        for tier in self.tiers:
            tier.close()


class OffloadTarget:
    """The 'PMCA': one device + the offload RTE around it."""

    def __init__(self, svm: Optional[SVMSpace] = None,
                 tracer: Optional[TraceBuffer] = None,
                 device: DeviceLike = None):
        self.svm = svm or SVMSpace()
        self.tracer = tracer
        self.device = resolve_device(device)

    def _trace(self, etype: EventType, a: int = 0, b: int = 0):
        if self.tracer is not None:
            self.tracer.record_host(etype, a, b)

    def _sync(self):
        """Wait for the device's queued work (``block_until_ready``)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def target(self, fn: Callable, *, donate: Sequence[int] = ()) -> Callable:
        """Mark a kernel for offload (the `omp target` outline step).

        PyTorch runs eagerly, so the outlined region is ``fn`` itself:
        there is no jitted function to cache.  ``donate`` is accepted and
        ignored: torch has no buffer donation.
        """
        del donate
        return fn

    # ------------------------------------------------------------------
    def run_copy_based(self, fn: Callable, *host_args: Any
                       ) -> Tuple[Any, OffloadReport]:
        """Copy-based SM offload: serialize -> stage -> run -> copy back.

        ``host_args`` are host-side structures (numpy arrays, CPU tensors
        or nested containers).  The serialization into contiguous staging
        buffers models HERO's physically-contiguous uncached section,
        including the pointer-flattening cost for linked structures.
        """
        jfn = self.target(fn)
        self._trace(EventType.OFFLOAD_BEGIN, 0, 0)
        t0 = time.perf_counter()
        # serialize: force one contiguous host copy of every leaf
        staged = _tree_map(_stage, host_args)
        blob_bytes = _nbytes(staged)
        # stage to device (the DMA across the host/PMCA boundary)
        dev = _tree_map(lambda x: x.to(self.device), staged)
        self._sync()
        t1 = time.perf_counter()
        self._trace(EventType.OFFLOAD_COPY_TO, blob_bytes % (1 << 31), 0)

        self._trace(EventType.OFFLOAD_KERNEL_BEGIN, 0, 0)
        out = jfn(*dev)
        self._sync()
        t2 = time.perf_counter()
        self._trace(EventType.OFFLOAD_KERNEL_END, 0, 0)

        # copy back to host memory (uncached section -> host structures)
        host_out = _tree_map(_to_host, out)
        t3 = time.perf_counter()
        bytes_from = _nbytes(host_out)
        self._trace(EventType.OFFLOAD_COPY_FROM, bytes_from % (1 << 31), 0)
        self._trace(EventType.OFFLOAD_END, 0, 0)
        rep = OffloadReport("copy", t1 - t0, t2 - t1, t3 - t2,
                            bytes_to=blob_bytes, bytes_from=bytes_from)
        return host_out, rep

    # ------------------------------------------------------------------
    def run_zero_copy(self, fn: Callable, *handles: int,
                      donate: Sequence[int] = ()
                      ) -> Tuple[Any, OffloadReport]:
        """Zero-copy SVM offload: pass pointers, no staging.

        ``handles`` are SVM handles to device-resident tensors.  The
        kernel's outputs are published back into SVM and returned as
        handles too — the host never touches the payload (Fig.5's SVM
        bars).
        """
        jfn = self.target(fn, donate=donate)
        self._trace(EventType.OFFLOAD_BEGIN, 1, 0)
        t0 = time.perf_counter()
        args = [self.svm.deref(h) for h in handles]       # pointer deref only
        t1 = time.perf_counter()
        self._trace(EventType.OFFLOAD_KERNEL_BEGIN, 0, 0)
        out = jfn(*args)
        self._sync()
        t2 = time.perf_counter()
        self._trace(EventType.OFFLOAD_KERNEL_END, 0, 0)
        out_handles = _tree_map(self.svm.share, out)
        self._trace(EventType.OFFLOAD_END, 0, 0)
        rep = OffloadReport("zero_copy", t1 - t0, t2 - t1, 0.0)
        return out_handles, rep
