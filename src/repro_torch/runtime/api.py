"""Unified generation API for the paged serving engine (PyTorch port).

The frozen dataclasses of ``repro.runtime.api``, unchanged, so a caller
moves between the two packages without rewriting its requests:

* :class:`EngineConfig` — every pool / scheduler / kernel / speculation /
  mesh knob in one spec, with the KV-cache knobs grouped in
  :class:`CacheConfig`.  It also names the engine's time source
  (``clock`` — a :class:`~repro_torch.runtime.clock.Clock`) and the
  chunked-prefill/decode interleave (``scheduler_policy`` — a
  :class:`~repro_torch.runtime.frontdoor.SchedulerPolicy`).
* :class:`SamplingParams` — per-request decoding policy.
* :class:`GenerationRequest` / :class:`GenerationResult` — the immutable
  request/result pair; results carry a ``finish_reason``.
* :class:`TokenDelta` — the streaming unit of ``engine.generate()``; the
  concatenation of a request's token deltas is its result's tokens.
* :func:`make_engine` — the one factory of both engines.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

from repro_torch.core.rab import RABConfig

__all__ = [
    "EngineConfig", "CacheConfig", "CacheStats", "SamplingParams",
    "GenerationRequest", "GenerationResult", "TokenDelta", "make_engine",
    "FINISH_STOP", "FINISH_LENGTH", "FINISH_ABORTED",
    "FINISH_TIMEOUT", "FINISH_ERROR", "FINISH_SHED",
]

#: finish reasons a GenerationResult can carry
FINISH_STOP = "stop"          # a stop token was emitted
FINISH_LENGTH = "length"      # max_new tokens generated
FINISH_ABORTED = "aborted"    # run() iteration cap, or engine.cancel(rid)
FINISH_TIMEOUT = "timeout"    # deadline_iters / deadline_s exceeded
FINISH_ERROR = "error"        # per-request fault demotion (engine survives)
FINISH_SHED = "shed"          # rejected at admission under overload


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding policy, applied on device.

    ``temperature == 0`` selects exact greedy argmax — the historical
    engine behaviour, byte-identical, and the only mode speculative
    drafting engages for (greedy verification is what makes the PR 4
    parity guarantee structural).  ``temperature > 0`` divides the logits
    by the temperature, applies top-k then top-p truncation, and samples
    with a per-lane PRNG key derived as
    ``fold_in(PRNGKey(seed), position)`` — deterministic per (seed,
    position) no matter how the scheduler interleaves, chunks, preempts
    or shards the request.
    """
    temperature: float = 0.0    # 0 = greedy argmax
    top_k: int = 0              # 0 disables top-k truncation
    top_p: float = 1.0          # 1.0 disables nucleus truncation
    seed: int = 0               # per-request PRNG seed
    stop_tokens: Tuple[int, ...] = ()   # any of these ends the request
    max_new: int = 16           # generated-token budget

    def __post_init__(self):
        object.__setattr__(self, "stop_tokens", tuple(self.stop_tokens))
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0")
        if self.max_new < 1:
            raise ValueError("max_new must be >= 1")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


@dataclasses.dataclass(frozen=True)
class GenerationRequest:
    """What a caller submits: prompt + policy.  Immutable — the engine
    keeps its mutable bookkeeping in a private ``SeqState``.

    ``deadline_iters`` bounds the request's lifetime in *engine
    iterations* from submission (deterministic; benchmark-friendly);
    ``deadline_s`` bounds it in wall-clock seconds.  Either expiring
    finishes the request with ``finish_reason="timeout"`` — its pages are
    released through the same refcount/CoW/reservation-aware path as
    preemption, and tokens generated so far are kept."""
    rid: int
    prompt: Tuple[int, ...]
    sampling: SamplingParams = SamplingParams()
    priority: int = 0           # scheduler class; higher preempts lower
    deadline_iters: Optional[int] = None    # engine-iteration budget
    deadline_s: Optional[float] = None      # wall-clock budget (seconds)

    def __post_init__(self):
        object.__setattr__(self, "prompt", tuple(self.prompt))
        if self.deadline_iters is not None and self.deadline_iters < 1:
            raise ValueError("deadline_iters must be >= 1")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError("deadline_s must be > 0")


@dataclasses.dataclass(frozen=True)
class GenerationResult:
    """What a caller gets back: tokens + why generation ended + the
    request's scheduler/speculation statistics."""
    rid: int
    prompt: Tuple[int, ...]
    tokens: Tuple[int, ...]
    finish_reason: str          # one of the FINISH_* constants
    prefix_hit_tokens: int = 0
    preemptions: int = 0
    cluster: int = 0
    spec_proposed: int = 0
    spec_accepted: int = 0
    spec_rejected: int = 0
    spec_k_final: int = 0       # adaptive draft depth when the request ended
    error: Optional[str] = None  # diagnostic for FINISH_ERROR / FINISH_TIMEOUT

    @property
    def out(self):
        """Token list, matching the old mutable ``Request.out`` shape."""
        return list(self.tokens)


@dataclasses.dataclass(frozen=True)
class TokenDelta:
    """One streamed increment from ``engine.generate()``.

    ``event`` is ``"token"`` (plain decode/prefill emission), ``"spec"``
    (a draft-verify iteration; ``data`` = accepted draft count),
    ``"prefix_hit"`` (``data`` = prompt tokens served from the cache),
    ``"preempt"`` (``data`` = pages swapped out), or one of the
    terminal failure events — ``"abort"`` (iteration cap), ``"cancel"``
    (user ``engine.cancel(rid)``), ``"timeout"`` (deadline), ``"error"``
    (fault demotion) and ``"shed"`` (admission-time overload rejection).
    ``finish_reason`` is set on the delta that ends the request; the
    concatenation of a request's ``tokens`` across its deltas equals the
    final :class:`GenerationResult.tokens`.
    """
    rid: int
    tokens: Tuple[int, ...] = ()
    event: str = "token"
    data: int = 0
    finish_reason: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Paged KV-cache spec: the device pool plus the tiered spill hierarchy
    (HERO SVM: scratchpad -> host DRAM -> storage, each level larger and
    slower).  Lives at :attr:`EngineConfig.cache`.

    ``host_tier_pages > 0`` turns spill on: prefix-index entries evicted
    from the device pool demote their payload to a host tier (and, under
    host pressure, to a ``disk_tier_pages``-capped disk tier under
    ``disk_dir``) instead of vanishing, and an admission-time hit on a
    spilled entry promotes it back.  Promotion completes asynchronously on
    the engine clock: a batch of ``prefetch_depth`` pages costs one
    ``promote_latency_s`` quantum, during which the admitted request waits
    (other lanes keep decoding) — under a ``VirtualClock`` the schedule
    replays byte-identically.

    ``kv_dtype`` selects the page representation: ``"bf16"`` stores pages
    in the model's parameter dtype (exact), ``"int8"`` stores quantized
    pages with one float32 scale per (page, K/V, kv-head) riding beside
    the pool — the fused scatter quantizes at write, the attention kernels
    dequantize inside the K/V fetch, and attention math stays fp32.  The
    quantized form flows through CoW, speculative trim, preemption swap
    and tier demote/promote unchanged (spilled payloads carry page bytes +
    scales under one checksum)."""
    num_pages: int = 64             # device pool capacity (per cluster)
    page_size: int = 8              # tokens per KV page
    max_pages_per_seq: int = 16     # logical address space per sequence
    enable_prefix_cache: bool = True
    kv_dtype: str = "bf16"          # "bf16" (exact) | "int8" (quantized)
    host_tier_pages: int = 0        # 0 = spill off (entries drop on evict)
    disk_tier_pages: int = 0        # 0 = no disk tier below the host tier
    disk_dir: Optional[str] = None  # None -> store-owned temp dir
    prefetch_depth: int = 4         # pages promoted per latency quantum
    promote_latency_s: float = 0.0  # modeled H2D promotion quantum

    def __post_init__(self):
        if min(self.num_pages, self.page_size, self.max_pages_per_seq) < 1:
            raise ValueError("num_pages, page_size and max_pages_per_seq "
                             "must all be >= 1")
        if self.host_tier_pages < 0 or self.disk_tier_pages < 0:
            raise ValueError("tier capacities must be >= 0")
        if self.disk_tier_pages and not self.host_tier_pages:
            raise ValueError("disk_tier_pages requires host_tier_pages > 0 "
                             "(the disk tier hangs below the host tier)")
        if self.prefetch_depth < 1:
            raise ValueError("prefetch_depth must be >= 1")
        if self.promote_latency_s < 0:
            raise ValueError("promote_latency_s must be >= 0")
        if self.kv_dtype not in ("bf16", "int8"):
            raise ValueError(
                f"kv_dtype must be 'bf16' or 'int8', got {self.kv_dtype!r}")

    @property
    def spill_enabled(self) -> bool:
        return self.host_tier_pages > 0


@dataclasses.dataclass(frozen=True)
class CacheStats:
    """A frozen snapshot of the cache hierarchy, from
    ``engine.cache_stats()`` — the public replacement for poking
    ``pool.cached_free`` / backing-store internals.

    Hit counts are in *pages served at admission*, split by the tier the
    page was resident in when the request hit it; ``miss_pages`` counts
    prompt pages that had to prefill fresh.  Byte counters measure payload
    traffic crossing tier boundaries in each direction.
    ``bytes_per_token`` is the KV-cache footprint of one resident token
    across all layers (page bytes plus the amortized per-page scale slab
    in int8 mode) — the quantization win reads directly off the ratio of
    two engines' values."""
    device_pages: int = 0           # device pool capacity (all clusters)
    device_indexed: int = 0         # prefix entries resident on device
    device_cached_free: int = 0     # ... of which parked on the LRU
    host_pages: int = 0             # cache entries resident in host tier
    disk_pages: int = 0             # cache entries resident in disk tier
    hits_device_pages: int = 0
    hits_host_pages: int = 0
    hits_disk_pages: int = 0
    miss_pages: int = 0
    prefix_hit_tokens: int = 0      # prompt tokens served from any tier
    promotions_in_flight: int = 0   # scheduled, not yet landed
    demoted_pages: int = 0          # device -> down-tier parks
    promoted_pages: int = 0         # down-tier -> device restores
    dropped_entries: int = 0        # lost off the bottom tier / fetch fault
    bytes_demoted: int = 0
    bytes_promoted: int = 0
    evictions: int = 0              # device LRU evictions (spill or drop)
    bytes_per_token: float = 0.0    # KV bytes/resident token, all layers


#: EngineConfig fields that moved into CacheConfig (PR 8); accepted flat
#: for one release behind a DeprecationWarning.
_CACHE_FLAT = ("num_pages", "page_size", "max_pages_per_seq",
               "enable_prefix_cache")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Every engine knob in one spec (HERO: one platform configuration
    drives the whole PMCA instantiation).

    ``clusters`` / ``heads`` / ``mesh`` / ``sharded`` select the engine
    class through :func:`make_engine`: any multi-cluster, head-sharded or
    explicitly ``sharded`` spec builds a ``ShardedPagedServer`` (where
    ``cache.num_pages`` and ``max_lanes`` are per cluster), everything
    else the plain ``PagedServer``.

    Cache knobs live in the nested frozen :class:`CacheConfig` at
    ``cache``.  The old flat spellings (``num_pages``, ``page_size``,
    ``max_pages_per_seq``, ``enable_prefix_cache``) are accepted for one
    release: a flat value that differs from ``cache``'s emits a
    ``DeprecationWarning`` and is folded in; after normalization the flat
    fields mirror ``cache`` so legacy readers keep working and
    ``dataclasses.replace`` round-trips silently."""
    # pool / cache hierarchy (flat fields are the deprecated spellings)
    num_pages: Optional[int] = None             # DEPRECATED -> cache
    page_size: Optional[int] = None             # DEPRECATED -> cache
    max_pages_per_seq: Optional[int] = None     # DEPRECATED -> cache
    rab_cfg: RABConfig = RABConfig(l1_entries=8, l2_entries=32,
                                   l2_assoc=4, l2_banks=2)
    enable_prefix_cache: Optional[bool] = None  # DEPRECATED -> cache
    cache: Optional[CacheConfig] = None         # None -> CacheConfig()
    # scheduler
    max_lanes: int = 4
    chunk: int = 16
    clock: Optional[object] = None      # runtime.clock.Clock; None -> the
    #                                     wall MonotonicClock.  Every
    #                                     scheduler timestamp (deadline_s,
    #                                     retry backoff, straggler EMA)
    #                                     reads this source
    scheduler_policy: Optional[object] = None   # frontdoor.SchedulerPolicy;
    #                                     None -> GreedyChunkPolicy (the
    #                                     historical prefill interleave)
    # kernels
    use_kernel: bool = True
    pages_per_step: int = 2
    # speculation
    spec_k: int = 0
    drafter: Optional[object] = None    # runtime.speculative.Drafter
    # mesh (sharded engine only)
    clusters: int = 1
    heads: int = 1
    mesh: Optional[object] = None       # launch.mesh.ClusterMesh
    sharded: bool = False               # force ShardedPagedServer at C=H=1
    # fault tolerance
    fault_injector: Optional[object] = None  # runtime.faults.FaultInjector
    swap_retries: int = 3               # retry budget for transient faults
    retry_backoff_s: float = 0.0        # 0 -> transient swap-in faults
    #                                     retry immediately (in-place);
    #                                     > 0 -> the resume is DEFERRED on
    #                                     the engine clock (base delay,
    #                                     doubled per attempt) while other
    #                                     lanes keep decoding — the engine
    #                                     loop never sleeps
    max_queue_depth: int = 0            # 0 = unbounded; else shed overload
    watchdog_iters: int = 0             # 0 = off; abort lanes stalled
    #                                     this many iterations
    straggler_factor: float = 0.0       # 0 = off; EMA multiple that flags
    #                                     a straggler engine iteration

    def __post_init__(self):
        cache = self.cache if self.cache is not None else CacheConfig()
        legacy = {}
        for f in _CACHE_FLAT:
            v = getattr(self, f)
            if v is not None and v != getattr(cache, f):
                legacy[f] = v
        if legacy:
            warnings.warn(
                "EngineConfig(%s): flat cache knobs are deprecated; pass "
                "EngineConfig(cache=CacheConfig(...)) instead"
                % ", ".join(sorted(legacy)),
                DeprecationWarning, stacklevel=3)
            cache = dataclasses.replace(cache, **legacy)
        object.__setattr__(self, "cache", cache)
        # mirror back: legacy readers see one consistent spec, and
        # dataclasses.replace() (which re-passes the mirrored values next
        # to `cache`) round-trips without re-warning
        for f in _CACHE_FLAT:
            object.__setattr__(self, f, getattr(cache, f))

    @property
    def wants_sharded(self) -> bool:
        return (self.sharded or self.clusters > 1 or self.heads > 1
                or self.mesh is not None)


def make_engine(cfg, params, engine_cfg: Optional[EngineConfig] = None, *,
                tracer=None, device=None):
    """Build the engine for ``engine_cfg`` (default spec if None) on
    ``device`` (``cuda`` unless the caller passes ``"cpu"``).

    One factory, both engines: a spec with ``clusters > 1``, ``heads > 1``,
    an explicit ``mesh`` or ``sharded=True`` returns a
    ``ShardedPagedServer``; anything else the unsharded ``PagedServer``.
    """
    from repro_torch.runtime.server import PagedServer
    from repro_torch.runtime.sharded_server import ShardedPagedServer

    engine_cfg = engine_cfg or EngineConfig()
    cls = ShardedPagedServer if engine_cfg.wants_sharded else PagedServer
    return cls(cfg, params, engine_cfg, tracer=tracer, device=device)
