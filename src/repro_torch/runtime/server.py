"""Paged continuous-batching serving engine on the RAB + paged KV pool.

The port of ``repro.runtime.server.PagedServer``: the same host-side
scheduler (priority admission, chunked prefill, page accounting through
the RAB, shared-prefix caching with copy-on-write, preemption swap to a
host backing store, deadlines, cancellation, watchdog, streaming deltas)
around a device step written in PyTorch.  On the CUDA device every layer's
attention runs the hand-written paged-attention kernel
(``kernels/paged_attention``); on the CPU it runs the kernel's plain
version, which is how the tests hold the engine against the reference.

The hot path keeps the reference's transfer discipline:

* K and V for all new tokens of all lanes are written into the fused
  ``(L, P+1, 2, page, Kv, hd)`` pool with ONE in-place scatter per layer
  (invalid slots go to the trash page, index ``P``, which is never read);
* block tables, lengths, the active-lane mask and the previously sampled
  token live on the device; the block table is repeat-padded and updated
  by dirty rows only;
* each iteration ends with exactly one device-to-host pull, the sampled
  tokens (or, in a speculative iteration, the (B, K+2) verdict).
  ``H2D`` / ``D2H`` events count the transfers exactly as the reference
  does.

With ``CacheConfig(kv_dtype="int8")`` the pool holds int8 pages beside a
``(L, P+1, 2, Kv)`` float32 slab of per-(page, K/V, kv-head) scales.  The
write quantizes each new token under its page's running-max scale; a page
whose scale grew is re-packed under the new scale.  Only the pages this
step writes can grow, so only they are re-packed, in place (the reference
re-packs the whole layer, where every other page's factor is exactly 1).
Attention dequantizes in the kernel's K/V fetch.  Parked pages travel as
one blob of int8 bytes and scales (``_pack_kv_page``), byte for byte the
reference's.

With ``spec_k > 0`` a host drafter (``runtime.speculative``, n-gram by
default) proposes up to K tokens per decoding lane; one verify step scores
all K+1 positions through the same kernel, the accepted prefix plus the
bonus token is the exact greedy continuation, and ``PagedKVPool.trim``
rolls the rejected tail back.  Only greedy lanes draft; a sampling lane
rides along in the verify step with zero drafts.

Each lane picks its next token by its request's ``SamplingParams``:
greedy lanes take the argmax of float32 logits; a lane at ``temperature >
0`` divides by the temperature, truncates to top-k and then top-p, and
draws with the key ``fold_in(PRNGKey(seed), position)`` (``runtime.prng``,
a bit-exact copy of the reference's threefry), so its stream does not
depend on chunking, batching or preemption.  The seed, temperature, top-k
and top-p of each lane live on the device beside its length.  An
iteration with no sampling lane never enters the sampler.

Prefix-cache pages evicted from the device pool can spill down a tier
chain (``CacheConfig(host_tier_pages=..., disk_tier_pages=...)``): their
payload is pulled D2H into the host tier, cascading to a disk tier under
pressure, and an admission that hits a spilled entry promotes it back
into a fresh device page, the lane gated on the engine clock for the
modeled promotion latency.  A demoted page's payload is pulled before any
write that could reuse the page is enqueued on the device.  An optional
``FaultInjector`` (``runtime.faults``) perturbs every backing-store op;
transient faults are retried, persistent ones demote their request to
``"error"``.  The tier seam is cluster 0's only.

MoE layers and the sharded engine raise ``NotImplementedError`` until
their slice is ported.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.offload import (
    BackingStoreError, DiskTier, HostBackingStore,
    TIER_CODES, TIER_DEVICE, TIER_HOST,
)
from repro_torch.core.rab import RAB, PagedKVPool
from repro_torch.core.tracing import EventType, TraceBuffer
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.launch import LaunchCounter
from repro_torch.kernels.paged_attention.ops import (
    mask_block_table, paged_prefill_fused, page_counts_for,
)
from repro_torch.kernels.paged_attention.ref import paged_prefill_ref
from repro_torch.models import layers as L
from repro_torch.models.layers import rms_head_norm, rope
from repro_torch.models.model import _check_supported
from repro_torch.optim.compress import (
    SCALE_EPS, headwise_scales, quantize_int8,
)
from repro_torch.runtime.api import (
    CacheStats, EngineConfig, GenerationRequest, GenerationResult,
    SamplingParams, TokenDelta, FINISH_ABORTED, FINISH_ERROR, FINISH_LENGTH,
    FINISH_SHED, FINISH_STOP, FINISH_TIMEOUT,
)
from repro_torch.runtime.clock import MonotonicClock
from repro_torch.runtime import prng
from repro_torch.runtime.frontdoor import GreedyChunkPolicy
from repro_torch.runtime.speculative import NGramDrafter

#: calls of :func:`_sample_tokens`: an all-greedy run never makes one
sampler_calls = LaunchCounter()


@dataclasses.dataclass
class SeqState:
    """Scheduler-internal mutable state for one admitted request (never
    part of the public API: callers see the frozen ``GenerationRequest``
    going in and the frozen ``GenerationResult`` coming out)."""
    rid: int
    prompt: List[int]
    sampling: SamplingParams
    priority: int = 0                 # scheduler class; higher preempts lower
    out: List[int] = dataclasses.field(default_factory=list)
    fed: int = 0                      # prompt tokens already consumed
    lane: int = -1
    done: bool = False
    finish_reason: Optional[str] = None
    prefix_hit_tokens: int = 0        # prompt tokens reused from the cache
    preemptions: int = 0
    arrival: int = -1                 # FIFO tiebreak, assigned by submit()
    reg_pages: int = 0                # prompt pages published to the index
    swapped: Optional[List[int]] = None   # lpages parked in the backing store
    promoting: bool = False           # admitted, gated on an in-flight
    #                                   prefix-page promotion (the lane
    #                                   feeds nothing until it lands)
    deadline_iter: Optional[int] = None   # absolute engine-iteration bound
    deadline_t: Optional[float] = None    # absolute engine-clock bound
    not_before: float = 0.0           # engine-clock time before which this
    #                                   queued request may not be placed
    #                                   (deferred swap-in retry backoff)
    retry_attempt: int = 0            # deferred swap-in retries consumed
    error: Optional[str] = None       # diagnostic for error/timeout finishes
    progress_marker: Tuple[int, int] = (-1, -1)   # (fed, len(out)) watermark
    progress_iter: int = 0            # iteration the marker last advanced
    spec_k_cur: int = 0               # adaptive per-lane draft depth
    spec_proposed: int = 0            # drafted tokens sent to verification
    spec_accepted: int = 0            # drafted tokens the target confirmed
    spec_rejected: int = 0            # drafted tokens rolled back

    @property
    def max_new(self) -> int:
        return self.sampling.max_new


def _to_host(t: torch.Tensor) -> np.ndarray:
    """Device tensor -> numpy.  bfloat16 travels as its int16 bit pattern
    (numpy has no bfloat16), so a parked page round-trips bit-exactly."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy()


def _from_host(a: np.ndarray, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype == torch.bfloat16:
        t = t.view(torch.bfloat16)
    return t.to(device)


def _pack_kv_page(pages: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Fuse one page's int8 payload + f32 scales into a single 1-D uint8
    blob (the backing store's contract is one array per page; one CRC
    covers both).  The reference's byte layout exactly."""
    return np.concatenate([
        np.ascontiguousarray(pages).view(np.uint8).reshape(-1),
        np.ascontiguousarray(scales).view(np.uint8).reshape(-1)])


def _unpack_kv_page(blob: np.ndarray, page_shape: tuple,
                    scale_shape: tuple) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse of ``_pack_kv_page``."""
    split = int(np.prod(page_shape))
    blob = np.asarray(blob).view(np.uint8).reshape(-1)
    pages = blob[:split].view(np.int8).reshape(page_shape)
    scales = blob[split:].view(np.float32).reshape(scale_shape)
    return pages, scales


def _not_ported(feature: str) -> NotImplementedError:
    return NotImplementedError(
        f"{feature} is not ported to the PyTorch engine yet")


class PagedServer:
    """The paged serving engine.  ``params`` is the port's
    ``DenseDecoder`` on ``device`` (``cuda`` unless the caller passes
    ``"cpu"``).

    ``last_logits`` holds, after each iteration, the float32 logits (B, V)
    of the row every lane sampled from — on the device, never pulled by
    the engine itself — for callers that compare engines logit by logit.
    """

    def __init__(self, cfg: ArchConfig, params,
                 engine: Optional[EngineConfig] = None, *,
                 tracer: Optional[TraceBuffer] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if engine is None:
            engine = EngineConfig()
        if not (cfg.block_kind == "transformer" and cfg.attention_kind == "gqa"
                and not cfg.local_global_period):
            raise ValueError("paged engine supports plain-GQA transformer "
                             "archs")
        if cfg.moe_num_experts:
            raise _not_ported("MoE layers")
        _check_supported(cfg)
        if engine.wants_sharded:
            raise _not_ported("sharded serving (clusters/heads/mesh)")
        if self.device.type == "cuda" and not engine.use_kernel:
            raise ValueError(
                "use_kernel=False (the plain attention path) runs on the "
                "CPU only; on CUDA the engine always uses the kernel")
        if params.device != self.device:
            raise ValueError(f"params are on {params.device}, the engine on "
                             f"{self.device}: move them first")
        self.engine_cfg = engine
        self.cfg, self.params = cfg, params
        self.cache_cfg = engine.cache
        # quantized KV: int8 pages + per-(page, K/V, head) scales; the
        # attention math stays float32
        self.quant_kv = self.cache_cfg.kv_dtype == "int8"
        self.spec_k = max(0, engine.spec_k)
        self.drafter = engine.drafter if engine.drafter is not None else \
            (NGramDrafter() if self.spec_k else None)
        self.page_size, self.max_lanes = self.cache_cfg.page_size, \
            engine.max_lanes
        self.max_pages = self.cache_cfg.max_pages_per_seq
        self.chunk = max(1, engine.chunk)
        self.tracer = tracer or TraceBuffer()
        self.use_kernel = engine.use_kernel
        self.pages_per_step = engine.pages_per_step
        # one time source for every scheduler timestamp (deadline_s
        # binding, retry backoff, straggler EMA)
        self.clock = engine.clock if engine.clock is not None \
            else MonotonicClock()
        self.policy = engine.scheduler_policy \
            if engine.scheduler_policy is not None else GreedyChunkPolicy()
        self.rab = RAB(engine.rab_cfg, self.tracer)
        self.pool = PagedKVPool(self.cache_cfg.num_pages, self.page_size,
                                self.max_pages, self.rab)
        self._build_device_state(self.cache_cfg.num_pages)
        self._bt_host = np.zeros((self.max_lanes, self.max_pages),
                                 np.int32)
        self.lanes: List[Optional[SeqState]] = [None] * self.max_lanes
        self.queue: List[SeqState] = []
        self.finished: List[GenerationResult] = []
        self.iterations = 0
        self.prefill_tokens = 0       # prompt tokens run through prefill
        self.h2d_events = 0
        self.d2h_events = 0
        self.enable_prefix_cache = self.cache_cfg.enable_prefix_cache
        # fault tolerance: the injector (if any) perturbs the backing-store
        # ops and traces every decision through THIS engine's tracer
        self.faults = engine.fault_injector
        if self.faults is not None and self.faults.tracer is None:
            self.faults.tracer = self.tracer
        # hierarchical prefix cache (device pool -> host DRAM -> disk):
        # swap traffic and demoted cache entries share one tier chain
        self.backing = self._build_backing_store()
        if self.cache_cfg.spill_enabled and self.enable_prefix_cache:
            self.pool.spill_enabled = True
        self._promotions: List[dict] = []   # in-flight H2D prefetches
        self.cache_hit_pages = {"device": 0, "host": 0, "disk": 0}
        self.cache_miss_pages = 0
        self.swap_retries = max(0, engine.swap_retries)
        self.retry_backoff_s = max(0.0, engine.retry_backoff_s)
        self.max_queue_depth = max(0, engine.max_queue_depth)
        self.watchdog_iters = max(0, engine.watchdog_iters)
        self.straggler_factor = max(0.0, engine.straggler_factor)
        self.fault_retries = 0        # transient-fault retries attempted
        self.recovered_faults = 0     # ops that succeeded after retrying
        self.timeouts = 0
        self.cancelled = 0
        self.errors = 0               # per-request "error" demotions
        self.shed_count = 0
        self.degrades = 0             # DEGRADE events emitted
        self.straggler_steps = 0      # iterations the EMA watchdog flagged
        self._ema_step_s: Optional[float] = None
        self.preemptions = 0
        self._dirty: set = set()      # lane rows to push before the kernel
        self._arrival = 0
        self._deltas: List[TokenDelta] = []   # streamed by generate()
        self.spec_iterations = 0      # engine iterations that verified drafts
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_rejected = 0

    # --------------------------------------------------------------- trace --
    def _h2d(self, n: int = 1):
        self.h2d_events += n
        self.tracer.record_host(EventType.H2D, n, 0)

    def _d2h(self, n: int = 1):
        self.d2h_events += n
        self.tracer.record_host(EventType.D2H, n, 0)

    def _delta(self, rid: int, tokens=(), event: str = "token", data: int = 0,
               reason: Optional[str] = None):
        self._deltas.append(TokenDelta(rid=rid, tokens=tuple(tokens),
                                       event=event, data=data,
                                       finish_reason=reason))

    # ------------------------------------------------------ construction --
    def _build_device_state(self, num_pages: int):
        cfg, dev = self.cfg, self.device
        L_, kv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
        self.kv_dtype = torch.int8 if self.quant_kv else \
            getattr(torch, cfg.param_dtype)
        # fused K/V pool; the extra page (index num_pages) is the trash
        # page masked writes are routed to
        self.kv_pages = torch.zeros(
            (L_, num_pages + 1, 2, self.page_size, kv, hd),
            dtype=self.kv_dtype, device=dev)
        # per-(page, K/V, kv-head) dequantization scales of an int8 pool,
        # updated in place like the pool
        self.kv_scales = torch.zeros((L_, num_pages + 1, 2, kv),
                                     dtype=torch.float32, device=dev) \
            if self.quant_kv else None
        # device-resident engine state: the scheduler and the model share
        # these without per-iteration re-uploads
        B = self.max_lanes
        self.bt_dev = torch.zeros((B, self.max_pages), dtype=torch.int32,
                                  device=dev)
        self.len_dev = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.active_dev = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.last_tok = torch.zeros((B,), dtype=torch.int32, device=dev)
        # each lane's sampling policy rides with it like its length does
        # (the seed masked to 32 bits, held in int64: torch has no uint32)
        self.seed_dev = torch.zeros((B,), dtype=torch.int64, device=dev)
        self.temp_dev = torch.zeros((B,), dtype=torch.float32, device=dev)
        self.topk_dev = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.topp_dev = torch.ones((B,), dtype=torch.float32, device=dev)
        self.last_logits: Optional[torch.Tensor] = None
        # constant decode-step inputs (every lane feeds its last sample)
        self._decode_feed = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        self._decode_use_last = torch.ones((B,), dtype=torch.int32,
                                           device=dev)
        step_args = (cfg, self.params, self.use_kernel, self.pages_per_step,
                     num_pages)
        self._step = functools.partial(_paged_chunk_step, *step_args,
                                       kv_scales=self.kv_scales)
        self._spec_step = functools.partial(_paged_spec_step, *step_args,
                                            kv_scales=self.kv_scales)

    def _build_backing_store(self) -> HostBackingStore:
        cc = self.cache_cfg
        disk = DiskTier(cc.disk_tier_pages, cc.disk_dir) \
            if cc.disk_tier_pages else None
        return HostBackingStore(self.faults, host_pages=cc.host_tier_pages,
                                disk_tier=disk)

    def close(self):
        """Release the backing store's tiers (disk-tier files and an owned
        directory).  Idempotent; the engine stays usable for stats reads
        afterwards."""
        self.backing.close()

    # ------------------------------------------------------------- admin --
    def submit(self, req: GenerationRequest):
        if not req.prompt:
            # an empty prompt would enter decode seeded by whatever token
            # the lane's previous occupant left in last_tok
            raise ValueError("empty prompt")
        sp = req.sampling
        if len(req.prompt) + sp.max_new - 1 > \
                self.max_pages * self.page_size:
            raise ValueError("request exceeds max_pages_per_seq")
        seq = SeqState(rid=req.rid, prompt=list(req.prompt), sampling=sp,
                       priority=req.priority)
        if self._pages_needed(seq) + self._cow_budget(seq) > \
                self.pool.num_pages:
            raise ValueError("request exceeds KV pool capacity")
        seq.arrival = self._arrival
        self._arrival += 1
        if req.deadline_iters is not None:
            seq.deadline_iter = self.iterations + req.deadline_iters
        if req.deadline_s is not None:
            seq.deadline_t = self.clock.now() + req.deadline_s
        self.tracer.record_host(EventType.REQUEST_ARRIVE, seq.rid,
                                len(self.queue))
        if self.spec_k and sp.greedy:
            # only greedy lanes draft: verification is greedy argmax, so a
            # sampling lane's drafts could never be accepted
            seq.spec_k_cur = self.spec_k
        self.queue.append(seq)
        if self.max_queue_depth and len(self.queue) > self.max_queue_depth:
            # admission-time load shedding: reject the lowest-priority
            # waiter (youngest within a class — on a priority tie the
            # newcomer itself is turned away)
            victim = min(self.queue, key=lambda r: (r.priority, -r.arrival))
            self.shed_count += 1
            self.tracer.record_host(EventType.REQUEST_SHED, victim.rid,
                                    len(self.queue))
            self._terminate(victim, FINISH_SHED, "shed",
                            diag="queue depth exceeded "
                                 f"{self.max_queue_depth}")

    def _pages_needed(self, req: SeqState) -> int:
        # every token the engine will *write* K/V for: the prompt plus all
        # generated tokens except the last (sampled but never fed back)
        total = len(req.prompt) + req.max_new - 1
        return int(page_counts_for(total, self.page_size))

    # --------------------------------------------------------- scheduler --
    def _cow_budget(self, req: SeqState) -> int:
        """One extra reserved page for a request whose prompt tail is
        partial: once that tail is registered in the prefix index a later
        admission may share it, and this request's own next append then
        copy-on-writes — a page its per-page reservation never counted."""
        return 1 if (self.enable_prefix_cache and req.max_new > 1
                     and len(req.prompt) % self.page_size) else 0

    def _plan(self, req: SeqState) -> dict:
        """Admission plan: which prefix-cache pages to map and how many
        pages to reserve.  ``need`` excludes only *stable* device-resident
        shared pages (fully written, never appended again); a shared
        partial tail keeps one reserved page as the sharer's copy-on-write
        budget, a spilled hit draws a fresh page for its promoted payload,
        and a resuming request budgets every page it must restore or
        allocate."""
        pool = self.pool
        total = self._pages_needed(req) + self._cow_budget(req)
        ps = self.page_size
        if req.swapped is not None:            # resuming after preemption
            return {"resume": True, "hits": [], "usable": 0,
                    "need": total, "cached_hits": 0}
        usable, hits = 0, []
        if self.enable_prefix_cache and len(req.prompt) > 1:
            # the hit chain may cross tiers: ("device", ppage) entries map
            # by sharing, ("spilled", key) entries cost a fresh page each
            # plus a promotion at placement
            entries, n = pool.match_prefix_tiered(req.prompt)
            # the final prompt token always runs through the model (it
            # produces the first sampled token), so it is never reused
            usable = min(n, len(req.prompt) - 1)
            hits = entries[:-(-usable // ps)] if usable else []
        full = usable // ps
        dev_full = sum(1 for i, (kind, _v) in enumerate(hits)
                       if kind == "device" and i < full)
        need = total - dev_full
        cached = sum(1 for kind, v in hits
                     if kind == "device" and v in pool.cached_free)
        plan = {"resume": False, "hits": hits, "usable": usable,
                "need": need, "cached_hits": cached}
        if hits and not self._fits(plan):
            # hits sitting on cached-free pages cost evictable capacity a
            # no-sharing admission would simply reuse — never let the cache
            # starve a request that fits without it
            fallback = {"resume": False, "hits": [], "usable": 0,
                        "need": total, "cached_hits": 0}
            if self._fits(fallback):
                return fallback
        return plan

    def _fits(self, plan: dict) -> bool:
        # reviving cached-free hit pages consumes them from the evictable
        # set, so they are budgeted on top of the reservation
        return self.pool.available() >= plan["need"] + plan["cached_hits"]

    def _victim(self, head: SeqState) -> Optional[SeqState]:
        """Lowest-priority running request (youngest within a class) —
        preemptable only by a strictly higher-priority waiter."""
        running = [r for r in self.lanes if r is not None]
        if not running:
            return None
        v = min(running, key=lambda r: (r.priority, -r.arrival))
        return v if v.priority < head.priority else None

    def _eligible_head(self) -> Optional[SeqState]:
        """Highest-priority oldest waiter whose deferred-retry backoff (if
        any) has expired on the engine clock."""
        self.queue.sort(key=lambda r: (-r.priority, r.arrival))
        now = self.clock.now()
        return next((r for r in self.queue if r.not_before <= now), None)

    def _admit(self):
        while self.queue:
            head = self._eligible_head()
            if head is None:
                break                     # every waiter is backing off
            lane = next((i for i in range(self.max_lanes)
                         if self.lanes[i] is None), None)
            plan = self._plan(head)
            if lane is None or not self._fits(plan):
                victim = self._victim(head)
                if victim is None:
                    break
                self._preempt(victim)
                continue                  # pool/lane state changed: re-plan
            self.queue.remove(head)
            self._place(head, lane, plan)

    def _resolve_spilled_hits(self, req: SeqState, plan: dict):
        """Pull every spilled hit's payload out of the tier store *before*
        any pool mutation.  A fetch fault (CRC mismatch, an injected pop
        fault past the retry budget) drops that entry from every tier and
        re-plans: dropping a spilled hit never changes ``need`` (device
        hits are untouched), so the new plan still fits."""
        pool, store = self.pool, self.backing
        while True:
            fetched: dict = {}
            ok = True
            for lp, (kind, val) in enumerate(plan["hits"]):
                if kind != "spilled":
                    continue
                eid = pool.key_ids[val]
                try:
                    payload, tier = self._with_retries(functools.partial(
                        store.fetch_cache, eid, req.rid), req.rid)
                except BackingStoreError:
                    pool.drop_spilled(val)
                    store.drop_cache(eid)
                    self._trace_store_moves()
                    ok = False
                    break
                fetched[lp] = (eid, payload, tier)
            if ok:
                return plan, fetched
            plan = self._plan(req)

    def _place(self, req: SeqState, lane: int, plan: dict):
        rid = req.rid
        req.lane = lane
        pool = self.pool
        self.lanes[lane] = req
        fetched: dict = {}
        if not plan["resume"] and any(k == "spilled" for k, _ in
                                      plan["hits"]):
            # fetch before reserving: a fetch fault re-plans through
            # _fits, which must not see this request's own reservation
            plan, fetched = self._resolve_spilled_hits(req, plan)
        if not plan["resume"]:
            prompt_pages = -(-len(req.prompt) // self.page_size)
            self.cache_miss_pages += prompt_pages - len(plan["hits"])
        if plan["need"] > 0:
            # reserve the request's remaining lifetime page budget so
            # chunked prefill / restore can never hit exhaustion mid-stream
            pool.reserve(rid, plan["need"])
        req.progress_marker = (req.fed, len(req.out))
        req.progress_iter = self.iterations   # queue time never counts
        if plan["resume"]:
            try:
                self._swap_in(req)
            except BackingStoreError as e:
                if self._defer_resume(req, e):
                    self._unplace(req)
                    return
                self._fail(req, str(e))
                return
            if req.retry_attempt:
                self.recovered_faults += 1
                req.retry_attempt = 0
        elif plan["usable"]:
            # prefix-cache hit: map resident pages by sharing; adopt a
            # fresh page for each spilled hit (its payload was fetched
            # above and is uploaded in _begin_promotion below)
            promo: List[tuple] = []
            for lp, (kind, val) in enumerate(plan["hits"]):
                if kind == "device":
                    pool.share_page(rid, lp, val)
                    self.cache_hit_pages["device"] += 1
                else:
                    eid, payload, tier = fetched[lp]
                    p = pool.adopt_spilled(rid, lp, val)
                    self.cache_hit_pages[tier] += 1
                    promo.append((p, eid, payload, tier))
            pool.seq_len[rid] = plan["usable"]
            pool.stats["prefix_hit_tokens"] += plan["usable"]
            req.fed = plan["usable"]
            req.prefix_hit_tokens = plan["usable"]
            req.reg_pages = plan["usable"] // self.page_size
            self.tracer.record_host(EventType.PREFIX_HIT, rid,
                                    plan["usable"])
            self._delta(rid, event="prefix_hit", data=plan["usable"])
            if promo:
                # adopting may have evicted and spilled other entries:
                # park their payloads before the promotion upload can land
                # on a recycled page
                self._drain_tier_ops()
                self._begin_promotion(req, promo)
        self._refresh_row(lane, req)
        sp = req.sampling
        self.active_dev[lane] = 0 if req.promoting else 1
        self.len_dev[lane] = pool.seq_len.get(rid, 0)
        self.seed_dev[lane] = sp.seed & 0xFFFFFFFF
        self.temp_dev[lane] = sp.temperature
        self.topk_dev[lane] = sp.top_k
        self.topp_dev[lane] = sp.top_p
        if plan["resume"] and req.fed >= len(req.prompt) and req.out:
            # mid-decode resume: re-seed the device-resident last sample
            self.last_tok[lane] = req.out[-1]
        self._h2d(1)
        self.tracer.record_host(EventType.REQUEST_ADMIT, rid, lane)

    def _defer_resume(self, req: SeqState, e: BackingStoreError) -> bool:
        """Should this failed swap-in be rescheduled instead of demoting
        the request?  Yes iff the fault is transient, a backoff is
        configured and budget remains; then ``not_before`` is set to the
        exponential-backoff deadline on the engine clock."""
        if not (e.transient and self.retry_backoff_s
                and req.retry_attempt < self.swap_retries):
            return False
        req.retry_attempt += 1
        self.fault_retries += 1
        req.not_before = self.clock.now() + \
            self.retry_backoff_s * (2 ** (req.retry_attempt - 1))
        return True

    def _unplace(self, req: SeqState):
        """Reverse an in-progress ``_place`` whose swap-in was deferred:
        free the lane, drop the reservation, re-queue the request."""
        self.pool.reserved.pop(req.rid, None)
        self.lanes[req.lane] = None
        req.lane = -1
        self.queue.append(req)

    # -------------------------------------------------- page payload seam --
    def _snap_pages(self, idx: List[int]) -> List[np.ndarray]:
        """One gathered D2H pull of ``idx``'s pages (all layers); returns
        one payload per page (packed blobs of bytes and scales in int8
        mode)."""
        gi = torch.tensor(idx, dtype=torch.long, device=self.device)
        payload = _to_host(self.kv_pages[:, gi])
        if not self.quant_kv:
            return [payload[:, j] for j in range(len(idx))]
        scales = _to_host(self.kv_scales[:, gi])
        return [_pack_kv_page(payload[:, j], scales[:, j])
                for j in range(len(idx))]

    def _load_pages(self, phys: List[int], payloads: List[np.ndarray]):
        """One batched H2D restore of ``payloads`` into pool slots
        ``phys`` (unpacking blobs into pages + scales in int8 mode)."""
        gi = torch.tensor(phys, dtype=torch.long, device=self.device)
        if not self.quant_kv:
            self.kv_pages[:, gi] = _from_host(np.stack(payloads, axis=1),
                                              self.kv_dtype, self.device)
            return
        cfg = self.cfg
        L_, kv = cfg.num_layers, cfg.num_kv_heads
        parts = [_unpack_kv_page(
            p, (L_, 2, self.page_size, kv, cfg.resolved_head_dim),
            (L_, 2, kv)) for p in payloads]
        self.kv_pages[:, gi] = _from_host(
            np.stack([pg for pg, _ in parts], axis=1), torch.int8,
            self.device)
        self.kv_scales[:, gi] = _from_host(
            np.stack([sc for _, sc in parts], axis=1), torch.float32,
            self.device)

    def _preempt(self, req: SeqState):
        """Reclaim a running lane: every mapped page's payload goes D2H
        into the host backing store and the mapping drops (non-shared
        pages are freed; shared ones lose this request's refcount, the host
        copy keeping re-admission independent of the sharers)."""
        rid, i = req.rid, req.lane
        pool = self.pool
        if req.promoting:
            # the promoted payload is already on the device (uploaded at
            # placement), so the sweep below checkpoints correct data:
            # just close the in-flight promotion's books first
            self._land_promotions(force_rid=rid)
        mapped = pool.seq_pages(rid)
        if mapped:
            payloads = self._snap_pages([p for _, p in mapped])
            self._d2h(len(mapped))    # one gather, len(mapped) pages pulled
            try:
                for j, (lp, _p) in enumerate(mapped):
                    self._with_retries(functools.partial(
                        self.backing.put, rid, lp, payloads[j]), rid)
                    pool.unmap_page(rid, lp)
            except BackingStoreError as e:
                self._fail(req, str(e))
                return
        req.swapped = [lp for lp, _ in mapped]
        pool.reserved.pop(rid, None)
        req.lane = -1
        req.preemptions += 1
        self.preemptions += 1
        self.lanes[i] = None
        self.active_dev[i] = 0
        self.len_dev[i] = 0
        self._h2d(1)
        pool.stats["swapped_out"] += len(mapped)
        self.tracer.record_host(EventType.SWAP_OUT, rid, len(mapped))
        self.tracer.record_host(EventType.REQUEST_PREEMPT, rid, len(mapped))
        self._delta(rid, event="preempt", data=len(mapped))
        self.queue.append(req)

    def preempt(self, rid: int) -> bool:
        """Forcibly preempt a running request (test/benchmark hook; pool
        pressure drives the same path through the scheduler)."""
        for r in self.lanes:
            if r is not None and r.rid == rid:
                self._preempt(r)
                return True
        return False

    def _swap_in(self, req: SeqState):
        """Restore a preempted request's swapped pages: fresh physical
        pages, one batched H2D payload upload, mappings re-established.
        Raises :class:`BackingStoreError` when a parked payload cannot be
        restored; payloads are popped before any pool mutation."""
        rid = req.rid
        pool = self.pool
        lps = req.swapped
        if not lps:
            req.swapped = None
            return
        deferring = bool(self.retry_backoff_s)
        payloads: List[np.ndarray] = []
        try:
            for lp in lps:
                if deferring:
                    payloads.append(self.backing.pop(rid, lp))
                else:
                    payloads.append(self._with_retries(functools.partial(
                        self.backing.pop, rid, lp), rid))
        except BackingStoreError as e:
            if deferring and e.transient \
                    and req.retry_attempt < self.swap_retries:
                for lp, payload in zip(lps, payloads):
                    self.backing.repark(rid, lp, payload)
            raise
        req.swapped = None
        phys = [pool.alloc_page(rid, lp) for lp in lps]
        # allocating may have evicted and spilled indexed pages: park their
        # payloads before this restore's upload can overwrite them
        self._drain_tier_ops()
        self._load_pages(phys, payloads)
        self._h2d(len(lps))
        pool.stats["swapped_in"] += len(lps)
        self.tracer.record_host(EventType.SWAP_IN, rid, len(lps))

    def _refresh_row(self, lane: int, req: SeqState):
        """Rebuild a lane's repeat-padded host block-table row from the
        pool (through the RAB translate path) and mark it for upload."""
        pool, rid = self.pool, req.rid
        n = pool.seq_len.get(rid, 0)
        n_pages = -(-n // self.page_size) if n else 0
        last = 0
        for lp in range(n_pages):
            last = pool.translate(rid, lp)
            self._bt_host[lane, lp] = last
        self._bt_host[lane, n_pages:] = last
        self._dirty.add(lane)

    def _register_prompt_pages(self, active: List[SeqState],
                               n_new: np.ndarray):
        """Publish prompt-prefix pages completed this iteration into the
        prefix index (full pages as they fill; the partial tail page once
        the whole prompt is pool-resident)."""
        if not self.enable_prefix_cache:
            return
        ps = self.page_size
        for r in active:
            if n_new[r.lane] == 0 or r.fed >= len(r.prompt):
                continue
            pool = self.pool
            written = min(pool.seq_len.get(r.rid, 0), len(r.prompt))
            for lp in range(r.reg_pages, written // ps):
                pool.register_page(r.rid, lp, r.prompt)
            r.reg_pages = max(r.reg_pages, written // ps)
            if written == len(r.prompt) and written % ps:
                pool.register_page(r.rid, written // ps, r.prompt)

    # ------------------------------------------- hierarchical cache tiers --
    def _trace_store_moves(self):
        for eid, src, dst in self.backing.drain_cache_moves():
            self.tracer.record_host(EventType.PAGE_DEMOTE, eid,
                                    src * 4 + dst)

    def _drain_tier_ops(self):
        """Service the pool's pending tier transitions: pull the payload
        of every just-demoted page D2H and park it in the tier store, drop
        entries a re-registration superseded, then trace the store's own
        cascade moves (host -> disk under pressure, drops).

        MUST run before any device write that could reuse a demoted page
        is enqueued: the pull reads the pages behind all work enqueued so
        far, so a scatter already enqueued into a recycled page would be
        captured in place of the demoted payload."""
        pool, store = self.pool, self.backing
        if not (pool.pending_demote or pool.pending_spill_drop):
            return
        moves = pool.drain_demotions()
        # skip entries superseded between eviction and this drain
        live = [(p, key) for p, key in moves if key in pool.spilled]
        if live:
            payloads = self._snap_pages([p for p, _ in live])
            self._d2h(len(live))
            for j, (_p, key) in enumerate(live):
                eid = pool.key_ids[key]
                store.park_cache(eid, payloads[j])
                self.tracer.record_host(EventType.PAGE_DEMOTE, eid,
                                        TIER_DEVICE * 4 + TIER_HOST)
        for key in pool.drain_spill_drops():
            store.drop_cache(pool.key_ids[key])
        self._trace_store_moves()

    def _begin_promotion(self, req: SeqState, promo: List[tuple]):
        """Upload the fetched spilled payloads into their adopted device
        pages and schedule the promotion's *landing* on the engine clock.

        The payload write is enqueued at once, so sharers admitted off the
        restored index entries and preemption sweeps always read correct
        data, but the admitted lane stays gated (``active_dev`` 0, fed
        nothing) until the modeled H2D prefetch latency elapses:
        ``prefetch_depth`` pages move per latency quantum.  All timing
        binds through ``self.clock``, so a VirtualClock replays it
        exactly."""
        cc = self.cache_cfg
        self._load_pages([g for g, _eid, _pl, _t in promo],
                         [pl for _g, _eid, pl, _t in promo])
        self._h2d(len(promo))
        quanta = -(-len(promo) // max(1, cc.prefetch_depth))
        due = self.clock.now() + cc.promote_latency_s * quanta
        req.promoting = True
        self._promotions.append({
            "rid": req.rid, "due": due,
            "pages": [(eid, t) for _g, eid, _pl, t in promo]})

    def _land_promotions(self, force_rid: Optional[int] = None):
        """Complete every promotion whose due time has passed (or whose
        owner ``force_rid`` is being preempted or terminated: the payload
        is already on the device, so cancelling just closes the books):
        trace PAGE_PROMOTE per page and un-gate the lane."""
        if not self._promotions:
            return
        now = self.clock.now()
        rest = []
        for pr in self._promotions:
            if pr["due"] > now and pr["rid"] != force_rid:
                rest.append(pr)
                continue
            for eid, tier in pr["pages"]:
                self.tracer.record_host(EventType.PAGE_PROMOTE, eid,
                                        TIER_CODES[tier] * 4 + TIER_DEVICE)
            req = next((r for r in self.lanes
                        if r is not None and r.rid == pr["rid"]), None)
            if req is not None and req.promoting:
                req.promoting = False
                # the gated interval must not count against the lane's
                # progress watchdog
                req.progress_iter = self.iterations
                self.active_dev[req.lane] = 1
                self._h2d(1)
        self._promotions = rest

    def _runnable(self) -> List[SeqState]:
        """Lanes the iteration may feed: resident and not promotion-gated."""
        return [r for r in self.lanes if r is not None and not r.promoting]

    def cache_stats(self) -> CacheStats:
        """One frozen snapshot of the hierarchical prefix cache: tier
        residency, per-tier admission hits, promotion/demotion traffic."""
        pool, store = self.pool, self.backing
        resident = store.cache_resident()
        cfg = self.cfg
        kv_hd = cfg.num_kv_heads * cfg.resolved_head_dim
        if self.quant_kv:
            # int8 page bytes plus the per-page scale slab amortized over
            # the page's token slots (4 bytes per (K/V, head) per page)
            bpt = cfg.num_layers * 2 * (
                kv_hd + 4.0 * cfg.num_kv_heads / self.page_size)
        else:
            bpt = cfg.num_layers * 2 * kv_hd * self.kv_dtype.itemsize
        return CacheStats(
            bytes_per_token=float(bpt),
            device_pages=pool.num_pages,
            device_indexed=len(pool.prefix_index),
            device_cached_free=len(pool.cached_free),
            host_pages=resident.get("host", 0),
            disk_pages=resident.get("disk", 0),
            hits_device_pages=self.cache_hit_pages["device"],
            hits_host_pages=self.cache_hit_pages["host"],
            hits_disk_pages=self.cache_hit_pages["disk"],
            miss_pages=self.cache_miss_pages,
            prefix_hit_tokens=pool.stats["prefix_hit_tokens"],
            promotions_in_flight=len(self._promotions),
            demoted_pages=pool.stats["cache_demoted"],
            promoted_pages=pool.stats["cache_promoted"],
            dropped_entries=store.cache_dropped,
            bytes_demoted=store.cache_bytes_demoted,
            bytes_promoted=store.cache_bytes_promoted,
            evictions=pool.stats["cache_evictions"])

    # ------------------------------------------------------------- finish --
    def _emit(self, req: SeqState, toks) -> tuple:
        """Append generated tokens to ``req``, honouring stop tokens and
        the token budget.  Returns (kept tokens, finish_reason or None); a
        stop token IS included (like an EOS) and wins over the length
        bound when both trigger on the same token."""
        kept: List[int] = []
        reason = None
        stop = req.sampling.stop_tokens
        for t in toks:
            t = int(t)
            req.out.append(t)
            kept.append(t)
            if t in stop:
                reason = FINISH_STOP
                break
            if len(req.out) >= req.max_new:
                reason = FINISH_LENGTH
                break
        return kept, reason

    def _result(self, req: SeqState) -> GenerationResult:
        return GenerationResult(
            rid=req.rid, prompt=tuple(req.prompt), tokens=tuple(req.out),
            finish_reason=req.finish_reason or FINISH_LENGTH,
            prefix_hit_tokens=req.prefix_hit_tokens,
            preemptions=req.preemptions,
            spec_proposed=req.spec_proposed,
            spec_accepted=req.spec_accepted,
            spec_rejected=req.spec_rejected,
            spec_k_final=req.spec_k_cur,
            error=req.error)

    def _finish(self, req: SeqState, reason: str):
        req.done = True
        req.finish_reason = reason
        self.tracer.record_host(EventType.REQUEST_FINISH, req.rid,
                                len(req.out))
        self.pool.release(req.rid)
        self.tracer.record_host(EventType.PAGE_RELEASE, req.rid, 0)
        self.lanes[req.lane] = None
        self.active_dev[req.lane] = 0
        self.len_dev[req.lane] = 0
        self._h2d(1)
        self.finished.append(self._result(req))

    def _terminate(self, req: SeqState, reason: str, event: str,
                   diag: Optional[str] = None):
        """Single exceptional-finish path: abort / cancel / timeout /
        error-demotion / shed all release the request's resources through
        the refcount/CoW/reservation-aware route preemption uses and
        surface a finished result + terminal delta.  Works on queued,
        running and preempted-parked requests."""
        req.done = True
        req.finish_reason = reason
        req.error = diag
        if req.promoting:
            self._land_promotions(force_rid=req.rid)
        if req in self.queue:
            self.queue.remove(req)
        self.pool.release(req.rid)
        if req.lane >= 0:
            self.lanes[req.lane] = None
            self.active_dev[req.lane] = 0
            self.len_dev[req.lane] = 0
            req.lane = -1
            self._h2d(1)
        # parked payload (if any) is dropped, not restored
        self.backing.discard(req.rid)
        req.swapped = None
        self.tracer.record_host(EventType.REQUEST_FINISH, req.rid,
                                len(req.out))
        self.tracer.record_host(EventType.PAGE_RELEASE, req.rid, 0)
        self.finished.append(self._result(req))
        self._delta(req.rid, event=event, reason=reason)

    def _fail(self, req: SeqState, diag: str):
        """Per-request ``"error"`` demotion: a persistent fault takes down
        THIS request, never the engine."""
        self.errors += 1
        self._terminate(req, FINISH_ERROR, "error", diag=diag)

    def _abort(self, req: SeqState):
        self._terminate(req, FINISH_ABORTED, "abort")

    def _abort_all(self):
        pending = [r for r in self.lanes if r is not None] + list(self.queue)
        for r in pending:
            self._abort(r)

    def cancel(self, rid: int) -> bool:
        """User-initiated cancellation, callable from the streaming
        consumer's loop body: the request — queued, running or
        preempted-parked — finishes with ``finish_reason="aborted"``.
        Returns False for unknown/finished rids."""
        for r in list(self.lanes) + list(self.queue):
            if r is not None and r.rid == rid and not r.done:
                self.cancelled += 1
                self._terminate(r, FINISH_ABORTED, "cancel")
                return True
        return False

    def _expired(self, req: SeqState, now: float) -> bool:
        return (req.deadline_iter is not None
                and self.iterations >= req.deadline_iter) or \
               (req.deadline_t is not None and now >= req.deadline_t)

    def _sweep_deadlines(self):
        """Finish every queued/running request whose deadline has passed
        with ``finish_reason="timeout"`` (tokens so far are kept)."""
        pending = [r for r in self.lanes if r is not None] + list(self.queue)
        if not any(r.deadline_iter is not None or r.deadline_t is not None
                   for r in pending):
            return
        now = self.clock.now()
        for r in pending:
            if self._expired(r, now):
                self.timeouts += 1
                self.tracer.record_host(EventType.REQUEST_TIMEOUT, r.rid,
                                        self.iterations)
                self._terminate(
                    r, FINISH_TIMEOUT, "timeout",
                    diag=f"deadline exceeded at iteration {self.iterations}")

    def _with_retries(self, fn: Callable[[], object], rid: int):
        """Run one backing-store op under the engine's retry policy:
        transient faults retry immediately, up to ``swap_retries`` times;
        persistent faults re-raise for the caller to demote the request."""
        attempt = 0
        while True:
            try:
                out = fn()
                if attempt:
                    self.recovered_faults += 1
                return out
            except BackingStoreError as e:
                if not e.transient or attempt >= self.swap_retries:
                    raise
                attempt += 1
                self.fault_retries += 1

    # --------------------------------------------------------------- step --
    def _account_appends(self, active: List[SeqState], n_new: np.ndarray):
        """Host-side page accounting for this iteration's writes: allocate
        (through the RAB translate path) every page the new tokens touch,
        apply copy-on-write remaps, and push only the dirty repeat-padded
        block-table rows."""
        dirty, self._dirty = self._dirty, set()
        cow_src: List[int] = []
        cow_dst: List[int] = []
        fresh_pages: List[int] = []
        pool = self.pool
        for r in active:
            i = r.lane
            for _ in range(int(n_new[i])):
                lpage, slot = pool.append_token(r.rid)
                if slot == 0:
                    phys = pool.translate(r.rid, lpage)
                    self.tracer.record_host(EventType.PAGE_ALLOC, r.rid, phys)
                    self._bt_host[i, lpage:] = phys
                    fresh_pages.append(phys)
                    dirty.add(i)
                for (s, lp, src, dst) in pool.drain_cow():
                    # the writer was remapped off a shared page: patch its
                    # row and queue the device-side payload copy
                    cow_src.append(src)
                    cow_dst.append(dst)
                    self._bt_host[i, lp:] = dst
                    dirty.add(i)
                    self.tracer.record_host(EventType.PAGE_COW, s, dst)
        # park payloads of pages the appends just evicted and spilled
        # BEFORE the CoW copy / K-V scatter can write into them
        self._drain_tier_ops()
        if self.quant_kv and fresh_pages:
            # a recycled page must not inherit its previous owner's scale:
            # the running max would only grow across pool reuse
            self.kv_scales[:, torch.tensor(fresh_pages, dtype=torch.long,
                                           device=self.device)] = 0.0
        if cow_src:
            # one batched on-device page copy, applied before this step's
            # K/V scatter so the write lands in the private copy
            src = torch.tensor(cow_src, dtype=torch.long, device=self.device)
            dst = torch.tensor(cow_dst, dtype=torch.long, device=self.device)
            self.kv_pages[:, dst] = self.kv_pages[:, src]
            if self.quant_kv:
                # the private copy carries the donor page's scales too
                self.kv_scales[:, dst] = self.kv_scales[:, src]
        self._register_prompt_pages(active, n_new)
        # registration may supersede spilled entries; drop them down-tier
        self._drain_tier_ops()
        if dirty:
            rows = sorted(dirty)
            self.bt_dev[rows] = torch.from_numpy(
                self._bt_host[rows]).to(self.device)
            self._h2d(len(rows))    # one dispatch, len(rows) rows uploaded

    def step(self) -> bool:
        """One engine iteration.  Returns False when fully idle.

        Deltas accumulate on ``self._deltas`` (drained by ``generate()``
        after every step), so events recorded *between* iterations — a
        ``preempt()`` or ``submit()`` from the caller's loop body — still
        reach the stream."""
        self._sweep_deadlines()
        self._land_promotions()
        self._admit()
        self._land_promotions()     # zero-latency promotions land in-step
        active = self._runnable()
        if not active and (self.queue or self._promotions):
            # nothing runs and every waiter is backing off or gated on an
            # in-flight promotion: park on the clock until the earliest
            # retry or landing comes due, then re-try (on a VirtualClock
            # nobody else ever moves time forward)
            waits = [pr["due"] for pr in self._promotions]
            if self.queue:
                nb = min(r.not_before for r in self.queue)
                if nb > self.clock.now():
                    waits.append(nb)
            if waits:
                self.clock.hold_until(min(waits))
                self._land_promotions()
                self._admit()
                active = self._runnable()
        if not active:
            return bool(self.queue) or bool(self._promotions)
        self.iterations += 1
        t0 = self.clock.now()

        if self._spec_wanted(active):
            drafts, n_spec = self._propose(active)
            if drafts is not None:
                self._spec_iteration(active, drafts, n_spec)
                self._post_iteration(self.clock.now() - t0)
                return True

        B, C = self.max_lanes, self.chunk
        n_new = np.zeros((B,), np.int32)
        feed = np.zeros((B, C), np.int32)
        use_last = np.zeros((B,), np.int32)
        prefill = [(r.lane, len(r.prompt) - r.fed) for r in active
                   if r.fed < len(r.prompt)]
        decode_only = not prefill
        alloc: dict = {}
        if prefill:
            # the interleave policy decides how many prompt tokens each
            # prefill-phase lane feeds; decode lanes always advance one
            alloc = dict(self.policy.plan(
                tuple(prefill), len(active) - len(prefill), C))
            if len(prefill) == len(active) and \
                    not any(alloc.get(ln, rem) for ln, rem in prefill):
                # an all-prefill iteration that feeds nothing would never
                # progress: force the oldest lane one chunk
                alloc[prefill[0][0]] = min(C, prefill[0][1])
        for r in active:
            i = r.lane
            if r.fed < len(r.prompt):
                n = min(C, len(r.prompt) - r.fed)
                n = max(0, min(n, int(alloc.get(i, n))))
                if n:
                    feed[i, :n] = r.prompt[r.fed:r.fed + n]
                    n_new[i] = n
                    self.prefill_tokens += n
            else:
                n_new[i] = 1
                use_last[i] = 1     # token is device-resident; no upload

        self._account_appends(active, n_new)

        sampling = self._sampling(active)
        if decode_only:
            # sync-free: every input already lives on device
            self.last_tok, self.len_dev, self.last_logits = self._step(
                self.kv_pages, self.bt_dev, self.len_dev, self.active_dev,
                self._decode_feed, self.last_tok, self._decode_use_last,
                sampling=sampling)
        else:
            self._h2d(1)            # the prompt-chunk feed bundle
            bundle = torch.from_numpy(np.concatenate(
                [n_new[:, None], use_last[:, None], feed], axis=1)).to(
                self.device)
            self.last_tok, self.len_dev, self.last_logits = self._step(
                self.kv_pages, self.bt_dev, self.len_dev, bundle[:, 0],
                bundle[:, 2:], self.last_tok, bundle[:, 1],
                sampling=sampling)

        tok = self.last_tok.cpu().numpy()     # one pull per iteration
        self._d2h(1)

        for r in list(active):
            i = r.lane
            reason = None
            kept: List[int] = []
            if r.fed < len(r.prompt):
                r.fed += int(n_new[i])
                if r.fed == len(r.prompt):
                    kept, reason = self._emit(r, [int(tok[i])])
            else:
                kept, reason = self._emit(r, [int(tok[i])])
            if kept or reason:
                self._delta(r.rid, kept, reason=reason)
            if reason:
                self._finish(r, reason)
        self._post_iteration(self.clock.now() - t0)
        return True

    def _post_iteration(self, dt: float):
        """Scheduler watchdog, run after every engine iteration: the EMA
        straggler flag (``DEGRADE(iteration, 3)``, diagnostics only) and
        the stalled-lane abort (a lane whose ``(fed, len(out))`` marker has
        not advanced for ``watchdog_iters`` iterations finishes with
        ``"error"`` plus ``DEGRADE(rid, 2)``)."""
        if self.straggler_factor:
            ema = self._ema_step_s
            # warmup guard: the first iterations pay one-off setup costs
            if ema is not None and self.iterations > 3 and \
                    dt > self.straggler_factor * ema:
                self.straggler_steps += 1
                self.degrades += 1
                self.tracer.record_host(EventType.DEGRADE,
                                        self.iterations, 3)
            alpha = 0.2            # the trainer watchdog's ema_alpha
            self._ema_step_s = dt if ema is None else \
                alpha * dt + (1 - alpha) * ema
        if self.watchdog_iters:
            for r in [r for r in self.lanes if r is not None]:
                if r.promoting:
                    # gated on an in-flight promotion: not stalled, the
                    # landing path resets the marker clock
                    r.progress_iter = self.iterations
                    continue
                marker = (r.fed, len(r.out))
                if marker != r.progress_marker:
                    r.progress_marker = marker
                    r.progress_iter = self.iterations
                elif self.iterations - r.progress_iter >= \
                        self.watchdog_iters:
                    self.degrades += 1
                    self.tracer.record_host(EventType.DEGRADE, r.rid, 2)
                    self._fail(
                        r, f"watchdog: lane {r.lane} made no progress "
                           f"for {self.watchdog_iters} iterations "
                           f"(stuck at fed={r.fed}, out={len(r.out)})")

    def _sampling(self, active: List[SeqState]):
        """The device rows of the lanes' sampling policies, or None when
        every active lane is greedy: the step then takes the argmax and
        never enters the sampler."""
        if all(r.sampling.greedy for r in active):
            return None
        return self.seed_dev, self.temp_dev, self.topk_dev, self.topp_dev

    # -------------------------------------------------------- speculation --
    def _spec_wanted(self, active: List[SeqState]) -> bool:
        """Draft this iteration?  Only when speculation is configured,
        every active lane decodes (mixed prefill iterations keep the chunk
        path), at least one lane is greedy (sampling lanes never draft but
        ride along: the verify step draws their bonus token exactly as
        plain decode would), and nothing waits for admission (a non-empty
        queue is preemption pressure: lanes should not widen their verify
        window while other work is starved)."""
        return (self.spec_k > 0 and not self.queue
                and all(r.fed >= len(r.prompt) for r in active)
                and any(r.sampling.greedy for r in active))

    def _propose(self, active: List[SeqState]):
        """Per-lane draft proposals in a fixed-width (B, spec_k) matrix.
        Sampling lanes never propose; a greedy lane's depth is its adaptive
        ``spec_k_cur`` capped by the tokens it still owes (at most
        ``remaining - 1`` drafts).  Returns (None, None) when no lane
        proposed anything: the plain decode step is cheaper."""
        drafts = np.zeros((self.max_lanes, self.spec_k), np.int32)
        n_spec = np.zeros((self.max_lanes,), np.int32)
        any_draft = False
        for r in active:
            if not r.sampling.greedy:
                continue
            rem = r.max_new - len(r.out)
            cap = min(r.spec_k_cur, rem - 1, self.spec_k)
            if cap <= 0:
                continue
            try:
                d = self.drafter.propose(r.prompt + r.out, cap)[:cap]
            except Exception:
                # a broken drafter is an accelerant, not a dependency: this
                # lane decodes plainly from here on, and the engine logs
                # the degradation instead of crashing the step
                r.spec_k_cur = 0
                self.degrades += 1
                self.tracer.record_host(EventType.DEGRADE, r.rid, 1)
                continue
            if not d:
                continue
            drafts[r.lane, :len(d)] = d
            n_spec[r.lane] = len(d)
            any_draft = True
        return (drafts, n_spec) if any_draft else (None, None)

    def _spec_iteration(self, active: List[SeqState], drafts: np.ndarray,
                        n_spec: np.ndarray):
        """One draft-verify-rollback iteration: the pool appends all K+1
        candidate positions per lane (the ordinary append path: pages,
        CoW), the verify step scores every position and counts the
        accepted prefix on the device, and the host trims each lane back
        to ``accepted + 1`` kept tokens.  The only pull is the verdict."""
        self.spec_iterations += 1
        pool = self.pool
        lens0 = {r.rid: pool.seq_len[r.rid] for r in active}
        n_new = np.zeros((self.max_lanes,), np.int32)
        for r in active:
            k_i = int(n_spec[r.lane])
            n_new[r.lane] = k_i + 1
            if k_i:
                self.tracer.record_host(EventType.SPEC_PROPOSE, r.rid, k_i)
                self.spec_proposed += k_i
                r.spec_proposed += k_i
        self._account_appends(active, n_new)

        self._h2d(1)                # the draft feed bundle
        bundle = torch.from_numpy(np.concatenate(
            [n_spec[:, None], drafts], axis=1)).to(self.device)
        verdict, self.last_tok, self.len_dev, self.last_logits = \
            self._spec_step(self.kv_pages, self.bt_dev, self.len_dev,
                            self.active_dev, self.last_tok, bundle[:, 1:],
                            bundle[:, 0], sampling=self._sampling(active))
        v = verdict.cpu().numpy()   # one pull per iteration
        self._d2h(1)

        K = drafts.shape[1]
        for r in list(active):
            i = r.lane
            k_i = int(n_spec[i])
            a = int(v[i, K + 1])
            emitted = [int(t) for t in drafts[i, :a]] + [int(v[i, a])]
            freed = pool.trim(r.rid, lens0[r.rid] + a + 1)
            kept, reason = self._emit(r, emitted)
            self._delta(r.rid, kept, event="spec" if k_i else "token",
                        data=a, reason=reason)
            if k_i:
                self.tracer.record_host(EventType.SPEC_ACCEPT, r.rid, a)
                self.spec_accepted += a
                r.spec_accepted += a
                rej = k_i - a
                if rej:
                    self.spec_rejected += rej
                    r.spec_rejected += rej
                    self.tracer.record_host(EventType.SPEC_ROLLBACK,
                                            r.rid, rej)
                # adaptive depth: full acceptance widens the window, total
                # rejection halves it (never below 1)
                if a == k_i:
                    r.spec_k_cur = min(self.spec_k, r.spec_k_cur + 1)
                elif a == 0:
                    r.spec_k_cur = max(1, r.spec_k_cur // 2)
            if freed:
                self._refresh_row(i, r)
            if reason:
                self._finish(r, reason)

    # ---------------------------------------------------------- frontend --
    def poll_deltas(self) -> List[TokenDelta]:
        """Drain every delta accumulated since the last drain, for callers
        that drive ``step()`` directly instead of consuming
        ``generate()`` (the two drains share one buffer)."""
        out, self._deltas = self._deltas, []
        return out

    def generate(self, requests: Iterable[GenerationRequest] = (),
                 max_iters: Optional[int] = None) -> Iterator[TokenDelta]:
        """Submit ``requests`` and stream the engine: yields a
        :class:`TokenDelta` for every request-visible increment as each
        iteration completes.  The concatenation of a request's token
        deltas is exactly its final ``GenerationResult.tokens``.  When
        ``max_iters`` is hit, still-queued/running requests are aborted
        (surfaced with ``finish_reason="aborted"``), never dropped.
        ``break``-ing out leaves the engine consistent and resumable;
        ``cancel``/``submit``/``preempt`` work from the loop body."""
        for q in requests:
            self.submit(q)
        it = 0
        while True:
            busy = self.step()
            while self._deltas:
                yield self._deltas.pop(0)
            if not busy:
                return
            it += 1
            if max_iters is not None and it >= max_iters:
                self._abort_all()
                while self._deltas:
                    yield self._deltas.pop(0)
                return

    def run(self, max_iters: int = 10_000) -> List[GenerationResult]:
        """Drain the engine and return every result it has produced."""
        for _ in self.generate(max_iters=max_iters):
            pass
        return self.finished


# ===========================================================================
# device steps
# ===========================================================================

def _write_coords(bt, lens, n_new, C: int, page_size: int, trash: int):
    """Physical (page, slot) for the C candidate token writes of each lane.

    Invalid slots (beyond a lane's n_new) are routed to the trash page so a
    single unmasked scatter covers every lane."""
    n_pages = bt.shape[1]
    ar = torch.arange(C, dtype=torch.int32, device=bt.device)[None, :]
    pos = lens[:, None] + ar                                      # (B,C)
    lp = torch.clamp(pos // page_size, max=n_pages - 1)
    sl = pos % page_size
    phys = torch.gather(bt, 1, lp.long())
    valid = ar < n_new[:, None]
    return torch.where(valid, phys, torch.full_like(phys, trash)), sl


def _layer_qkv(cfg, lp, x, pos):
    h = L.norm_forward(cfg, lp["ln1"], x)
    ap = lp["attn"]
    B, S, d = h.shape
    q = (h @ ap["wq"].reshape(d, -1)).reshape(B, S, cfg.num_heads, -1)
    k = (h @ ap["wk"].reshape(d, -1)).reshape(B, S, cfg.num_kv_heads, -1)
    v = (h @ ap["wv"].reshape(d, -1)).reshape(B, S, cfg.num_kv_heads, -1)
    if cfg.use_qk_norm:
        q = rms_head_norm(ap["q_norm"], q, cfg.norm_eps)
        k = rms_head_norm(ap["k_norm"], k, cfg.norm_eps)
    if cfg.use_rope:
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
    return q, k, v


def _layer_mlp(cfg, lp, x):
    h = L.norm_forward(cfg, lp["ln2"], x)
    if "moe" in lp:
        raise _not_ported("MoE layers")
    return x + L.mlp_forward(cfg, lp["mlp"], h)


def _touched_pages(bt, lens, n_new, C: int, page_size: int, trash: int):
    """Every physical page this step writes, as a fixed-size index vector:
    per lane the ``(C + page - 2) // page + 1`` logical pages positions
    ``lens .. lens + C - 1`` can span, an unwritten one replaced by the
    trash page, plus the trash page itself.  Fixed-size (no ``unique``)
    so the decode step never waits on the host; written pages are private
    to their lane (the pool copies a shared page on write), so only the
    trash page repeats."""
    n_pages = bt.shape[1]
    span = (C + page_size - 2) // page_size + 1
    lp = (lens // page_size)[:, None] + torch.arange(
        span, dtype=torch.int32, device=bt.device)[None, :]      # (B,span)
    first = torch.maximum(lp * page_size, lens[:, None])
    written = first < (lens + n_new)[:, None]
    phys = torch.gather(bt, 1, lp.clamp(max=n_pages - 1).long())
    phys = torch.where(written, phys, torch.full_like(phys, trash))
    return torch.cat([phys.reshape(-1),
                      phys.new_full((1,), trash)]).long()


def _quant_scatter(pool, scales, phys, sl, touched, kv_new):
    """Write ``kv_new`` (B, C, 2, Kv, hd) into the int8 layer ``pool``
    (P+1, 2, page, Kv, hd) at (phys, sl), with ``scales`` (P+1, 2, Kv) the
    layer's running-max scales, all in place.

    The reference's arithmetic, on the touched pages only: fold the new
    tokens' absmax/127 into their pages' scales (a max, so duplicate
    indices are safe), re-pack each touched page's bytes by old/new scale
    (exactly 1.0 where the scale did not grow, 0 for a fresh page), then
    quantize the new tokens under the new scales.  Two of the reference's
    steps are identities here and are left out: its ``where(new > 0, ...,
    0)`` (a scale of 0 was 0 before too, and 0 / SCALE_EPS is 0) and the
    clip of the re-packed bytes (|q| <= 127 times a factor in [0, 1])."""
    B, C = phys.shape
    kv32 = kv_new.float()
    old = scales[touched]
    flat = scales.view(scales.shape[0], -1)
    tok = headwise_scales(kv32).reshape(B * C, -1)             # (B*C, 2*Kv)
    flat.scatter_reduce_(0, phys.reshape(-1, 1).expand(-1, tok.shape[1]),
                         tok, "amax", include_self=True)
    factor = old / scales[touched].clamp(min=SCALE_EPS)
    pool[touched] = torch.round(
        pool[touched].float() * factor[:, :, None, :, None]).to(torch.int8)
    pool[phys, :, sl] = quantize_int8(kv32, scales[phys][..., None])


def _paged_forward(cfg: ArchConfig, model, use_kernel: bool,
                   pages_per_step: int, num_pages: int, kv_pages, bt, lens,
                   n_new, feed, last_tok, use_last, kv_scales=None):
    """Shared forward of the chunk, decode and speculative verify steps:
    consume up to C tokens per lane (prompt chunks from ``feed``; lanes
    with ``use_last`` take the device-resident previous sample at position
    0), writing their K/V into ``kv_pages`` in place.

    kv_pages: (L, P+1, 2, page, kv, hd); bt: (B, n_pages) repeat-padded;
    kv_scales: (L, P+1, 2, kv) float32 for an int8 pool, else None.
    Returns (final-norm hidden (B, C, d), new lengths (B,))."""
    B, C = feed.shape
    page = kv_pages.shape[3]
    tokens = feed.clone()
    tokens[:, 0] = torch.where(use_last == 1, last_tok, feed[:, 0])
    x = L.embed_tokens(cfg, model.embed, tokens)            # (B,C,d)
    pos = lens[:, None] + torch.arange(C, dtype=torch.int32,
                                       device=feed.device)[None, :]
    new_lens = lens + n_new
    counts = page_counts_for(new_lens, page)
    phys, sl = _write_coords(bt, lens, n_new, C, page, num_pages)
    phys, sl = phys.long(), sl.long()
    if kv_scales is not None:
        touched = _touched_pages(bt, lens, n_new, C, page, num_pages)
    if not use_kernel:      # the -1-marked table form the plain path reads
        bt_masked = mask_block_table(bt, counts)

    for i, lp in enumerate(model.layers):
        q, k, v = _layer_qkv(cfg, lp, x, pos)
        pool = kv_pages[i]                           # (P+1,2,page,Kv,hd) view
        kv_new = torch.stack([k, v], dim=2)          # (B,C,2,Kv,hd)
        sc = kv_scales[i] if kv_scales is not None else None
        # one fused scatter writes K AND V of all lanes' chunk tokens,
        # in place: the pool is the largest tensor of the engine and is
        # never copied (duplicate indices only ever hit the trash page)
        if sc is None:
            pool[phys, :, sl] = kv_new.to(pool.dtype)
        else:
            _quant_scatter(pool, sc, phys, sl, touched, kv_new)
        if use_kernel:
            a = paged_prefill_fused(q, pool, bt, counts, new_lens, lens,
                                    pages_per_step=pages_per_step,
                                    kv_scales=sc)
        else:
            scales = {} if sc is None else dict(k_scales=sc[:, 0],
                                                v_scales=sc[:, 1])
            a = paged_prefill_ref(q, pool[:, 0], pool[:, 1], bt_masked,
                                  new_lens, lens, **scales)
        x = x + a.reshape(B, C, -1) @ lp["attn"]["wo"].reshape(-1, cfg.d_model)
        x = _layer_mlp(cfg, lp, x)

    return L.norm_forward(cfg, model.final_norm, x), new_lens


def _sample_scores(logits, seeds, pos, temps, top_ks, top_ps):
    """The scores a sampling lane takes the argmax of: its (B, V) float32
    ``logits`` divided by its temperature, truncated to top-k and then to
    top-p (-inf outside), plus the Gumbel noise of the key
    ``fold_in(PRNGKey(seed), pos)``, all lanes at once.

    The reference's ``one`` (``repro.runtime.server._sample_tokens``) step
    for step: top-k keeps the values >= the k-th largest (``top_k == 0``
    keeps all); the nucleus keeps every probability >= the smallest of the
    descending prefix whose mass before it is < top-p."""
    V = logits.shape[-1]
    lg = logits / torch.clamp(temps, min=1e-6)[:, None]
    desc = torch.sort(lg, dim=-1, descending=True).values
    kth = desc.gather(1, (top_ks.long() - 1).clamp(0, V - 1)[:, None])
    lg = torch.where((top_ks[:, None] > 0) & (lg < kth), -torch.inf, lg)
    e = torch.exp(lg - lg.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    sp = torch.sort(probs, dim=-1, descending=True).values
    keep = (torch.cumsum(sp, dim=-1) - sp) < top_ps[:, None]
    thresh = torch.where(keep, sp, torch.inf).amin(dim=-1, keepdim=True)
    lg = torch.where(probs >= thresh, lg, -torch.inf)
    keys = prng.fold_in(prng.prng_key(seeds), pos)
    return lg + prng.gumbel(keys, V)


def _sample_tokens(logits, seeds, pos, temps, top_ks, top_ps):
    """Each lane's next token from its (B, V) float32 ``logits``: the
    greedy argmax where its temperature is 0, else a categorical draw
    (the argmax of :func:`_sample_scores`) keyed by its seed and the
    token's absolute position ``pos``, so a draw depends on (seed,
    position) alone, however the request was chunked or preempted."""
    sampler_calls.n += 1
    greedy = logits.argmax(dim=-1)
    sampled = _sample_scores(logits, seeds, pos, temps, top_ks,
                             top_ps).argmax(dim=-1)
    return torch.where(temps > 0, sampled, greedy).to(torch.int32)


def _select(logits, pos, sampling):
    """The greedy argmax of (B, V) ``logits``, or with ``sampling`` (the
    engine's seed, temperature, top-k and top-p rows) each lane's draw at
    position ``pos``."""
    if sampling is None:
        return logits.argmax(dim=-1).to(torch.int32)
    seeds, temps, top_ks, top_ps = sampling
    return _sample_tokens(logits, seeds, pos, temps, top_ks, top_ps)


@torch.no_grad()
def _paged_chunk_step(cfg: ArchConfig, model, use_kernel: bool,
                      pages_per_step: int, num_pages: int, kv_pages, bt, lens,
                      n_new, feed, last_tok, use_last, kv_scales=None,
                      sampling=None):
    """Consume up to C tokens per lane and pick each lane's next token
    from the float32 logits at its last fed position: the greedy argmax,
    or with ``sampling`` each lane's draw at the token's position ``lens +
    n_new``.  The decode step is the C=1 case (every lane feeds its
    device-resident previous sample, ``n_new = active``).

    Returns (next tokens (B,), new lengths (B,), logits (B, V) f32)."""
    h, new_lens = _paged_forward(cfg, model, use_kernel, pages_per_step,
                                 num_pages, kv_pages, bt, lens, n_new, feed,
                                 last_tok, use_last, kv_scales)
    # only the row each lane samples from goes through the head, so a
    # chunk's (B, C, V) float32 logits are never materialized
    row = (n_new - 1).clamp(min=0).long()
    h_last = torch.gather(h, 1, row[:, None, None].expand(-1, 1, h.shape[-1])
                          )[:, 0]
    logits = L.logits_from_hidden(cfg, model.embed, h_last)     # (B,V) f32
    nxt = _select(logits, new_lens, sampling)
    nxt = torch.where(n_new > 0, nxt, last_tok)   # idle lanes keep their token
    return nxt, new_lens, logits


@torch.no_grad()
def _paged_spec_step(cfg: ArchConfig, model, use_kernel: bool,
                     pages_per_step: int, num_pages: int, kv_pages, bt, lens,
                     active, last_tok, drafts, n_spec, kv_scales=None,
                     sampling=None):
    """Speculative verify: score all K+1 candidate positions of every lane
    in one chunked forward and count the accepted draft prefix (greedy
    lanes only).

    The feed is ``[x0, d_1 .. d_K]`` with x0 the device-resident previous
    sample; lane b uses ``n_spec[b]`` drafts (the rest go to the trash
    page).  Draft d_{j+1} is accepted iff every earlier one was and it
    equals the greedy token after position j, so the accepted prefix plus
    the bonus token (the greedy token at row ``accepted``) is exactly the
    plain greedy continuation.  With ``sampling`` the bonus token is each
    lane's draw at position ``lens + accepted + 1``: for a drafting
    (greedy) lane the greedy token, for a sampling lane (zero drafts) the
    draw plain decode makes.  Lengths advance by ``accepted + 1``.

    Returns (verdict (B, K+2), next tokens (B,), new lengths (B,), the
    bonus rows' logits (B, V) f32); ``verdict[:, :K+1]`` holds each row's
    greedy token (the bonus token at column ``accepted``) and
    ``verdict[:, K+1]`` the accepted count."""
    B, K = drafts.shape
    feed = torch.cat([torch.zeros_like(drafts[:, :1]), drafts], dim=1)
    n_new = torch.where(active == 1, n_spec + 1, torch.zeros_like(n_spec))
    h, _ = _paged_forward(cfg, model, use_kernel, pages_per_step, num_pages,
                          kv_pages, bt, lens, n_new, feed, last_tok, active,
                          kv_scales)
    logits = L.logits_from_hidden(cfg, model.embed, h)     # (B,K+1,V) f32
    greedy = logits.argmax(dim=-1).to(torch.int32)
    idx = torch.arange(K, device=drafts.device)[None, :]
    ok = (drafts == greedy[:, :K]) & (idx < n_spec[:, None])
    accepted = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1).to(
        torch.int32)
    new_lens = lens + torch.where(active == 1, accepted + 1,
                                  torch.zeros_like(accepted))
    rows, acc = torch.arange(B, device=drafts.device), accepted.long()
    bonus_logits = logits[rows, acc]                            # (B,V)
    if sampling is None:    # all greedy: the bonus token IS the greedy one
        bonus = greedy[rows, acc]
    else:
        seeds, temps, top_ks, top_ps = sampling
        bonus = _sample_tokens(bonus_logits, seeds, lens + accepted + 1,
                               temps, top_ks, top_ps)
    last = torch.where(active == 1, bonus, last_tok)
    toks = greedy.clone()
    toks[rows, acc] = last
    verdict = torch.cat([toks, accepted[:, None]], dim=1)
    return verdict, last, new_lens, bonus_logits
