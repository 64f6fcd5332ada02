"""Multi-cluster sharded paged serving engine (HERO §2.1 scaled out).

The port of ``repro.runtime.sharded_server.ShardedPagedServer``.  HERO's
headline property is that the PMCA *scales*: throughput grows by adding
RISC-V clusters behind one SVM/RAB fabric.  This engine is the serving
side of that lever: the paged engine of ``runtime.server`` sharded over a
``ClusterMesh`` (``launch.mesh``) of C "clusters" (data-parallel lane
groups) x H head shards, ``("cluster", "head")``.

Mapping back to the paper:

* **per-cluster RAB + page shard** (§2.2): every cluster owns a
  ``PagedKVPool`` with its own free list, refcounts, prefix index, ``RAB``
  and tier store (``ClusterPagedPool``); a sequence lives inside one
  cluster, so its block table holds cluster-local page ids and the
  cluster id rides with the request;
* **cluster-aware admission**: placement is cache-affine least-loaded
  (largest prefix hit, then most obtainable pages, then lowest id);
  preemption stays cluster-local: a victim's pages swap out of its own
  cluster's shard;
* **one program, C clusters**: as in the reference, one host scheduler
  drives every shard, and each cluster's step is the unsharded engine's
  step (``runtime.server._paged_chunk_step`` / ``_paged_spec_step``) on
  that cluster's lanes, pool and heads.  Each (cluster, head) shard owns
  a contiguous ``(L, P+1, 2, page, Kv/H, hd)`` slab with its own trash
  page (the kernels read a contiguous pool), and a head shard's weights
  are views of the one model (``parallel.sharding.head_param_views``).
  Heads are GQA-aware tensor parallelism: one reduction of the attention
  output a layer (``server._head_reduce``, the reference's ``psum``).
  With C = H = 1 the engine is the unsharded ``PagedServer`` token for
  token, sampled lanes included (their keys fold by seed and position
  and never see the mesh);
* **tracing** (§2.3.1): placement and the per-iteration gather of every
  cluster's sampled tokens (ONE D2H pull an iteration) emit
  ``CLUSTER_DISPATCH`` / ``ALL_GATHER`` events, analyzed by
  ``core.analysis.layer2_cluster_balance``.

Every shard sits on the engine's one device (``make_serving_mesh``), so
the clusters' steps run one after another on it: a decode iteration
launches about C times the kernels of an unsharded one.  An MoE layer
routes each cluster's rows apart, so expert capacity is per cluster.

Configuration flows through the same ``EngineConfig`` as the unsharded
engine (``clusters`` / ``heads`` / ``mesh`` select the mesh;
``make_engine`` picks this class whenever the spec wants one).
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.offload import DiskTier, HostBackingStore
from repro_torch.core.rab import ClusterPagedPool, PagedKVPool, RABConfig
from repro_torch.core.tracing import EventType, TraceBuffer
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.parallel.sharding import (
    cluster_engine_layout, head_param_views,
)
from repro_torch.runtime.api import EngineConfig
from repro_torch.runtime.server import PagedServer, SeqState, _cat

__all__ = ["ShardedPagedServer"]


def _rows(sampling, sl: slice):
    """One cluster's rows of the sampling-policy rows (or None)."""
    return None if sampling is None else tuple(t[sl] for t in sampling)


class ShardedPagedServer(PagedServer):
    """``PagedServer`` sharded over a ``("cluster", "head")`` mesh.

    ``EngineConfig.cache.num_pages`` and ``EngineConfig.max_lanes`` are
    *per cluster* (so a 1-cluster sharded engine is configured exactly
    like the unsharded one).  Cluster c's lanes are rows
    ``c * max_lanes ..`` of the engine-wide lane state.
    """

    def __init__(self, cfg: ArchConfig, params,
                 engine: Optional[EngineConfig] = None, *,
                 tracer: Optional[TraceBuffer] = None,
                 device: DeviceLike = None):
        if engine is None:
            engine = EngineConfig()
        if engine.mesh is not None:
            cmesh = engine.mesh
            if device is not None and resolve_device(device) != cmesh.device:
                raise ValueError(f"device {device} but the mesh's shards "
                                 f"sit on {cmesh.device}")
        else:
            cmesh = make_serving_mesh(engine.clusters, engine.heads, device)
        self.cmesh = cmesh
        self.clusters = cmesh.clusters
        self.heads = cmesh.heads
        self.lanes_per_cluster = engine.max_lanes
        self._local_pages = engine.cache.num_pages
        super().__init__(
            cfg, params,
            dataclasses.replace(engine,
                                max_lanes=engine.max_lanes * cmesh.clusters),
            tracer=tracer, device=cmesh.device)
        self.engine_cfg = engine        # the per-cluster spec, as given
        self.peak_pages = [0] * cmesh.clusters  # per-cluster occupancy peak
        self._fin_mark = 0
        self._parked_len: dict = {}     # rid -> seq_len across preemption

    # ------------------------------------------------------ construction --
    def _build_pool(self, num_pages: int, rab_cfg: RABConfig):
        # per-cluster pools/RABs instead of the base's single pool;
        # self.pool points at the aggregate view (stats, free_pages,
        # check_invariants) for external readers, never at an allocator
        self.cpool = ClusterPagedPool(self.clusters, num_pages,
                                      self.page_size, self.max_pages,
                                      rab_cfg, self.tracer)
        self.pool = self.cpool
        self.rabs = self.cpool.rabs
        self.rab = self.rabs[0]

    def _build_slabs(self, num_pages: int):
        # one contiguous slab (and int8 scale slab) per (cluster, head)
        # shard, each with its own trash page at local index num_pages;
        # head shards read their weights as views of the one model
        self.layout = cluster_engine_layout(
            self.cfg, self.clusters, self.heads, num_pages, self.page_size,
            self.lanes_per_cluster)
        dev = self.device
        self.kv_shards = [[torch.zeros(self.layout.kv, dtype=self.kv_dtype,
                                       device=dev)
                           for _ in range(self.heads)]
                          for _ in range(self.clusters)]
        self.scale_shards = [[torch.zeros(self.layout.kv_scales,
                                          dtype=torch.float32, device=dev)
                              if self.quant_kv else None
                              for _ in range(self.heads)]
                             for _ in range(self.clusters)]
        self.head_attn = None if self.heads == 1 else [
            head_param_views(self.params, self.heads, s)
            for s in range(self.heads)]

    def _build_backing_store(self) -> HostBackingStore:
        # cache spill tiers are per cluster (like the pools and prefix
        # indexes they back); swap traffic stays on ONE engine-wide store
        # because a preempted victim may resume on any cluster
        cc = self.cache_cfg
        self.tier_stores: List[HostBackingStore] = []
        for c in range(self.clusters):
            sub = None if cc.disk_dir is None else \
                os.path.join(cc.disk_dir, f"cluster{c}")
            disk = DiskTier(cc.disk_tier_pages, sub) \
                if cc.disk_tier_pages else None
            self.tier_stores.append(HostBackingStore(
                self.faults, host_pages=cc.host_tier_pages, disk_tier=disk))
        return HostBackingStore(self.faults)

    # ---------------------------------------------------------- pool seam --
    def _pool_of(self, cluster: int) -> PagedKVPool:
        return self.cpool.pools[cluster]

    def _all_pools(self) -> List[PagedKVPool]:
        return list(self.cpool.pools)

    def _capacity_pages(self) -> int:
        return self._local_pages

    def _cache_store_of(self, cluster: int) -> HostBackingStore:
        return self.tier_stores[cluster]

    def _cache_stores(self) -> List[HostBackingStore]:
        return list(self.tier_stores)

    # --------------------------------------------------------------- steps --
    def _chunk(self, n_new, feed, use_last, sampling):
        """Each cluster runs the unsharded chunk step on its own lanes,
        pool and heads; their results are gathered onto the device in
        cluster order."""
        outs = [self._step(self.kv_shards[c], self.bt_dev[sl],
                           self.len_dev[sl], n_new[sl], feed[sl],
                           self.last_tok[sl], use_last[sl],
                           kv_scales=self.scale_shards[c],
                           sampling=_rows(sampling, sl),
                           head_attn=self.head_attn)
                for c, sl in enumerate(self.layout.lanes)]
        self.last_tok, self.len_dev, self.last_logits = (
            _cat(list(parts), 0) for parts in zip(*outs))

    def _verify(self, drafts, n_spec, sampling) -> torch.Tensor:
        """Each cluster runs the unsharded verify step on its own lanes;
        the verdicts and logits (``last_logits``, ``verify_logits``) are
        gathered in cluster order, so a lane indexes them as it does the
        unsharded engine's."""
        outs = [self._spec_step(self.kv_shards[c], self.bt_dev[sl],
                                self.len_dev[sl], self.active_dev[sl],
                                self.last_tok[sl], drafts[sl], n_spec[sl],
                                kv_scales=self.scale_shards[c],
                                sampling=_rows(sampling, sl),
                                head_attn=self.head_attn)
                for c, sl in enumerate(self.layout.lanes)]
        (verdict, self.last_tok, self.len_dev, self.last_logits,
         self.verify_logits) = (_cat(list(parts), 0)
                                for parts in zip(*outs))
        return verdict

    # --------------------------------------------------------- scheduler --
    def _free_lane(self, cluster: int) -> Optional[int]:
        lo = cluster * self.lanes_per_cluster
        for i in range(lo, lo + self.lanes_per_cluster):
            if self.lanes[i] is None:
                return i
        return None

    def _admit(self):
        """Cluster-aware admission: plan the queue head against every
        cluster with a free lane and place it cache-affine least-loaded —
        largest usable prefix hit first, then most obtainable pages, then
        lowest cluster id.  When no cluster fits, preemption reclaims the
        lowest-priority running lane (the sweep is cluster-local: only the
        victim's cluster shard is touched) and planning retries."""
        while self.queue:
            head = self._eligible_head()
            if head is None:
                break                 # every waiter is backing off
            best = None
            for c in range(self.clusters):
                lane = self._free_lane(c)
                if lane is None:
                    continue
                plan = self._plan(head, cluster=c)
                if not self._fits(plan):
                    continue
                score = (plan["usable"], self._pool_of(c).available(), -c)
                if best is None or score > best[0]:
                    best = (score, lane, plan)
            if best is None:
                victim = self._victim(head)
                if victim is None:
                    break
                self._preempt(victim)
                continue
            self.queue.remove(head)
            self._place(head, best[1], best[2])

    def _place(self, req: SeqState, lane: int, plan: dict):
        self.cpool.place(req.rid, plan["cluster"])
        self.tracer.record_host(EventType.CLUSTER_DISPATCH, req.rid,
                                plan["cluster"])
        if plan["resume"] and req.rid in self._parked_len:
            # re-install the sequence length into the (possibly different)
            # destination cluster's pool before the swap-in restores pages
            self._pool_of(plan["cluster"]).seq_len[req.rid] = \
                self._parked_len.pop(req.rid)
        super()._place(req, lane, plan)

    def _unplace(self, req: SeqState):
        # a deferred swap-in retry: re-park the sequence length and drop
        # the routing entry (mirroring _preempt) so the later retry may
        # place the request on ANY cluster again
        pool = self._pool(req)
        super()._unplace(req)
        self._parked_len[req.rid] = pool.seq_len.pop(req.rid, 0)
        self.cpool.forget(req.rid)

    def _preempt(self, req: SeqState):
        pool = self._pool(req)
        super()._preempt(req)
        if req.done:
            # the checkpoint sweep hit a persistent backing-store fault
            # and demoted the victim: _terminate already cleaned up
            return
        # the victim may be re-placed on ANY cluster (its KV payload is
        # host-resident now): park its sequence length with the scheduler
        # and drop the old cluster's routing entry
        self._parked_len[req.rid] = pool.seq_len.pop(req.rid, 0)
        self.cpool.forget(req.rid)

    def _finish(self, req: SeqState, reason: str):
        super()._finish(req, reason)
        self.cpool.forget(req.rid)

    def _terminate(self, req: SeqState, reason: str, event: str,
                   diag: Optional[str] = None):
        # every exceptional exit (abort / cancel / timeout / error / shed)
        # flows through here: drop the parked length and routing entry too
        super()._terminate(req, reason, event, diag)
        self._parked_len.pop(req.rid, None)
        self.cpool.forget(req.rid)

    # --------------------------------------------------------------- step --
    def step(self) -> bool:
        before_it = self.iterations
        occ0 = self.cpool.occupancy()
        progressed = super().step()
        if self.iterations > before_it:
            busy = {r.cluster for r in self.lanes if r is not None}
            busy |= {r.cluster for r in self.finished[self._fin_mark:]}
            self._fin_mark = len(self.finished)
            # the one D2H token pull per iteration gathers every active
            # cluster's sampled tokens
            self.tracer.record_host(EventType.ALL_GATHER, self.iterations,
                                    len(busy))
            for c, (a, b) in enumerate(zip(occ0, self.cpool.occupancy())):
                self.peak_pages[c] = max(self.peak_pages[c], a, b)
        return progressed

    # ------------------------------------------------------------- report --
    def cluster_report(self) -> dict:
        """Per-cluster occupancy/balance summary for benchmarks."""
        occ = self.cpool.occupancy()
        return {
            "clusters": self.clusters,
            "heads": self.heads,
            "peak_pages_per_cluster": list(self.peak_pages),
            "pages_per_cluster": self._local_pages,
            "peak_occupancy_per_cluster": [
                p / self._local_pages for p in self.peak_pages],
            "live_pages_per_cluster": occ,
        }
