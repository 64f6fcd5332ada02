"""The port's multi-cluster sharded engine (``ShardedPagedServer``).

The reference's own sharded engine fails under jax 0.9 (a
``ShardingTypeError`` on a ``.at[...].set`` into a lane array sharded
over ``cluster``), so the port is held against the unsharded engines, the
yardstick the reference's tests use (C = H = 1 is the unsharded engine; a
multi-cluster run gives its tokens):

* at (C, H) = (1, 1) the sharded engine equals the JAX ``PagedServer``
  token for token and on its counters, pool stats, spec counters and
  traced host rows (the mesh's own ``CLUSTER_DISPATCH`` / ``ALL_GATHER``
  rows aside);
* at (2, 1), (4, 1), (2, 2) and (1, 2) it gives the port's unsharded
  engine's tokens, also across a forced preemption, with speculation,
  with a sampled lane, on int8 pages and with tiers under faults, and
  ``ClusterPagedPool.check_invariants()`` holds after every step;
* ``planner.simulate`` predicts its iterations, tokens and per-cluster
  page peaks exactly;
* an MoE model's steps route each cluster's rows apart.

Float32 weights (yi-6b's and qwen3-32b's smoke configs), seeded with
``np.random.default_rng``.
"""
import dataclasses
import zlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as JM
from repro.runtime import (
    CacheConfig as JCacheConfig, EngineConfig as JEngineConfig,
    GenerationRequest as JRequest, SamplingParams as JSampling,
    make_engine as j_make_engine,
)
from repro.core.tracing import TraceBuffer as JTraceBuffer
from repro_torch import planner as P
from repro_torch.configs import get_config
from repro_torch.core.analysis import (
    assert_faults_contained, assert_tier_conservation, layer1_decode,
    layer2_cluster_balance,
)
from repro_torch.core.tracing import EventType, TraceBuffer
from repro_torch.kernels.paged_attention.ops import validate_head_sharding
from repro_torch.launch.mesh import ClusterMesh, make_serving_mesh
from repro_torch.models import moe as MOE
from repro_torch.models.model import init_params, params_from_jax
from repro_torch.parallel.sharding import (
    cluster_engine_layout, head_param_views,
)
from repro_torch.runtime import (
    CacheConfig, EngineConfig, FaultInjector, FaultSpec, GenerationRequest,
    PagedServer, SamplingParams, ShardedPagedServer, VirtualClock,
    make_engine,
)
from repro_torch.runtime import server as S

#: the mesh's own trace events, which the unsharded engine never records
MESH_EVENTS = (int(EventType.CLUSTER_DISPATCH), int(EventType.ALL_GATHER))


def _pair(arch):
    jcfg = dataclasses.replace(j_get_config(arch).smoke(),
                               param_dtype="float32")
    tcfg = dataclasses.replace(get_config(arch).smoke(),
                               param_dtype="float32")
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(tcfg, jax.tree.map(np.asarray, params),
                            device="cpu")
    return jcfg, params, tcfg, model


@pytest.fixture(scope="module")
def yi():
    return _pair("yi-6b")


@pytest.fixture(scope="module")
def smoke():
    """The port alone, on float32 weights from its own ``init_params``."""
    out = {}
    for arch in ("yi-6b", "qwen3-32b"):
        cfg = dataclasses.replace(get_config(arch).smoke(),
                                  param_dtype="float32")
        out[arch] = (cfg, init_params(cfg, seed=0, device="cpu"))
    return out


# ===========================================================================
# (1, 1) against the JAX engine
# ===========================================================================

SYS11 = [11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21]


def _jax_workload(vocab):
    """A shared 11-token prompt (prefix hit and copy-on-write of its
    partial tail page), a repeated pattern the n-gram drafter follows,
    and a random prompt."""
    rng = np.random.default_rng(0)
    pat = rng.integers(1, vocab, 4).tolist()
    return [SYS11, SYS11, pat * 3, rng.integers(1, vocab, 9).tolist()]


def _jax_summary(e, rows):
    rows = np.asarray(rows)
    host = rows[~np.isin(rows[:, 2], MESH_EVENTS)][:, 1:]
    return dict(
        results={r.rid: (tuple(r.tokens), r.finish_reason,
                         r.prefix_hit_tokens, r.preemptions,
                         r.spec_proposed, r.spec_accepted, r.spec_rejected,
                         r.spec_k_final) for r in e.finished},
        iterations=e.iterations, h2d=e.h2d_events, d2h=e.d2h_events,
        preemptions=e.preemptions, pool=dict(e.pool.stats),
        spec=(e.spec_iterations, e.spec_proposed, e.spec_accepted,
              e.spec_rejected),
        prefill_tokens=e.prefill_tokens, rows=host.tolist())


def _serve_both(pair, *, page, kv_dtype, use_kernel, spec_k):
    """rid 0 runs alone through its prefill, rids 1-3 follow (1 shares its
    prompt), rid 0 is preempted three steps later; both engines step in
    lockstep and the port's cluster pool is checked after every step."""
    jcfg, params, tcfg, model = pair
    prompts = _jax_workload(tcfg.vocab_size)
    kw = dict(max_lanes=2, chunk=8, use_kernel=use_kernel, spec_k=spec_k)
    jt, tt = JTraceBuffer(capacity=1 << 14), TraceBuffer(capacity=1 << 14)
    j = j_make_engine(jcfg, params, JEngineConfig(cache=JCacheConfig(
        num_pages=48, page_size=page, max_pages_per_seq=16,
        kv_dtype=kv_dtype), **kw), tracer=jt)
    t = make_engine(tcfg, model, EngineConfig(cache=CacheConfig(
        num_pages=48, page_size=page, max_pages_per_seq=16,
        kv_dtype=kv_dtype), sharded=True, clusters=1, heads=1, **kw),
        tracer=tt, device="cpu")
    assert isinstance(t, ShardedPagedServer)
    for step in range(300):
        if step == 0:
            j.submit(JRequest(0, tuple(prompts[0]), JSampling(max_new=12)))
            t.submit(GenerationRequest(0, tuple(prompts[0]),
                                       SamplingParams(max_new=12)))
        elif step == 2:
            for rid, p in enumerate(prompts[1:], start=1):
                j.submit(JRequest(rid, tuple(p), JSampling(max_new=12)))
                t.submit(GenerationRequest(rid, tuple(p),
                                           SamplingParams(max_new=12)))
        elif step == 5:
            assert j.preempt(0) and t.preempt(0)
        busy = j.step()
        assert t.step() == busy
        t.cpool.check_invariants()
        if not busy:
            break
    return _jax_summary(j, jt.drain()), _jax_summary(t, tt.drain()), t


@pytest.mark.parametrize("page,kv_dtype,use_kernel,spec_k", [
    (4, "bf16", False, 0), (8, "bf16", False, 0), (4, "int8", False, 0),
    (8, "int8", False, 0), (4, "bf16", True, 0), (8, "bf16", True, 0),
    (4, "int8", True, 0), (8, "int8", True, 0), (4, "int8", False, 4),
    (8, "bf16", False, 4)],
    ids=["p4-bf16", "p8-bf16", "p4-int8", "p8-int8", "p4-bf16-kernel",
         "p8-bf16-kernel", "p4-int8-kernel", "p8-int8-kernel",
         "p4-int8-spec", "p8-bf16-spec"])
def test_one_cluster_equals_jax_engine(yi, page, kv_dtype, use_kernel,
                                       spec_k):
    """C = H = 1 is the unsharded engine: the JAX ``PagedServer``'s tokens,
    iterations, transfers, pool stats, spec counters and host rows."""
    ref, port, srv = _serve_both(yi, page=page, kv_dtype=kv_dtype,
                                 use_kernel=use_kernel, spec_k=spec_k)
    assert port == ref
    assert port["pool"]["prefix_hit_tokens"] > 0
    assert port["pool"]["swapped_in"] > 0
    if spec_k:
        assert port["spec"][2] > 0 and port["spec"][3] > 0
    assert srv.pool.free_pages() == 48


def _sampled_tokens(make, cfg, params, EC, CC, R, SP, page, **kw):
    """The reference's sampled workload (three random prompts; temperature
    0.8, top-p 0.9, seed 40 + rid, 8 new tokens) on 2 lanes (per
    cluster), 32 pages of ``page``."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
               for n in rng.integers(3, 11, size=3)]
    dev = kw.pop("device", {})
    srv = make(cfg, params, EC(cache=CC(num_pages=32, page_size=page,
                                        max_pages_per_seq=8),
                               max_lanes=2, chunk=4, **kw), **dev)
    for rid, p in enumerate(prompts):
        srv.submit(R(rid, tuple(p), SP(temperature=0.8, top_p=0.9,
                                       seed=40 + rid, max_new=8)))
    return {r.rid: tuple(r.tokens) for r in srv.run()}


@pytest.mark.parametrize("page", [4, 8])
def test_sampled_streams_equal_jax_engine(yi, page):
    """Sampled lanes key their draws by (seed, position), so neither the
    attention route nor the mesh moves them: the JAX engine's streams
    equal the port's sharded engine's at (1, 1) on the plain and the
    kernel route, and at (2, 1) and (1, 2)."""
    jcfg, params, tcfg, model = yi
    ref = _sampled_tokens(j_make_engine, jcfg, params, JEngineConfig,
                          JCacheConfig, JRequest, JSampling, page,
                          use_kernel=False)
    port = dict(make=make_engine, cfg=tcfg, params=model, EC=EngineConfig,
                CC=CacheConfig, R=GenerationRequest, SP=SamplingParams,
                page=page, device=dict(device="cpu"), sharded=True)
    for kw in (dict(use_kernel=False), dict(use_kernel=True),
               dict(clusters=2), dict(heads=2)):
        assert _sampled_tokens(**port, **kw) == ref, kw


# ===========================================================================
# several clusters and head shards against the unsharded port
# ===========================================================================

PROMPTS = [[5, 6, 7, 8, 9, 10, 11], [3, 1, 4, 1, 5], [2, 7], [9, 9, 8]]


class ReplayDrafter:
    """Proposes each prompt's known greedy continuation, the last draft of
    a call at an odd context length corrupted (so verification accepts and
    rejects); deterministic in the context, so every engine that agrees
    sees the same drafts."""

    def __init__(self, known: dict, vocab: int):
        self.known, self.vocab = known, vocab

    def propose(self, ctx, k):
        for prompt, cont in self.known.items():
            n = len(prompt)
            if tuple(ctx[:n]) == prompt and \
                    list(ctx[n:]) == list(cont[:len(ctx) - n]):
                d = list(cont[len(ctx) - n:len(ctx) - n + k])
                if d and len(ctx) % 2:
                    d[-1] = (d[-1] + 1) % self.vocab
                return d
        return []


def _serve(cfg, model, *, preempt=False, sampled_rid=None, kv_dtype="bf16",
           max_new=3, max_lanes=2, num_pages=16, **kw):
    """The reference test's multi-cluster workload
    (``tests/test_sharded_server.py``): 4 prompts, 16 pages of 4 and 2
    lanes (per cluster), chunk 4; invariants after every step."""
    srv = make_engine(cfg, model, EngineConfig(
        cache=CacheConfig(num_pages=num_pages, page_size=4,
                          max_pages_per_seq=8, kv_dtype=kv_dtype),
        max_lanes=max_lanes, chunk=4, use_kernel=False, **kw), device="cpu")
    for rid, p in enumerate(PROMPTS):
        sp = SamplingParams(max_new=max_new) if rid != sampled_rid else \
            SamplingParams(max_new=max_new, temperature=0.8, seed=13)
        srv.submit(GenerationRequest(rid=rid, prompt=tuple(p), sampling=sp))
    if preempt:
        srv.step()
        assert srv.preempt(0)      # forced mid-flight preemption
    it = 0
    while srv.step():
        it += 1
        assert it < 300
        if isinstance(srv, ShardedPagedServer):
            srv.cpool.check_invariants()
    return {r.rid: r.tokens for r in srv.finished}, srv


MESHES = [(2, 1), (4, 1), (2, 2), (1, 2)]


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("arch", ["yi-6b", "qwen3-32b"])
@pytest.mark.parametrize("mesh", MESHES, ids=[f"{c}x{h}" for c, h in MESHES])
def test_mesh_equals_unsharded(smoke, arch, mesh, kv_dtype):
    cfg, model = smoke[arch]
    base, _ = _serve(cfg, model, kv_dtype=kv_dtype)
    C, H = mesh
    out, srv = _serve(cfg, model, kv_dtype=kv_dtype, clusters=C, heads=H)
    assert out == base
    assert (srv.clusters, srv.heads) == mesh
    used = {r.cluster for r in srv.finished}
    assert len(used) == min(C, len(PROMPTS)), used
    assert srv.pool.free_pages() == 16 * C


@pytest.mark.parametrize("mesh", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_forced_preemption_across_clusters(smoke, mesh):
    cfg, model = smoke["yi-6b"]
    base, _ = _serve(cfg, model)
    out, srv = _serve(cfg, model, preempt=True, clusters=mesh[0],
                      heads=mesh[1])
    assert out == base and srv.preemptions >= 1
    assert srv.pool.stats["swapped_in"] > 0
    assert not srv._parked_len and not srv.cpool.cluster_of


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_speculation_across_clusters(smoke, kv_dtype):
    """``spec_k=4`` at (2, 1) gives the unsharded speculative engine's
    tokens and each request's verdicts when both hold the same lanes and
    pages (4 and 32): a lane drafts only while nothing waits, so the lane
    and page counts decide which iterations draft.  On bf16 pages that
    is the plain greedy stream; on int8 pages a rejected draft may have
    grown its page's scale, so the stream is the unsharded int8
    speculative engine's."""
    cfg, model = smoke["yi-6b"]
    plain, _ = _serve(cfg, model, kv_dtype=kv_dtype, max_new=8)
    known = {tuple(p): plain[rid] for rid, p in enumerate(PROMPTS)}
    spec = dict(kv_dtype=kv_dtype, max_new=8, spec_k=4,
                drafter=ReplayDrafter(known, cfg.vocab_size))
    base, one = _serve(cfg, model, max_lanes=4, num_pages=32, **spec)
    out, srv = _serve(cfg, model, clusters=2, **spec)
    assert out == base
    if kv_dtype == "bf16":
        assert out == plain
    assert srv.spec_accepted > 0 and srv.spec_rejected > 0
    assert srv.spec_proposed == srv.spec_accepted + srv.spec_rejected

    def verdicts(e):
        return sorted((r.rid, r.spec_proposed, r.spec_accepted,
                       r.spec_rejected) for r in e.finished)
    assert verdicts(srv) == verdicts(one)


@pytest.mark.parametrize("mesh", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_sampled_lane_across_clusters(smoke, mesh):
    """A sampled lane's stream is keyed by (seed, position) and never
    sees the mesh; the greedy lanes stay as they were."""
    cfg, model = smoke["yi-6b"]
    base, _ = _serve(cfg, model)
    sbase, _ = _serve(cfg, model, sampled_rid=1)
    calls = S.sampler_calls.n
    sout, _ = _serve(cfg, model, sampled_rid=1, clusters=mesh[0],
                     heads=mesh[1])
    assert S.sampler_calls.n > calls
    assert sout == sbase
    assert all(sout[r] == base[r] for r in (0, 2, 3))


def test_cluster_dispatch_tracing_and_balance(smoke):
    cfg, model = smoke["yi-6b"]
    tracer = TraceBuffer(capacity=1 << 14)
    srv = make_engine(cfg, model, EngineConfig(
        cache=CacheConfig(num_pages=16, page_size=4, max_pages_per_seq=8),
        max_lanes=1, chunk=4, use_kernel=False, clusters=2), tracer=tracer,
        device="cpu")
    for rid, p in enumerate(PROMPTS):
        srv.submit(GenerationRequest(rid, tuple(p), SamplingParams(max_new=3)))
    srv.run()
    events = layer1_decode(tracer.drain())
    kinds = [e.etype for e in events]
    assert kinds.count(EventType.CLUSTER_DISPATCH) == len(PROMPTS)
    assert kinds.count(EventType.D2H) == srv.iterations   # one pull each
    bal = layer2_cluster_balance(events, n_clusters=2)
    assert bal["all_gathers"] == srv.iterations
    assert bal["balance"] == 1.0
    assert sorted(r for c in bal["clusters"].values()
                  for r in c["requests"]) == [0, 1, 2, 3]
    rep = srv.cluster_report()
    assert rep["clusters"] == 2 and rep["heads"] == 1
    assert min(rep["peak_pages_per_cluster"]) > 0
    assert rep["live_pages_per_cluster"] == [0, 0]
    assert {r.cluster for r in srv.finished} == {0, 1}


# ===========================================================================
# tiers and faults per cluster
# ===========================================================================

def _tenant_prompts(tenants=6, reps=2):
    """Six tenants' 16-token system prompts (4 pages at page 4), each
    visited twice with a 2-token tail: more prefix corpus than the pool
    holds, so entries spill and come back."""
    systems = {t: [t * 7 + 1, t + 2, t + 3, t + 4] * 4
               for t in range(tenants)}
    return [systems[t] + [90 + rep, 95 + rep]
            for rep in range(reps) for t in range(tenants)]


def _serve_tiers(cfg, model, tmp=None, faults=None, hook=None,
                 kv_dtype="bf16", **kw):
    """The tenant workload with one forced preemption through an 8-page
    pool (per cluster) that spills into a 4-page host tier and a disk
    tier, on a virtual clock."""
    tracer = TraceBuffer(capacity=1 << 15)
    cache = CacheConfig(num_pages=8, page_size=4, max_pages_per_seq=8,
                        host_tier_pages=4, disk_tier_pages=64,
                        prefetch_depth=2, promote_latency_s=0.001,
                        kv_dtype=kv_dtype,
                        disk_dir=None if tmp is None else str(tmp))
    srv = make_engine(cfg, model, EngineConfig(
        cache=cache, max_lanes=1, chunk=8, use_kernel=False,
        clock=VirtualClock(), fault_injector=faults, swap_retries=4, **kw),
        tracer=tracer, device="cpu")
    if hook is not None:
        hook(srv)
    try:
        for rid, p in enumerate(_tenant_prompts()):
            srv.submit(GenerationRequest(rid, tuple(p),
                                         SamplingParams(max_new=3)))
        srv.step()
        assert srv.preempt(0)
        while srv.step():
            if isinstance(srv, ShardedPagedServer):
                srv.cpool.check_invariants()
        for st in {id(s): s for s in srv._cache_stores()
                   + [srv.backing]}.values():
            st.check_invariants()
        return srv, layer1_decode(tracer.drain())
    finally:
        srv.close()


def test_tiers_per_cluster(smoke, tmp_path):
    """At (2, 1) each cluster demotes into its own store and its own
    ``cluster{c}`` disk directory; the tokens are the unsharded engine's
    and every traced tier move is conserved."""
    cfg, model = smoke["yi-6b"]
    base, _ = _serve_tiers(cfg, model)
    srv, events = _serve_tiers(cfg, model, tmp_path / "spill", clusters=2)
    out = {r.rid: r.tokens for r in srv.finished}
    assert out == {r.rid: r.tokens for r in base.finished}
    st = srv.cache_stats()
    assert st.demoted_pages > 0 and st.hits_host_pages + st.hits_disk_pages > 0
    assert assert_tier_conservation(events)
    for c, store in enumerate(srv.tier_stores):
        assert store is not srv.backing
        demoted = srv.cpool.pools[c].stats["cache_demoted"]
        assert demoted > 0, c
        # entry ids interleave by cluster: c, c + C, c + 2C, ...
        assert all(key[1] % 2 == c for key in store._sums
                   if key[0] == "cache")
        assert store.cache_bytes_demoted > 0
    assert sorted(p.name for p in (tmp_path / "spill").iterdir()) == \
        ["cluster0", "cluster1"]


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_tier_payloads_at_two_head_shards_equal_unsharded(smoke, kv_dtype):
    """At (1, 2) a page's payload is its two head shards' slices joined in
    head order: every swapped and demoted payload has the unsharded
    engine's bytes, so its CRC32 too.  One layer: its K/V come before the
    head reduction (a deeper layer's differ in the last bits, since the
    shards' partial products are summed in another order)."""
    cfg = dataclasses.replace(smoke["yi-6b"][0], num_layers=1)
    model = init_params(cfg, seed=0, device="cpu")
    logs = []

    def hook(srv):
        log = []
        logs.append(log)
        for st in {id(s): s for s in srv._cache_stores()
                   + [srv.backing]}.values():
            for name in ("park_cache", "put"):
                real = getattr(st, name)

                def spy(*a, _real=real, _name=name):
                    log.append((_name, a[:-1], zlib.crc32(
                        np.ascontiguousarray(a[-1]).tobytes())))
                    return _real(*a)
                setattr(st, name, spy)

    base, _ = _serve_tiers(cfg, model, hook=hook, kv_dtype=kv_dtype)
    out, _ = _serve_tiers(cfg, model, hook=hook, heads=2, kv_dtype=kv_dtype)
    assert [r.tokens for r in out.finished] == \
        [r.tokens for r in base.finished]
    assert logs[1] == logs[0]
    assert {k for k, _, _ in logs[0]} == {"park_cache", "put"}


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("heads", [1, 2])
def test_page_payload_is_the_head_shards_joined(smoke, heads, kv_dtype):
    """The page seam on the same bits: pages whose kv heads hold the same
    values in an unsharded engine and in a (1, ``heads``) engine snapshot
    to byte-equal payloads, and a payload loaded into either engine lands
    as the same values."""
    cfg, model = smoke["qwen3-32b"]
    spec = dict(cache=CacheConfig(num_pages=8, page_size=4,
                                  max_pages_per_seq=4, kv_dtype=kv_dtype),
                max_lanes=1)
    one = make_engine(cfg, model, EngineConfig(**spec), device="cpu")
    sh = make_engine(cfg, model, EngineConfig(heads=heads, sharded=True,
                                              **spec), device="cpu")
    rng = np.random.default_rng(heads)
    (pg, sc), = one._shard_pools(0)
    if kv_dtype == "int8":
        pg.copy_(torch.from_numpy(rng.integers(-127, 128, pg.shape,
                                               dtype=np.int8)))
        sc.copy_(torch.from_numpy(rng.uniform(0, 1, sc.shape)
                                  .astype(np.float32)))
    else:
        pg.copy_(torch.from_numpy(rng.standard_normal(pg.shape)
                                  .astype(np.float32)))
    kvs = cfg.num_kv_heads // heads
    for h, (spg, ssc) in enumerate(sh._shard_pools(0)):
        spg.copy_(pg[..., h * kvs:(h + 1) * kvs, :])
        if ssc is not None:
            ssc.copy_(sc[..., h * kvs:(h + 1) * kvs])
    pages = [0, 3, 5]
    a, b = one._snap_pages(0, pages), sh._snap_pages(0, pages)
    assert [zlib.crc32(x.tobytes()) for x in a] == \
        [zlib.crc32(x.tobytes()) for x in b]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    one._load_pages(0, [1, 2, 7], a)
    sh._load_pages(0, [1, 2, 7], a)
    for x, y in zip(one._snap_pages(0, [1, 2, 7]),
                    sh._snap_pages(0, [1, 2, 7])):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(
        np.stack(one._snap_pages(0, [1, 2, 7])), np.stack(a))


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2)], ids=["2x1", "1x2"])
def test_faults_per_cluster(smoke, mesh):
    """Seeded transient I/O faults on every backing-store op at (2, 1) and
    (1, 2), with forced preemptions: no request is lost, those that finish
    have the fault-free unsharded engine's tokens, every fault is traced
    and contained, and the routing and parked lengths are left empty."""
    cfg, model = smoke["yi-6b"]
    base, _ = _serve_tiers(cfg, model)
    want = {r.rid: r.tokens for r in base.finished}
    inj = FaultInjector(seed=5, rate=0.3, kinds=(FaultSpec("io"),))
    srv, events = _serve_tiers(cfg, model, faults=inj, clusters=mesh[0],
                               heads=mesh[1])
    assert inj.injected > 0
    assert len(srv.finished) == len(want)
    for r in srv.finished:
        assert r.finish_reason in ("length", "error")
        if r.finish_reason == "length":
            assert r.tokens == want[r.rid], r.rid
    assert srv.recovered_faults > 0
    assert assert_faults_contained(events)
    assert not srv.cpool.cluster_of and not srv._parked_len
    srv.cpool.check_invariants()


# ===========================================================================
# the planner's cluster model
# ===========================================================================

@pytest.mark.parametrize("requests,prompt_len,max_new", [
    (3, 12, 4), (9, 10, 5)])
@pytest.mark.parametrize("clusters", [1, 2, 4])
def test_simulate_equals_sharded_engine(smoke, clusters, requests,
                                        prompt_len, max_new):
    """``benchmarks/plan_accuracy.py``'s cluster-sweep replay: the same
    arrivals through ``simulate`` (no iteration cost, virtual clock) and
    the sharded engine agree on iterations, generated tokens and each
    cluster's peak pages."""
    cfg, model = smoke["yi-6b"]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=prompt_len).tolist()
               for _ in range(requests)]
    page = 4
    per_seq = -(-(prompt_len + max_new) // page) + 1
    engine = EngineConfig(
        cache=CacheConfig(num_pages=per_seq * 2 + 8, page_size=page,
                          max_pages_per_seq=per_seq),
        max_lanes=2, chunk=8, clusters=clusters, sharded=True,
        use_kernel=False)
    arrivals = [P.SampledRequest(rid=i, t=0.0, prompt=tuple(p),
                                 max_new=max_new)
                for i, p in enumerate(prompts)]
    rep = P.simulate(arrivals, engine,
                     iteration_cost=P.FixedIterationCost(0.0))
    srv = make_engine(cfg, model, engine, device="cpu")
    for a in arrivals:
        srv.submit(GenerationRequest(a.rid, a.prompt,
                                     SamplingParams(max_new=a.max_new)))
    done = srv.run()
    assert rep["iterations"] == srv.iterations
    assert rep["generated_tokens"] == sum(len(r.tokens) for r in done)
    assert rep["peak_pages_per_cluster"] == \
        srv.cluster_report()["peak_pages_per_cluster"]


# ===========================================================================
# arguments, layout and views
# ===========================================================================

def test_validate_head_sharding_gqa():
    assert validate_head_sharding(8, 4, 2) == 2
    assert validate_head_sharding(8, 4, 4) == 1
    assert validate_head_sharding(4, 2, 1) == 2
    for args in ((8, 4, 3), (8, 4, 8), (7, 4, 1), (8, 4, 0)):
        with pytest.raises(ValueError):
            validate_head_sharding(*args)


def test_head_split_must_divide_kv_heads(smoke):
    cfg, model = smoke["yi-6b"]                  # Kv = 2
    for heads in (3, 4):
        with pytest.raises(ValueError, match="num_kv_heads"):
            ShardedPagedServer(cfg, model, EngineConfig(
                heads=heads, cache=CacheConfig(num_pages=8, page_size=4,
                                               max_pages_per_seq=4),
                max_lanes=1), device="cpu")


def test_mesh_of_distinct_devices_raises():
    with pytest.raises(NotImplementedError, match="several GPUs"):
        make_serving_mesh(2, 1, ["cuda:0", "cuda:1"])
    with pytest.raises(NotImplementedError, match="several GPUs"):
        make_serving_mesh(1, 2, ["cpu", "cuda:0"])
    with pytest.raises(ValueError):
        make_serving_mesh(2, 2, ["cpu"] * 3)
    with pytest.raises(ValueError):
        make_serving_mesh(0, 1, "cpu")
    mesh = make_serving_mesh(2, 2, ["cpu"] * 4)
    assert mesh.grid == ((torch.device("cpu"),) * 2,) * 2
    assert (mesh.clusters, mesh.heads, mesh.devices) == (2, 2, 4)
    assert mesh.AXIS_NAMES == ("cluster", "head")


def test_make_engine_picks_the_sharded_engine(smoke):
    cfg, model = smoke["yi-6b"]
    cache = CacheConfig(num_pages=8, page_size=4, max_pages_per_seq=4)
    for spec in (dict(clusters=2), dict(heads=2), dict(sharded=True),
                 dict(mesh=make_serving_mesh(2, 1, "cpu"))):
        srv = make_engine(cfg, model, EngineConfig(cache=cache, max_lanes=1,
                                                   **spec), device="cpu")
        assert isinstance(srv, ShardedPagedServer), spec
        assert srv.device == torch.device("cpu")
    assert type(make_engine(cfg, model, EngineConfig(cache=cache),
                            device="cpu")) is PagedServer
    # the default device is the card: without one it raises for it
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_engine(cfg, model, EngineConfig(cache=cache, clusters=2))
    elsewhere = ClusterMesh(grid=((torch.device("meta"),),), clusters=1,
                            heads=1)
    with pytest.raises(ValueError, match="mesh"):
        make_engine(cfg, model, EngineConfig(cache=cache, mesh=elsewhere),
                    device="cpu")


def test_head_shards_are_views_of_one_model(smoke):
    """A head shard's attention weights are views of the model's own
    tensors (no copy), its q/k/v reshapes stay views, and each (cluster,
    head) shard owns a contiguous slab of the layout's shape."""
    cfg, model = smoke["qwen3-32b"]
    H, Kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    views = [head_param_views(model, 2, s) for s in range(2)]
    for i, lp in enumerate(model.layers):
        full = lp["attn"]
        for s in range(2):
            v = views[s][i]
            for name in ("wq", "wk", "wv", "wo"):
                assert v[name].untyped_storage().data_ptr() == \
                    full[name].untyped_storage().data_ptr()
            assert v["wq"].shape == (cfg.d_model, H // 2, hd)
            assert v["wo"].shape == (H // 2, hd, cfg.d_model)
            assert v["q_norm"] is full["q_norm"]
            w = v["wq"].reshape(cfg.d_model, -1)
            assert w._base is not None and w.data_ptr() == \
                full["wq"].data_ptr() + s * (H // 2) * hd * 4
        # the two shards' q heads tile the whole kv-major head axis
        torch.testing.assert_close(
            torch.cat([views[0][i]["wq"], views[1][i]["wq"]], dim=1),
            full["wq"], rtol=0, atol=0)
    srv = make_engine(cfg, model, EngineConfig(
        cache=CacheConfig(num_pages=8, page_size=4, max_pages_per_seq=4,
                          kv_dtype="int8"), max_lanes=1, clusters=2,
        heads=2), device="cpu")
    lay = cluster_engine_layout(cfg, 2, 2, 8, 4, 1)
    assert lay.kv == (cfg.num_layers, 9, 2, 4, Kv // 2, hd)
    assert [(sl.start, sl.stop) for sl in lay.lanes] == [(0, 1), (1, 2)]
    for c in range(2):
        for pg, sc in srv._shard_pools(c):
            assert pg.is_contiguous() and tuple(pg.shape) == lay.kv
            assert sc.is_contiguous() and tuple(sc.shape) == lay.kv_scales


def test_head_reduce_sums_in_shard_order():
    a, b, c = (torch.tensor([1e8, 1.0]), torch.tensor([-1e8, 1.0]),
               torch.tensor([1.0, 1e-8]))
    torch.testing.assert_close(S._head_reduce([a, b, c]), (a + b) + c,
                               rtol=0, atol=0)
    assert S._head_reduce([a]) is a


# ===========================================================================
# MoE: capacity per cluster
# ===========================================================================

def test_moe_cluster_steps_route_their_own_rows():
    """olmoe's smoke config at (2, 1) with capacity factor 0.25 (steps
    drop assignments): each cluster's step is exactly the port's unsharded
    step on that cluster's lanes alone (f32), and each ``moe_forward``
    call routes only that cluster's rows."""
    cfg = dataclasses.replace(get_config("olmoe-1b-7b").smoke(),
                              param_dtype="float32",
                              moe_capacity_factor=0.25)
    model = init_params(cfg, seed=0, device="cpu")
    srv = make_engine(cfg, model, EngineConfig(
        cache=CacheConfig(num_pages=16, page_size=4, max_pages_per_seq=8),
        max_lanes=2, chunk=4, use_kernel=False, clusters=2), device="cpu")
    routed, checked = [], []
    real_moe, real_step = MOE.moe_forward, srv._step

    def moe_spy(cfg_, p, h, *a, **kw):
        routed.append(h.shape[0] * h.shape[1])
        return real_moe(cfg_, p, h, *a, **kw)

    def step_spy(pools, bt, lens, n_new, feed, last_tok, use_last, *,
                 kv_scales, sampling, head_attn):
        before = [p.clone() for p in pools]
        out = real_step(pools, bt, lens, n_new, feed, last_tok, use_last,
                        kv_scales=kv_scales, sampling=sampling,
                        head_attn=head_attn)
        alone = before[0]
        want = S._paged_chunk_step(cfg, model, False, srv.pages_per_step,
                                   16, alone, bt, lens, n_new, feed,
                                   last_tok, use_last, sampling=sampling)
        for x, y in zip(out, want):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
        torch.testing.assert_close(pools[0], alone, rtol=0, atol=0)
        checked.append(bt.shape[0])
        return out

    srv._step = step_spy
    MOE.moe_forward = moe_spy
    try:
        for rid, p in enumerate(PROMPTS):
            srv.submit(GenerationRequest(rid, tuple(p),
                                         SamplingParams(max_new=4)))
        done = srv.run()
    finally:
        MOE.moe_forward = real_moe
    assert len(done) == 4 and {r.cluster for r in done} == {0, 1}
    assert checked and set(checked) == {2}
    # 2 lanes x chunk 4 rows (prefill) or x 1 (decode), never all 4
    # lanes; each step routed twice (the engine's and the check's)
    assert set(routed) == {2 * 4, 2 * 1}
    assert len(routed) == 2 * cfg.num_layers * len(checked)


# ===========================================================================
# the serving CLI
# ===========================================================================

@pytest.mark.parametrize("argv", [[], ["--spec-k", "3", "--requests", "5"],
                                  ["--temperature", "0.8", "--top-p", "0.9",
                                   "--seed", "7", "--kernel"]],
                         ids=["greedy", "spec", "sampled"])
def test_serve_cli_prints_what_the_reference_prints(argv, capsys,
                                                    monkeypatch):
    """``python -m repro_torch.launch.serve`` against
    ``python -m repro.launch.serve``: the same lines, requests, finish
    reasons, RAB statistics, speculation counters and trace counts (the
    tokens differ: each package draws its own random weights)."""
    import re
    import sys
    from repro.launch import serve as j_serve
    from repro_torch.launch import serve

    serve.main(argv + ["--device", "cpu"])
    ours = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    j_serve.main()
    ref = capsys.readouterr().out.splitlines()

    def shape(lines):
        return [re.sub(r"-> \[[0-9, ]*\]", "-> [...]", ln) for ln in lines]
    assert len(ours) == len(ref)
    n = sum(ln.startswith("req ") for ln in ref)
    assert shape(ours[:n]) == shape(ref[:n])
    assert all(ln.endswith("[length]") for ln in ours[:n])
    if "--spec-k" in argv:
        # drafts follow each side's tokens: so do the RAB's traffic, the
        # counters and the trace
        assert ours[n + 1].startswith("spec: proposed=")
    else:
        assert ours[n:] == ref[n:]
