"""The port's hierarchical prefix cache against the reference's, after
the unsharded cases of ``tests/test_hierarchical_cache.py``: device ->
host -> disk spill with promotion on the engine clock, promotion racing
preemption and cancellation, faults during promotion, the store-level
contract of ``HostBackingStore`` and ``DiskTier``, ``cache_stats()`` and
the traced tier moves.

Each engine case serves one seeded workload on the JAX engine and on the
port (CPU, float32 weights carried over by ``params_from_jax``), and the
two must agree exactly: tokens, finish reasons, counters,
``cache_stats()``, the virtual clock and every traced host row.  One more
case holds the port's demoted payloads against the reference's, and
shows that a drain moved after the device step would capture a page the
step had already overwritten.
"""
import copy
import dataclasses
import os
import zlib

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.analysis import (
    assert_tier_conservation as j_assert_tier_conservation,
    layer1_decode as j_layer1_decode,
    layer2_tier_residency as j_layer2_tier_residency,
)
from repro.core.offload import DiskTier as JDiskTier
from repro.core.offload import HostBackingStore as JHostBackingStore
from repro.core.tracing import TraceBuffer as JTraceBuffer
from repro.models import model as JM
from repro.runtime import (
    CacheConfig as JCacheConfig, EngineConfig as JEngineConfig,
    FaultInjector as JFaultInjector, FaultSpec as JFaultSpec,
    GenerationRequest as JRequest, SamplingParams as JSampling,
    VirtualClock as JVirtualClock, make_engine as j_make_engine,
)
from repro_torch.configs import get_config
from repro_torch.core import DiskTier
from repro_torch.core.analysis import (
    assert_tier_conservation, layer1_decode, layer2_tier_residency,
)
from repro_torch.core.offload import BackingStoreError, HostBackingStore
from repro_torch.core.tracing import TraceBuffer
from repro_torch.models.model import params_from_jax
from repro_torch.runtime import (
    CacheConfig, CacheStats, EngineConfig, FaultInjector, FaultSpec,
    GenerationRequest, SamplingParams, VirtualClock, make_engine,
)


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(j_get_config("yi-6b").smoke(),
                               param_dtype="float32")
    tcfg = dataclasses.replace(get_config("yi-6b").smoke(),
                               param_dtype="float32")
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(tcfg, jax.tree.map(np.asarray, params),
                            device="cpu")
    return jcfg, params, tcfg, model


#: the two packages' names, side by side
PORT = dict(make=make_engine, EC=EngineConfig, CC=CacheConfig,
            R=GenerationRequest, SP=SamplingParams, Clock=VirtualClock,
            Trace=TraceBuffer, Inj=FaultInjector, Spec=FaultSpec,
            decode=layer1_decode, residency=layer2_tier_residency,
            conserved=assert_tier_conservation, device=dict(device="cpu"),
            use_kernel=False)
#: the port on the card (its engine always takes the kernel there)
CUDA = dict(PORT, device=dict(device="cuda"), use_kernel=True)
REF = dict(make=j_make_engine, EC=JEngineConfig, CC=JCacheConfig,
           R=JRequest, SP=JSampling, Clock=JVirtualClock,
           Trace=JTraceBuffer, Inj=JFaultInjector, Spec=JFaultSpec,
           decode=j_layer1_decode, residency=j_layer2_tier_residency,
           conserved=j_assert_tier_conservation, device={},
           use_kernel=False)


def _tenant_prompts(tenants=6, reps=2):
    """Each tenant owns a 16-token (4 pages @ ps=4) system prompt; every
    visit appends a unique 2-token tail.  24 pages of prefix corpus vs
    the 12-page device pool."""
    systems = {t: [t * 7 + 1, t + 2, t + 3, t + 4] * 4
               for t in range(tenants)}
    return [systems[t] + [90 + rep, 95 + rep]
            for rep in range(reps) for t in range(tenants)]


def _cache(side, **kw):
    base = dict(num_pages=12, page_size=4, max_pages_per_seq=8)
    base.update(kw)
    return side["CC"](**base)


def _serve(side, pair, prompts, cache_kw, *, virtual=True, faults=None,
           swap_retries=2, preempt_rid=None, cancel_rid=None, hook=None):
    """Serve ``prompts`` (3 new tokens each) on one side; ``faults``:
    the injector's keyword arguments, with plan values as (kind, op,
    persistent) tuples.  Returns everything the sides must agree on."""
    jcfg, params, tcfg, model = pair
    cfg, weights = (jcfg, params) if side is REF else (tcfg, model)
    clock = side["Clock"]() if virtual else None
    tracer = side["Trace"](capacity=1 << 14)
    inj = None
    if faults is not None:
        kw = dict(faults)
        if "plan" in kw:
            kw["plan"] = {i: side["Spec"](k, op=o, persistent=p)
                          for i, (k, o, p) in kw["plan"].items()}
        if "kinds" in kw:
            kw["kinds"] = tuple(side["Spec"](k, persistent=p)
                                for k, p in kw["kinds"])
        inj = side["Inj"](**kw)
    srv = side["make"](cfg, weights, side["EC"](
        cache=_cache(side, **cache_kw), max_lanes=2, chunk=8,
        use_kernel=side["use_kernel"], clock=clock, fault_injector=inj,
        swap_retries=swap_retries, retry_backoff_s=0.0), tracer=tracer,
        **side["device"])
    if hook is not None:
        hook(srv)
    try:
        for rid, p in enumerate(prompts):
            srv.submit(side["R"](rid, tuple(p), side["SP"](max_new=3)))
        if preempt_rid is not None or cancel_rid is not None:
            srv.step()                      # the target reaches a lane
            if preempt_rid is not None:
                srv.preempt(preempt_rid)
            if cancel_rid is not None:
                srv.cancel(cancel_rid)
        done = srv.run()
        srv.pool.check_invariants()
        srv.backing.check_invariants()
        rows = tracer.drain()
        events = side["decode"](rows)
        return dict(
            out={r.rid: list(r.tokens) for r in done},
            reasons={r.rid: r.finish_reason for r in done},
            stats=dataclasses.asdict(srv.cache_stats()),
            counters=(srv.iterations, srv.h2d_events, srv.d2h_events,
                      srv.preemptions, srv.fault_retries,
                      srv.recovered_faults, srv.errors),
            faults=None if inj is None else inj.report(),
            clock=None if clock is None else clock.now(),
            rows=rows.tolist(),
            residency=side["residency"](events),
            conserved=side["conserved"](events))
    finally:
        srv.close()


def _both(pair, prompts, cache_kw, **kw):
    ref = _serve(REF, pair, prompts, cache_kw, **kw)
    port = _serve(PORT, pair, prompts, cache_kw, **kw)
    assert port == ref
    return port


@pytest.fixture(scope="module")
def device_only(pair):
    """The device-only run every tiered run's tokens are held to."""
    return _both(pair, _tenant_prompts(), {}, virtual=False)


# ------------------------------------------------------- tiered hits --

@pytest.mark.parametrize("cache_kw,tier", [
    (dict(host_tier_pages=64), "host"),
    (dict(host_tier_pages=4, disk_tier_pages=64, prefetch_depth=2), "disk"),
])
def test_prefix_hit_on_tier(pair, device_only, cache_kw, tier):
    got = _both(pair, _tenant_prompts(), cache_kw)
    st = got["stats"]
    assert got["out"] == device_only["out"], f"{tier} restore changed tokens"
    assert st[f"hits_{tier}_pages"] > 0
    assert st["demoted_pages"] > 0 and st["promoted_pages"] > 0
    assert st["bytes_demoted"] > 0 and st["bytes_promoted"] > 0
    # the tiers bought hits the device-only engine had to re-prefill
    assert st["miss_pages"] < device_only["stats"]["miss_pages"]
    assert got["conserved"]


def test_virtual_clock_promotion_replays_identically(pair):
    cache_kw = dict(host_tier_pages=8, disk_tier_pages=64,
                    prefetch_depth=2, promote_latency_s=0.5)
    a = _serve(PORT, pair, _tenant_prompts(), cache_kw)
    b = _both(pair, _tenant_prompts(), cache_kw)
    assert a == b, "same-seed tiered runs diverged"
    assert a["stats"]["promoted_pages"] > 0


def test_promotion_latency_is_virtual_time(pair, device_only):
    """A large modeled promotion latency costs virtual seconds, not wall
    seconds, and does not change tokens."""
    got = _both(pair, _tenant_prompts(),
                dict(host_tier_pages=64, promote_latency_s=10.0))
    assert got["out"] == device_only["out"]
    assert got["stats"]["promoted_pages"] > 0
    assert got["clock"] >= 10.0, "promotion latency never bound the clock"


# ------------------------------------------- races with lane removal --

@pytest.mark.parametrize("race", ["preempt", "cancel"])
def test_promotion_races_lane_removal(pair, device_only, race):
    """Preempting a lane that may be mid-promotion force-lands its
    in-flight pages before the D2H sweep; cancelling one closes its
    books.  Survivors' tokens are unchanged."""
    kw = dict(preempt_rid=0) if race == "preempt" else dict(cancel_rid=1)
    got = _both(pair, _tenant_prompts(),
                dict(host_tier_pages=64, promote_latency_s=1.0), **kw)
    want = dict(device_only["out"])
    out = dict(got["out"])
    if race == "cancel":
        assert got["reasons"][1] == "aborted"
        del want[1], out[1]
    else:
        assert got["stats"]["promoted_pages"] > 0
    assert out == want, f"{race} during promotion changed tokens"


# -------------------------------------------- faults during promotion --

@pytest.mark.parametrize("faults,retries", [
    # a transient planted pop fault: retried, the tier hit still lands
    (dict(plan={0: ("io", "pop", False)}), 3),
    # a persistent one: the entry is dropped everywhere, the request
    # re-plans
    (dict(plan={0: ("io", "pop", True)}), 2),
    # every fetch faults persistently: the tiers degrade to misses
    (dict(seed=3, rate=1.0, kinds=(("io", True),)), 2),
])
def test_faults_during_promotion(pair, device_only, faults, retries):
    got = _both(pair, _tenant_prompts(), dict(host_tier_pages=64),
                faults=faults, swap_retries=retries)
    st = got["stats"]
    assert got["out"] == device_only["out"]
    assert got["faults"]["injected"] >= 1, "planted fault never fired"
    if "rate" in faults:
        assert st["hits_host_pages"] == 0 and st["hits_disk_pages"] == 0
    elif faults["plan"][0][2]:
        assert st["dropped_entries"] >= 1
    else:
        assert st["hits_host_pages"] > 0, "retry did not recover the hit"
        assert got["counters"][5] >= 1          # recovered_faults


# ----------------------------------------------------- late drain --

def _record_parks(srv, parked):
    real = srv.backing.park_cache

    def park(eid, payload):
        parked.setdefault(eid, np.array(payload, copy=True))
        real(eid, payload)
    srv.backing.park_cache = park


def _late_drain(srv):
    """A mutation of the engine: every tier drain waits until the step's
    device work has been enqueued (and, on the CPU, done)."""
    real_drain, real_step = srv._drain_tier_ops, srv.step
    srv._drain_tier_ops = lambda: None

    def step():
        busy = real_step()
        real_drain()
        return busy
    srv.step = step


def test_demoted_payloads_are_pulled_before_reuse(pair):
    """The payload a demotion parks is the page as its owner wrote it:
    the port parks, for every entry, what the reference parks (float32
    K/V of the two frameworks agree to a few ulps).  The same check
    catches a drain moved after the step: the evicted page is by then
    overwritten by the step that reused it."""
    prompts = _tenant_prompts()
    cache_kw = dict(host_tier_pages=64)
    ref_parks, port_parks, late_parks = {}, {}, {}
    _serve(REF, pair, prompts, cache_kw,
           hook=lambda s: _record_parks(s, ref_parks))
    _serve(PORT, pair, prompts, cache_kw,
           hook=lambda s: _record_parks(s, port_parks))
    assert ref_parks and sorted(port_parks) == sorted(ref_parks)
    for eid, want in ref_parks.items():
        np.testing.assert_allclose(port_parks[eid], want, rtol=1e-5,
                                   atol=1e-5, err_msg=f"entry {eid}")

    def late(srv):
        _record_parks(srv, late_parks)
        _late_drain(srv)
    _serve(PORT, pair, prompts, cache_kw, hook=late)
    stale = [eid for eid, want in ref_parks.items()
             if eid in late_parks and not np.allclose(
                 late_parks[eid], want, rtol=1e-5, atol=1e-5)]
    assert stale, "a late drain went unnoticed"


@pytest.mark.cuda
def test_demoted_payloads_are_pulled_before_reuse_on_the_card(pair):
    """On the card a demoted page's pull is ordered behind every kernel
    enqueued before it: the CUDA engine (kernel) parks what the CPU
    engine parks and serves the same tokens, counters and rows, and a
    drain moved after the step is caught there too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine: "
                    "pytest -m cuda tests/test_torch_hierarchical_cache.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    jcfg, params, tcfg, model = pair
    card = (jcfg, params, tcfg, copy.deepcopy(model).to("cuda"))
    prompts = _tenant_prompts()
    cache_kw = dict(host_tier_pages=4, disk_tier_pages=64)
    cpu_parks, card_parks, late_parks = {}, {}, {}
    want = _serve(PORT, pair, prompts, cache_kw,
                  hook=lambda s: _record_parks(s, cpu_parks))
    got = _serve(CUDA, card, prompts, cache_kw,
                 hook=lambda s: _record_parks(s, card_parks))
    assert got == want
    assert sorted(card_parks) == sorted(cpu_parks)
    for eid, arr in cpu_parks.items():
        np.testing.assert_allclose(card_parks[eid], arr, rtol=1e-5,
                                   atol=1e-5, err_msg=f"entry {eid}")

    def late(srv):
        _record_parks(srv, late_parks)
        _late_drain(srv)
    _serve(CUDA, card, prompts, cache_kw, hook=late)
    assert any(eid in late_parks and not np.allclose(
        late_parks[eid], arr, rtol=1e-5, atol=1e-5)
        for eid, arr in cpu_parks.items()), "a late drain went unnoticed"


# ----------------------------------------------- store-level contract --

@pytest.mark.parametrize("Store,Disk", [
    (HostBackingStore, DiskTier), (JHostBackingStore, JDiskTier)])
def test_discard_sweeps_all_tiers(Store, Disk):
    store = Store(host_pages=1, disk_tier=Disk(8))
    try:
        page = np.arange(8, dtype=np.float32).reshape(2, 4)
        for lpage in range(3):              # cascade pushes 2 to disk
            store.put(5, lpage, page + lpage)
        assert len(store) == 3
        assert sum(store.cache_resident().values()) == 0
        store.discard(5)
        assert len(store) == 0
        store.check_invariants()
        for lpage in range(3):
            with pytest.raises(Exception) as ei:
                store.pop(5, lpage)
            assert type(ei.value).__name__ == "BackingStoreError"
    finally:
        store.close()


def _cascade(Store, Disk):
    store = Store(host_pages=1, disk_tier=Disk(8))
    try:
        pages = [np.full((2, 4), i, dtype=np.float32) for i in range(3)]
        for i, p in enumerate(pages):
            store.park_cache(i, p)
        resident = store.cache_resident()
        first = store.fetch_cache(0, rid=7)
        last = store.fetch_cache(2, rid=7)
        store.check_invariants()
        return (resident, first[1], last[1], store.drain_cache_moves(),
                store.cache_bytes_demoted, store.cache_bytes_promoted,
                dict(store.cache_hits), first[0].tolist(), last[0].tolist())
    finally:
        store.close()


def test_cache_entry_survives_cascade_and_restores():
    got = _cascade(HostBackingStore, DiskTier)
    assert got == _cascade(JHostBackingStore, JDiskTier)
    resident, tier0, tier2 = got[:3]
    assert resident["disk"] == 2            # the two oldest cascaded
    assert (tier0, tier2) == ("disk", "host")


def _payloads():
    """A bfloat16 page as the reference holds it (ml_dtypes) and as the
    port parks it (its int16 bit pattern), and an int8 page's packed blob
    of bytes and float32 scales (the same on both sides)."""
    rng = np.random.default_rng(0)
    bf16 = rng.standard_normal((2, 2, 4, 2, 16)).astype(np.float32) \
        .astype(ml_dtypes.bfloat16)
    pages = rng.integers(-127, 128, (2, 2, 4, 2, 16)).astype(np.int8)
    scales = rng.random((2, 2, 2)).astype(np.float32)
    blob = np.concatenate([pages.view(np.uint8).reshape(-1),
                           scales.view(np.uint8).reshape(-1)])
    return (bf16, bf16.view(np.int16)), (blob, blob)


@pytest.mark.parametrize("kind", [0, 1], ids=["bf16_as_int16", "int8_blob"])
def test_disk_tier_round_trips_bits(kind):
    """Raw-byte files with a dtype/shape sidecar: the port's int16 bit
    patterns and packed uint8 blobs come back exactly, and a store whose
    disk tier held them counts the bytes and checksums the reference's
    store counts for the same bits."""
    ref_arr, arr = _payloads()[kind]
    tier = DiskTier(4)
    try:
        tier.store(("cache", 1), arr)
        back = tier.load(("cache", 1))
        assert back.dtype == arr.dtype and back.shape == arr.shape
        assert back.tobytes() == arr.tobytes()
    finally:
        tier.close()
    seen = []
    for Store, Disk, a in ((HostBackingStore, DiskTier, arr),
                           (JHostBackingStore, JDiskTier, ref_arr)):
        store = Store(host_pages=1, disk_tier=Disk(4))
        try:
            store.park_cache(0, a)
            store.park_cache(1, a[::-1].copy())   # pushes entry 0 to disk
            assert store.cache_tier(0) == "disk"
            crcs = dict(store._sums)
            out, tier_name = store.fetch_cache(0, rid=3)
            assert out.tobytes() == a.tobytes()
            seen.append((tier_name, store.cache_bytes_demoted,
                         store.cache_bytes_promoted, sorted(crcs.items())))
        finally:
            store.close()
    assert seen[0] == seen[1]
    assert seen[0][3][0][1] == zlib.crc32(ref_arr.tobytes())


def test_disk_tier_owned_dir_removed_on_close(tmp_path):
    tier = DiskTier(4)
    tier.store(("cache", 1), np.zeros(4, dtype=np.float32))
    owned = tier._ensure_dir()
    assert os.path.isdir(owned)
    tier.close()
    assert not os.path.exists(owned)

    kept = tmp_path / "disk"
    kept.mkdir()
    tier = DiskTier(4, str(kept))
    tier.store(("cache", 2), np.zeros(4, dtype=np.float32))
    assert len(list(kept.iterdir())) == 1
    tier.close()
    assert kept.is_dir(), "caller-provided directory must be left alone"
    assert len(list(kept.iterdir())) == 0, "parked files must be removed"


def test_engine_disk_dir_and_close(pair, tmp_path):
    """An engine with a caller's ``disk_dir`` spills files there while it
    serves, and ``close()`` removes them but not the directory."""
    spill = tmp_path / "spill"
    files = []
    _serve(PORT, pair, _tenant_prompts(),
           dict(host_tier_pages=2, disk_tier_pages=64, disk_dir=str(spill)),
           hook=lambda srv: files.append(srv.backing.tiers[1]))
    assert spill.is_dir() and not list(spill.iterdir())
    assert files[0]._serial > 0, "nothing reached the disk tier"


def test_backing_store_error_is_the_ports():
    with pytest.raises(BackingStoreError):
        HostBackingStore().fetch_cache(1, rid=2)


# ----------------------------------------------------- cache_stats() --

def test_cache_stats_shape_and_sanity(pair):
    _, _, tcfg, model = pair
    srv = make_engine(tcfg, model, EngineConfig(
        cache=_cache(PORT, host_tier_pages=16), max_lanes=2, chunk=8,
        use_kernel=False, clock=VirtualClock()), device="cpu")
    try:
        st0 = srv.cache_stats()
        assert isinstance(st0, CacheStats)
        assert st0.device_pages == 12
        assert st0.host_pages == 0          # residency, not capacity
        assert st0.promotions_in_flight == 0
        with pytest.raises(dataclasses.FrozenInstanceError):
            st0.device_pages = 1
    finally:
        srv.close()
    got = _both(pair, _tenant_prompts(tenants=3), dict(host_tier_pages=16))
    st = got["stats"]
    assert st["prefix_hit_tokens"] > 0
    assert st["device_indexed"] <= st["device_pages"]
    assert st["device_cached_free"] <= st["device_pages"]
    assert st["promotions_in_flight"] == 0    # all landed by drain


# ----------------------------------------------------------- tracing --

def test_tier_moves_traced_and_conserved(pair):
    got = _both(pair, _tenant_prompts(),
                dict(host_tier_pages=8, disk_tier_pages=64,
                     prefetch_depth=2))
    moves = got["residency"]["moves"]
    assert moves.get("device->host", 0) > 0, "no demotions traced"
    assert moves.get("host->disk", 0) > 0, "no cascade traced"
    assert sum(n for m, n in moves.items() if m.endswith("->device")) > 0
    assert got["conserved"]
