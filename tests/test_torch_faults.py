"""The port's fault handling against the reference's, after the unsharded
cases of ``tests/test_faults.py``: typed backing-store errors and the
checksum, ``FaultSpec`` validation, the injector's seeded decisions
(plans, persistent sites, ``max_faults``, traced codes), and the engine
under injected faults: transient faults retried, a persistent fault
demoting one request, corruption caught at swap-in, stalls, and a
timeout that releases a swapped-out request.

Store and injector cases feed both packages the same op sequence; engine
cases serve one seeded workload on the JAX engine and on the port (CPU,
float32 weights carried over by ``params_from_jax``, forced preemptions
so pages travel through the backing store).  Tokens, finish reasons and
errors, retry counters, the injector's report and every traced host row
must be equal.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.core.analysis import (
    assert_faults_contained as j_assert_faults_contained,
    layer1_decode as j_layer1_decode,
    layer2_fault_recovery as j_layer2_fault_recovery,
)
from repro.core.offload import BackingStoreError as JBackingStoreError
from repro.core.offload import HostBackingStore as JHostBackingStore
from repro.core.tracing import TraceBuffer as JTraceBuffer
from repro.models import model as JM
from repro.runtime import (
    CacheConfig as JCacheConfig, EngineConfig as JEngineConfig,
    FaultInjector as JFaultInjector, FaultSpec as JFaultSpec,
    GenerationRequest as JRequest, SamplingParams as JSampling,
    make_engine as j_make_engine,
)
from repro_torch.configs import get_config
from repro_torch.core.analysis import (
    assert_faults_contained, layer1_decode, layer2_fault_recovery,
)
from repro_torch.core.offload import BackingStoreError, HostBackingStore
from repro_torch.core.tracing import EventType, TraceBuffer
from repro_torch.models.model import params_from_jax
from repro_torch.runtime import (
    CacheConfig, EngineConfig, FaultInjector, FaultSpec, GenerationRequest,
    SamplingParams, make_engine, FINISH_ERROR, FINISH_TIMEOUT,
)

MAX_NEW = 6
NUM_PAGES = 32

#: the two packages' names, side by side
PORT = dict(make=make_engine, EC=EngineConfig, CC=CacheConfig,
            R=GenerationRequest, SP=SamplingParams, Trace=TraceBuffer,
            Inj=FaultInjector, Spec=FaultSpec, Store=HostBackingStore,
            Err=BackingStoreError, decode=layer1_decode,
            recovery=layer2_fault_recovery,
            contained=assert_faults_contained, device=dict(device="cpu"))
REF = dict(make=j_make_engine, EC=JEngineConfig, CC=JCacheConfig,
           R=JRequest, SP=JSampling, Trace=JTraceBuffer,
           Inj=JFaultInjector, Spec=JFaultSpec, Store=JHostBackingStore,
           Err=JBackingStoreError, decode=j_layer1_decode,
           recovery=j_layer2_fault_recovery,
           contained=j_assert_faults_contained, device={})


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


def _prompts(vocab, n=4, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=ln).tolist()
            for ln in rng.integers(3, 11, size=n)]


def _spec(side, kind, op="any", persistent=False, stall_s=0.0):
    return side["Spec"](kind, op=op, persistent=persistent, stall_s=stall_s)


def _injector(side, faults):
    """``faults``: the injector's keyword arguments, with specs as
    (kind, op, persistent[, stall_s]) tuples."""
    if faults is None:
        return None
    kw = dict(faults)
    if "plan" in kw:
        kw["plan"] = {i: _spec(side, *s) for i, s in kw["plan"].items()}
    if "kinds" in kw:
        kw["kinds"] = tuple(_spec(side, *s) for s in kw["kinds"])
    return side["Inj"](**kw)


def _serve(side, pair, *, faults=None, kv_dtype="bf16", preempt_at=(4,),
           deadline_iters=None, stream_preempt=None, **kw):
    """The reference test's workload: 4 prompts on 2 lanes, page 4,
    chunk 4; a running lane is preempted at the given delta counts (or,
    with ``stream_preempt``, rid 0 once, at delta 1, if it runs)."""
    jcfg, params, tcfg, model = pair
    cfg, weights = (tcfg, model) if side is PORT else (jcfg, params)
    tracer = side["Trace"](capacity=1 << 14)
    inj = _injector(side, faults)
    srv = side["make"](cfg, weights, side["EC"](
        cache=side["CC"](num_pages=NUM_PAGES, page_size=4,
                         max_pages_per_seq=8, kv_dtype=kv_dtype),
        max_lanes=2, chunk=4, use_kernel=False, fault_injector=inj, **kw),
        tracer=tracer, **side["device"])
    for rid, p in enumerate(_prompts(cfg.vocab_size)):
        srv.submit(side["R"](
            rid=rid, prompt=tuple(p), sampling=side["SP"](max_new=MAX_NEW),
            deadline_iters=deadline_iters.get(rid) if deadline_iters
            else None))
    hits = set(preempt_at)
    for i, _ in enumerate(srv.generate()):
        if stream_preempt is not None:
            if i == 1:
                run = next((r for r in srv.lanes if r is not None), None)
                if run is not None and run.rid == stream_preempt:
                    srv.preempt(stream_preempt)
        elif i in hits:
            run = [r for r in srv.lanes if r is not None and not r.done]
            if run:
                srv.preempt(run[0].rid)
    srv.pool.check_invariants()
    pristine = (srv.pool.free_pages() == NUM_PAGES and len(srv.backing) == 0)
    rows = tracer.drain()
    events = side["decode"](rows)
    rep = side["recovery"](events)
    return dict(
        results={r.rid: (list(r.tokens), r.finish_reason, r.error)
                 for r in srv.finished},
        counters=(srv.iterations, srv.h2d_events, srv.d2h_events,
                  srv.preemptions, srv.fault_retries, srv.recovered_faults,
                  srv.errors, srv.timeouts),
        faults=None if inj is None else inj.report(),
        rows=rows.tolist(), recovery=rep,
        contained=side["contained"](events), pristine=pristine,
        swapped_in=srv.pool.stats["swapped_in"])


def _both(pair, **kw):
    ref = _serve(REF, pair, **kw)
    port = _serve(PORT, pair, **kw)
    assert port == ref
    assert port["pristine"] and port["contained"]
    return port


@pytest.fixture(scope="module")
def baseline(pair):
    """Fault-free greedy outputs the survivor-parity checks compare to."""
    return {rid: r[0] for rid, r in _both(pair)["results"].items()}


# ------------------------------------------------------- typed errors --

def test_backing_store_error_message():
    got = []
    for Err in (BackingStoreError, JBackingStoreError):
        e = Err(7, 3, "pop", kind="corrupt",
                detail="checksum mismatch on restore")
        assert isinstance(e, RuntimeError) and not e.transient
        got.append((str(e), e.rid, e.lpage, e.op, e.kind))
    assert got[0] == got[1]
    assert "rid=7" in got[0][0] and "checksum mismatch" in got[0][0]


def _store_ops(side):
    """Missing pop, double put, checksum round trip and a corruption
    caught at restore, each error as (type, kind, rid, lpage, op,
    transient, text)."""
    out = []

    def err(fn):
        try:
            fn()
        except side["Err"] as e:
            out.append((e.kind, e.rid, e.lpage, e.op, e.transient, str(e)))
            return
        out.append(None)
    store = side["Store"]()
    err(lambda: store.pop(5, 2))
    page = np.zeros((2, 3), np.float32)
    store.put(1, 0, page)
    err(lambda: store.put(1, 0, page))
    store.pop(1, 0)                             # slot reusable after pop
    store.put(1, 0, page)
    page = np.arange(12, dtype=np.float32).reshape(3, 4)
    store.put(9, 1, page)
    out.append(store.pop(9, 1).tolist())
    store = side["Store"](side["Inj"](
        plan={0: _spec(side, "corrupt", "put")}))
    store.put(4, 0, np.ones((2, 2), np.float32))
    err(lambda: store.pop(4, 0))
    out.append((store.bytes_out, store.bytes_in, store.peak_pages))
    return out


def test_backing_store_errors_and_checksum():
    got = _store_ops(PORT)
    assert got == _store_ops(REF)
    missing, overwrite, _, corrupt, _ = got
    assert missing[0] == "missing" and overwrite[0] == "overwrite"
    assert corrupt[0] == "corrupt" and not corrupt[4]
    assert "checksum" in corrupt[5]


# ---------------------------------------------------------- injector --

@pytest.mark.parametrize("bad", [dict(kind="cosmic-ray"), dict(op="get")])
def test_fault_spec_validation(bad):
    for Spec in (FaultSpec, JFaultSpec):
        with pytest.raises(ValueError):
            Spec(**bad)
    for Inj in (FaultInjector, JFaultInjector):
        with pytest.raises(ValueError):
            Inj(rate=1.5)


def _decisions(side, **kw):
    """Fire 200 ops (put and pop over a few sites) through an injector;
    each op's outcome and the final report."""
    inj = _injector(side, kw)
    fired = []
    for i in range(200):
        op = "put" if i % 3 else "pop"
        try:
            spec = inj.before(op, i % 5, i % 3)
            fired.append(None if spec is None else spec.kind)
        except side["Err"] as e:
            fired.append((e.kind, e.transient))
    return fired, inj.report()


@pytest.mark.parametrize("kw", [
    dict(seed=11, rate=0.3),
    dict(seed=12, rate=0.3),
    dict(seed=5, rate=0.5, kinds=(("io", "any", False),
                                  ("corrupt", "put", False),
                                  ("io", "pop", True))),
    dict(rate=1.0, max_faults=2),
    dict(plan={2: ("io", "any", True), 7: ("corrupt", "any", False)}),
], ids=["seed11", "seed12", "kinds", "max_faults", "plan"])
def test_injector_decisions_equal_reference(kw):
    got = _decisions(PORT, **kw)
    assert got == _decisions(REF, **kw)
    assert got == _decisions(PORT, **kw)        # deterministic
    assert any(f is not None for f in got[0])
    if "max_faults" in kw:
        assert got[1]["injected"] == 2


def test_injector_plan_and_persistent_site():
    inj = FaultInjector(plan={2: FaultSpec("io", persistent=True)})
    inj.before("put", 1, 0)
    inj.before("put", 1, 1)
    with pytest.raises(BackingStoreError) as ei:
        inj.before("put", 7, 4)         # op index 2: the planted fault
    assert not ei.value.transient
    for _ in range(3):                  # the site keeps failing on retry
        with pytest.raises(BackingStoreError):
            inj.before("put", 7, 4)
    inj.before("put", 7, 5)             # a different site is clean
    assert inj.report()["persistent_sites"] == 1


def test_injector_traces_fault_events():
    rows = []
    for side in (PORT, REF):
        tracer = side["Trace"]()
        inj = side["Inj"](plan={0: _spec(side, "io", persistent=True),
                                1: _spec(side, "corrupt", "put")},
                          tracer=tracer)
        with pytest.raises(side["Err"]):
            inj.before("put", 3, 0)
        assert inj.before("put", 4, 1).kind == "corrupt"
        rows.append(tracer.drain().tolist())
    assert rows[0] == rows[1]
    codes = [(e.a0, e.a1) for e in layer1_decode(np.asarray(rows[0]))
             if e.etype == EventType.FAULT_INJECT]
    assert codes == [(3, 1 + 8), (4, 2)]


# ----------------------------------------------------------- engine --

@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_transient_faults_recovered_by_retry(pair, baseline, kv_dtype):
    got = _both(pair, faults=dict(seed=2, rate=0.5,
                                  kinds=(("io", "any", False),)),
                kv_dtype=kv_dtype, preempt_at=(2, 6), swap_retries=6)
    res = got["results"]
    assert len(res) == 4 and all(r[1] == "length" for r in res.values())
    assert got["faults"]["injected"] > 0 and got["counters"][4] > 0
    assert got["counters"][5] > 0 and got["counters"][6] == 0
    if kv_dtype == "bf16":
        assert {rid: r[0] for rid, r in res.items()} == baseline, \
            "transient fault storm changed survivor outputs"
    assert got["recovery"]["faults"] == got["faults"]["injected"]
    assert all(v["finished"] for v in got["recovery"]["requests"].values())


def test_persistent_fault_demotes_one_request(pair, baseline):
    got = _both(pair, faults=dict(plan={i: ("io", "pop", True)
                                        for i in range(64)}),
                swap_retries=2)
    res = got["results"]
    errs = [r for r in res.values() if r[1] == FINISH_ERROR]
    assert len(res) == 4 and len(errs) == 1 and got["counters"][6] == 1
    assert "injected I/O fault" in errs[0][2]
    survivors = {rid: r[0] for rid, r in res.items() if r[1] == "length"}
    assert len(survivors) == 3
    assert all(t == baseline[rid] for rid, t in survivors.items())
    assert got["recovery"]["persistent_faults"] > 0


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_corruption_detected_at_swap_in(pair, kv_dtype):
    """One corrupt put: on a float32 page or a packed int8 blob of bytes
    and scales, the checksum catches it at swap-in."""
    got = _both(pair, faults=dict(plan={0: ("corrupt", "put", False)}),
                kv_dtype=kv_dtype)
    errs = [r for r in got["results"].values() if r[1] == FINISH_ERROR]
    assert len(errs) == 1 and "checksum" in errs[0][2]


def test_stall_fault_slows_but_completes(pair, baseline):
    got = _both(pair, faults=dict(plan={0: ("stall", "any", False, 0.01),
                                        1: ("stall", "any", False, 0.01)}))
    res = got["results"]
    assert all(r[1] == "length" for r in res.values())
    assert {rid: r[0] for rid, r in res.items()} == baseline
    assert got["faults"]["by_kind"]["stall"] == 2


def test_timeout_releases_swapped_out_request(pair):
    """A request that times out while parked in the backing store
    releases its host payloads too (the discard path, not just pages)."""
    got = _both(pair, deadline_iters={0: 6}, stream_preempt=0)
    assert len(got["results"]) == 4
    assert got["results"][0][1] == FINISH_TIMEOUT
