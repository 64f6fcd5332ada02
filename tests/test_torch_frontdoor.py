"""The port's serving front door against the reference's, after
``tests/test_frontdoor.py``: the ``TokenBudgetPolicy`` interleave, the
``FrontDoor`` arrival loop on a ``VirtualClock``, ``latency_report`` and
the ``layer2_latency`` view of the engine's trace.  Each case runs the
port and the JAX package on the same weights (``params_from_jax``) and
the same seeded workload, and their records, reports and views must be
equal."""
import dataclasses
import json

import jax
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.core.analysis import layer1_decode as j_layer1_decode
from repro.core.analysis import layer2_latency as j_layer2_latency
from repro.core.tracing import TraceBuffer as JTraceBuffer
from repro.models import model as JM
from repro.runtime import (
    Arrival as JArrival, CacheConfig as JCacheConfig,
    EngineConfig as JEngineConfig, FrontDoor as JFrontDoor,
    GenerationRequest as JRequest, SamplingParams as JSampling,
    TokenBudgetPolicy as JTokenBudgetPolicy, VirtualClock as JVirtualClock,
    latency_report as j_latency_report, make_engine as j_make_engine,
)
from repro.runtime.frontdoor import RequestRecord as JRequestRecord
from repro_torch.configs import get_config
from repro_torch.core.analysis import layer1_decode, layer2_latency
from repro_torch.core.tracing import TraceBuffer
from repro_torch.models.model import params_from_jax
from repro_torch.runtime import (
    FINISH_LENGTH, FINISH_SHED, Arrival, CacheConfig, EngineConfig,
    FrontDoor, GenerationRequest, GreedyChunkPolicy, RequestRecord,
    SamplingParams, TokenBudgetPolicy, VirtualClock, latency_report,
    make_engine,
)

MAX_NEW = 6


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
            R=GenerationRequest, SP=SamplingParams, Arrival=Arrival,
            FrontDoor=FrontDoor, Clock=VirtualClock,
            Budget=TokenBudgetPolicy, Trace=TraceBuffer,
            report=latency_report, device=dict(device="cpu"))
REF = dict(make=j_make_engine, EC=JEngineConfig, CC=JCacheConfig,
           R=JRequest, SP=JSampling, Arrival=JArrival,
           FrontDoor=JFrontDoor, Clock=JVirtualClock,
           Budget=JTokenBudgetPolicy, Trace=JTraceBuffer,
           report=j_latency_report, device={})


def _prompts(vocab, n=2, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=ln).tolist()
            for ln in rng.integers(4, 10, size=n)]


def _engine(side, pair, budget=None, clock=True, **kw):
    jcfg, params, tcfg, model = pair
    cfg, weights = (tcfg, model) if side is PORT else (jcfg, params)
    if budget is not None:
        kw["scheduler_policy"] = side["Budget"](budget)
    if clock:
        kw["clock"] = side["Clock"]()
    if side is REF:
        kw["use_kernel"] = False
    return side["make"](cfg, weights, side["EC"](
        cache=side["CC"](num_pages=32, page_size=4, max_pages_per_seq=8),
        max_lanes=2, chunk=4, **kw),
        tracer=side["Trace"](capacity=1 << 14), **side["device"])


def _arrivals(side, prompts, gap=0.05):
    return [side["Arrival"](t=i * gap, request=side["R"](
        rid=i, prompt=tuple(p), sampling=side["SP"](max_new=MAX_NEW)))
        for i, p in enumerate(prompts)]


def _records(records) -> dict:
    return {rid: dataclasses.asdict(r) for rid, r in records.items()}


# --------------------------------------------------------------- policies --

@pytest.mark.parametrize("budget", [1, 3, 5, 16])
def test_token_budget_plans_match_reference(budget):
    rng = np.random.default_rng(budget)
    ours, ref = TokenBudgetPolicy(budget), JTokenBudgetPolicy(budget)
    for _ in range(200):
        prefill = tuple((int(lane), int(rem)) for lane, rem in zip(
            rng.permutation(8)[:rng.integers(0, 5)],
            rng.integers(1, 40, 8)))
        n_decode, chunk = int(rng.integers(0, 6)), int(rng.integers(1, 9))
        assert ours.plan(prefill, n_decode, chunk) == \
            ref.plan(prefill, n_decode, chunk)
    assert TokenBudgetPolicy(5).plan(((2, 10), (3, 7)), 3, 4) == \
        {2: 2, 3: 0}
    assert TokenBudgetPolicy(2).plan(((0, 8),), 4, 4) == {0: 0}
    assert GreedyChunkPolicy().plan(((0, 10), (1, 2)), 0, 4) == \
        {0: 4, 1: 2}


def test_token_budget_policy_rejects_empty_budget():
    with pytest.raises(ValueError):
        TokenBudgetPolicy(0)


@pytest.mark.parametrize("budget", [3, 6])
def test_token_budget_engine_matches_reference(pair, budget):
    """The budget reshapes when prompt chunks are fed, never what the
    model computes: the same tokens as the greedy interleave, and the
    reference's iterations and transfers."""
    prompts = _prompts(pair[2].vocab_size, n=3)
    out = []
    for side, b in ((PORT, budget), (REF, budget), (PORT, None)):
        srv = _engine(side, pair, budget=b, clock=False)
        for rid, p in enumerate(prompts):
            srv.submit(side["R"](rid, tuple(p),
                                 side["SP"](max_new=MAX_NEW)))
        done = srv.run()
        out.append(({r.rid: (r.tokens, r.finish_reason) for r in done},
                    srv.iterations, srv.h2d_events, srv.d2h_events))
    port, ref, greedy = out
    assert port == ref
    assert port[0] == greedy[0]
    assert all(why == FINISH_LENGTH for _, why in port[0].values())


# -------------------------------------------------------------- the door --

@pytest.mark.parametrize("budget", [None, 6])
def test_frontdoor_serves_live_arrivals_as_reference(pair, budget):
    prompts = _prompts(pair[2].vocab_size, n=4)
    recs = []
    for side in (PORT, REF):
        srv = _engine(side, pair, budget=budget)
        door = side["FrontDoor"](srv, iter_time_s=0.01)
        recs.append(_records(door.serve(_arrivals(side, prompts))))
    port, ref = recs
    assert port == ref
    for rec in port.values():
        assert rec["finish_reason"] == FINISH_LENGTH
        assert rec["tokens"] == MAX_NEW
        assert rec["arrive_t"] <= rec["submit_t"] <= rec["first_token_t"] \
            <= rec["finish_t"]
    # later arrivals were admitted mid-loop, at their due times
    assert port[3]["submit_t"] >= 3 * 0.05


def test_frontdoor_idle_gap_jumps_not_spins(pair):
    prompts = _prompts(pair[2].vocab_size, n=2)
    recs = []
    for side in (PORT, REF):
        door = side["FrontDoor"](_engine(side, pair), iter_time_s=0.01)
        recs.append(_records(door.serve(_arrivals(side, prompts, gap=50.0),
                                        max_iters=200)))
    assert recs[0] == recs[1]
    assert all(r["finish_reason"] == FINISH_LENGTH for r in recs[0].values())
    assert recs[0][1]["submit_t"] >= 50.0


def test_frontdoor_rejects_duplicate_rid(pair):
    reqs = _arrivals(PORT, _prompts(pair[2].vocab_size, n=1)) * 2
    with pytest.raises(ValueError):
        FrontDoor(_engine(PORT, pair)).serve(reqs)


def test_frontdoor_max_iters_aborts_like_reference(pair):
    prompts = _prompts(pair[2].vocab_size, n=3)
    recs = []
    for side in (PORT, REF):
        door = side["FrontDoor"](_engine(side, pair), iter_time_s=0.01)
        recs.append(_records(door.serve(_arrivals(side, prompts),
                                        max_iters=4)))
    assert recs[0] == recs[1]
    assert any(r["finish_reason"] == "aborted" for r in recs[0].values())


def test_frontdoor_replay_report_is_byte_identical(pair):
    prompts = _prompts(pair[2].vocab_size, n=4)

    def once(side):
        srv = _engine(side, pair, budget=5)
        records = side["FrontDoor"](srv, iter_time_s=0.01).serve(
            _arrivals(side, prompts))
        return json.dumps(side["report"](records, slo_ttft_s=0.25,
                                         slo_tpot_s=0.05), sort_keys=True)

    a, b = once(PORT), once(PORT)
    assert a == b == once(REF)
    rep = json.loads(a)
    assert rep["slo_goodput"] == 1.0 and rep["completed"] == 4


# -------------------------------------------------------- latency report --

def _rec(cls, rid, arrive, first, finish, tokens, reason=FINISH_LENGTH):
    return cls(rid=rid, arrive_t=arrive, submit_t=arrive,
               first_token_t=first, finish_t=finish, tokens=tokens,
               finish_reason=reason)


def test_latency_report_math():
    rows = [(0, 0.0, 0.1, 0.5, 5), (1, 0.0, 0.3, 0.3, 1),
            (2, 0.0, None, None, 0, FINISH_SHED)]
    rep = latency_report({r[0]: _rec(RequestRecord, *r) for r in rows},
                         slo_ttft_s=0.2, slo_tpot_s=0.15)
    assert rep == j_latency_report(
        {r[0]: _rec(JRequestRecord, *r) for r in rows},
        slo_ttft_s=0.2, slo_tpot_s=0.15)
    assert rep["requests"] == 3 and rep["completed"] == 2
    assert rep["slo_goodput"] == pytest.approx(1 / 3)
    assert rep["ttft_p50_s"] == pytest.approx(0.1)
    assert rep["ttft_p99_s"] == pytest.approx(0.3)
    assert rep["tpot_p99_s"] == pytest.approx(0.1)


@pytest.mark.parametrize("n", [0, 1, 7, 100])
def test_latency_report_matches_reference_on_random_records(n):
    rng = np.random.default_rng(n)
    rows = []
    for rid in range(n):
        arrive = float(rng.uniform(0, 5))
        first = arrive + float(rng.exponential(0.2))
        tokens = int(rng.integers(0, 20))
        reason = str(rng.choice(["length", "stop", "timeout", "shed"]))
        done = None if reason == "shed" else first + tokens * float(
            rng.uniform(0.01, 0.05))
        rows.append((rid, arrive, None if reason == "shed" else first, done,
                     tokens, reason))
    kw = dict(slo_ttft_s=0.2, slo_tpot_s=0.03)
    rep = latency_report({r[0]: _rec(RequestRecord, *r) for r in rows}, **kw)
    assert rep == j_latency_report(
        {r[0]: _rec(JRequestRecord, *r) for r in rows}, **kw)
    if not n:
        assert rep["requests"] == 0 and rep["slo_goodput"] == 0.0
        assert rep["ttft_p95_s"] == 0.0


# ----------------------------------------------------------- trace view --

def test_layer2_latency_stitches_lifecycle_as_reference(pair):
    prompts = _prompts(pair[2].vocab_size, n=3)
    views = []
    for side, decode, view in ((PORT, layer1_decode, layer2_latency),
                               (REF, j_layer1_decode, j_layer2_latency)):
        srv = _engine(side, pair, clock=False)
        for rid, p in enumerate(prompts):
            srv.submit(side["R"](rid, tuple(p),
                                 side["SP"](max_new=MAX_NEW)))
        done = srv.run()
        views.append((view(decode(srv.tracer.drain())),
                      {r.rid: len(r.tokens) for r in done}))
    (view, tokens), ref = views
    assert (view, tokens) == ref
    assert view["arrived"] == 3 and view["finished"] == 3
    for rid in (0, 1, 2):
        r = view["requests"][rid]
        assert r["arrive_ts"] <= r["admit_ts"] <= r["finish_ts"]
        assert r["admissions"] >= 1 and r["tokens"] == tokens[rid]
        assert r["e2e"] == r["queue_delay"] + r["service"]
