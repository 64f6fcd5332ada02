"""The port's capacity planner and load generator against the reference's,
after ``tests/test_planner.py``: ``WorkloadSpec`` draws, the
discrete-event ``simulate`` on the same arrivals and engine spec, trace
calibration, ``plan_capacity``, and the load generator's report.  The
port's CPU engine served through the front door on a ``VirtualClock``
must equal ``simulate`` exactly, as the reference's does; the planner
reads no wall clock and the port keeps no TPU constant.
"""
import contextlib
import dataclasses
import importlib.util
import inspect
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.core.analysis import layer1_decode as j_layer1_decode
from repro.core.tracing import TraceBuffer as JTraceBuffer
from repro.models import model as JM
from repro import planner as JP
from repro.runtime import (
    Arrival as JArrival, CacheConfig as JCacheConfig,
    EngineConfig as JEngineConfig, FrontDoor as JFrontDoor,
    GenerationRequest as JRequest, SamplingParams as JSampling,
    TokenBudgetPolicy as JTokenBudgetPolicy, VirtualClock as JVirtualClock,
    make_engine as j_make_engine,
)
from repro_torch import planner as P
from repro_torch.configs import get_config
from repro_torch.core.analysis import layer1_decode
from repro_torch.core.tracing import TraceBuffer
from repro_torch.launch import load_gen, mesh
from repro_torch.models.model import init_params, params_from_jax
from repro_torch.runtime import (
    Arrival, CacheConfig, EngineConfig, FrontDoor, GenerationRequest,
    SamplingParams, TokenBudgetPolicy, VirtualClock, make_engine,
)

ROOT = Path(__file__).resolve().parent.parent


def _spec(M, **over):
    base = dict(rate_rps=50.0, requests=8, prompt_min=4, prompt_max=10,
                output_min=2, output_max=4, seed=0)
    base.update(over)
    return M.WorkloadSpec(**base)


def _engine_for(arrivals, *, EC, CC, Budget, page_size=4, max_lanes=2,
                chunk=4, token_budget=None, clusters=1, kv_dtype="bf16",
                spec_k=0, **cache_kw):
    longest = max(len(a.prompt) + a.max_new for a in arrivals)
    per_seq = -(-longest // page_size) + 1
    policy = Budget(token_budget) if token_budget else None
    return EC(
        cache=CC(num_pages=per_seq * max_lanes + 8, page_size=page_size,
                 max_pages_per_seq=per_seq, kv_dtype=kv_dtype, **cache_kw),
        max_lanes=max_lanes, chunk=chunk, clusters=clusters, spec_k=spec_k,
        use_kernel=False, scheduler_policy=policy)


PORT = dict(M=P, EC=EngineConfig, CC=CacheConfig, Budget=TokenBudgetPolicy)
REF = dict(M=JP, EC=JEngineConfig, CC=JCacheConfig,
           Budget=JTokenBudgetPolicy)


# ===========================================================================
# WorkloadSpec
# ===========================================================================

@pytest.mark.parametrize("over", [
    {}, dict(requests=16, seed=3), dict(prefix_share_ratio=0.5, seed=9),
    dict(prefix_share_ratio=1.0, requests=6),
    dict(rate_rps=7.5, prompt_min=1, prompt_max=1, output_min=9,
         output_max=9)])
def test_sample_arrivals_equal_reference(over):
    for vocab in (256, 64000):
        a = _spec(P, **over).sample_arrivals(vocab)
        b = _spec(JP, **over).sample_arrivals(vocab)
        assert [dataclasses.astuple(r) for r in a] == \
            [dataclasses.astuple(r) for r in b]
    spec = _spec(P, **over)
    back = P.WorkloadSpec.from_json(json.loads(json.dumps(spec.to_json())))
    assert back == spec and spec.to_json() == _spec(JP, **over).to_json()


@pytest.mark.parametrize("over", [
    {"rate_rps": 0.0}, {"requests": 0}, {"prompt_min": 0},
    {"prompt_min": 12, "prompt_max": 4}, {"output_min": 0},
    {"prefix_share_ratio": 1.5}, {"spec_acceptance_rate": -0.1},
])
def test_validation_rejects(over):
    with pytest.raises(ValueError):
        _spec(P, **over)
    d = _spec(P).to_json()
    d["surprise"] = 1
    with pytest.raises(ValueError, match="unknown WorkloadSpec"):
        P.WorkloadSpec.from_json(d)


# ===========================================================================
# simulate against the reference's
# ===========================================================================

SIM_CASES = {
    "budget": dict(spec=dict(requests=6, seed=3),
                   engine=dict(token_budget=6)),
    "clusters": dict(spec=dict(requests=6, seed=5),
                     engine=dict(clusters=2)),
    "prefix": dict(spec=dict(requests=12, prefix_share_ratio=0.7, seed=1,
                             prompt_min=8, prompt_max=14),
                   engine=dict(max_lanes=2, chunk=8)),
    "tiers": dict(spec=dict(requests=12, prefix_share_ratio=0.7, seed=2,
                            prompt_min=8, prompt_max=14, rate_rps=200.0),
                  engine=dict(max_lanes=2, chunk=8, host_tier_pages=4,
                              disk_tier_pages=8, promote_latency_s=0.02)),
    "spec": dict(spec=dict(requests=4, seed=4, output_min=10,
                           output_max=12),
                 engine=dict(spec_k=4), acceptance=0.8),
    "int8": dict(spec=dict(requests=8, seed=6),
                 engine=dict(kv_dtype="int8", chunk=8, max_lanes=4)),
}


def _simulate(side, case, cost):
    c = SIM_CASES[case]
    M = side["M"]
    arrivals = _spec(M, **c["spec"]).sample_arrivals(256)
    engine = _engine_for(arrivals, EC=side["EC"], CC=side["CC"],
                         Budget=side["Budget"], **c["engine"])
    return M.simulate(arrivals, engine, iteration_cost=cost(side, engine),
                      spec_acceptance=c.get("acceptance", 0.0))


def _fixed(side, engine):
    return side["M"].FixedIterationCost(0.01)


def _analytic(side, engine):
    # the same peaks on both sides: the reference's defaults are a TPU's
    return side["M"].AnalyticCostModel.for_engine(
        get_config("yi-6b").smoke() if side is PORT
        else j_get_config("yi-6b").smoke(), engine,
        peak_flops=mesh.PEAK_FLOPS_BF16, hbm_bw=mesh.HBM_BW)


@pytest.mark.parametrize("case", sorted(SIM_CASES))
@pytest.mark.parametrize("cost", [_fixed, _analytic],
                         ids=["fixed", "analytic"])
def test_simulate_equals_reference(case, cost):
    got = _simulate(PORT, case, cost)
    assert got == _simulate(REF, case, cost)
    assert got == _simulate(PORT, case, cost)           # deterministic
    assert got["completed"] == got["requests"]


def test_analytic_cost_model_uses_the_cards_peaks():
    cfg = get_config("yi-6b").smoke()
    arr = _spec(P).sample_arrivals(256)
    eng = _engine_for(arr, EC=EngineConfig, CC=CacheConfig,
                      Budget=TokenBudgetPolicy)
    cost = P.AnalyticCostModel.for_engine(cfg, eng)
    assert (cost.peak_flops, cost.hbm_bw) == (mesh.PEAK_FLOPS_BF16,
                                              mesh.HBM_BW)
    st = P.IterationStats(prefill_tokens=64, decode_lanes=1, spec_tokens=0,
                          context_tokens=10_000, active_clusters=1)
    ref = JP.AnalyticCostModel.for_engine(
        j_get_config("yi-6b").smoke(),
        _engine_for(arr, EC=JEngineConfig, CC=JCacheConfig,
                    Budget=JTokenBudgetPolicy),
        peak_flops=mesh.PEAK_FLOPS_BF16, hbm_bw=mesh.HBM_BW)
    assert cost(st) == ref(st) > 0


def test_no_tpu_constant_in_the_port():
    """The reference's TPU v5e figures (197 TFLOP/s, 819 GB/s, 50 GB/s
    links) appear nowhere in the port."""
    src = ROOT / "src" / "repro_torch"
    banned = ("197e12", "819e9", "50e9", "v5e", "ICI_LINK_BW")
    for path in list(src.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        text = path.read_text()
        for tok in banned:
            assert tok not in text, f"{path.relative_to(ROOT)}: {tok}"


# ===========================================================================
# the port's engine equals simulate
# ===========================================================================

def _serve_load(spec_kw, engine_kw, iter_time_s=0.01):
    cfg = get_config("yi-6b").smoke()
    spec = _spec(P, **spec_kw)
    arrivals = load_gen.arrivals_from_spec(spec, cfg.vocab_size)
    rep = load_gen.run_load(
        cfg, init_params(cfg, seed=0, device="cpu"), arrivals,
        iter_time_s=iter_time_s, slo_ttft_s=0.25, slo_tpot_s=0.05,
        device="cpu", **engine_kw)
    sampled = spec.sample_arrivals(cfg.vocab_size)
    longest = max(len(a.prompt) + a.max_new for a in sampled)
    engine = load_gen.engine_config(longest, **engine_kw)
    sim = P.simulate(sampled, engine,
                     iteration_cost=P.FixedIterationCost(iter_time_s),
                     slo_ttft_s=0.25, slo_tpot_s=0.05)
    return rep, sim


@pytest.mark.parametrize("spec_kw,engine_kw", [
    (dict(requests=8), dict(page_size=4, max_lanes=2, chunk=4,
                            token_budget=6)),
    (dict(requests=12, seed=7, rate_rps=120.0, prompt_max=20),
     dict(page_size=8, max_lanes=4, chunk=8, token_budget=12)),
])
def test_engine_on_virtual_clock_equals_simulate(spec_kw, engine_kw):
    rep, sim = _serve_load(spec_kw, engine_kw)
    assert rep["iterations"] == sim["iterations"]
    assert rep["virtual_duration_s"] == sim["virtual_duration_s"]
    for k in ("requests", "completed", "ttft_p50_s", "ttft_p95_s",
              "ttft_p99_s", "tpot_p50_s", "tpot_p95_s", "tpot_p99_s",
              "slo_goodput"):
        assert rep[k] == sim[k], k


# ===========================================================================
# calibration from a recorded trace
# ===========================================================================

def _calibrate(side):
    jcfg = dataclasses.replace(j_get_config("yi-6b").smoke(),
                               param_dtype="float32")
    tcfg = dataclasses.replace(get_config("yi-6b").smoke(),
                               param_dtype="float32")
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    if side is PORT:
        cfg = tcfg
        weights = params_from_jax(tcfg, jax.tree.map(np.asarray, params),
                                  device="cpu")
        names = (make_engine, EngineConfig, CacheConfig, VirtualClock,
                 TokenBudgetPolicy, TraceBuffer, Arrival, GenerationRequest,
                 SamplingParams, FrontDoor, layer1_decode, dict(device="cpu"))
    else:
        cfg, weights = jcfg, params
        names = (j_make_engine, JEngineConfig, JCacheConfig, JVirtualClock,
                 JTokenBudgetPolicy, JTraceBuffer, JArrival, JRequest,
                 JSampling, JFrontDoor, j_layer1_decode, {})
    (make, EC, CC, Clock, Budget, Trace, Arr, Req, SP, Door, decode,
     dev) = names
    tracer = Trace(capacity=1 << 14)
    srv = make(cfg, weights, EC(
        cache=CC(num_pages=32, page_size=4, max_pages_per_seq=8),
        max_lanes=2, chunk=4, use_kernel=False, clock=Clock(),
        scheduler_policy=Budget(6)), tracer=tracer, **dev)
    arrivals = [Arr(t=r.t, request=Req(
                    rid=r.rid, prompt=list(r.prompt),
                    sampling=SP(max_new=r.max_new)))
                for r in _spec(side["M"], requests=4, seed=1)
                .sample_arrivals(cfg.vocab_size)]
    Door(srv, iter_time_s=0.01).serve(arrivals)
    events = decode(srv.tracer.drain())
    cal = side["M"].Calibration.from_trace(events, iter_time_s=0.01)
    return dataclasses.astuple(cal), srv.iterations


def test_calibration_from_trace_equals_reference():
    got = _calibrate(PORT)
    assert got == _calibrate(REF)
    assert got[0][1] >= 1                      # mean service iterations
    with pytest.raises(ValueError):
        P.Calibration(iter_time_s=-1.0)


# ===========================================================================
# plan_capacity
# ===========================================================================

@pytest.mark.parametrize("spec_kw,slo", [
    (dict(requests=12, rate_rps=60.0), (0.15, 0.03)),
    (dict(requests=12, rate_rps=120.0, seed=4), (0.08, 0.02)),
])
def test_plan_capacity_equals_reference(spec_kw, slo):
    tcfg, jcfg = get_config("yi-6b").smoke(), j_get_config("yi-6b").smoke()
    a = P.plan_capacity(_spec(P, **spec_kw), P.SLOSpec(*slo),
                        model_cfg=tcfg, max_clusters=4,
                        calibration=P.Calibration(iter_time_s=0.01))
    b = P.plan_capacity(_spec(P, **spec_kw), P.SLOSpec(*slo),
                        model_cfg=tcfg, max_clusters=4,
                        calibration=P.Calibration(iter_time_s=0.01))
    ref = JP.plan_capacity(_spec(JP, **spec_kw), JP.SLOSpec(*slo),
                           model_cfg=jcfg, max_clusters=4,
                           calibration=JP.Calibration(iter_time_s=0.01))
    assert (a.engine, a.predicted, a.cost, a.evaluated) == \
        (b.engine, b.predicted, b.cost, b.evaluated)
    assert P.SLOSpec(*slo).met_by(a.predicted)
    assert a.cost == P.config_cost(a.engine, tcfg) == ref.cost
    assert (a.predicted, a.evaluated) == (ref.predicted, ref.evaluated)
    assert dataclasses.asdict(a.engine.cache) == \
        dataclasses.asdict(ref.engine.cache)
    for k in ("max_lanes", "chunk", "clusters", "spec_k"):
        assert getattr(a.engine, k) == getattr(ref.engine, k)
    with pytest.raises(dataclasses.FrozenInstanceError):
        a.cost = 0.0


def test_plan_capacity_impossible_slo_raises():
    with pytest.raises(ValueError, match="no candidate"):
        P.plan_capacity(_spec(P), P.SLOSpec(ttft_p95_s=1e-6,
                                            tpot_p95_s=1e-6),
                        model_cfg=get_config("yi-6b").smoke(),
                        max_clusters=2,
                        calibration=P.Calibration(iter_time_s=0.01))


def test_planner_never_reads_the_wall_clock():
    import repro_torch.planner.capacity
    import repro_torch.planner.costs
    import repro_torch.planner.simulator
    import repro_torch.planner.workload
    banned = ("time.time", "perf_counter", "time.monotonic",
              "datetime", "time.sleep", "import time")
    for mod in (repro_torch.planner.capacity, repro_torch.planner.costs,
                repro_torch.planner.simulator, repro_torch.planner.workload):
        src = inspect.getsource(mod)
        for tok in banned:
            assert tok not in src, f"{mod.__name__} uses {tok}"


# ===========================================================================
# the load generator's CLI
# ===========================================================================

def test_load_gen_cli_prints_the_reference_report():
    """``python -m repro_torch.launch.load_gen --device cpu`` at smoke
    size prints exactly the report ``benchmarks/load_gen.py`` prints on
    the same seed and knobs (it depends on the schedule, not on
    numerics)."""
    argv = ["--smoke", "--selfcheck", "--seed", "3", "--rate", "80"]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    port = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.load_gen", "--device",
         "cpu", *argv], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=300)
    assert port.returncode == 0, port.stderr
    spec = importlib.util.spec_from_file_location(
        "ref_load_gen", ROOT / "benchmarks" / "load_gen.py")
    ref_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_mod)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        ref_mod.main(argv)
    assert port.stdout == out.getvalue()
    report = json.loads(port.stdout)
    assert report["replay_identical"] and report["completed"] == 8
