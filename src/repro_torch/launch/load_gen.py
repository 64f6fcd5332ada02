"""Seeded open-loop load generator for the serving front door (the port of
``benchmarks/load_gen.py``, with its CLI)::

    python -m repro_torch.launch.load_gen [--smoke] [--selfcheck] [--device cpu]

Builds a timed arrival schedule — Poisson arrivals (seeded exponential
interarrival gaps) with uniform prompt/output length distributions —
and replays it through :class:`repro_torch.runtime.FrontDoor` on a
:class:`repro_torch.runtime.VirtualClock`, on the CUDA device unless
``--device cpu``.  Every engine iteration costs a
fixed ``iter_time_s`` of virtual time, so the latency report
(p50/p95/p99 TTFT and TPOT, SLO goodput) is a pure function of
(seed, workload knobs, engine config): two same-seed runs must be
byte-identical, and ``--selfcheck`` asserts exactly that by running the
workload twice on fresh engines and comparing the serialized JSON.

Requests are capped by ``max_new`` only (no stop tokens), so output
lengths — and with them every virtual-time metric — depend on the
schedule, not on model numerics.  This is the load side of HERO's
split: the host owns arrival, admission and deadline policy
while the accelerator engine only ever sees per-iteration work.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.configs import get_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import init_params
from repro_torch.planner.workload import WorkloadSpec
from repro_torch.runtime import (
    Arrival, CacheConfig, EngineConfig, FrontDoor, GenerationRequest,
    SamplingParams,
    TokenBudgetPolicy, VirtualClock, latency_report, make_engine,
)


def arrivals_from_spec(spec: WorkloadSpec, vocab: int):
    """Sample ``spec``'s schedule and wrap it for the front door: one
    :class:`Arrival` per :class:`repro_torch.planner.SampledRequest`.  This is
    the bridge between the shared workload schema and the engine — the
    planner's simulator consumes the *same* sampled schedule, so a
    prediction and this generator's measurement describe identical
    traffic."""
    return [Arrival(t=r.t, request=GenerationRequest(
                rid=r.rid, prompt=r.prompt,
                sampling=SamplingParams(max_new=r.max_new)))
            for r in spec.sample_arrivals(vocab)]


def make_arrivals(*, rate_rps: float, requests: int, prompt_min: int,
                  prompt_max: int, output_min: int, output_max: int,
                  vocab: int, seed: int = 0):
    """Seeded arrival schedule: Poisson arrivals at ``rate_rps``, prompt
    lengths uniform in [prompt_min, prompt_max], output budgets uniform
    in [output_min, output_max].  Deterministic for a given seed.

    Delegates to :class:`repro_torch.planner.WorkloadSpec` — the draw order is
    that class's contract now, and historical seeds produce bit-identical
    schedules."""
    spec = WorkloadSpec(
        rate_rps=rate_rps, requests=requests, prompt_min=prompt_min,
        prompt_max=prompt_max, output_min=output_min,
        output_max=output_max, seed=seed)
    return arrivals_from_spec(spec, vocab)


def engine_config(longest: int, *, page_size: int, max_lanes: int,
                  chunk: int, token_budget: int, use_kernel: bool = False,
                  clock=None) -> EngineConfig:
    """The engine spec :func:`run_load` serves with, sized to admit a
    request of ``longest`` tokens (prompt + budget) on every lane; the
    planner's ``simulate`` takes the same spec."""
    per_seq = -(-longest // page_size) + 1
    return EngineConfig(
        cache=CacheConfig(num_pages=per_seq * max_lanes + 8,
                          page_size=page_size,
                          max_pages_per_seq=per_seq),
        max_lanes=max_lanes, chunk=chunk,
        use_kernel=use_kernel, clock=clock,
        scheduler_policy=TokenBudgetPolicy(token_budget))


def run_load(cfg, params, arrivals, *, page_size: int, max_lanes: int,
             chunk: int, token_budget: int, iter_time_s: float,
             slo_ttft_s: float, slo_tpot_s: float,
             use_kernel: bool = False, device: DeviceLike = None) -> dict:
    """One fresh engine + virtual clock + front door over ``arrivals`` on
    ``device`` (the model's); returns the :func:`latency_report`
    summary.  On the CUDA device the engine always takes the kernel."""
    dev = resolve_device(device)
    use_kernel = use_kernel or dev.type == "cuda"
    longest = max(len(a.request.prompt) + a.request.sampling.max_new
                  for a in arrivals)
    engine_cfg = engine_config(longest, page_size=page_size,
                               max_lanes=max_lanes, chunk=chunk,
                               token_budget=token_budget,
                               use_kernel=use_kernel, clock=VirtualClock())
    engine = make_engine(cfg, params, engine_cfg, device=dev)
    door = FrontDoor(engine, iter_time_s=iter_time_s)
    records = door.serve(arrivals)
    rep = latency_report(records, slo_ttft_s=slo_ttft_s,
                         slo_tpot_s=slo_tpot_s)
    rep["iterations"] = engine.iterations
    rep["virtual_duration_s"] = round(engine.clock.now(), 9)
    return rep


def run_load_gen(*, arch: str = "yi-6b", rate_rps: float = 50.0,
                 requests: int = 16, prompt_min: int = 8,
                 prompt_max: int = 24, output_min: int = 2,
                 output_max: int = 8, seed: int = 0,
                 prefix_share_ratio: float = 0.0, page_size: int = 4,
                 max_lanes: int = 4, chunk: int = 8,
                 token_budget: int = 12, iter_time_s: float = 0.01,
                 slo_ttft_s: float = 0.25, slo_tpot_s: float = 0.05,
                 use_kernel: bool = False, cfg=None, params=None,
                 spec: WorkloadSpec = None, device: DeviceLike = None
                 ) -> dict:
    """Full load-gen run: schedule + fresh engine + report.  ``cfg`` /
    ``params`` may be passed in to reuse an already-initialised model
    (the engine itself is always built fresh).  Pass ``spec`` to drive
    the generator from an existing :class:`WorkloadSpec` (e.g. one
    deserialized from ``--workload``); the individual knobs are ignored
    then.  The spec rides along in the report under
    ``workload["spec"]``, so a report is always replayable."""
    if cfg is None:
        cfg = get_config(arch).smoke()
    if params is None:
        params = init_params(cfg, seed=0, device=resolve_device(device))
    if spec is None:
        spec = WorkloadSpec(
            rate_rps=rate_rps, requests=requests, prompt_min=prompt_min,
            prompt_max=prompt_max, output_min=output_min,
            output_max=output_max, seed=seed,
            prefix_share_ratio=prefix_share_ratio)
    arrivals = arrivals_from_spec(spec, cfg.vocab_size)
    rep = run_load(cfg, params, arrivals, page_size=page_size,
                   max_lanes=max_lanes, chunk=chunk,
                   token_budget=token_budget, iter_time_s=iter_time_s,
                   slo_ttft_s=slo_ttft_s, slo_tpot_s=slo_tpot_s,
                   use_kernel=use_kernel, device=device)
    return {
        "workload": {
            "arch": cfg.name, "rate_rps": spec.rate_rps,
            "requests": spec.requests,
            "prompt_len": [spec.prompt_min, spec.prompt_max],
            "output_len": [spec.output_min, spec.output_max],
            "seed": spec.seed,
            "page_size": page_size, "max_lanes": max_lanes,
            "chunk": chunk, "token_budget": token_budget,
            "iter_time_s": iter_time_s,
            "spec": spec.to_json(),
        },
        **rep,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--rate", type=float, default=50.0,
                    help="mean arrival rate, requests per virtual second")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-min", type=int, default=8)
    ap.add_argument("--prompt-max", type=int, default=24)
    ap.add_argument("--output-min", type=int, default=2)
    ap.add_argument("--output-max", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefix-share", type=float, default=0.0,
                    help="fraction of requests whose prompt starts with "
                         "one shared prompt_min-token block")
    ap.add_argument("--workload", default=None,
                    help="read the WorkloadSpec from this JSON file "
                         "(overrides the individual workload knobs)")
    ap.add_argument("--workload-out", default=None,
                    help="serialize the WorkloadSpec to this JSON file "
                         "(round-trips through --workload)")
    ap.add_argument("--page-size", type=int, default=4)
    ap.add_argument("--max-lanes", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--token-budget", type=int, default=12,
                    help="TokenBudgetPolicy total tokens per iteration")
    ap.add_argument("--iter-time", type=float, default=0.01,
                    help="virtual seconds charged per engine iteration")
    ap.add_argument("--slo-ttft", type=float, default=0.25,
                    help="TTFT service-level objective, virtual seconds")
    ap.add_argument("--slo-tpot", type=float, default=0.05,
                    help="TPOT service-level objective, virtual seconds")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized: tiny workload, seconds on CPU")
    ap.add_argument("--selfcheck", action="store_true",
                    help="run the workload twice on fresh engines and "
                         "assert the serialized reports are byte-identical")
    ap.add_argument("--out", default=None,
                    help="write the report JSON here (default: stdout only)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    if args.smoke:
        args.requests = min(args.requests, 8)
        args.prompt_min, args.prompt_max = 4, 12
        args.output_min, args.output_max = 2, 5
        args.max_lanes, args.chunk, args.token_budget = 2, 4, 6

    cfg = get_config(args.arch).smoke()
    device = resolve_device(args.device)
    params = init_params(cfg, seed=0, device=device)
    spec = None
    if args.workload:
        with open(args.workload) as f:
            spec = WorkloadSpec.from_json(json.load(f))
    knobs = dict(
        rate_rps=args.rate, requests=args.requests,
        prompt_min=args.prompt_min, prompt_max=args.prompt_max,
        output_min=args.output_min, output_max=args.output_max,
        seed=args.seed, prefix_share_ratio=args.prefix_share,
        page_size=args.page_size,
        max_lanes=args.max_lanes, chunk=args.chunk,
        token_budget=args.token_budget, iter_time_s=args.iter_time,
        slo_ttft_s=args.slo_ttft, slo_tpot_s=args.slo_tpot,
        cfg=cfg, params=params, spec=spec, device=device)
    if args.workload_out:
        dump = spec if spec is not None else WorkloadSpec(
            rate_rps=args.rate, requests=args.requests,
            prompt_min=args.prompt_min, prompt_max=args.prompt_max,
            output_min=args.output_min, output_max=args.output_max,
            seed=args.seed, prefix_share_ratio=args.prefix_share)
        with open(args.workload_out, "w") as f:
            json.dump(dump.to_json(), f, indent=2)

    result = run_load_gen(**knobs)
    if args.selfcheck:
        replay = run_load_gen(**knobs)
        a = json.dumps(result, sort_keys=True)
        b = json.dumps(replay, sort_keys=True)
        assert a == b, "same-seed load-gen runs diverged:\n" \
            f"  first : {a}\n  replay: {b}"
        result["replay_identical"] = True
        print("selfcheck: two same-seed runs byte-identical", file=sys.stderr)

    print(json.dumps(result, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
