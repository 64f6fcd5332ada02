"""Run one cell of ``BENCHMARK.json`` once and build its result line.

Everything specific to a cell is found by name: the cell's entry and its
file ``bench/workloads/<cell>.json`` (engine settings, the open-loop
rate, the traced sub-window, the sample size and the limit of the
comparison), its configuration (``bench/configs/<config>.json``, named by
the entry's ``file``), its traffic mix (``bench/traffic/<mix>.json``) and
each of its metrics (``bench/metrics/<metric>.py``, a ``read(run)`` that
returns a number or None).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from harness import correct, traffic
from harness import weights as W
from harness.counts import Geometry
from harness.driver import Driver, FINISHED_OK, Log
from harness.reference import set_exact_float32

ROOT = Path(__file__).resolve().parents[2]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict                 # the BENCHMARK.json workload entry
    spec: dict                  # bench/workloads/<name>.json
    conf: dict                  # the configuration file
    mix: dict                   # bench/traffic/<mix>.json
    metrics: Dict[str, List[dict]]   # "end_to_end" / "per_layer" entries

    @classmethod
    def find(cls, name: str, root: Path = ROOT) -> "Cell":
        bench = load_json(root / "BENCHMARK.json")
        entry = next((w for w in bench["workloads"] if w["name"] == name),
                     None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        conf_entry = next(c for c in bench["configs"]
                          if c["name"] == entry["config"])
        metrics = {kind: [m for m in bench[kind]
                          if "workloads" not in m or name in m["workloads"]]
                   for kind in ("end_to_end", "per_layer")}
        return cls(name=name, entry=entry,
                   spec=load_json(root / "bench" / "workloads"
                                  / f"{name}.json"),
                   conf=load_json(root / conf_entry["file"]),
                   mix=load_json(root / "bench" / "traffic"
                                 / f"{entry['traffic']}.json"),
                   metrics=metrics)


@dataclasses.dataclass
class Run:
    """What a metric reader sees."""
    geometry: Geometry
    lanes: int
    chunk: int
    kv_bytes: int
    setup_s: float
    log: Log
    trace: Optional[object] = None  # trace.Reduced in a traced run


def read_metric(name: str, run: Run, root: Path = ROOT) -> Optional[float]:
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


# ---------------------------------------------------------------- program --

def arch_config(conf: dict):
    """The port's ``ArchConfig`` for a configuration file."""
    from repro_torch.configs.base import ArchConfig
    d, H = conf["hidden_size"], conf["num_attention_heads"]
    E = conf.get("num_experts", 0)
    return ArchConfig(
        name=conf["name"], family="moe" if E else "dense",
        num_layers=conf["num_hidden_layers"], d_model=d, num_heads=H,
        num_kv_heads=conf["num_key_value_heads"],
        d_ff=0 if E else conf["intermediate_size"],
        vocab_size=conf["vocab_size"], head_dim=conf.get("head_dim") or d // H,
        rope_theta=float(conf["rope_theta"]),
        norm_eps=float(conf["rms_norm_eps"]),
        tie_embeddings=bool(conf.get("tie_word_embeddings", False)),
        use_qk_norm=bool(conf.get("qk_norm")),
        moe_num_experts=E, moe_top_k=conf.get("num_experts_per_tok", 0),
        moe_d_ff=conf["intermediate_size"] if E else 0,
        moe_capacity_factor=float(conf.get("moe_capacity_factor", 1.25)),
        param_dtype="bfloat16", compute_dtype="bfloat16")


def assemble(cfg, leaves: Dict[str, torch.Tensor]):
    """The port's model holding ``leaves`` (no copy): built on the meta
    device, every leaf then set to the benchmark's tensor."""
    from repro_torch.models.model import DenseDecoder, param_shapes, \
        set_param
    shapes = param_shapes(cfg)
    if set(shapes) != set(leaves) or any(
            tuple(leaves[p].shape) != tuple(s) for p, s in shapes.items()):
        raise ValueError("the benchmark's weights do not match the port's "
                         "parameter layout")
    model = DenseDecoder(cfg, torch.device("meta"))
    for path, t in leaves.items():
        set_param(model, path, t)
    return model


def engine_config(spec: dict, mix: dict, pages: int):
    from repro_torch.runtime import CacheConfig, EngineConfig
    e = spec["engine"]
    page = int(e["page_size"])
    return EngineConfig(
        max_lanes=int(e["max_lanes"]), chunk=int(e["chunk"]),
        cache=CacheConfig(num_pages=pages, page_size=page,
                          max_pages_per_seq=-(-traffic.longest(mix) // page),
                          kv_dtype=e["kv_dtype"],
                          enable_prefix_cache=bool(e["prefix_cache"])))


def make_request(req: traffic.Request):
    from repro_torch.runtime import GenerationRequest, SamplingParams
    return GenerationRequest(rid=req.rid, prompt=req.prompt,
                             sampling=SamplingParams(max_new=req.max_new))


def warm(engine, prompts) -> None:
    """One (lanes, chunk) prefill iteration, then one (lanes, 1) decode
    iteration: the only two step shapes a window runs."""
    from repro_torch.runtime import GenerationRequest, SamplingParams
    base = 1 << 40
    for i, p in enumerate(prompts):
        engine.submit(GenerationRequest(rid=base + i, prompt=p,
                                        sampling=SamplingParams(max_new=2)))
    while engine.step():
        pass
    engine.poll_deltas()
    if engine.device.type == "cuda":
        torch.cuda.synchronize()


def prime(engine, shared) -> None:
    """Serve each shared prompt once, so that the prefix cache holds them
    when the window opens, as a deployment's does in its steady state."""
    from repro_torch.runtime import GenerationRequest, SamplingParams
    base = 1 << 41
    for i, p in enumerate(shared):
        engine.submit(GenerationRequest(
            rid=base + i, prompt=tuple(int(x) for x in p),
            sampling=SamplingParams(max_new=1)))
    while engine.step():
        pass
    engine.poll_deltas()


def page_bytes(conf: dict, spec: dict) -> int:
    d, H = conf["hidden_size"], conf["num_attention_heads"]
    hd = conf.get("head_dim") or d // H
    kv_bytes = 1 if spec["engine"]["kv_dtype"] == "int8" else 2
    return (conf["num_hidden_layers"] * 2 * int(spec["engine"]["page_size"])
            * conf["num_key_value_heads"] * hd * kv_bytes)


def pool_pages(conf: dict, spec: dict, weights_bytes: int,
               step_peak: int, total: int) -> int:
    """A deployment's pool: ``memory_utilization`` of the card (vLLM's
    ``gpu_memory_utilization``), less the weights, less the warm-up
    step's peak above them."""
    share = float(spec["engine"]["memory_utilization"])
    free = share * total - weights_bytes - step_peak
    return max(1, int(free // page_bytes(conf, spec)))


# -------------------------------------------------------------- one run --

def device_info(chips: int) -> dict:
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20).stdout.strip()
        info["power_limit_w"] = float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        info["power_limit_w"] = None
    return info


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, root: Path = ROOT, device: str = "cuda",
             cell: Optional[Cell] = None, total_memory: Optional[int] = None,
             control: bool = False, judge: bool = True) -> dict:
    """One run of cell ``name``; returns the result line as a dict (the
    caller prints it).  ``t_start`` is the process's start on the
    monotonic clock: set-up runs from there to the start of the traffic
    (the lead-in that precedes the window is not set-up).
    ``control`` also reads the float8 control on the same sample
    (``bench/calibrate.py``; never in the benchmark's own runs);
    without ``judge`` the comparison is skipped (the rate sweep)."""
    from repro_torch.runtime import make_engine
    cell = cell or Cell.find(name, root)
    spec, conf, mix = cell.spec, cell.conf, cell.mix
    set_exact_float32()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    chips = int(cell.entry.get("chips", 1))
    leaves = W.make(conf, seed, dev)
    cfg = arch_config(conf)
    model = assemble(cfg, leaves)
    lanes, chunk = int(spec["engine"]["max_lanes"]), \
        int(spec["engine"]["chunk"])
    prompts = traffic.warmup_prompts(seed, conf["vocab_size"], lanes, chunk)
    probe_pages = lanes * (-(-(chunk + 2) // int(spec["engine"]
                                                  ["page_size"]))) + 8
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
    probe = make_engine(cfg, model, engine_config(spec, mix, probe_pages),
                        device=dev)
    warm(probe, prompts)
    if cuda:
        probe_pool = probe.kv_pages.numel() * probe.kv_pages.element_size()
        step_peak = torch.cuda.max_memory_allocated() - before - probe_pool
        total = total_memory or torch.cuda.mem_get_info(dev)[1]
    else:
        step_peak, total = 0, total_memory or 0
    del probe
    gc.collect()
    pages = pool_pages(conf, spec, W.nbytes(leaves), step_peak, total) \
        if (cuda or total_memory) else probe_pages
    # the probe warmed both step shapes in this process: the serving
    # engine's first steps compile nothing, and run in the lead-in
    engine = make_engine(cfg, model, engine_config(spec, mix, pages),
                         device=dev)
    prime(engine, traffic.shared_prompts(mix, seed, conf["vocab_size"]))
    routes = None
    if conf.get("num_experts"):
        from harness.moe_follow import RouteLog
        routes = RouteLog(conf)
        routes.install(engine)
    tracer = None
    if trace:
        from harness.trace import Tracer, mark_moe
        if conf.get("num_experts"):
            mark_moe()
        t_len = float(spec["trace_seconds"])
        tracer = Tracer(max(0.0, (seconds - t_len) / 2), t_len)
    offer = traffic.requests(mix, seed, conf["vocab_size"],
                             spec.get("rate_per_s"))
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.monotonic() - t_start
    log = Driver(engine, mix, offer, make_request, seconds, tracer,
                 float(spec.get("lead_in_s", 0))).run()
    if cuda:
        torch.cuda.synchronize()
    if routes is not None:
        routes.uninstall()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    reduced = tracer.reduce() if tracer is not None else None
    run = Run(geometry=Geometry.of(conf), lanes=lanes, chunk=chunk,
              kv_bytes=1 if spec["engine"]["kv_dtype"] == "int8" else 2,
              setup_s=setup_s, log=log, trace=reduced)
    # the program's state goes before the reference runs
    engine.close()
    del engine, model, tracer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    check = spec["check"]
    picked = correct.sample(log.records, seed, int(check["min_tokens"]),
                            int(check["max_requests"]))
    limit = float(spec["limits"]["max_gap"])
    drops, mismatched = routes.follow([r.rid for r in picked]) \
        if routes is not None and judge else ({}, None)
    del routes
    verdict = correct.judge(conf, leaves, picked, limit, drops) if judge \
        else {"correct": False, "max_gap": None, "tokens": 0,
              "requests": 0, "why": "not judged"}
    if mismatched:
        verdict["correct"] = False
    ctl = correct.control(conf, leaves, picked, drops) if control else None
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell.metrics[kind]:
        v = read_metric(m["name"], run, root)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    attempted = [r for r in log.records.values()
                 if 0 <= r.arrive <= seconds]
    failed = sum(1 for r in attempted
                 if r.reason is not None and r.reason not in FINISHED_OK)
    device_out = device_info(chips) if cuda else {
        "platform": "cpu", "kind": "cpu", "count": 1}
    device_out["memory_peak_bytes"] = peak
    device_out["pool_pages"] = pages
    device_out["pool_pages_live_peak"] = log.pages_live_peak
    device_out["pool_pages_held_peak"] = log.pages_held_peak
    out = {"correct": bool(verdict["correct"]), "attempted": len(attempted),
           "failed": failed, "metrics": metrics, "device": device_out}
    if reduced is not None:
        device_out["busy_s"] = reduced.busy_s
        device_out["window_s"] = reduced.window_s
        out["breakdown"] = {
            "device_ops": [[n, s] for n, s in reduced.device_ops],
            "idle_gaps": [[n, s] for n, s in reduced.idle_gaps]}
    out["checks"] = {
        "max_gap": {"value": verdict["max_gap"], "limit": limit},
        "compared": {"requests": verdict["requests"],
                     "tokens": verdict["tokens"]}}
    if mismatched is not None:
        out["checks"]["dispatch_mismatch"] = {"value": mismatched,
                                              "limit": 0}
    if "route_agreement" in verdict:
        out["checks"]["route_agreement"] = verdict["route_agreement"]
    if "why" in verdict:
        out["checks"]["why"] = verdict["why"]
    if ctl is not None:
        out["control"] = ctl
    out["_run"] = run
    return out


def check_lines(out: dict) -> List[str]:
    """The numbers compared, each beside its limit, for standard error."""
    c = out["checks"]
    lines = [f"check max_gap {c['max_gap']['value']} limit "
             f"{c['max_gap']['limit']} (widest gap of a served token's "
             f"logit below the float32 reference's best)",
             f"check compared requests {c['compared']['requests']} tokens "
             f"{c['compared']['tokens']}",
             *([f"check dispatch_mismatch "
                f"{c['dispatch_mismatch']['value']} limit 0 (MoE "
                f"assignments whose kept or dropped verdict differs from "
                f"the capacity rule on the program's routing)"]
               if "dispatch_mismatch" in c else []),
             f"correct {out['correct']}"]
    if "why" in c:
        lines.insert(0, f"check {c['why']}")
    return lines


def loaded_jax_modules(names=None) -> List[str]:
    """Top-level names among ``names`` (default: ``sys.modules``) that are
    JAX, jaxlib, flax or the JAX package ``repro`` (compared whole:
    ``repro_torch`` is not)."""
    banned = {"jax", "jaxlib", "flax", "repro"}
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & banned)
