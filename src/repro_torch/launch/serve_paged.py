"""Serve a small model through the paged engine's unified generation API,
the port of ``examples/serve_paged.py``: continuous batching + RAB
translation + shared-prefix KV caching + priority preemption +
per-request sampling + live token streaming.

Requests share a common system prompt, so later admissions hit the prefix
cache and skip most of their prefill; one request decodes with
temperature/top-p sampling (on device, seed-reproducible) while the rest
stay greedy; a late high-priority request lands in a deliberately tight
pool and preempts a running lane (its pages swap to the host backing
store and back).  Everything is observed live through
``engine.generate()``: the stream of ``TokenDelta``s (tokens, prefix
hits, preemptions) is printed as it happens, and its per-request
concatenation must equal the final ``GenerationResult``s.

    PYTHONPATH=src python -m repro_torch.launch.serve_paged \
        [--requests 8] [--kernel] [--device cpu]

The arch's smoke config with random weights from seed 0; on ``cuda``
(the default) every layer's attention is the paged-attention kernel,
with or without ``--kernel``.  :func:`run` takes the weights, so a
caller can serve carried ones (``params_from_jax``, or a copy of the
card's on the CPU).
"""
from __future__ import annotations

import argparse
from typing import Dict

from repro_torch.configs import ArchConfig, get_config
from repro_torch.core.analysis import (
    layer1_decode, layer2_request_lifecycles, layer2_tlb_transactions,
    render_timeline,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import init_params
from repro_torch.runtime import (
    CacheConfig, EngineConfig, GenerationRequest, SamplingParams,
    make_engine,
)

#: the shared "system prompt"
SYSTEM = [9, 9, 8, 2, 5, 5, 1, 3]
#: the late high-priority request, submitted once the stream has given
#: delta ``VIP_AT``
VIP_AT = 8
VIP = dict(rid=99, prompt=[4, 2] * 8, priority=5)


def requests(n: int) -> list:
    """The reference's requests: the system prompt and one token of their
    own, 6 new tokens; rid 1 samples at temperature 0.7, top-p 0.9, seed
    11, the rest are greedy."""
    out = []
    for rid in range(n):
        sampling = SamplingParams(temperature=0.7, top_p=0.9, seed=11,
                                  max_new=6) if rid == 1 else \
            SamplingParams(max_new=6)
        out.append(GenerationRequest(rid=rid, prompt=SYSTEM + [20 + rid],
                                     sampling=sampling))
    return out


def engine_config(chunk: int = 4, kernel: bool = False,
                  prefix_cache: bool = True,
                  device: DeviceLike = None) -> EngineConfig:
    """The reference's tight engine: 2 lanes, a pool of 24 pages of 4."""
    return EngineConfig(
        cache=CacheConfig(num_pages=24, page_size=4,
                          max_pages_per_seq=16,
                          enable_prefix_cache=prefix_cache),
        max_lanes=2, chunk=chunk,
        use_kernel=kernel or resolve_device(device).type == "cuda")


def run(cfg: ArchConfig, params, n_requests: int = 8, chunk: int = 4,
        kernel: bool = False, prefix_cache: bool = True,
        device: DeviceLike = None) -> Dict:
    """Serve the reference's schedule on ``params`` (on ``device``) and
    print its report; returns the streams, results and counters."""
    srv = make_engine(cfg, params, engine_config(chunk, kernel, prefix_cache,
                                                 device), device=device)
    streamed: dict = {}
    for i, delta in enumerate(srv.generate(requests(n_requests))):
        streamed.setdefault(delta.rid, []).extend(delta.tokens)
        tag = f" [{delta.event}]" if delta.event != "token" else ""
        fin = f" -> {delta.finish_reason}" if delta.finish_reason else ""
        print(f"delta {i:3d}: req {delta.rid} +{list(delta.tokens)}"
              f"{tag}{fin}")
        if i == VIP_AT:
            # a late VIP request into a busy pool: the scheduler preempts a
            # lane; submissions can land mid-stream
            srv.submit(GenerationRequest(
                **VIP, sampling=SamplingParams(max_new=6)))
            print("delta   —: submitted VIP req 99 mid-stream")
    done = srv.finished

    # the streamed deltas are the results, token for token
    results = {r.rid: list(r.tokens) for r in done}
    if results != streamed:
        raise RuntimeError("delta concatenation diverged from final "
                           f"results: {streamed} != {results}")

    print(f"\n# served {len(done)} requests (lanes=2, pages=24x4, "
          f"chunk={chunk}) in {srv.iterations} engine iterations "
          f"(h2d={srv.h2d_events}, d2h={srv.d2h_events}, "
          f"preemptions={srv.preemptions})")
    for r in sorted(done, key=lambda r: r.rid):
        tag = f" [prefix hit {r.prefix_hit_tokens} tok]" \
            if r.prefix_hit_tokens else ""
        tag += f" [preempted x{r.preemptions}]" if r.preemptions else ""
        print(f"req {r.rid}: prompt {list(r.prompt)} -> {list(r.tokens)} "
              f"[{r.finish_reason}]{tag}")
    print("\n# RAB:", srv.rab.stats)
    print("# pool:", srv.pool.stats)
    print(f"# backing store: {srv.backing.bytes_out} B out, "
          f"{srv.backing.bytes_in} B in")
    events = layer1_decode(srv.tracer.drain())
    print(f"\n# {len(events)} events; TLB transactions (first 10):")
    for tx in layer2_tlb_transactions(events)[:10]:
        print(tx)
    print("\n# request lifecycles (admit/preempt/swap_in/finish):")
    lifecycles = layer2_request_lifecycles(events)
    for rid, spans in sorted(lifecycles.items()):
        print(f"req {rid}: " + " -> ".join(s["kind"] for s in spans))
    print("\n# timeline (truncated)")
    print(render_timeline(events, max_rows=12)[:2000])
    return {
        "streamed": streamed,
        "results": {r.rid: dict(tokens=list(r.tokens),
                                finish_reason=r.finish_reason,
                                prefix_hit_tokens=r.prefix_hit_tokens,
                                preemptions=r.preemptions)
                    for r in done},
        "iterations": srv.iterations, "h2d": srv.h2d_events,
        "d2h": srv.d2h_events, "preemptions": srv.preemptions,
        "rab": dict(srv.rab.stats), "pool": dict(srv.pool.stats),
        "backing": (srv.backing.bytes_out, srv.backing.bytes_in),
        "lifecycles": {rid: [s["kind"] for s in spans]
                       for rid, spans in lifecycles.items()},
        "events": len(events)}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=4,
                    help="prompt tokens consumed per engine iteration "
                         "(chunked prefill)")
    ap.add_argument("--kernel", action="store_true",
                    help="the paged-attention kernel's route (on the CPU "
                         "its plain version through the repeat-padded "
                         "table; on CUDA the engine always takes it)")
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch).smoke()
    params = init_params(cfg, seed=0, device=device)
    return run(cfg, params, args.requests, args.chunk, args.kernel,
               not args.no_prefix_cache, device)


if __name__ == "__main__":
    main()
