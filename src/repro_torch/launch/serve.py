"""Serving launcher: the paged continuous-batching engine behind the
unified generation API.  The port of ``repro.launch.serve``.

    python -m repro_torch.launch.serve --arch yi-6b \
        --requests 8 --max-new 8 [--kernel] [--temperature 0.8 --top-p 0.9 \
        --top-k 40 --seed 7 --stop 13 --stop 17] [--device cpu]

Serves the arch's smoke config with random weights from seed 0 through
``make_engine``: RAB translation, the paged pool, continuous batching,
on-device sampling and tracing.  Runs on ``cuda`` unless ``--device``
says otherwise; there every layer's attention is the paged-attention
kernel, with or without ``--kernel``.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.core.analysis import layer1_decode, layer2_tlb_transactions
from repro_torch.device import resolve_device
from repro_torch.models.model import init_params
from repro_torch.runtime import (
    CacheConfig, EngineConfig, GenerationRequest, SamplingParams,
    make_engine,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--pages", type=int, default=64)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--kernel", action="store_true",
                    help="the paged-attention kernel's route (on the CPU "
                         "its plain version through the repeat-padded "
                         "table; on CUDA the engine always takes it)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: n-gram drafter proposes up "
                         "to K tokens per lane per iteration, verified in "
                         "one chunked step (0 disables; greedy lanes only)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy argmax; > 0 samples on device with a "
                         "per-request PRNG key folded by position")
    ap.add_argument("--top-k", type=int, default=0,
                    help="keep only the k highest logits (0 disables)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus truncation mass (1.0 disables)")
    ap.add_argument("--seed", type=int, default=0,
                    help="per-request sampling seed (request i uses "
                         "seed + i so lanes differ but stay reproducible)")
    ap.add_argument("--stop", type=int, action="append", default=None,
                    help="stop token id; repeatable — any of them ends a "
                         "request with finish_reason='stop'")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch).smoke()
    params = init_params(cfg, seed=0, device=device)
    engine_cfg = EngineConfig(
        cache=CacheConfig(num_pages=args.pages,
                          page_size=args.page_size,
                          max_pages_per_seq=16),
        max_lanes=args.lanes,
        use_kernel=args.kernel or device.type == "cuda",
        spec_k=args.spec_k)
    srv = make_engine(cfg, params, engine_cfg, device=device)
    requests = [
        GenerationRequest(
            rid=rid, prompt=(rid + 1, 3, 5),
            sampling=SamplingParams(
                temperature=args.temperature, top_k=args.top_k,
                top_p=args.top_p, seed=args.seed + rid,
                stop_tokens=tuple(args.stop or ()), max_new=args.max_new))
        for rid in range(args.requests)
    ]
    for _ in srv.generate(requests):
        pass                        # drain the stream; results accumulate
    for r in srv.finished:
        print(f"req {r.rid}: {list(r.prompt)} -> {list(r.tokens)} "
              f"[{r.finish_reason}]")
    print("RAB:", srv.rab.stats)
    if args.spec_k:
        gen = sum(len(r.tokens) for r in srv.finished)
        print(f"spec: proposed={srv.spec_proposed} "
              f"accepted={srv.spec_accepted} rejected={srv.spec_rejected} "
              f"iters/token={srv.iterations / max(gen, 1):.2f}")
    events = layer1_decode(srv.tracer.drain())
    print(f"{len(events)} trace events; "
          f"{len(layer2_tlb_transactions(events))} TLB transactions")


if __name__ == "__main__":
    main()
