#!/usr/bin/env python3
"""Calibration on the card, run once when a cell is defined; never part
of a benchmark run.

    python3 bench/calibrate.py sweep --workload <cell> --rates 2,3,4 \\
        --seconds 40 --seed <n>
    python3 bench/calibrate.py limits --workload <cell> --seeds a,b,c \\
        --seconds 25

``sweep`` offers an open-loop cell's traffic at each rate in turn (one
process, comparison skipped) and prints per rate the tokens per second,
the time to first token of the window's first and second halves, and the
queue left at the close: the highest rate whose queue does not grow is
the knee, and the cell runs at four fifths of it.  ``limits`` runs the
cell on each seed (one process, a short window at the cell's own load)
and prints the program's widest gap, the lower reading of the limit,
beside the float8 control's on the same sample, the upper reading.  Each
line also goes to ``build/calibrate.jsonl`` in the checkout.
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path[:0] = [str(BENCH), str(ROOT / "src")]


def emit(row: dict):
    line = json.dumps(row)
    print(line, flush=True)
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    with open(out / "calibrate.jsonl", "a") as f:
        f.write(line + "\n")


def halves(log) -> dict:
    from harness.stats import nearest_rank
    S = log.seconds
    out = {}
    for name, lo, hi in (("first", 0, S / 2), ("second", S / 2, S)):
        w = [(r.times[0] if r.times else S) - r.arrive
             for r in log.records.values() if lo <= r.arrive < hi]
        out[f"ttft_p95_ms_{name}_half"] = (nearest_rank(w, 95) or 0) * 1e3
    return out


def walls(log) -> dict:
    """Quantiles of the window's iteration walls, by kind."""
    import statistics
    out = {}
    for kind, its in (("prefill", [i for i in log.iterations
                                   if i.prefill_fed]),
                      ("decode", [i for i in log.iterations
                                  if not i.prefill_fed])):
        ms = sorted(i.ms for i in its)
        out[f"{kind}_iterations"] = len(ms)
        if len(ms) >= 4:
            q = statistics.quantiles(ms, n=10)
            out[f"{kind}_ms_p10_p50_p90_max"] = [q[0], statistics.median(ms),
                                                 q[-1], ms[-1]]
    return out


def values(out: dict) -> dict:
    return {k: v["value"] for k, v in out["metrics"].items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("sweep", "limits"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", default="")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seeds", default="")
    args = ap.parse_args()
    import torch
    from harness import cell as C
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = C.Cell.find(args.workload, ROOT)
    t0 = T_START
    if args.what == "sweep":
        for rate in [float(r) for r in args.rates.split(",")]:
            cell.spec["rate_per_s"] = rate
            out = C.run_cell(args.workload, args.seed, args.seconds, False,
                             t0, ROOT, cell=cell, judge=False)
            run = out.pop("_run")
            log = run.log
            emit({"sweep": args.workload, "rate_per_s": rate,
                  "seed": args.seed, "seconds": args.seconds,
                  "metrics": values(out),
                  "attempted": out["attempted"], "failed": out["failed"],
                  "finished": sum(1 for r in log.records.values()
                                  if r.reason is not None),
                  "queued_at_close": log.queued_at_close,
                  "late_s": log.late, **halves(log), **walls(log),
                  "pool_pages": out["device"]["pool_pages"],
                  "memory_peak_bytes": out["device"]["memory_peak_bytes"]})
            t0 = time.monotonic()
    else:
        for seed in [int(s) for s in args.seeds.split(",")]:
            t = time.monotonic()
            out = C.run_cell(args.workload, seed, args.seconds, False, t0,
                             ROOT, cell=cell, control=True)
            out.pop("_run")
            emit({"limits": args.workload, "seed": seed,
                  "seconds": args.seconds, "correct": out["correct"],
                  "program_max_gap": out["checks"]["max_gap"]["value"],
                  "control_max_gap": out["control"]["max_gap"],
                  "compared": out["checks"]["compared"],
                  "metrics": values(out),
                  "run_s": time.monotonic() - t})
            t0 = time.monotonic()
    return 0


if __name__ == "__main__":
    sys.exit(main())
