#!/usr/bin/env python3
"""Where a serving iteration's time goes: host vs device, kernel by kernel.

    python3 scripts/profile_torch_serve.py [--kv-dtype int8]

Serves ``chip_smoke.py``'s phase-5 workload (yi-6b at full width, bf16,
random weights from seed 0, 12 requests, a 1,024-page pool) on the CUDA
device with the PyTorch port, twice: once unprofiled for wall time per
iteration, once with ``torch.profiler`` around every iteration for the
device's kernel time.  Iterations are split into prefill (any prompt
tokens fed) and decode (all lanes decoding).  Prints one JSON object per
class: median wall ms, median device-busy ms (sum of kernel durations),
idle share (1 - busy / wall), kernel launches per iteration, and the
kernels taking the most device time.  ``--kv-dtype int8`` serves the
same workload from an int8 KV pool.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]


def _kernels(prof):
    """(busy ms, launches, {kernel name: ms}) of one profiled window."""
    per = collections.Counter()
    launches = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per[e.name] += e.device_time_total / 1e3
            launches += 1
    return sum(per.values()), launches, per


def _drive(engine, requests, profiled: bool):
    for r in requests:
        engine.submit(r)
    rows = []
    while True:
        before = engine.prefill_tokens
        if profiled:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                busy = engine.step()
            torch.cuda.synchronize()
        else:
            t = time.perf_counter()
            busy = engine.step()
            wall = (time.perf_counter() - t) * 1e3
        if not busy:
            return rows
        kind = "prefill" if engine.prefill_tokens > before else "decode"
        rows.append((kind, _kernels(prof) if profiled else wall))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kv-dtype", default="bf16", choices=("bf16", "int8"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import serve_workload
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.models.model import init_params
    from repro_torch.runtime import make_engine

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    launch.build([K.SOURCE])
    cfg = get_config("yi-6b")
    model = init_params(cfg, seed=0)
    ecfg, requests = serve_workload(cfg, kv_dtype=args.kv_dtype)
    _drive(make_engine(cfg, model, ecfg), requests, profiled=False)  # warm
    walls = _drive(make_engine(cfg, model, ecfg), requests, profiled=False)
    traced = _drive(make_engine(cfg, model, ecfg), requests, profiled=True)
    for kind in ("prefill", "decode"):
        wall = [w for k, w in walls if k == kind]
        prof = [p for k, p in traced if k == kind]
        busy = statistics.median(b for b, _, _ in prof)
        total = collections.Counter()
        for _, _, per in prof:
            total.update(per)
        top = [(name[:80], round(ms / len(prof), 4))
               for name, ms in total.most_common(8)]
        med_wall = statistics.median(wall)
        print(json.dumps({
            "kv_dtype": args.kv_dtype, "iterations": kind,
            "count": len(wall),
            "wall_ms_median": med_wall, "device_busy_ms_median": busy,
            "idle_share": 1 - busy / med_wall,
            "kernel_launches_per_iter": statistics.median(
                n for _, n, _ in prof),
            "top_kernels_ms_per_iter": top}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
