#!/usr/bin/env python3
"""Where a serving iteration's time goes: host vs device, kernel by kernel.

    python3 scripts/profile_torch_serve.py [--kv-dtype int8] [--arch ARCH]

Serves ``chip_smoke.py``'s phase-5 workload (``--arch``, default yi-6b,
at full width, bf16, random weights from seed 0, 12 requests, a
1,024-page pool; ``--arch olmoe-1b-7b`` is phase 16's) on the CUDA
device with the PyTorch port, twice: once unprofiled for wall time per
iteration, once with ``torch.profiler`` around every iteration for the
device's kernel time.  Iterations are split into prefill (any prompt
tokens fed) and decode (all lanes decoding).  Prints one JSON object per
class: median wall ms, median device-busy ms (sum of kernel durations),
idle share (1 - busy / wall), kernel launches per iteration, the device
ms per iteration of the port's paged-attention kernels (every kernel of
``paged_attention.cu``, whose names hold ``paged_``), the device ms per
iteration of an MoE model's parts (marked from here with
``record_function``, the package unchanged: the router product and
top-k, the sort and scatter into the experts' slots, the experts'
``bmm``s, the combine; each part's busy time, the sum of its kernels,
and its span on the device, idle gaps included), and the kernels taking
the most device time.  ``--kv-dtype int8`` serves the
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
from torch.profiler import ProfilerActivity, profile, record_function

ROOT = Path(__file__).resolve().parents[1]


#: the MoE layer's parts, marked around ``repro_torch.models.moe``'s
#: functions of the same names
MOE_PARTS = ("_route", "_dispatch", "_experts", "_combine")


def _mark_moe():
    """Wrap each of ``MOE_PARTS`` in ``record_function("moe<name>")``."""
    from repro_torch.models import moe as MOE
    for name in MOE_PARTS:
        fn = getattr(MOE, name)

        def wrapped(*a, fn=fn, label=f"moe{name}", **kw):
            with record_function(label):
                return fn(*a, **kw)
        setattr(MOE, name, wrapped)


def _kernels(prof):
    """(busy ms, launches, {kernel name: ms}, {MoE part: busy ms, and
    "<part> span": its span}) of one profiled window.  A marked range
    shows on the host as an event whose device time is the sum of the
    kernels launched inside it (the part's busy time), and on the device
    as a user annotation spanning them, idle gaps included (its span):
    neither is a kernel."""
    per, parts = collections.Counter(), collections.Counter()
    launches = 0
    labels = {f"moe{name}" for name in MOE_PARTS}
    for e in prof.events():
        if e.name in labels:
            key = e.name if e.device_type != torch.autograd.DeviceType.CUDA \
                else f"{e.name} span"
            parts[key] += e.device_time_total / 1e3
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            per[e.name] += e.device_time_total / 1e3
            launches += 1
    return sum(per.values()), launches, per, parts


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
    ap.add_argument("--arch", default="yi-6b")
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
    cfg = get_config(args.arch)
    model = init_params(cfg, seed=0)
    ecfg, requests = serve_workload(cfg, kv_dtype=args.kv_dtype)
    _drive(make_engine(cfg, model, ecfg), requests, profiled=False)  # warm
    walls = _drive(make_engine(cfg, model, ecfg), requests, profiled=False)
    _mark_moe()
    traced = _drive(make_engine(cfg, model, ecfg), requests, profiled=True)
    for kind in ("prefill", "decode"):
        wall = [w for k, w in walls if k == kind]
        prof = [p for k, p in traced if k == kind]
        busy = statistics.median(b for b, _, _, _ in prof)
        total, parts = collections.Counter(), collections.Counter()
        for _, _, per, part in prof:
            total.update(per)
            parts.update(part)
        top = [(name[:80], round(ms / len(prof), 4))
               for name, ms in total.most_common(8)]
        med_wall = statistics.median(wall)
        print(json.dumps({
            "arch": cfg.name, "kv_dtype": args.kv_dtype, "iterations": kind,
            "count": len(wall),
            "wall_ms_median": med_wall, "device_busy_ms_median": busy,
            "idle_share": 1 - busy / med_wall,
            "kernel_launches_per_iter": statistics.median(
                n for _, n, _, _ in prof),
            "paged_attention_ms_per_iter": sum(
                ms for name, ms in total.items() if "paged_" in name)
            / len(prof),
            "moe_parts_ms_per_iter": {
                name: ms / len(prof) for name, ms in sorted(parts.items())},
            "top_kernels_ms_per_iter": top}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
