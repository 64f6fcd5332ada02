"""Where a full-size train step's time goes: host vs device, by part and
by kernel.

    PYTHONPATH=src python3 -m repro_torch.launch.profile_train [--steps 2]

Trains gemma2-2b as registered (26 layers, bf16 with a float32 master,
random weights from seed 0) at ``train_4k``'s S=4096 with batch 2, as
``chip_smoke.py`` phase 12 does, on the CUDA device with the PyTorch
port: one warm-up step, ``--steps`` unprofiled steps for wall time, then
one step under ``torch.profiler``.  The profiled step marks four parts
with ``record_function`` (wrapping the port's functions from here, the
package is not changed): the flash kernel's forwards, the flash op's
backward recompute, the loss chunks (forward and their recompute) and
the AdamW update; the rest is the layers' GEMMs and elementwise work,
forward, recompute and backward.  Prints one JSON object: median wall
ms, device-busy ms (sum of kernel durations), idle share (1 - busy /
wall), kernel launches, each part's device ms (the span of the kernels
launched inside it) and the kernels taking the most device time.  Needs
a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import functools
import json
import statistics
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.configs import SHAPES, ShapeSpec, get_config
from repro_torch.data import MarkovChainData
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ops as FO
from repro_torch.models import layers as L
from repro_torch.models import steps as ST


def _mark(owner, attr: str, label: str, static: bool = False):
    """Wrap ``owner.attr`` in ``record_function(label)``."""
    fn = getattr(owner, attr)

    @functools.wraps(fn)
    def wrapped(*a, **kw):
        with record_function(label):
            return fn(*a, **kw)

    setattr(owner, attr, staticmethod(wrapped) if static else wrapped)


def _device_times(prof, labels):
    """(kernel ms by name, launches, {label: device ms}) of one profiled
    window.  A marked range shows on the device as a user annotation
    spanning the kernels launched inside it (on any thread, the autograd
    engine's included); those spans are the parts, not kernels."""
    per, parts = collections.Counter(), collections.Counter()
    launches = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if e.name in labels:
            parts[e.name] += e.device_time_total / 1e3
        else:
            per[e.name] += e.device_time_total / 1e3
            launches += 1
    return per, launches, parts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("gemma2-2b")
    S = SHAPES["train_4k"].seq_len
    shape = ShapeSpec("train_4k", S, 2, "train")
    data = MarkovChainData(cfg, shape, seed=0)
    opt = ST.default_opt_cfg(cfg)
    state = ST.init_train_state(cfg, opt, seed=0)
    step_fn = ST.make_train_step(cfg, opt)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in
                data.batch(i).items()} for i in range(args.steps + 2)]

    state, _ = step_fn(state, batches[0])              # warm-up
    torch.cuda.synchronize()
    wall = []
    for b in batches[1:-1]:
        t = time.perf_counter()
        state, _ = step_fn(state, b)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t) * 1e3)

    labels = ("flash_kernel", "flash_backward_recompute", "loss_chunk",
              "adamw")
    _mark(FK, "flash_attention_fwd", labels[0])
    _mark(FO._FlashAttention, "backward", labels[1], static=True)
    _mark(L, "_xent_chunk", labels[2])
    _mark(ST, "adamw_update", labels[3])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        state, m = step_fn(state, batches[-1])
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t) * 1e3
    per, launches, parts = _device_times(prof, labels)
    busy = sum(per.values())
    med = statistics.median(wall)
    print(json.dumps({
        "card": smi, "arch": cfg.name, "batch": 2, "seq": S,
        "wall_ms_median": med, "wall_ms": wall,
        "profiled_wall_ms": prof_wall, "device_busy_ms": busy,
        "idle_share": 1 - busy / med, "launches": launches,
        "loss": float(m["loss"]),
        "parts_device_ms": dict({k: parts.get(k, 0.0) for k in labels},
                                rest=busy - sum(parts.values())),
        "top_kernels_ms": dict(per.most_common(15)),
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
