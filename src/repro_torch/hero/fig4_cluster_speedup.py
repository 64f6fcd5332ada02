"""Fig.4 reproduction: matrix-matrix multiplication parallelized over
clusters (1/2/4/8), bus vs NoC interconnect.  The port of
``benchmarks/fig4_cluster_speedup.py``.

    PYTHONPATH=src python -m repro_torch.hero.fig4_cluster_speedup \
        [--throughput] [--device cpu] [--sizes 1024,2048]

Two measurements, as the reference's:

  1. the analytic interconnect model (``core.cluster.interconnect_model``):
     ideal speedup at 2/4/6 clusters, ~2% below ideal at 8 on the bus,
     recovered by the NoC.  Its rows print exactly the reference's, and so
     do the §1 nominal-GIPS rows (``--throughput``);
  2. a measured row-tiled float32 matmul over 1, 2, 4 and 8 clusters at
     the reference's 1024^3 and at the model's 2048^3.  The reference runs
     each cluster on a virtual device of a ``shard_map`` mesh; here each is
     a share of one card (``core.cluster.make_card_clusters``): its own
     stream and a budget of the card's SMs // 8, with the cluster matmul
     kernel (``kernel.matmul(..., sms=)``) as its body.  All clusters'
     launches are in flight together; HBM and L2, which they share, stand
     for the PMCA's system interconnect.  For each count it prints the
     wall per call (CUDA events, median of ``REPS`` after ``WARMUP``
     calls; the caller's stream sleeps ~2 ms before each timed call, so
     that every cluster's launch is queued before the first starts; the
     same wall without that sleep, where the host paces the launches,
     and the host ms to queue a call beside it), each cluster's own time
     (its launch alone on its stream),
     the speedup over one cluster, and the bound on a cluster's SM share:
     2 (m/n) k n / (budget / SMs x 67 TFLOP/s, the data sheet's float32
     rate).  B is scaled by 1/sqrt(k) (an initialised weight's scale, as
     ``chip_smoke.py`` phase 7) so that C is of unit scale.  The operands
     stay warm in L2 between calls (B is read by every cluster).

With ``--device cpu`` the measured half runs the plain version on a list
of CPU "devices" (one per cluster, as ``cluster_parallel_matmul`` takes
them) and times it on the host clock (``clock=host``); those rows say
nothing of a card.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.core.cluster import (
    ClusterConfig, budgeted_matmul, cluster_parallel_matmul,
    interconnect_model, make_card_clusters,
)
from repro_torch.device import DeviceLike, resolve_device

#: the reference's measured cluster counts
COUNTS = (1, 2, 4, 8)
#: the reference's measured 1024^3 and its model's 2048^3
SIZES = (1024, 2048)
#: timed calls (median) and untimed calls before them
REPS, WARMUP = 20, 3
#: device cycles the stream sleeps before a timed call (~2 ms at the
#: H100's 1.98 GHz boost clock): longer than queueing 8 clusters' launches
#: (~1 ms on the H100's host, ``enqueue_ms``)
GATE_CYCLES = 4_000_000
#: float32 rate outside the tensor cores, H100 SXM data sheet (dense)
PEAK_F32 = 67e12


def modeled_speedups():
    rows = []
    # per-cluster work for an n-cluster row-tiled 2048^3 matmul
    total_compute_s = 1.0
    total_bytes = 512 * 2 ** 20
    for ic in ("bus", "noc"):
        for n in (1, 2, 4, 6, 8):
            cfg = ClusterConfig(n_clusters=n, interconnect=ic)
            m = interconnect_model(cfg, total_bytes // max(n, 1),
                                   total_compute_s / max(n, 1))
            rows.append(m)
    return rows


def operands(size: int, device) -> tuple:
    """A ~ N(0, 1) from seed 0, B ~ N(0, 1/size) from seed 1, float32,
    (size, size) each, made with numpy and moved to ``device``."""
    a = np.random.default_rng(0).standard_normal((size, size), np.float32)
    b = np.random.default_rng(1).standard_normal((size, size), np.float32)
    b /= np.float32(np.sqrt(size))
    return (torch.from_numpy(a).to(device), torch.from_numpy(b).to(device))


def _event_ms(fn, stream, gate: bool, reps: int = REPS,
              warmup: int = WARMUP) -> tuple:
    """(median CUDA-event ms of ``fn()`` on ``stream``, median host ms of
    the call itself), after ``warmup`` calls; with ``gate`` the stream
    sleeps :data:`GATE_CYCLES` before each start event, so the host ms is
    the time to queue the call's work."""
    with torch.cuda.stream(stream):
        for _ in range(warmup):
            fn()
        pairs, host = [], []
        for _ in range(reps):
            if gate:
                torch.cuda._sleep(GATE_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            fn()
            host.append((time.perf_counter() - t0) * 1e3)
            end.record()
            pairs.append((start, end))
    torch.cuda.synchronize(stream.device)
    return (statistics.median(s.elapsed_time(e) for s, e in pairs),
            statistics.median(host))


def _host_ms(fn, reps: int = REPS, warmup: int = WARMUP) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def measure(size: int, device: DeviceLike = None,
            counts: Sequence[int] = COUNTS, reps: int = REPS) -> List[Dict]:
    """One row per cluster count at ``size``^3 (see the module
    docstring).  Each row holds the product ``out`` of its clusters."""
    dev = resolve_device(device)
    a, b = operands(size, dev)
    rows = []
    for n in counts:
        m = size // n
        row = {"size": size, "n_clusters": n, "m": m,
               "flops_per_cluster": 2 * m * size * size}
        if dev.type == "cpu":
            from repro_torch.kernels.cluster_matmul import cluster_matmul
            devices = [dev] * n

            def call():
                return cluster_parallel_matmul(devices, a, b, cluster_matmul)
            blocks = a.chunk(n, dim=0)
            row.update(
                clock="host", sms=None, resident=None, tile=None,
                splits=None, out=call(),
                wall_ms=_host_ms(call, reps), enqueue_ms=None,
                wall_host_paced_ms=None,
                cluster_ms=[_host_ms(lambda at=at: cluster_matmul(at, b),
                                     reps) for at in blocks],
                bound_ms=None)
        else:
            from repro_torch.kernels.cluster_matmul import kernel as K
            clusters = make_card_clusters(n, dev)
            sms = clusters[0].sms
            tile, splits = K.general_plan(m, size, size, torch.float32,
                                          sms=sms)
            sm_total = torch.cuda.get_device_properties(dev) \
                .multi_processor_count

            def call():
                return cluster_parallel_matmul(clusters, a, b)
            caller = torch.cuda.current_stream(dev)
            wall_ms, enqueue_ms = _event_ms(call, caller, True, reps)
            row.update(
                clock="cuda_events", sms=sms, sm_total=sm_total,
                resident=K.resident_blocks(torch.float32, tile),
                tile=tile, splits=splits, out=call(),
                wall_ms=wall_ms, enqueue_ms=enqueue_ms,
                wall_host_paced_ms=_event_ms(call, caller, False, reps)[0],
                cluster_ms=[_event_ms(
                    lambda at=at, c=c: budgeted_matmul(at, b, c.sms),
                    c.stream, True, reps)[0]
                    for at, c in zip(a.chunk(n, dim=0), clusters)],
                bound_ms=row["flops_per_cluster"]
                / (sms / sm_total * PEAK_F32) * 1e3)
        rows.append(row)
    base = rows[0]["wall_ms"] if rows[0]["n_clusters"] == 1 else None
    for r in rows:
        r["speedup"] = base / r["wall_ms"] if base else None
    return rows


def card_label(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (``name, power.limit``), or the device's name where it cannot."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "cpu (host clock)"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index}"],
            capture_output=True, text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return f"{torch.cuda.get_device_name(dev)}, power limit not read"


def _fmt(x, spec: str = ".4f") -> str:
    return "" if x is None else format(x, spec)


def print_measured(rows: List[Dict], label: str) -> None:
    print("## measured (SM-budgeted clusters sharing one card, "
          "cluster_matmul row tiling)")
    print(f"# {label}")
    print("measured,size,n_clusters,clock,sms_per_cluster,resident_blocks,"
          "tile,splits,wall_ms,wall_host_paced_ms,enqueue_ms,cluster_ms,"
          "speedup,bound_ms")
    for r in rows:
        print(f"measured,{r['size']},{r['n_clusters']},{r['clock']},"
              f"{_fmt(r['sms'], 'd')},{_fmt(r['resident'], 'd')},"
              f"{_fmt(r['tile'], 'd')},{_fmt(r['splits'], 'd')},"
              f"{r['wall_ms']:.4f},{_fmt(r['wall_host_paced_ms'])},"
              f"{_fmt(r['enqueue_ms'])},"
              f"{';'.join(f'{t:.4f}' for t in r['cluster_ms'])},"
              f"{_fmt(r['speedup'], '.3f')},{_fmt(r['bound_ms'], '.5f')}")


def main(throughput: bool = False, device: DeviceLike = None,
         sizes: Sequence[int] = SIZES) -> List[Dict]:
    print("# Fig.4: cluster-parallel matmul speedup")
    print("## analytic interconnect model (bus vs NoC)")
    print("interconnect,n_clusters,speedup,ideal,efficiency")
    for m in modeled_speedups():
        print(f"{m['interconnect']},{m['n_clusters']},{m['speedup']:.3f},"
              f"{m['ideal']},{m['efficiency']:.4f}")
    rows = [r for size in sizes for r in measure(size, device)]
    if sizes:
        print_measured(rows, card_label(device))
    if throughput:
        print("## nominal GIPS (paper §1: 64 PEs @ >30 MHz -> >1.9 GIPS)")
        for n in (1, 2, 4, 8):
            cfg = ClusterConfig(n_clusters=n)
            print(f"gips,{cfg.total_pes},{cfg.nominal_gips():.2f}")
    return rows


def _parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--throughput", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)),
                    help="square product sizes to measure, comma-separated")
    args = ap.parse_args(argv)
    args.sizes = [int(s) for s in args.sizes.split(",") if s]
    return args


if __name__ == "__main__":
    args = _parse(sys.argv[1:])
    main(args.throughput, args.device, args.sizes)
