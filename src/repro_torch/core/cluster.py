"""Cluster abstraction (HERO §2.1/§3.2): the PMCA as clusters of PEs.

Ported from ``repro.core.cluster``.  HERO's PMCA is 1..8 clusters of 2..8
RISC-V PEs behind a bus-or-NoC system interconnect; §3.2 parallelizes
matmul row-wise over clusters and finds the bus binding at 8 clusters.
Here a *cluster* is one device of the list ``make_cluster_mesh`` returns
(the reference: one slice of a JAX mesh axis); the per-cluster compute is
the SPM-tiled matmul (``kernels/cluster_matmul``).  On one card that list
holds one device; runs over several wait for the sharded slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    n_clusters: int = 8            # Tab.1: 1,2,4,8
    pes_per_cluster: int = 8       # Tab.1: 2,4,8
    interconnect: str = "bus"      # Tab.1: bus | noc
    l1_spm_kib: int = 256
    clock_mhz: float = 31.0        # Juno ADP implementation (§3.1)

    @property
    def total_pes(self) -> int:
        return self.n_clusters * self.pes_per_cluster

    def nominal_gips(self) -> float:
        """§1: 64 cores @ >30 MHz -> >1.9 GIPS (1 instr/cycle/PE)."""
        return self.total_pes * self.clock_mhz * 1e6 / 1e9


def make_cluster_mesh(n_clusters: int, device: DeviceLike = None
                      ) -> List[torch.device]:
    """The first ``min(n_clusters, device count)`` devices: CUDA devices
    by default, or the one CPU for ``device="cpu"``."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev][:n_clusters]
    n = min(n_clusters, torch.cuda.device_count())
    return [torch.device("cuda", i) for i in range(n)]


def cluster_parallel_matmul(devices: Sequence[torch.device], a: torch.Tensor,
                            b: torch.Tensor,
                            per_cluster_fn: Optional[Callable] = None
                            ) -> torch.Tensor:
    """C = A @ B, A/C tiled row-wise over clusters (HERO §3.2's layout).

    Each cluster receives its row block of A and all of B, computes its
    row block of C with ``per_cluster_fn`` (default ``at @ bt``), and the
    blocks are concatenated on the first device.  The rows must divide
    evenly over the clusters, as the reference's sharding requires.
    """
    per_cluster_fn = per_cluster_fn or (lambda at, bt: at @ bt)
    n = len(devices)
    if n < 1:
        raise ValueError("no clusters")
    if a.shape[0] % n:
        raise ValueError(f"{a.shape[0]} rows do not split over {n} clusters")
    blocks = [per_cluster_fn(at.to(d), b.to(d))
              for at, d in zip(a.chunk(n, dim=0), devices)]
    return torch.cat([blk.to(devices[0]) for blk in blocks], dim=0)


def interconnect_model(cfg: ClusterConfig, total_bytes: int,
                       total_compute_s: float) -> dict:
    """Analytic bus-vs-NoC model reproducing Fig.4.

    DMA is double-buffered (overlapped with compute — the SPM/DMA model), so
    a cluster's runtime is max(compute, its transfer share).  On the *bus*
    all clusters' transfers serialize through one port; on the *NoC* they
    proceed in parallel.  With the paper's matmul intensity the bus only
    binds at 8 clusters (~2% below ideal), which calibrates the port
    bandwidth constant below.
    """
    n = cfg.n_clusters
    # bus port calibrated so serialized DMA = 1.02 x compute at 8 clusters
    bus_transfer_s = 1.02 * (total_compute_s / 8.0) * \
        (total_bytes / max(total_bytes, 1))
    if cfg.interconnect == "bus":
        transfer_s = bus_transfer_s                 # serialized, whole-job
    else:
        transfer_s = bus_transfer_s / n             # parallel links
    single = total_compute_s                        # 1 cluster, DMA hidden
    par = max(total_compute_s / n, transfer_s)
    return {
        "n_clusters": n,
        "interconnect": cfg.interconnect,
        "single_cluster_s": single,
        "parallel_s": par,
        "speedup": single / par,
        "ideal": n,
        "efficiency": (single / par) / n,
    }
