"""Cluster abstraction (HERO §2.1/§3.2): the PMCA as clusters of PEs.

Ported from ``repro.core.cluster``.  HERO's PMCA is 1..8 clusters of 2..8
RISC-V PEs behind a bus-or-NoC system interconnect; §3.2 parallelizes
matmul row-wise over clusters and finds the bus binding at 8 clusters.
The per-cluster compute is the SPM-tiled matmul
(``kernels/cluster_matmul``).

A cluster is one of two things here:

* a device of the list ``make_cluster_mesh`` returns (the reference: one
  slice of a JAX mesh axis); on the CPU that list is the one CPU, and on
  one card it holds one device;
* a :class:`CardCluster` of ``make_card_clusters``: a share of one card,
  the counterpart of the reference's measured setup, where 8 virtual
  devices each run one cluster.  Each has its own CUDA stream and a
  budget of ``multi_processor_count // MAX_CLUSTERS`` SMs (16 on the
  132-SM H100: HERO's PMCA has at most 8 clusters, Tab.1).  The card's
  HBM and L2, which every cluster's blocks share, play the part of the
  PMCA's system interconnect.  A budget caps the blocks a cluster's
  launch keeps in flight (``kernel.matmul(..., sms=)``); the hardware
  scheduler, not this code, places them on SMs, so two clusters' blocks
  may share an SM while another idles.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Union

import torch

from repro_torch.device import DeviceLike, resolve_device

#: the PMCA's most clusters (Tab.1): a card is cut into this many SM
#: budgets, whatever number of clusters runs
MAX_CLUSTERS = 8


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


@dataclasses.dataclass(frozen=True)
class CardCluster:
    """One PMCA cluster on a shared card: its device, its SM budget and
    the stream its work runs on."""
    device: torch.device
    sms: int
    stream: torch.cuda.Stream


def make_card_clusters(n_clusters: int, device: DeviceLike = None
                       ) -> List[CardCluster]:
    """``n_clusters`` (1..:data:`MAX_CLUSTERS`) clusters on one CUDA card,
    each on a new stream with a budget of the card's SMs //
    :data:`MAX_CLUSTERS` (read from the device's properties)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"clusters share a CUDA card, not {dev}; on the "
                         "CPU use make_cluster_mesh")
    if not 1 <= n_clusters <= MAX_CLUSTERS:
        raise ValueError(f"{n_clusters} clusters: the PMCA has 1 to "
                         f"{MAX_CLUSTERS}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count \
        // MAX_CLUSTERS
    return [CardCluster(dev, sms, torch.cuda.Stream(dev))
            for _ in range(n_clusters)]


def budgeted_matmul(at: torch.Tensor, bt: torch.Tensor, sms: int
                    ) -> torch.Tensor:
    """The cluster matmul kernel within a budget of ``sms`` SMs: a card
    cluster's default body."""
    from repro_torch.kernels.cluster_matmul import kernel as K
    return K.matmul(at.contiguous(), bt.contiguous(), sms=sms)


def cluster_parallel_matmul(clusters: Sequence[Union[torch.device,
                                                      CardCluster]],
                            a: torch.Tensor, b: torch.Tensor,
                            per_cluster_fn: Optional[Callable] = None
                            ) -> torch.Tensor:
    """C = A @ B, A/C tiled row-wise over clusters (HERO §3.2's layout).

    Each cluster receives its row block of A and all of B, computes its
    row block of C with ``per_cluster_fn``, and the blocks are
    concatenated.  The rows must divide evenly over the clusters, as the
    reference's sharding requires.

    ``clusters`` is a list of devices (``per_cluster_fn(at, bt)``, default
    ``at @ bt``; the blocks are gathered on the first device) or of
    :class:`CardCluster`s of one card (``per_cluster_fn(at, bt, sms)``,
    default :func:`budgeted_matmul`): each cluster's block is launched on
    its own stream within its budget, after the work the caller's stream
    has queued, all of them in flight together, and the blocks join on
    the caller's stream.
    """
    n = len(clusters)
    if n < 1:
        raise ValueError("no clusters")
    if a.shape[0] % n:
        raise ValueError(f"{a.shape[0]} rows do not split over {n} clusters")
    if not isinstance(clusters[0], CardCluster):
        per_cluster_fn = per_cluster_fn or (lambda at, bt: at @ bt)
        blocks = [per_cluster_fn(at.to(d), b.to(d))
                  for at, d in zip(a.chunk(n, dim=0), clusters)]
        return torch.cat([blk.to(clusters[0]) for blk in blocks], dim=0)
    per_cluster_fn = per_cluster_fn or budgeted_matmul
    dev = clusters[0].device
    if any(not isinstance(c, CardCluster) or c.device != dev
           for c in clusters) or a.device != dev or b.device != dev:
        raise ValueError("card clusters, A and B must share one device")
    caller = torch.cuda.current_stream(dev)
    blocks = []
    for at, c in zip(a.chunk(n, dim=0), clusters):
        c.stream.wait_stream(caller)
        with torch.cuda.stream(c.stream):
            blk = per_cluster_fn(at, b, c.sms)
        # the caller's stream reads the block; its memory must not be
        # reused on the cluster's stream before that
        blk.record_stream(caller)
        blocks.append(blk)
    for c in clusters:
        caller.wait_stream(c.stream)
    return torch.cat(blocks, dim=0)


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
