"""The serving mesh and the hardware constants of the card the port runs
on (the roofline and the capacity planner's target).

``ClusterMesh`` / ``make_serving_mesh`` are the port's counterparts of
``repro.launch.mesh``'s: a cluster-major grid of C x H devices with the
axis names ``("cluster", "head")``.  The sharded engine
(``runtime.sharded_server``) runs one program over it from one host
scheduler.  Shards may share a device, and by default every shard sits
on the engine's one device; a grid over several distinct devices raises
``NotImplementedError`` (the transport between cards is not written).

The constants are the peak bf16 operation rate and the HBM byte rate of
one NVIDIA H100, as ``chip_smoke.py`` phase 15 measures them (a bf16
``torch.matmul`` at 8192^3 and a device-to-device copy of 1 GiB, 2 GiB
moved; medians of CUDA-event times).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple, Union

import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class ClusterMesh:
    """The serving engine's device mesh: C PMCA clusters x H head shards.

    HERO §2.1: the PMCA scales by adding clusters behind one SVM fabric.
    The serving adaptation maps each cluster to a data-parallel lane group
    with its own KV page shard, and splits attention heads (GQA-aware)
    tensor-parallel inside a cluster over the ``head`` axis.  ``grid``
    holds each shard's device, cluster-major: ``grid[c][h]``.
    """

    grid: Tuple[Tuple[torch.device, ...], ...]
    clusters: int
    heads: int

    AXIS_NAMES = ("cluster", "head")

    @property
    def devices(self) -> int:
        return self.clusters * self.heads

    @property
    def device(self) -> torch.device:
        """The one device every shard sits on."""
        return self.grid[0][0]


def make_serving_mesh(clusters: int = 1, heads: int = 1,
                      devices: Union[DeviceLike,
                                     Sequence[DeviceLike]] = None
                      ) -> ClusterMesh:
    """Build the ``("cluster", "head")`` serving mesh.

    ``devices`` is one device for every shard (``None``: ``cuda``, as
    every entry point of the port) or ``clusters * heads`` devices,
    cluster-major.  Shards may share a device; a grid naming more than
    one distinct device raises ``NotImplementedError``."""
    if clusters < 1 or heads < 1:
        raise ValueError(f"mesh {clusters}x{heads}: both axes must be >= 1")
    n = clusters * heads
    if devices is None or isinstance(devices, (str, torch.device)):
        listed = [devices] * n
    else:
        listed = list(devices)
        if len(listed) != n:
            raise ValueError(f"mesh {clusters}x{heads} needs {n} devices, "
                             f"got {len(listed)}")
    distinct = {None if d is None else torch.device(d) for d in listed}
    if len(distinct) > 1:
        raise NotImplementedError(
            f"mesh {clusters}x{heads} over {len(distinct)} devices "
            f"{sorted(map(str, distinct))}: the shards of a mesh share one "
            "device until a mesh over several GPUs (peer copies or NCCL "
            "between the shards' cards; ROADMAP.md Queue 2) lands")
    dev = resolve_device(listed[0])
    grid = tuple(tuple(dev for _ in range(heads)) for _ in range(clusters))
    return ClusterMesh(grid=grid, clusters=clusters, heads=heads)


# Measured on NVIDIA H100 80GB HBM3, 700.00 W (chip_smoke.py phase 15:
# 8192^3 in 1.3762 ms, a 1 GiB copy in 0.7135 ms).  The data sheet's
# dense figures, for comparison: 989e12 FLOP/s (bf16), 3.35e12 bytes/s.
PEAK_FLOPS_BF16 = 7.98961e14   # FLOP/s per card
HBM_BW = 3.00984e12            # bytes/s per card
