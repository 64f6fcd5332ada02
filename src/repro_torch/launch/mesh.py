"""The serving mesh, the production meshes of the dry-run, and the
hardware constants of the card the port runs on (the roofline and the
capacity planner's target).

``ClusterMesh`` / ``make_serving_mesh`` are the port's counterparts of
``repro.launch.mesh``'s: a cluster-major grid of C x H devices with the
axis names ``("cluster", "head")``.  The sharded engine
(``runtime.sharded_server``) runs one program over it from one host
scheduler.  Shards may share a device, and by default every shard sits
on the engine's one device; a grid over several distinct devices raises
``NotImplementedError`` (the transport between cards is not written).

``make_production_mesh`` and ``make_local_mesh`` build the
``torch.distributed`` ``DeviceMesh`` the sharding layer
(``parallel.sharding``) lays tensors over: ``("data", "model")`` of
(16, 16), or ``("pod", "data", "model")`` of (2, 16, 16) with
``multi_pod``.  With no process group of its own, the process gets a
fake one of the mesh's size (``torch.testing``'s ``FakeStore`` with the
``fake`` backend): its collectives move nothing and return tensors of
the right shape, so the dry-run (``launch.dryrun``) traces a step of a
512-card mesh in one process on the CPU.  They are functions, so
importing this module starts no process group.

The constants are the peak bf16 operation rate and the HBM byte rate of
one NVIDIA H100, as ``chip_smoke.py`` phase 15 measures them (a bf16
``torch.matmul`` at 8192^3 and a device-to-device copy of 1 GiB, 2 GiB
moved; medians of CUDA-event times).
"""
from __future__ import annotations

import dataclasses
import math
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


#: NVLink 4 between two cards of an H100 SXM host, one direction, from
#: the data sheet's 900 GB/s bidirectional total; not measured (a
#: one-card machine has no link to time).
NVLINK_BW = 4.5e11             # bytes/s per card, data sheet
#: The cards one NVLink domain joins: the 8 of an HGX / DGX H100 host.
NVLINK_DOMAIN = 8
#: Between hosts: one 400 Gb/s ConnectX-7 (InfiniBand NDR) port per card
#: on a DGX H100, one direction, from its data sheet; not measured.
INTERNODE_BW = 400e9 / 8       # bytes/s per card, data sheet


def link_bw(devices: int) -> float:
    """The per-card rate the roofline's collective term prices a mesh of
    ``devices`` cards at: NVLink's within one host, else the inter-host
    rate.  On the production meshes every axis's groups cross hosts
    (``model``'s 16 consecutive cards span two hosts, ``data`` and
    ``pod`` take one card of each of 16 or 2 hosts), and a ring moves at
    its slowest link.  A mesh of more than 8 cards whose collectives all
    stay on an inner axis of at most 8 would run faster than this."""
    return NVLINK_BW if devices <= NVLINK_DOMAIN else INTERNODE_BW


def _fake_world(size: int):
    """This process as rank 0 of a fake process group of ``size`` ranks
    (a fake group of another size is replaced)."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == size:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()} process group of "
                f"{dist.get_world_size()} ranks is running: a mesh of "
                f"{size} devices needs that many ranks")
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def release_fake_world():
    """End the fake process group :func:`make_local_mesh` or
    :func:`make_production_mesh` started, if one runs."""
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()


def _mesh(shape: Tuple[int, ...], names: Tuple[str, ...]):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = math.prod(shape)
    if not (dist.is_initialized() and dist.get_backend() != "fake"):
        _fake_world(n)
    elif dist.get_world_size() != n:
        raise RuntimeError(f"mesh {shape} needs {n} ranks, the process "
                           f"group has {dist.get_world_size()}")
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    """``("data", "model")`` (16, 16), or with ``multi_pod``
    ``("pod", "data", "model")`` (2, 16, 16), on a fake process group."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"))
    return _mesh((16, 16), ("data", "model"))


def make_local_mesh(data: int = 1, model: int = 1):
    """A ``("data", "model")`` mesh over the running process group (a
    ``gloo`` group of ``data * model`` ranks), or over a fake one of that
    size where none runs."""
    return _mesh((data, model), ("data", "model"))
