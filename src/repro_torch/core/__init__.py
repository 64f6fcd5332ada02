"""HERO's core contributions (C1-C5), ported from ``repro.core``.

offload  - C1: OpenMP-target-style offload runtime (copy vs zero-copy)
svm      - C1/C2: shared handle space between host and accelerator
rab      - C2: two-level software TLB + miss protocol + paged KV pool
cluster  - C3: cluster = one device of the cluster list
tracing  - C4: non-intrusive in-step event tracing, freeze-and-drain
analysis - C4: three-layer event analysis with definable assertions
buildflow- C5: graph-based config matrix flattening
"""
from repro_torch.core.rab import RAB, RABConfig, PagedKVPool, RABMiss
from repro_torch.core.svm import SVMSpace, AddressCollision
from repro_torch.core.offload import (
    OffloadTarget, OffloadReport, HostBackingStore,
)
from repro_torch.core.tracing import TraceBuffer, EventType, HOST_TRACER_ID
from repro_torch.core.cluster import (
    ClusterConfig, make_cluster_mesh, cluster_parallel_matmul,
    interconnect_model,
)
from repro_torch.core.buildflow import ConfigGraph, hero_test_matrix

__all__ = [
    "RAB", "RABConfig", "PagedKVPool", "RABMiss",
    "SVMSpace", "AddressCollision",
    "OffloadTarget", "OffloadReport", "HostBackingStore",
    "TraceBuffer", "EventType", "HOST_TRACER_ID",
    "ClusterConfig", "make_cluster_mesh", "cluster_parallel_matmul",
    "interconnect_model",
    "ConfigGraph", "hero_test_matrix",
]
