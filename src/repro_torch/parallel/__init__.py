"""The serving mesh's sharding: head-shard weight views and the cluster /
head layout of the sharded engine's state (``parallel.sharding``)."""
from repro_torch.parallel.sharding import (
    ClusterLayout, cluster_engine_layout, head_param_views,
)

__all__ = ["ClusterLayout", "cluster_engine_layout", "head_param_views"]
