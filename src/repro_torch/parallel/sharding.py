"""How the sharded paged engine splits its weights and its state.

The port's counterpart of the serving half of ``repro.parallel.sharding``
(``head_param_pspecs`` and ``cluster_engine_specs``).  There, partition
specs tell ``shard_map`` how to lay arrays over a ``("cluster", "head")``
mesh.  Here one host program loops over the shards itself, so the same
decisions are made explicitly:

* request lanes, and their KV page shard, are split over ``cluster``;
* attention heads are split GQA-aware over ``head``: each head shard
  holds an equal contiguous block of the kv heads and, kv-major, the
  query heads that read them, so a query head stays with its kv head;
* everything else (embeddings, norms, MLP or MoE weights, the logits
  path) is shared, so on-device sampling needs nothing but the one
  reduction of the attention output a layer.

On a shared device a head shard's weights are views of the one copy:
nothing is copied, whatever the number of shards.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.paged_attention.ops import validate_head_sharding

#: attention leaves split over the head axis: leaf name -> the negative
#: index of its head dimension.  wq/wk/wv: (d, H|Kv, hd); wo: (H, hd, d);
#: q_norm/k_norm would be (H|Kv, hd), but the port's (and the
#: reference's) are one (hd,) scale shared by every head, which has no
#: head dimension and is therefore shared like any other leaf.
_HEAD_DIM_BY_NAME = {"wq": -2, "wk": -2, "wv": -2, "wo": -3,
                     "q_norm": -2, "k_norm": -2}


def head_param_views(model, heads: int, shard: int
                     ) -> List[Dict[str, torch.Tensor]]:
    """Per layer of ``model``, its attention leaves as head shard
    ``shard`` of ``heads`` sees them: each leaf with a head dimension
    narrowed to the shard's contiguous block of it (a view), every other
    leaf as it is.  Raises ``ValueError`` on a split that would cut a GQA
    group (``validate_head_sharding``)."""
    cfg = model.cfg
    validate_head_sharding(cfg.num_heads, cfg.num_kv_heads, heads)
    if not 0 <= shard < heads:
        raise ValueError(f"head shard {shard} of {heads}")
    out = []
    for lp in model.layers:
        views = {}
        for name, leaf in lp["attn"].items():
            dim = _HEAD_DIM_BY_NAME.get(name)
            if dim is None or leaf.dim() < -dim:
                views[name] = leaf
                continue
            n = leaf.shape[dim] // heads
            views[name] = leaf.narrow(dim, shard * n, n)
        out.append(views)
    return out


@dataclasses.dataclass(frozen=True)
class ClusterLayout:
    """Where the sharded engine's state lives.

    ``kv`` is the shape of each (cluster, head) shard's own contiguous
    K/V slab, ``(L, P+1, 2, page, Kv/H, hd)``, its trash page at local
    index ``P``; ``kv_scales`` its ``(L, P+1, 2, Kv/H)`` float32 scales
    (int8 pools); ``lanes[c]`` cluster c's rows of the engine-wide lane
    state (block tables, lengths, last tokens, active flags and the four
    sampling-policy rows).  Head shard h holds kv heads ``h * Kv/H ..``
    and their query heads."""
    kv: Tuple[int, ...]
    kv_scales: Tuple[int, ...]
    lanes: Tuple[slice, ...]


def cluster_engine_layout(cfg: ArchConfig, clusters: int, heads: int,
                          num_pages: int, page_size: int,
                          lanes_per_cluster: int) -> ClusterLayout:
    """The sharded engine's state layout for ``clusters`` x ``heads``
    shards of ``num_pages`` pages and ``lanes_per_cluster`` lanes each."""
    kvs = validate_head_sharding(cfg.num_heads, cfg.num_kv_heads, heads)
    L_, hd = cfg.num_layers, cfg.resolved_head_dim
    return ClusterLayout(
        kv=(L_, num_pages + 1, 2, page_size, kvs, hd),
        kv_scales=(L_, num_pages + 1, 2, kvs),
        lanes=tuple(slice(c * lanes_per_cluster, (c + 1) * lanes_per_cluster)
                    for c in range(clusters)))
