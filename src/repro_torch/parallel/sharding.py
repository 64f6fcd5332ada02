"""Logical-axis sharding, the port of ``repro.parallel.sharding``.

Model code never names physical mesh axes.  It uses *logical* axes:

  ``dp``    batch dim                -> ("pod", "data")
  ``fsdp``  ZeRO-3 param shard dim   -> ("pod", "data")
  ``tp``    tensor-parallel dim      -> ("model",)   (heads / d_ff / vocab)
  ``sp``    sequence-parallel dim    -> ("model",)   (long KV seq dim)
  ``ep``    expert-parallel dim      -> ("model",)
  ``None``  replicated

under one of three :data:`PROFILES` (the reference's, letter for
letter).  :func:`logical_pspec` translates a shape and its logical axes
into the reference's partition, a tuple of mesh-axis names per tensor
dim, with its rules: a prefix of the physical axes whose product
divides the dim, no mesh axis used twice, axes of size 1 dropped
(hymba's 25 heads stay whole on a 16-way ``model`` axis).  A mesh is a
``torch.distributed`` ``DeviceMesh`` with named dims, or for the
partition alone any mapping of axis name to size.  :func:`placements`
turns the partition into DTensor placements and :func:`shard` is the
activation constraint: under :func:`mesh_context` it redistributes a
DTensor to its logical placement, and without a mesh (the engines, the
trainer) it returns its argument untouched.

The second half is the sharded paged engine's layout: request lanes,
and their KV page shard, split over ``cluster``; attention heads split
GQA-aware over ``head``: each head shard holds an equal contiguous block
of the kv heads and, kv-major, the query heads that read them; every
other leaf shared.  There one host program loops over the shards
itself, and on a shared device a head shard's weights are views of the
one copy.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import (Any, Dict, List, Mapping, Optional, Sequence, Tuple,
                    Union)

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.paged_attention.ops import validate_head_sharding

#: Sharding profiles:
#:   megatron: TP over `model` for heads/ff/vocab + ZeRO-3 over `pod,data`
#:   fsdp:     pure ZeRO-3 over the whole mesh (no TP): weights gathered
#:             per layer instead of activations
#:   serve:    TP only, no weight sharding over data: weights resident
#:             per model shard, no weight gathers per token
PROFILES = {
    "megatron": {
        "dp": ("pod", "data"),
        "fsdp": ("pod", "data"),
        "tp": ("model",),
        "sp": ("model",),
        "ep": ("model",),
    },
    "fsdp": {
        "dp": ("pod", "data", "model"),
        "fsdp": ("pod", "data", "model"),
        "tp": (),
        "sp": (),
        "ep": ("model",),
    },
    "serve": {
        "dp": ("pod", "data"),
        "fsdp": (),
        "tp": ("model",),
        "sp": ("model",),
        "ep": ("model",),
    },
}

#: a mesh dim's partition entry: replicated, one axis, or several (major
#: first)
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]

_PROFILE: contextvars.ContextVar[str] = contextvars.ContextVar(
    "repro_torch_profile", default="megatron")
_MESH: contextvars.ContextVar[Any] = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


@contextlib.contextmanager
def sharding_profile(name: str):
    if name not in PROFILES:
        raise ValueError(f"profile {name!r} not in {list(PROFILES)}")
    tok = _PROFILE.set(name)
    try:
        yield
    finally:
        _PROFILE.reset(tok)


def current_profile() -> str:
    return _PROFILE.get()


@contextlib.contextmanager
def mesh_context(mesh):
    """Make ``mesh`` (a ``DeviceMesh``, or None) the one :func:`shard`
    and the model's mesh-aware layers read."""
    tok = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(tok)


def current_mesh():
    return _MESH.get()


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` or of a mapping (none for no
    mesh)."""
    if mesh is None:
        return {}
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _physical_axes(logical: Optional[str], sizes: Mapping[str, int]
                   ) -> Tuple[str, ...]:
    if logical is None:
        return ()
    phys = PROFILES[_PROFILE.get()].get(logical, ())
    return tuple(a for a in phys if a in sizes)


def logical_pspec(shape: Sequence[int], axes: Sequence[Optional[str]],
                  mesh) -> Spec:
    """The reference's divisibility-safe partition of ``shape`` annotated
    with logical ``axes``: per tensor dim None, a mesh-axis name or a
    tuple of them, trailing Nones dropped."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} vs axes {tuple(axes)}")
    sizes = axis_sizes(mesh)
    used: set = set()
    out: List[Any] = []
    for dim, name in zip(shape, axes):
        phys = tuple(a for a in _physical_axes(name, sizes)
                     if a not in used and sizes[a] > 1)
        kept: List[str] = []
        prod = 1
        for a in phys:
            if dim % (prod * sizes[a]) == 0:
                kept.append(a)
                prod *= sizes[a]
        if kept:
            used.update(kept)
            out.append(tuple(kept) if len(kept) > 1 else kept[0])
        else:
            out.append(None)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def placements(shape: Sequence[int], axes: Sequence[Optional[str]],
               mesh) -> tuple:
    """DTensor placements of :func:`logical_pspec`: ``Shard(d)`` on each
    mesh dim that tensor dim d names, ``Replicate()`` elsewhere.  Mesh
    dims are named in the mesh's own order, the major axis first, which
    is the order DTensor shards a dim over several mesh dims in."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out: List[Any] = [Replicate()] * len(names)
    for d, entry in enumerate(logical_pspec(shape, axes, mesh)):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else entry
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"dim {d} sharded over {group}, not in the "
                             f"mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def shard(x: torch.Tensor, *axes: Optional[str],
          grad: Optional[Sequence[Optional[str]]] = None) -> torch.Tensor:
    """The activation constraint: under a mesh, a DTensor redistributed
    to its logical placement, and its gradient too (the transpose of the
    reference's ``with_sharding_constraint`` constrains the cotangent
    alike), or to ``grad``'s where given; without a mesh, or for a plain
    tensor, ``x`` itself."""
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    want = placements(x.shape, axes, mesh)
    back = want if grad is None else placements(x.shape, grad, mesh)
    return _Constrain.apply(x, mesh, want, back)


class _Constrain(torch.autograd.Function):
    """A DTensor redistributed to one placement, its gradient to
    another."""

    @staticmethod
    def forward(ctx, x, mesh, want, back):
        ctx.mesh, ctx.back = mesh, back
        if tuple(x.placements) == want:
            return x.view_as(x)
        return x.redistribute(mesh, want)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.back:
            g = g.redistribute(ctx.mesh, ctx.back)
        return g, None, None, None


#: the ``local_map`` regions the running code is inside, innermost last
#: (a tracer attributes the collectives that lay out a region's inputs
#: to it)
LOCAL_REGIONS: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "repro_torch_local_regions", default=())


def local_region(name: str, fn, args: Sequence[Any], in_placements,
                 out_placements):
    """``fn(*args)`` on the local shards of its DTensor args, the
    counterpart of the reference's ``shard_map``: each DTensor arg is
    redistributed to its entry of ``in_placements`` (None for an arg
    that is no tensor), ``fn`` runs on the local tensors, and each of its
    outputs becomes a DTensor with its entry of ``out_placements``
    (``torch.distributed.tensor.experimental.local_map``).  A plain
    tensor arg counts as replicated, as under DTensor's implicit
    replication.  Without a mesh, or with no DTensor among ``args``,
    ``fn(*args)`` itself.

    Gradients follow the transpose rule of the reference's ``shard_map``
    (``check_rep=False``): an output replicated over mesh dims has its
    gradient divided by their size on each device, and an input
    replicated over mesh dims gets a gradient that is partial over them
    (summed across the devices), so a replicated computation counts
    once."""
    mesh = current_mesh()
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if mesh is None or not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map
    repl = (Replicate(),) * mesh.ndim
    args = [DTensor.from_local(a, mesh, repl, run_check=False)
            if isinstance(a, torch.Tensor) and not isinstance(a, DTensor)
            else a for a in args]
    grad_pl = tuple(None if p is None else tuple(
        Partial() if isinstance(x, Replicate) else x for x in p)
        for p in in_placements)
    scales = [1.0 if p is None else 1.0 / _replicas(p, mesh)
              for p in out_placements]

    def body(*a):
        out = fn(*a)
        if not torch.is_grad_enabled() or all(s == 1.0 for s in scales):
            return out
        if isinstance(out, torch.Tensor):
            return _ScaleGrad.apply(out, scales[0])
        return type(out)(_ScaleGrad.apply(o, s)
                         if isinstance(o, torch.Tensor) and s != 1.0 else o
                         for o, s in zip(out, scales))

    tok = LOCAL_REGIONS.set(LOCAL_REGIONS.get() + (name,))
    try:
        return local_map(body, tuple(out_placements), tuple(in_placements),
                         grad_pl, device_mesh=mesh,
                         redistribute_inputs=True)(*args)
    finally:
        LOCAL_REGIONS.reset(tok)


def _replicas(pl, mesh) -> int:
    """The number of devices holding the same values under placements
    ``pl``: the product of the sizes of the mesh dims it replicates."""
    from torch.distributed.tensor import Replicate
    n = 1
    for size, p in zip(mesh.shape, pl):
        if isinstance(p, Replicate):
            n *= size
    return n


class _ScaleGrad(torch.autograd.Function):
    """The identity, with its gradient scaled."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def pspec_entry(shape: Sequence[int], axes: Sequence[Optional[str]], mesh,
                dim: int):
    """Dim ``dim``'s entry of :func:`logical_pspec` (None past its end)."""
    spec = logical_pspec(shape, axes, mesh)
    return spec[dim] if dim < len(spec) else None


def shard_index(mesh, entry) -> Tuple[int, int]:
    """(this device's index, the count) of the shards a partition entry
    (None, an axis name or a tuple, major first) cuts a dim into."""
    idx, n = 0, 1
    for a in ((entry,) if isinstance(entry, str) else entry or ()):
        size = axis_sizes(mesh)[a]
        idx = idx * size + mesh.get_local_rank(a)
        n *= size
    return idx, n


def axis_group(mesh, entry):
    """The process group a partition entry's axes form, as the
    functional collectives take it (None for no axis).  One axis only."""
    axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
    if not axes:
        return None
    if len(axes) > 1:
        raise NotImplementedError(f"a collective over {axes}")
    return (mesh, list(mesh.mesh_dim_names).index(axes[0]))


def heads_axis(heads: int) -> Optional[str]:
    """``"tp"`` where the current mesh's ``tp`` split divides ``heads``,
    else None: the axis a (B, S, heads * hd) activation may be split
    over without cutting a head."""
    sizes = axis_sizes(current_mesh())
    tp = 1
    for a in _physical_axes("tp", sizes):
        tp *= sizes[a]
    return "tp" if heads % tp == 0 else None


class Axes:
    """A leaf carrying a logical-axes annotation."""

    __slots__ = ("axes",)

    def __init__(self, axes: Sequence[Optional[str]]):
        self.axes = tuple(axes)

    def __repr__(self):
        return f"Axes{self.axes}"


def tree_map_axes(fn, spec_tree, axes_tree):
    """``fn(spec, axes)`` over two trees of one structure (nested dicts
    and lists), ``axes_tree``'s leaves :class:`Axes`."""
    if isinstance(axes_tree, Axes):
        return fn(spec_tree, axes_tree.axes)
    if isinstance(axes_tree, Mapping):
        return {k: tree_map_axes(fn, spec_tree[k], v)
                for k, v in axes_tree.items()}
    return [tree_map_axes(fn, s, a) for s, a in zip(spec_tree, axes_tree)]


def _shape_of(spec) -> Tuple[int, ...]:
    """A spec leaf's shape: a tensor's, or a ``(shape, dtype)`` pair's."""
    return tuple(spec.shape) if hasattr(spec, "shape") else tuple(spec[0])


def tree_pspecs(spec_tree, axes_tree, mesh):
    """Partition tree from a tree of shapes (``(shape, dtype)`` pairs or
    tensors) and its :class:`Axes` tree."""
    return tree_map_axes(
        lambda s, ax: logical_pspec(_shape_of(s), ax, mesh),
        spec_tree, axes_tree)


def tree_placements(spec_tree, axes_tree, mesh):
    """DTensor placement tree, the counterpart of :func:`tree_pspecs`."""
    return tree_map_axes(
        lambda s, ax: placements(_shape_of(s), ax, mesh),
        spec_tree, axes_tree)


# ---------------------------------------------------------------------------
# The sharded paged engine's layout (the ``("cluster", "head")`` mesh)
# ---------------------------------------------------------------------------

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
