"""Per-device collective bytes, FLOPs and memory of an eager sharded step,
the counterpart of ``repro.launch.hlo_stats``.

The reference parses the SPMD-partitioned HLO text of a compiled step: its
collectives, its dot FLOPs, multiplied by the trip count of every while
loop that holds them, because ``cost_analysis`` counts a loop body once.
Eager PyTorch has no HLO and no loops to correct for: a layer loop is a
Python loop, and every op of every iteration is dispatched.  So
:class:`StepStats` watches the dispatch itself.  It is a
``TorchDispatchMode`` that steps aside for DTensor (it returns
``NotImplemented`` for any op on a DTensor, so DTensor's dispatch runs
and issues its local ops and its collectives), and records the ops on
one device's local shards:

* every ``_c10d_functional`` collective and DTensor's shard-to-shard
  all-to-all, as the reference's ``{kind: {count, operand_bytes,
  result_bytes}}``, the kinds named as in HLO (``all-reduce``,
  ``all-gather``, ``reduce-scatter``, ``all-to-all``); those issued
  inside a ``local_map`` region (``parallel.sharding.local_region``) are
  also summed per region;
* FLOPs by ``torch.utils.flop_counter``'s formulas, on the local shapes,
  with ``FlopCounterMode``'s rule for ops it has no formula for (their
  decomposition is counted): ``flops`` every op it counts, ``dot_flops``
  the matrix products, ``kernel_flops`` those inside a
  ``kernels.launch.kernel_scope``, the plain versions of the flash
  forward and the paged ops that stand in for hand-written kernels here.
  A dim DTensor could not split is computed whole on every device and
  counted so;
* the bytes of the storages the local ops create while they live:
  ``peak`` is the most alive at once beyond the storages that existed
  before (:meth:`track` registers the arguments').  A kernel's plain
  version makes temporaries its kernel never holds (a flash forward's
  score matrix), so the peak is not raised inside a kernel scope.

The fake process group's collectives move nothing, and a ``FakeTensorMode``
keeps every shard's storage unallocated, so a step of a 512-device mesh
is traced in one process.  :func:`dtensor_tracing` adjusts two things
DTensor does for itself while a dry-run traces.  Its sharding propagator
runs each op once more on fake tensors of the global shapes to learn the
output's shape: no device runs those, so nothing in the propagator is
recorded, and the propagator runs outside the trace's fake mode (it
makes its own for those ops; the index arithmetic of a strided layout
reads back small tensors, which a fake one cannot give; it runs outside
the fake mode wherever DTensor does it).  And on a CPU
mesh DTensor swaps the all-to-all of a shard-to-shard redistribute for
an all-gather and a chunk (gloo has no all-to-all), where a CUDA mesh
issues the all-to-all, which it restores.
"""
from __future__ import annotations

import contextlib
import contextvars
import weakref
from collections import defaultdict
from typing import Any, Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels.launch import KERNEL_SCOPES
from repro_torch.parallel.sharding import LOCAL_REGIONS

#: collective op name -> the HLO kind it is
COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "broadcast",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_dtensor")

_DOT_OPS = ("mm", "addmm", "bmm", "baddbmm", "_scaled_mm")

#: set while DTensor's sharding propagator runs (:func:`dtensor_tracing`)
_IN_PROPAGATION: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "repro_torch_in_propagation", default=False)


def total_collective_bytes(stats: Dict[str, Dict[str, float]]) -> float:
    """Per-device bytes on the wire, with per-kind ring-cost weights
    (the reference's): an all-reduce moves ~2x its operand
    (reduce-scatter then all-gather), an all-gather the larger of its
    result and operand, the others ~1x their operand."""
    total = 0.0
    for kind, d in stats.items():
        if kind == "all-reduce":
            total += 2.0 * d["operand_bytes"]
        elif kind == "all-gather":
            total += max(d["result_bytes"], d["operand_bytes"])
        else:
            total += d["operand_bytes"]
    return total


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def _skipped_ops():
    aten = torch.ops.aten
    return {aten.sym_is_contiguous.default, aten.is_contiguous.default,
            aten.is_contiguous.memory_format,
            aten.is_strides_like_format.default,
            aten.is_non_overlapping_and_dense.default, aten.size.default,
            aten.sym_size.default, aten.stride.default,
            aten.sym_stride.default, aten.storage_offset.default,
            aten.sym_storage_offset.default, aten.numel.default,
            aten.sym_numel.default, aten.dim.default,
            torch.ops.prim.layout.default}


class StepStats(TorchDispatchMode):
    """Collectives, FLOPs and live bytes of the local ops run under it
    (see the module docstring).  Enter it inside the ``FakeTensorMode``
    the step's tensors were made in."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        from torch.distributed._functional_collectives import (
            AsyncCollectiveTensor,
        )
        from torch.distributed.tensor import DTensor
        self._registry = flop_registry
        self._skip = _skipped_ops()
        self._decomposable: Dict[Any, bool] = {}
        #: tensor subclasses whose dispatch runs first (their local ops
        #: come back through this mode)
        self._wrappers = (DTensor, AsyncCollectiveTensor)
        self.collectives: Dict[str, Dict[str, float]] = defaultdict(
            lambda: {"count": 0, "operand_bytes": 0, "result_bytes": 0})
        self.regions: Dict[str, Dict[str, Any]] = defaultdict(
            lambda: {"collectives": 0, "bytes": 0.0, "kinds": {}})
        self.flops = 0
        self.dot_flops = 0
        self.kernel_flops = 0
        self.live = 0
        self.peak = 0
        self.base = 0
        self._storages: Dict[int, Any] = {}

    # -- memory ------------------------------------------------------------
    def _add(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return 0
        n = st.nbytes()

        def gone(_, key=key, n=n):
            self._storages.pop(key, None)
            self.live -= n
        self._storages[key] = weakref.ref(st, gone)
        self.live += n
        return n

    def track(self, tensors: Iterable[torch.Tensor]) -> int:
        """Register tensors alive before the step (a DTensor by its local
        shard); returns their storages' bytes, not counted twice."""
        from torch.distributed.tensor import DTensor
        n = 0
        for t in tensors:
            if isinstance(t, DTensor):
                t = t._local_tensor
            if isinstance(t, torch.Tensor):
                n += self._add(t)
        self.base = self.live
        self.peak = max(self.peak, self.live)
        return n

    @property
    def temp_bytes(self) -> int:
        """The most bytes alive at once beyond those alive at the start."""
        return self.peak - self.base

    # -- dispatch ----------------------------------------------------------
    def _decomposes(self, func) -> bool:
        """Whether ``FlopCounterMode`` would run ``func`` as its
        decomposition: no FLOP formula, and a CompositeImplicit kernel."""
        hit = self._decomposable.get(func)
        if hit is None:
            hit = (func._overloadpacket not in self._registry
                   and func is not torch.ops.prim.device.default
                   and torch._C._dispatch_has_kernel_for_dispatch_key(
                       func.name(),
                       torch._C.DispatchKey.CompositeImplicitAutograd))
            self._decomposable[func] = hit
        return hit

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, self._wrappers) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if func in self._skip or _IN_PROPAGATION.get() or isinstance(
                func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if self._decomposes(func):
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        packet = func._overloadpacket
        out = func(*args, **kwargs)
        in_kernel = bool(KERNEL_SCOPES.get())
        if packet in self._registry:
            f = self._registry[packet](*args, **kwargs, out_val=out)
            self.flops += f
            if packet.__name__ in _DOT_OPS:
                self.dot_flops += f
            if in_kernel:
                self.kernel_flops += f
        if func.namespace in _COLLECTIVE_NAMESPACES:
            kind = COLLECTIVE_KINDS.get(packet.__name__)
            if kind is not None:
                self._collective(kind, _bytes((args, kwargs)), _bytes(out))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self._add(t)
        if not in_kernel:
            self.peak = max(self.peak, self.live)
        return out

    def _collective(self, kind: str, operand: int, result: int):
        d = self.collectives[kind]
        d["count"] += 1
        d["operand_bytes"] += operand
        d["result_bytes"] += result
        regions = LOCAL_REGIONS.get()
        if regions:
            r = self.regions[regions[-1]]
            r["collectives"] += 1
            r["kinds"][kind] = r["kinds"].get(kind, 0) + 1
            r["bytes"] += total_collective_bytes(
                {kind: {"count": 1, "operand_bytes": operand,
                        "result_bytes": result}})

    def record(self) -> Dict[str, Any]:
        """The dry-run record's fields this mode measures."""
        coll = {k: dict(v) for k, v in self.collectives.items()}
        return {
            "cost": {"flops": float(self.flops)},
            "dot_flops": float(self.dot_flops),
            "kernel_flops": float(self.kernel_flops),
            "collectives": coll,
            "collective_bytes": total_collective_bytes(coll),
            "local_regions": {k: {**v, "kinds": dict(v["kinds"])}
                              for k, v in self.regions.items()},
        }


@contextlib.contextmanager
def dtensor_tracing():
    """While a dry-run traces: nothing DTensor's sharding propagator runs
    is recorded, and a shard-to-shard redistribute issues DTensor's
    all-to-all op (as on a CUDA mesh) instead of gloo's all-gather and
    chunk; the op's fake implementation gives the shape."""
    import torch.distributed.tensor.placement_types as pt
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    name = "propagate_op_sharding_non_cached"
    propagate = getattr(ShardingPropagator, name, None)
    if propagate is None:
        raise RuntimeError(f"this torch's DTensor has no "
                           f"ShardingPropagator.{name} to keep out of the "
                           "count")

    def quiet(self, *a, **k):
        tok = _IN_PROPAGATION.set(True)
        try:
            with unset_fake_temporarily():
                return propagate(self, *a, **k)
        finally:
            _IN_PROPAGATION.reset(tok)

    original = getattr(pt, "shard_dim_alltoall", None)

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    # a strided layout's index arithmetic, outside the fake mode
    strided = getattr(pt, "_StridedShard", None)
    real = {}
    for attr in ("local_shard_size_and_offset",
                 "_local_shard_size_and_offset"):
        fn = strided.__dict__.get(attr) if strided is not None else None
        if fn is None:
            continue
        real[attr] = fn
        inner = fn.__func__ if isinstance(fn, staticmethod) else fn

        def unfaked(*a, _inner=inner, **k):
            with unset_fake_temporarily():
                return _inner(*a, **k)
        setattr(strided, attr, staticmethod(unfaked)
                if isinstance(fn, staticmethod) else unfaked)

    setattr(ShardingPropagator, name, quiet)
    if original is not None:
        pt.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, propagate)
        if original is not None:
            pt.shard_dim_alltoall = original
        for attr, fn in real.items():
            setattr(strided, attr, fn)
