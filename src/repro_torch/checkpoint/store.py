"""Checkpointing with atomic commit and async save, the port of
``repro.checkpoint.store``, in the same on-disk format:

    <root>/step_<N>/
        metadata.json        tree paths, shapes, logical dtypes
        <leafpath>.npy       one file per leaf
        COMMITTED            commit marker (written last; the directory is
                             renamed into place with os.replace)

Types numpy cannot write (bfloat16, float8) are stored as a same-width
unsigned-integer view with their logical dtype in the metadata, as the
reference's ``_VIEW_SAVE`` does, and restored through torch
(``torch.from_numpy(u16).view(torch.bfloat16)``), so no ``ml_dtypes`` is
needed.  A checkpoint written by either package restores in the other.
Leaves may be torch tensors (any device) or numpy arrays; restored leaves
are CPU torch tensors.

Sharded state (the reference's elastic reshard): a leaf may be a
``DTensor`` laid over a ``DeviceMesh``.  Saving gathers each such leaf's
full tensor on every rank (a collective, in path order), rank 0 alone
writes and commits, and every rank returns after a barrier.
``restore_checkpoint(..., shardings=, mesh=)`` takes a tree of DTensor
placements (as ``parallel.sharding.tree_placements`` builds it) and
returns each leaf it names as a DTensor with those placements on
``mesh``, whatever mesh it was saved from: each rank reads whole leaves
from disk, as the reference does, and keeps only its local shard.
"""
from __future__ import annotations

import concurrent.futures as cf
import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

# logical dtype -> (the .npy integer view, the torch dtype it views)
_VIEW = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}
_TORCH_VIEW = {td: (name, np.dtype(nd)) for name, (nd, td) in _VIEW.items()}


def _flatten_with_paths(tree: Any) -> List[Tuple[str, Any]]:
    out: List[Tuple[str, Any]] = []

    def visit(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                visit(node[k], prefix + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                visit(v, prefix + [str(i)])
        else:
            out.append(("/".join(prefix), node))

    visit(tree, [])
    return out


def _unflatten_like(like: Any, values: Dict[str, Any]) -> Any:
    def visit(node, prefix):
        if isinstance(node, dict):
            return {k: visit(node[k], prefix + [str(k)]) for k in node}
        if isinstance(node, (list, tuple)):
            t = [visit(v, prefix + [str(i)]) for i, v in enumerate(node)]
            return type(node)(t)
        return values["/".join(prefix)]

    return visit(like, [])


def _nest(values: Dict[str, Any]) -> Dict[str, Any]:
    """Nested dicts from ``a/b/c`` paths."""
    out: Dict[str, Any] = {}
    for path, v in values.items():
        *heads, last = path.split("/")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def _to_numpy(leaf: Any) -> Tuple[np.ndarray, str]:
    """(the array to write, its logical dtype)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype in _TORCH_VIEW:
            name, nd = _TORCH_VIEW[t.dtype]
            signed = torch.int16 if nd.itemsize == 2 else torch.uint8
            return t.view(signed).numpy().view(nd), name
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    logical = str(arr.dtype)
    if logical in _VIEW:
        return arr.view(_VIEW[logical][0]), logical
    return arr, logical


def _to_tensor(arr: np.ndarray, logical: str) -> torch.Tensor:
    if not arr.flags.c_contiguous:
        arr = arr.copy()
    if logical in _VIEW:
        nd, td = _VIEW[logical]
        signed = np.int16 if np.dtype(nd).itemsize == 2 else np.uint8
        return torch.from_numpy(arr.view(signed)).view(td)
    return torch.from_numpy(arr)


def _is_dtensor(x: Any) -> bool:
    if not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _gathered(flat: List[Tuple[str, Any]]) -> Tuple[List[Tuple[str, Any]],
                                                    bool]:
    """``flat`` with every DTensor leaf replaced by its full tensor (a
    collective on every rank, in ``flat``'s order), and whether there was
    one."""
    sharded = any(_is_dtensor(leaf) for _, leaf in flat)
    if not sharded:
        return flat, False
    return [(path, leaf.full_tensor() if _is_dtensor(leaf) else leaf)
            for path, leaf in flat], True


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank()


def _barrier() -> None:
    import torch.distributed as dist
    dist.barrier()


def _write(root: str, step: int, flat: List[Tuple[str, Any]]) -> str:
    """Write ``(path, leaf)`` pairs as step ``step`` and commit it."""
    root_p = Path(root)
    root_p.mkdir(parents=True, exist_ok=True)
    final = root_p / f"step_{step:08d}"
    tmp = Path(tempfile.mkdtemp(prefix=f".tmp_step_{step}_", dir=root))
    try:
        meta = {"step": step, "leaves": {}}
        for path, leaf in flat:
            arr, logical = _to_numpy(leaf)
            fn = path.replace("/", "__") + ".npy"
            np.save(tmp / fn, arr)
            meta["leaves"][path] = {"file": fn, "shape": list(arr.shape),
                                    "dtype": logical}
        (tmp / "metadata.json").write_text(json.dumps(meta))
        (tmp / "COMMITTED").write_text("ok")
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return str(final)


def save_checkpoint(root: str, step: int, state: Any) -> str:
    """Atomic synchronous save.  Returns the committed directory.  With
    DTensor leaves every rank of their process group must call it: the
    leaves are gathered, rank 0 writes, and all return after a
    barrier."""
    flat, sharded = _gathered(_flatten_with_paths(state))
    if not sharded:
        return _write(root, step, flat)
    try:
        if _rank() == 0:
            _write(root, step, flat)
    finally:
        _barrier()
    return str(Path(root) / f"step_{step:08d}")


def latest_step(root: str) -> Optional[int]:
    p = Path(root)
    if not p.exists():
        return None
    steps = []
    for d in p.iterdir():
        if d.name.startswith("step_") and (d / "COMMITTED").exists():
            steps.append(int(d.name.split("_")[1]))
    return max(steps) if steps else None


def _placement_leaves(tree: Any) -> Dict[str, tuple]:
    """Path -> placements of a tree whose leaves are tuples of DTensor
    ``Placement``s (``tree_placements``' form)."""
    from torch.distributed.tensor.placement_types import Placement
    out: Dict[str, tuple] = {}

    def visit(node, prefix):
        if isinstance(node, tuple) and node \
                and all(isinstance(p, Placement) for p in node):
            out["/".join(prefix)] = node
        elif isinstance(node, dict):
            for k in sorted(node):
                visit(node[k], prefix + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                visit(v, prefix + [str(i)])
        else:
            raise TypeError(f"{'/'.join(prefix)}: {node!r} is no tuple of "
                            "placements")

    visit(tree, [])
    return out


def _distribute(full: torch.Tensor, mesh, placements: tuple):
    """``full`` as a DTensor on ``mesh`` with ``placements``, holding only
    this rank's shard (cut locally: every rank has read ``full``)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    d = distribute_tensor(full, mesh, placements, src_data_rank=None)
    local = d.to_local()
    if local.untyped_storage().nbytes() > local.numel() * local.element_size():
        d = DTensor.from_local(local.clone(), mesh, placements,
                               run_check=False, shape=d.shape,
                               stride=d.stride())
    return d


def restore_checkpoint(root: str, like: Any = None,
                       step: Optional[int] = None,
                       shardings: Any = None,
                       mesh: Any = None) -> Tuple[Any, int]:
    """Load a committed checkpoint as CPU tensors, shaped like ``like``
    (any tree with the same paths) or, without one, as nested dicts from
    the stored paths.

    ``shardings`` (with its ``mesh``, a ``DeviceMesh``): a tree of DTensor
    placements (``parallel.sharding.tree_placements``); every leaf it
    names comes back as a DTensor with those placements on ``mesh``, each
    rank holding only its shard, whatever mesh the state was saved from.
    Every rank of the mesh calls it."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {root}")
    if shardings is not None and mesh is None:
        raise ValueError("shardings need the mesh they lay leaves over")
    placed = _placement_leaves(shardings) if shardings is not None else {}
    d = Path(root) / f"step_{step:08d}"
    meta = json.loads((d / "metadata.json").read_text())
    missing = set(placed) - set(meta["leaves"])
    if missing:
        raise KeyError(f"shardings name leaves the checkpoint lacks: "
                       f"{sorted(missing)[:5]}")
    values = {}
    for path, info in meta["leaves"].items():
        t = _to_tensor(np.load(d / info["file"]), info["dtype"])
        values[path] = _distribute(t, mesh, placed[path]) \
            if path in placed else t
    tree = _unflatten_like(like, values) if like is not None \
        else _nest(values)
    return tree, step


class AsyncCheckpointer:
    """One-slot async save queue (next save waits for the previous).
    With DTensor leaves every rank calls ``save`` and ``wait`` alike: the
    leaves are gathered at ``save``, rank 0 writes in the background, and
    each rank passes a barrier in the ``wait`` that ends the save (the
    next ``save``, ``wait`` or ``close``)."""

    def __init__(self, root: str):
        self.root = root
        self._pool = cf.ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[cf.Future] = None
        self._barrier = False

    def save(self, step: int, state: Any) -> None:
        # snapshot to host synchronously (a copy: the port updates its
        # state in place), write files in the background
        flat, sharded = _gathered(_flatten_with_paths(state))
        host = [(path, leaf.detach().to("cpu", copy=True)
                 if isinstance(leaf, torch.Tensor) else np.array(leaf))
                for path, leaf in flat]
        self.wait()
        self._barrier = sharded
        if not sharded or _rank() == 0:
            self._pending = self._pool.submit(_write, self.root, step, host)

    def wait(self) -> None:
        try:
            if self._pending is not None:
                pending, self._pending = self._pending, None
                pending.result()
        finally:
            if self._barrier:
                self._barrier = False
                _barrier()

    def close(self) -> None:
        self.wait()
        self._pool.shutdown(wait=True)
