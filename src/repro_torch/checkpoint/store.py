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


def save_checkpoint(root: str, step: int, state: Any) -> str:
    """Atomic synchronous save.  Returns the committed directory."""
    root_p = Path(root)
    root_p.mkdir(parents=True, exist_ok=True)
    final = root_p / f"step_{step:08d}"
    tmp = Path(tempfile.mkdtemp(prefix=f".tmp_step_{step}_", dir=root))
    try:
        meta = {"step": step, "leaves": {}}
        for path, leaf in _flatten_with_paths(state):
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


def latest_step(root: str) -> Optional[int]:
    p = Path(root)
    if not p.exists():
        return None
    steps = []
    for d in p.iterdir():
        if d.name.startswith("step_") and (d / "COMMITTED").exists():
            steps.append(int(d.name.split("_")[1]))
    return max(steps) if steps else None


def restore_checkpoint(root: str, like: Any = None,
                       step: Optional[int] = None) -> Tuple[Any, int]:
    """Load a committed checkpoint as CPU tensors, shaped like ``like``
    (any tree with the same paths) or, without one, as nested dicts from
    the stored paths.  The reference's ``shardings`` (re-placing leaves on
    a mesh) has no counterpart here: the caller moves the tensors."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {root}")
    d = Path(root) / f"step_{step:08d}"
    meta = json.loads((d / "metadata.json").read_text())
    values = {path: _to_tensor(np.load(d / info["file"]), info["dtype"])
              for path, info in meta["leaves"].items()}
    tree = _unflatten_like(like, values) if like is not None \
        else _nest(values)
    return tree, step


class AsyncCheckpointer:
    """One-slot async save queue (next save waits for the previous)."""

    def __init__(self, root: str):
        self.root = root
        self._pool = cf.ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[cf.Future] = None

    def save(self, step: int, state: Any) -> None:
        # snapshot to host synchronously (a copy: the port updates its
        # state in place), write files in the background
        host_state = _unflatten_like(state, {
            path: (leaf.detach().to("cpu", copy=True)
                   if isinstance(leaf, torch.Tensor) else np.array(leaf))
            for path, leaf in _flatten_with_paths(state)})
        self.wait()
        self._pending = self._pool.submit(save_checkpoint, self.root, step,
                                          host_state)

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def close(self) -> None:
        self.wait()
        self._pool.shutdown(wait=True)
