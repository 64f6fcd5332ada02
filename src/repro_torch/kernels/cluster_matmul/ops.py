"""Public wrapper for the cluster matmul, as
``repro.kernels.cluster_matmul.ops``.

``cluster_matmul`` keeps the reference kernel's shape contract: tiles of
``min(tile, dim)`` must divide each dimension (an ``AssertionError`` with
the reference's message otherwise).  Dispatch is by device: CUDA tensors
go to the hand-written kernel (``kernel.py``), CPU tensors to the plain
version (``ref.py``); there is no fallback from one to the other.  Unlike
the reference, which promotes inside ``jnp.dot``, two matrices of
different types, or of a type other than float32 and bfloat16, are
refused.  Non-contiguous inputs (a transposed view) are made contiguous
first.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cluster_matmul import kernel as K
from repro_torch.kernels.cluster_matmul.ref import cluster_matmul_ref

__all__ = ["cluster_matmul", "cluster_matmul_ref"]

DTYPES = (torch.float32, torch.bfloat16)


def cluster_matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128,
                   bn: int = 128, bk: int = 128) -> torch.Tensor:
    if a.dtype != b.dtype:
        raise TypeError(f"mixed dtypes {a.dtype} @ {b.dtype}: cast one "
                        "first (the reference would promote)")
    if a.dtype not in DTYPES:
        raise TypeError(f"dtype {a.dtype} not supported (float32, "
                        "bfloat16)")
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"need 2-D matrices, got {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise AssertionError((tuple(a.shape), tuple(b.shape)))
    bm, bn, bk = min(bm, m), min(bn, n), min(bk, k)
    if m % bm or n % bn or k % bk:
        raise AssertionError(f"({m},{k})x({k},{n}) not tiled by "
                             f"({bm},{bn},{bk})")
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    a, b = a.contiguous(), b.contiguous()
    if a.device.type == "cuda":
        return K.matmul(a, b)
    if a.device.type == "cpu":
        return cluster_matmul_ref(a, b)
    raise ValueError(f"unsupported device {a.device}")
