"""Plain-PyTorch cluster matmul: the port of
``repro.kernels.cluster_matmul.ref``.

``C = A @ B`` computed in float32, returned in A's type.  It is the CUDA
kernel's plain version: the CPU tests hold it against the JAX kernel, and
``chip_smoke.py`` holds the kernel against it on the card (where a float32
product goes to cuBLAS, so TF32 must be off for it to be float32).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.launch import LaunchCounter

#: calls of the plain version (``chip_smoke.py`` checks that the offload
#: path on the card never reaches it)
calls = LaunchCounter()


def cluster_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    calls.n += 1
    return (a.float() @ b.float()).to(a.dtype)
