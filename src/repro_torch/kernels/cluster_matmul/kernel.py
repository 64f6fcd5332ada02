"""Cluster matmul on Hopper: the wrapper around ``csrc/cluster_matmul.cu``.

``matmul(a, b)`` launches the hand-written kernel that replaces the
reference's Pallas ``repro.kernels.cluster_matmul.kernel.matmul``: C = A @
B with a float32 accumulator, C in A's type (float32 or bfloat16).  It
takes CUDA tensors only, contiguous and of one type; a CPU tensor is the
caller's cue to use the plain version (``ops`` dispatches), never this
module's.  The kernel tiles C itself and masks the ragged edge, so it
takes any shape; the reference's tile contract is checked in ``ops``.

Three branches, chosen by :func:`route` from the type, the shape and the
base addresses alone (never on a failure): bfloat16 products whose rows
TMA can address (k and n multiples of 8, 16-byte-aligned bases) go to the
TMA-fed, warp-specialised wgmma kernel; float32 products whose rows are
whole 16-byte chunks (k and n multiples of 4, 16-byte-aligned bases) to
the float32 kernel fed by a cp.async ring; shapes that break those
16-byte rules (3 x 5 @ 5 x 7 is legal) to the general kernel.  The
library is built with ``nvcc`` at first launch (``kernels.launch``);
every launch adds one to :data:`launches`, and a launch of the wgmma or
the ring branch also to :data:`wgmma_launches` or :data:`ring_launches`.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.launch import LaunchCounter, load

SOURCE = Path(__file__).resolve().parent / "csrc" / "cluster_matmul.cu"
#: element-type codes of the C interface
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the launch grid's row dimension holds ceil(m / 128) <= 65535 blocks
MAX_ROWS = 65535 * 128

#: launches of the cluster-matmul kernel, both branches
launches = LaunchCounter()
#: launches of its wgmma branch
wgmma_launches = LaunchCounter()
#: launches of its float32 ring branch
ring_launches = LaunchCounter()

#: the three branches :func:`route` chooses between
WGMMA, F32_RING, GENERAL = "wgmma", "f32_ring", "general"


def route(dtype: torch.dtype, m: int, k: int, n: int,
          aligned: bool = True) -> str:
    """The branch a product of this type and shape takes: :data:`WGMMA`
    for bfloat16 when TMA can address its rows (k and n multiples of 8,
    so A's, B's and C's row pitches are multiples of 16 bytes; k > 0;
    ``aligned``: every base address a multiple of 16 bytes),
    :data:`F32_RING` for float32 when its rows are whole 16-byte chunks
    (k and n multiples of 4; k > 0; ``aligned``), :data:`GENERAL`
    otherwise."""
    if k > 0 and aligned:
        if dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0:
            return WGMMA
        if dtype == torch.float32 and k % 4 == 0 and n % 4 == 0:
            return F32_RING
    return GENERAL


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load(SOURCE)
    fn = lib.cluster_matmul_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    for name in ("cluster_matmul_wgmma_launch",
                 "cluster_matmul_f32_ring_launch"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(a: torch.Tensor, b: torch.Tensor):
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise ValueError(f"dtypes {a.dtype}, {b.dtype}: the kernel takes "
                         "two float32 or two bfloat16 matrices")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.shape[0] > MAX_ROWS:
        raise ValueError(f"{a.shape[0]} rows exceed the kernel's {MAX_ROWS}")
    for name, t in (("a", a), ("b", b)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B: a (m, k), b (k, n), both float32 or both bfloat16, on
    one CUDA device.  Returns (m, n) in a's type."""
    _check(a, b)
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    branch = route(a.dtype, m, k, n, aligned=all(
        t.data_ptr() % 16 == 0 for t in (a, b, out)))
    lib = _library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if branch == WGMMA:
            err = lib.cluster_matmul_wgmma_launch(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, stream)
        elif branch == F32_RING:
            err = lib.cluster_matmul_f32_ring_launch(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, stream)
        else:
            err = lib.cluster_matmul_launch(
                _DTYPES[a.dtype], a.data_ptr(), b.data_ptr(),
                out.data_ptr(), m, n, k, stream)
    if err:
        raise RuntimeError(f"cluster matmul kernel ({branch} branch) launch "
                           f"failed: CUDA error {err}")
    launches.n += 1
    if branch == WGMMA:
        wgmma_launches.n += 1
    elif branch == F32_RING:
        ring_launches.n += 1
    return out
