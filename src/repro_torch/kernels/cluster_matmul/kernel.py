"""Cluster matmul on Hopper: the wrapper around ``csrc/cluster_matmul.cu``.

``matmul(a, b)`` launches the hand-written kernel that replaces the
reference's Pallas ``repro.kernels.cluster_matmul.kernel.matmul``: C = A @
B with a float32 accumulator, C in A's type (float32 or bfloat16).  It
takes CUDA tensors only, contiguous and of one type; a CPU tensor is the
caller's cue to use the plain version (``ops`` dispatches), never this
module's.  The kernel tiles C itself and masks the ragged edge, so it
takes any shape; the reference's tile contract is checked in ``ops``.

Two branches, chosen by :func:`route` from the type, the shape and the
base addresses alone (never on a failure): bfloat16 products whose rows
TMA can address (k and n multiples of 8, 16-byte-aligned bases) go to the
TMA-fed, warp-specialised wgmma kernel; every float32 product, and bf16
shapes that break the 16-byte rules (3 x 5 @ 5 x 7 is legal), to the
general kernel.  A float32 product there takes the tile and the K splits
:func:`general_plan` picks from its shape: 128 x 128 tiles where they fill
a wave of the card, else 64 x 64 tiles with K split over blocks, the
partials summed in split order by the tile's last block (one launch; the
float32 partials and the tickets are scratch this module keeps per device
and stream).  The library is built with ``nvcc`` at first launch
(``kernels.launch``); every launch adds one to :data:`launches`, a launch
of the wgmma branch also to :data:`wgmma_launches`, and a general launch
with K split to :data:`split_launches`.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.launch import SMS, LaunchCounter, load, \
    split_scratch

SOURCE = Path(__file__).resolve().parent / "csrc" / "cluster_matmul.cu"
#: element-type codes of the C interface
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the launch grid's row dimension holds ceil(m / 128) <= 65535 blocks
MAX_ROWS = 65535 * 128

#: launches of the cluster-matmul kernel, both branches
launches = LaunchCounter()
#: launches of its wgmma branch
wgmma_launches = LaunchCounter()
#: launches of its general branch with K split over blocks
split_launches = LaunchCounter()

#: the two branches :func:`route` chooses between
WGMMA, GENERAL = "wgmma", "general"
#: the general kernel's K per stage
BK = 16
#: the fewest K tiles (of :data:`BK`) a split of the general kernel takes
MIN_SPLIT_TILES = 4
#: per (device, stream), the general kernel's float32 partials and its
#: tickets (``launch.split_scratch``; a tile's last block resets its own
#: ticket)
_general_buffers: dict = {}


def route(dtype: torch.dtype, m: int, k: int, n: int,
          aligned: bool = True) -> str:
    """The branch a product of this type and shape takes: :data:`WGMMA`
    for bfloat16 when TMA can address its rows (k and n multiples of 8,
    so A's, B's and C's row pitches are multiples of 16 bytes; k > 0;
    ``aligned``: every base address a multiple of 16 bytes),
    :data:`GENERAL` otherwise (every float32 product among them)."""
    if dtype == torch.bfloat16 and k > 0 and aligned \
            and k % 8 == 0 and n % 8 == 0:
        return WGMMA
    return GENERAL


def fills_a_wave(m: int, n: int) -> bool:
    """Whether an (m, n) output in 128 x 128 tiles gives every SM a block
    (:data:`SMS` tiles or more)."""
    return -(-m // 128) * -(-n // 128) >= SMS


def general_plan(m: int, k: int, n: int) -> tuple:
    """(tile, splits) of a float32 product on the general kernel: 128 x 128
    tiles and no split where they give a wave (:data:`SMS` blocks); else
    64 x 64 tiles, with K (in :data:`BK`-deep tiles) split so that the
    grid holds about four blocks an SM, each split at least
    :data:`MIN_SPLIT_TILES` tiles deep, no split empty."""
    if fills_a_wave(m, n):
        return 128, 1
    tiles = -(-m // 64) * -(-n // 64)
    k_tiles = -(-k // BK)
    splits = min(k_tiles // MIN_SPLIT_TILES, 4 * SMS // tiles)
    if splits <= 1:
        return 64, 1
    per = -(-k_tiles // splits)
    return 64, -(-k_tiles // per)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load(SOURCE)
    fn = lib.cluster_matmul_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    fn = lib.cluster_matmul_wgmma_launch
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
        else:
            tile, splits = general_plan(m, k, n) \
                if a.dtype == torch.float32 else (128, 1)
            part = tickets = None
            if splits > 1:
                tiles = -(-m // tile) * -(-n // tile)
                part, tickets = split_scratch(
                    _general_buffers, a.device, stream,
                    tiles * splits * tile * tile, tiles)
            err = lib.cluster_matmul_launch(
                _DTYPES[a.dtype], a.data_ptr(), b.data_ptr(),
                out.data_ptr(), m, n, k, tile, splits,
                part.data_ptr() if part is not None else None,
                tickets.data_ptr() if tickets is not None else None, stream)
    if err:
        raise RuntimeError(f"cluster matmul kernel ({branch} branch) launch "
                           f"failed: CUDA error {err}")
    launches.n += 1
    if branch == WGMMA:
        wgmma_launches.n += 1
    elif splits > 1:
        split_launches.n += 1
    return out
