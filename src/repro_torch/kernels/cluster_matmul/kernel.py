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
TMA can address (k and n multiples of 8, 16-byte-aligned bases) go to
the TMA-fed, warp-specialised wgmma kernel; every float32 product, and
every other bf16 one (3 x 5 @ 5 x 7, a base 2 bytes off), to the general
kernel.  There a product takes the tile and the K splits
:func:`general_plan` picks from its type and shape: 128 x 128 tiles where
they fill a wave, else 64 x 64 tiles with K split over blocks, the
partials summed in split order by the tile's last block (one launch; the
float32 partials and the tickets are scratch this module keeps per device
and stream).  float32 runs on the
FP32 cores through a ring of 4-byte copies; bfloat16 on the tensor cores
(``mma.sync``), each operand loaded by the widest access its rows allow
(:func:`a_access`, :func:`access_width`: 16, 8 or 4 bytes through a
``cp.async`` ring, 2 bytes through registers; A's K tiles shifted so that
its copies stay aligned whatever its base).  The library is built with
``nvcc`` at first launch (``kernels.launch``); every launch adds one to
:data:`launches`, a launch of the wgmma branch also to
:data:`wgmma_launches`, a general launch with K split to
:data:`split_launches`, and a launch under an SM budget to
:data:`budgeted_launches`.

``matmul(a, b, sms=s)`` runs a general-branch product within a budget of
``s`` SMs (Fig.4's clusters sharing one card, ``core.cluster``): the plan
is the one for a card of ``s`` SMs (:func:`general_plan`), and the grid
holds at most ``s`` x :func:`resident_blocks` blocks, each walking the
(tile, split) items by grid stride.  Those grid-stride kernels are a
second library, built from :data:`BUDGETED_SOURCE` beside the first.  The
budget caps the blocks in flight; the hardware scheduler places them on
SMs.  A budget on a product :func:`route` sends to the wgmma branch
raises ``ValueError``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.launch import SMS, LaunchCounter, load, \
    split_scratch

SOURCE = Path(__file__).resolve().parent / "csrc" / "cluster_matmul.cu"
#: the same kernels' grid-stride instantiations (``SOURCE`` compiled with
#: ``CLUSTER_MATMUL_BUDGETED``), built in parallel with it
BUDGETED_SOURCE = SOURCE.with_name("cluster_matmul_budgeted.cu")
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
#: launches of its general branch within an SM budget
budgeted_launches = LaunchCounter()

#: the two branches :func:`route` chooses between
WGMMA, GENERAL = "wgmma", "general"
#: the general kernel's K per stage: float32 (:data:`BK`) and bfloat16
#: (:data:`BK_BF16`, two m16n8k16 steps)
BK, BK_BF16 = 16, 32
#: the fewest K tiles a split of the general kernel takes: float32 (4 of
#: 16) and bfloat16 (8 of 32: a split's partial and combine cost about
#: what a 64 x 64 bf16 tile's walk of 8 K tiles does, PERF.md §6)
MIN_SPLIT_TILES, MIN_SPLIT_TILES_BF16 = 4, 8
#: the blocks an SM a split grid aims at: float32 (4) and bfloat16 (1: a
#: 64 x 64 bf16 tile walks K fast on the tensor cores, so a split's
#: partial and combine cost more than a second block an SM gains)
SPLIT_BLOCKS_PER_SM, SPLIT_BLOCKS_PER_SM_BF16 = 4, 1
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
    :data:`GENERAL` otherwise (every float32 product among them).  On
    grids under a wave the general kernel was not faster at every shape
    timed (``PERF.md`` §6, row 3e), so the grid does not decide."""
    if dtype == torch.bfloat16 and k > 0 and aligned \
            and k % 8 == 0 and n % 8 == 0:
        return WGMMA
    return GENERAL


def access_width(address: int, row_bytes: int) -> int:
    """The widest access of 16, 8, 4 or 2 bytes that divides both a
    bfloat16 matrix's base address and its row pitch: the general
    kernel copies B by ``cp.async`` in accesses of this width (4 bytes
    or more), or loads it through registers (2)."""
    for w in (16, 8, 4):
        if address % w == 0 and row_bytes % w == 0:
            return w
    return 2


def a_access(address: int, row_bytes: int) -> tuple:
    """(width, shift) of the general kernel's bfloat16 A: the widest
    access of 16, 8 or 4 bytes that divides A's row pitch, and the
    elements its K tiles start early, (address mod width) / 2, so that
    every copy of A is aligned to that width whatever the base (K tile
    kt covers k in [32kt - shift, 32kt - shift + 32)); (2, 0) for rows
    of an odd number of elements, which go through registers, and for
    rows of none (k = 0: nothing is read)."""
    for w in (16, 8, 4):
        if row_bytes and row_bytes % w == 0:
            return w, address % w // 2
    return 2, 0


def fills_a_wave(m: int, n: int, sms: Optional[int] = None) -> bool:
    """Whether an (m, n) output in 128 x 128 tiles gives every SM of a
    budget of ``sms`` (None: the card's :data:`SMS`) a block."""
    return -(-m // 128) * -(-n // 128) >= (SMS if sms is None else sms)


def general_plan(m: int, k: int, n: int,
                 dtype: torch.dtype = torch.float32,
                 sms: Optional[int] = None) -> tuple:
    """(tile, splits) of a product on the general kernel within a budget
    of ``sms`` SMs (None: the card's :data:`SMS`): 128 x 128 tiles and no
    split where they give a wave (``sms`` blocks); else 64 x 64 tiles,
    with K (in tiles of :data:`BK` for float32, :data:`BK_BF16` for
    bfloat16) split so that the grid holds about
    :data:`SPLIT_BLOCKS_PER_SM` (float32) or
    :data:`SPLIT_BLOCKS_PER_SM_BF16` (bfloat16) blocks an SM, each split
    at least :data:`MIN_SPLIT_TILES` or :data:`MIN_SPLIT_TILES_BF16`
    tiles deep, no split empty.  A plan is a function of the shape, the
    type and the budget alone."""
    sms = SMS if sms is None else sms
    if fills_a_wave(m, n, sms):
        return 128, 1
    bf16 = dtype == torch.bfloat16
    tiles = -(-m // 64) * -(-n // 64)
    k_tiles = -(-k // (BK_BF16 if bf16 else BK))
    splits = min(k_tiles // (MIN_SPLIT_TILES_BF16 if bf16
                             else MIN_SPLIT_TILES),
                 (SPLIT_BLOCKS_PER_SM_BF16 if bf16 else SPLIT_BLOCKS_PER_SM)
                 * sms // tiles)
    if splits <= 1:
        return 64, 1
    per = -(-k_tiles // splits)
    return 64, -(-k_tiles // per)


def _general_entry(lib: ctypes.CDLL) -> None:
    fn = lib.cluster_matmul_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load(SOURCE)
    _general_entry(lib)
    fn = lib.cluster_matmul_wgmma_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _budgeted_library() -> ctypes.CDLL:
    lib = load(BUDGETED_SOURCE)
    _general_entry(lib)
    fn = lib.cluster_matmul_resident
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def resident_blocks(dtype: torch.dtype, tile: int, wa: int = 4,
                    wb: int = 4) -> int:
    """The blocks an SM holds at once of the general kernel's budgeted
    (grid-stride) form for ``tile`` (64 or 128) and, in bfloat16, A's and
    B's access widths (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    on the current device)."""
    out = ctypes.c_int(0)
    err = _budgeted_library().cluster_matmul_resident(
        _DTYPES[dtype], tile, wa, wb, ctypes.addressof(out))
    if err or out.value < 1:
        raise RuntimeError(f"cluster matmul occupancy query failed: CUDA "
                           f"error {err}, {out.value} blocks an SM")
    return out.value


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


def matmul(a: torch.Tensor, b: torch.Tensor,
           sms: Optional[int] = None) -> torch.Tensor:
    """C = A @ B: a (m, k), b (k, n), both float32 or both bfloat16, on
    one CUDA device.  Returns (m, n) in a's type.  ``sms``: run within a
    budget of that many SMs (general branch only; see the module
    docstring)."""
    _check(a, b)
    if sms is not None and (isinstance(sms, bool) or not isinstance(sms, int)
                            or sms < 1):
        raise ValueError(f"an SM budget is a positive int, got {sms!r}")
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    branch = route(a.dtype, m, k, n, aligned=all(
        t.data_ptr() % 16 == 0 for t in (a, b, out)))
    if sms is not None and branch == WGMMA:
        raise ValueError(
            f"an SM budget of {sms} on a {m}x{k}x{n} {a.dtype} product the "
            "wgmma branch takes: only the general branch runs within a "
            "budget")
    lib = _library() if sms is None else _budgeted_library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if branch == WGMMA:
            err = lib.cluster_matmul_wgmma_launch(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, stream)
        else:
            (wa, sa), wb = (a_access(a.data_ptr(), 2 * k),
                            access_width(b.data_ptr(), 2 * n)) \
                if a.dtype == torch.bfloat16 else ((4, 0), 4)
            # a shifted A walks k + sa
            if sms is None:
                tile, splits = general_plan(m, k + sa, n, a.dtype)
                max_blocks = 0
            else:
                tile, splits = general_plan(m, k + sa, n, a.dtype, sms=sms)
                max_blocks = sms * resident_blocks(a.dtype, tile, wa, wb)
            part = tickets = None
            if splits > 1:
                tiles = -(-m // tile) * -(-n // tile)
                part, tickets = split_scratch(
                    _general_buffers, a.device, stream,
                    tiles * splits * tile * tile, tiles)
            err = lib.cluster_matmul_launch(
                _DTYPES[a.dtype], a.data_ptr(), b.data_ptr(),
                out.data_ptr(), m, n, k, tile, splits, wa, wb, sa,
                max_blocks,
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
    if sms is not None:
        budgeted_launches.n += 1
    return out
