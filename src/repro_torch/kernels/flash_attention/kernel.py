"""Flash attention on Hopper: the wrapper around ``csrc/flash_attention.cu``.

``flash_attention_fwd(q, k, v, ...)`` launches the hand-written kernel
that replaces the reference's Pallas
``repro.kernels.flash_attention.kernel.flash_attention_fwd``: q
``(BH, S, d)``, k/v ``(BH // groups, T, d)`` with flat query head ``b``
reading KV row ``b // groups`` (KV-major heads, as ``ops.mha_flash``
lays them out), causal / sliding-window masks on top-left-aligned iotas
and an optional tanh logit cap; float32 or bfloat16, d in
:data:`HEAD_DIMS`.  It takes CUDA tensors only: a CPU tensor is the
caller's cue to use the plain version (``ops`` dispatches), never this
module's.  The kernel masks partial tiles, so any S and T are right (the
reference asserts that its tiles divide S and T).

The source holds two kernels, and :func:`route` picks one from the type
and the head dim alone (never on a failure): bfloat16 at hd 64, 128 and
256 runs on the tensor cores (TMA + wgmma), float32 and bf16 at hd 16
and 32 on the FP32 cores.  Where the FP32-core grid is under a wave of
the card, :func:`fp32_plan` splits each query tile's key walk over
blocks, combined in one launch (the float32 partials and the tickets are
scratch this module keeps per device and stream).  The library is built
with ``nvcc`` at first launch (``kernels.launch``); every launch adds one
to :data:`launches`, a tensor-core launch also to :data:`tc_launches`,
and an FP32-core launch with its walks split to :data:`split_launches`.
"""
from __future__ import annotations

import ctypes
import functools
import heapq
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.launch import SMS, LaunchCounter, load, \
    split_scratch

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128, 256)
#: head dims the tensor-core kernel takes: whole 64-column (128-byte) TMA
#: boxes
TC_HEAD_DIMS = (64, 128, 256)
#: element-type codes of the C interface
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the launch grid's head dimension holds at most 65535 blocks
MAX_HEADS = 65535

#: launches of either flash-attention kernel
launches = LaunchCounter()
#: launches of the tensor-core kernel
tc_launches = LaunchCounter()
#: launches of the FP32-core kernel with its key walks split over blocks
split_launches = LaunchCounter()

#: the two kernels :func:`route` chooses between
TENSOR_CORES, FP32_CORES = "tensor_cores", "fp32_cores"
#: the FP32-core kernel's query rows a block and keys a K/V tile
FP32_ROWS, FP32_KEYS = 64, 64
#: what a split block costs beyond its key tiles (its q tile staged, its
#: partial written, the last one's combine), in key tiles of head dim 100
#: (about 9 us on the H100, where a 64 x 64 tile at hd 256 takes ~18 us;
#: ``scripts/ab_kernel_variants.py --parts flash_f32``)
FP32_SPLIT_COST = 100
#: per (device, stream), the FP32-core kernel's float32 partials and its
#: tickets (``launch.split_scratch``; a query tile's last split resets its
#: own ticket)
_fp32_buffers: dict = {}


def route(dtype: torch.dtype, hd: int) -> str:
    """The kernel a call of ``dtype`` with head dim ``hd`` takes:
    :data:`TENSOR_CORES` for bfloat16 at hd in :data:`TC_HEAD_DIMS`,
    :data:`FP32_CORES` for float32 (its 2e-4 bar is out of the tensor
    cores' reach) and for bfloat16 at hd 16 and 32 (less than one
    128-byte TMA box a row)."""
    if dtype == torch.bfloat16 and hd in TC_HEAD_DIMS:
        return TENSOR_CORES
    return FP32_CORES


def fp32_walks(S: int, T: int, causal: bool, window: int) -> list:
    """Key tiles (:data:`FP32_KEYS` keys) each query tile of the FP32-core
    kernel walks: from its first visible key (a window starts it at q0 -
    window + 1) to its last (causal stops it at the tile's last row)."""
    walks = []
    for q0 in range(0, S, FP32_ROWS):
        last = min(q0 + FP32_ROWS, S) - 1
        hi = min(T, last + 1) if causal else T
        lo = max(0, q0 - window + 1) if window else 0
        walks.append(-(-(hi - lo) // FP32_KEYS) if hi > lo else 0)
    return walks


def _makespan(sizes) -> float:
    """Time the card takes for blocks of these sizes, issued in this order,
    one at a time an SM as SMs free up (the block scheduler's greedy
    order)."""
    free = [0.0] * min(SMS, len(sizes))
    for size in sizes:
        heapq.heapreplace(free, free[0] + size)
    return max(free)


@functools.lru_cache(maxsize=1024)
def fp32_plan(BH: int, S: int, T: int, hd: int, causal: bool,
              window: int) -> tuple:
    """(span_keys, splits) of an FP32-core call: (0, 1), one block a query
    tile, where the grid fills two waves (2 x :data:`SMS` blocks); else
    the span of whole key tiles whose blocks finish first on :data:`SMS`
    SMs as :func:`_makespan` models them: a block costs its key tiles,
    plus :data:`FP32_SPLIT_COST` / hd of a tile when its query tile is
    split, and no split wins ties."""
    walks = fp32_walks(S, T, causal, window)
    longest = max(walks)
    if len(walks) * BH >= 2 * SMS:
        return 0, 1
    # issue order: head by head, each head's query tiles last-first
    order = walks[::-1] * BH
    best, plan = _makespan(order), (0, 1)
    for span in range(1, longest):
        splits = -(-longest // span)
        sizes = []
        for w in order:
            live = max(1, -(-w // span))
            extra = FP32_SPLIT_COST / hd if live > 1 else 0.0
            sizes += [min(span, w - s * span) + extra for s in range(live)]
            sizes += [0.0] * (splits - live)
        cost = _makespan(sizes)
        if cost < best:
            best, plan = cost, (span * FP32_KEYS, splits)
    return plan


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from a flash-attention
    source (this one, or a deliberately broken copy in the tests)."""
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                   + [ctypes.c_int] * 7 + [ctypes.c_float] * 2
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.flash_attention_tc_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return bind(load(SOURCE))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, groups: int):
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: the "
                         "kernel takes float32 or bfloat16 q, k and v of "
                         "one type")
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"bad shapes: q {tuple(q.shape)} (want BH,S,d), "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} (want "
                         "BH/groups,T,d)")
    BH, S, d = q.shape
    if k.shape[2] != d or d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} (k {k.shape[2]}) not in {HEAD_DIMS}")
    if groups < 1 or BH != k.shape[0] * groups:
        raise ValueError(f"BH={BH} != {k.shape[0]} kv rows x groups="
                         f"{groups}")
    if BH > MAX_HEADS:
        raise ValueError(f"BH={BH} exceeds the kernel's {MAX_HEADS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernels "
                             "read rows 16 bytes at a time, or by TMA)")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        cap: float = 0.0, scale: Optional[float] = None,
                        groups: int = 1) -> torch.Tensor:
    """q: (BH, S, d); k/v: (BH // groups, T, d), one CUDA device, one type.
    Returns (BH, S, d) in q's type."""
    _check(q, k, v, groups)
    BH, S, d = q.shape
    T = k.shape[1]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    kernel = route(q.dtype, d)
    if T == 0 and kernel == TENSOR_CORES:
        # no key at all: every row is fully masked and gives 0 (a tensor
        # map cannot describe an empty K/V)
        return out.zero_()
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if kernel == TENSOR_CORES:
            err = lib.flash_attention_tc_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH,
                S, T, d, groups, int(bool(causal)), int(window), float(cap),
                float(sc), stream)
        else:
            span, splits = fp32_plan(BH, S, T, d, bool(causal), int(window))
            ml = acc = tickets = 0
            if splits > 1:
                # the partials: (m, l) pairs, then acc rows (16-byte
                # aligned), per (head, query tile, split, row)
                rows = BH * -(-S // FP32_ROWS) * splits * FP32_ROWS
                part, tk = split_scratch(_fp32_buffers, q.device, stream,
                                         rows * (2 + d),
                                         BH * -(-S // FP32_ROWS))
                ml, acc, tickets = (part.data_ptr(),
                                    part.data_ptr() + 4 * 2 * rows,
                                    tk.data_ptr())
            err = lib.flash_attention_launch(
                _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), ml, acc, tickets, BH, S, T, d, groups,
                int(bool(causal)), int(window), float(cap), float(sc), span,
                splits, stream)
    if err:
        raise RuntimeError(f"flash attention kernel ({kernel}) launch "
                           f"failed: CUDA error {err}")
    launches.n += 1
    if kernel == TENSOR_CORES:
        tc_launches.n += 1
    elif splits > 1:
        split_launches.n += 1
    return out
