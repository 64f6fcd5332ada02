"""Flash attention on Hopper: the wrapper around ``csrc/flash_attention.cu``.

``flash_attention_fwd(q, k, v, ...)`` launches the hand-written kernel
that replaces the reference's Pallas
``repro.kernels.flash_attention.kernel.flash_attention_fwd``: q
``(BH, S, d)``, k ``(BH // groups, T, d)``, v ``(BH // groups, T, dv)``
with flat query head ``b`` reading KV row ``b // groups`` (KV-major
heads, as ``ops.mha_flash`` lays them out), causal / sliding-window masks
on top-left-aligned iotas and an optional tanh logit cap; float32 or
bfloat16, ``dv = d`` in :data:`HEAD_DIMS`, or MLA's q/k 192 beside v
128 (:data:`TC_PAIRS` in bfloat16, :data:`FP32_PAIRS` in float32).  It
takes CUDA tensors only: a CPU tensor is the caller's cue to use the
plain version (``ops`` dispatches), never this module's.  The kernel masks partial tiles, so
any S and T are right (the reference asserts that its tiles divide S and
T).

The source holds two kernels, and :func:`route` picks one from the type
and the head dims alone (never on a failure): bfloat16 at hd 64, 128 and
256 and at MLA's (192, 128) runs on the tensor cores (TMA + wgmma, the
tile plans of :data:`TC_PLANS`, one picked by :func:`tc_plan`), float32
(MLA's (192, 128) too) and bf16 at hd 16 and 32 on the FP32 cores;
:func:`head_dims` says at which dims a call runs (``ops`` zero-pads any
other pair to one hd).
Where the FP32-core grid is under a wave of
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
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.launch import SMS, LaunchCounter, load, \
    split_scratch

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128, 256)
#: (q/k head dim, v head dim) pairs of unequal dims the tensor-core kernel
#: takes as they are, in bfloat16: MLA's (deepseek-v2) 128 + 64 beside 128
TC_PAIRS = ((192, 128),)
#: ... and the FP32-core kernel, in float32 (its ``<float, 192, 128>``)
FP32_PAIRS = ((192, 128),)
#: the unequal pairs each type runs as they are
_NATIVE_PAIRS = {torch.bfloat16: TC_PAIRS, torch.float32: FP32_PAIRS}


class TcPlan(NamedTuple):
    """A tile plan of the tensor-core kernel (``csrc`` ``tc::Plan``):
    consumer warpgroups of 64 query rows, keys a K/V tile, ring stages,
    blocks an SM."""
    consumers: int
    keys: int
    stages: int
    blocks: int


#: the tensor-core kernel's instantiations (head dims of whole 64-column,
#: 128-byte TMA boxes), (dk, dv) -> its tile plans, widest first, as
#: ``csrc/flash_attention.cu`` sets them (``tc::Plan``, ``Plan64Wide``,
#: ``Plan64``): 128 query rows a block and 64-key tiles; at hd 64 128-key
#: tiles, with 192 rows where the grid fills two waves (:func:`tc_plan`)
TC_PLANS = {(64, 64): (TcPlan(3, 128, 2, 1), TcPlan(2, 128, 2, 1)),
            (128, 128): (TcPlan(2, 64, 2, 1),),
            (256, 256): (TcPlan(2, 64, 2, 1),),
            (192, 128): (TcPlan(2, 64, 2, 1),)}
#: shared memory a block may opt in to on the H100 (227 KB)
SMEM_LIMIT = 232448
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


def tc_plan(BH: int, S: int, dk: int, dv: int) -> TcPlan:
    """The tile plan of a tensor-core call: the instantiation's widest
    where its grid (``BH`` x ceil(S / rows) blocks of 64 x consumers query
    rows) fills two waves of :data:`SMS` SMs, else its narrowest (fewer
    rows a block: more blocks, so the last wave is not half empty)."""
    plans = TC_PLANS[dk, dv]
    if BH * -(-S // (64 * plans[0].consumers)) >= 2 * SMS:
        return plans[0]
    return plans[-1]


def tc_smem_bytes(dk: int, dv: int, p: TcPlan) -> int:
    """Dynamic shared memory of a tensor-core block of the instantiation
    (dk, dv) under plan ``p``, as ``tc::Smem`` counts it: 1 KB of alignment
    slack, Q, the stages' K and V tiles (bf16), and 1 + 4 x stages
    mbarriers."""
    return (1024 + 64 * p.consumers * dk * 2
            + p.stages * p.keys * (dk + dv) * 2 + (1 + 4 * p.stages) * 8)


def fp32_smem(dtype: torch.dtype, dk: int, dv: int) -> tuple:
    """(slots, dynamic shared memory bytes) of an FP32-core block of the
    instantiation (``dtype``, dk, dv), as ``fp32::Smem`` counts them: the
    q tile and each K slot in rows of dk plus 16 bytes, P in float32 rows
    of 80, each V slot in rows of dv; two K and two V slots where they fit
    the opt-in less 16 bytes (the static ``last_flag``), else one of
    each."""
    e = torch.finfo(dtype).bits // 8
    ld = dk + 16 // e
    fixed = FP32_ROWS * ld * e + FP32_ROWS * (FP32_KEYS + 16) * 4
    slot = FP32_KEYS * e * (ld + dv)
    slots = 2 if fixed + 2 * slot <= SMEM_LIMIT - 16 else 1
    return slots, fixed + slots * slot


def fp32_scratch(BH: int, S: int, dv: int, splits: int) -> tuple:
    """(partial rows, float32 words, int32 tickets) of an FP32-core call's
    split scratch: an (m, l) pair and an acc row of ``dv`` for each (head,
    query tile, split, row), and a ticket a (head, query tile)."""
    tiles = BH * -(-S // FP32_ROWS)
    rows = tiles * splits * FP32_ROWS
    return rows, rows * (2 + dv), tiles


def head_dims(dtype: torch.dtype, dk: int, dv: int) -> tuple:
    """(q/k, v) head dims the kernels run a call of ``dtype`` with q/k head
    dim ``dk`` and v head dim ``dv`` at: the call's own where they take it
    as it is (``dk == dv`` in :data:`HEAD_DIMS`, a bfloat16 pair of
    :data:`TC_PAIRS` or a float32 one of :data:`FP32_PAIRS`), else (d, d)
    with d the smallest of :data:`HEAD_DIMS` at least ``max(dk, dv)``, to
    which ``ops`` zero-pads q, k and v (the smoke config's (24, 16): 32).
    Raises where none is that wide."""
    if (dk == dv and dk in HEAD_DIMS) or \
            (dk, dv) in _NATIVE_PAIRS.get(dtype, ()):
        return dk, dv
    for d in HEAD_DIMS:
        if d >= max(dk, dv):
            return d, d
    raise ValueError(f"head dims q/k {dk}, v {dv}: the kernel takes at "
                     f"most {HEAD_DIMS[-1]}")


def route(dtype: torch.dtype, dk: int, dv: Optional[int] = None) -> str:
    """The kernel a call of ``dtype`` with q/k head dim ``dk`` and v head
    dim ``dv`` (``dk`` if None) takes, at :func:`head_dims`:
    :data:`TENSOR_CORES` for bfloat16 at an instantiation of
    :data:`TC_PLANS` (hd 64, 128, 256, MLA's (192, 128)),
    :data:`FP32_CORES` for float32 (its 2e-4 bar is out of the tensor
    cores' reach; MLA's (192, 128) included) and for bfloat16 at hd 16
    and 32 (less than one 128-byte TMA box a row)."""
    dk, dv = head_dims(dtype, dk, dk if dv is None else dv)
    if dtype == torch.bfloat16 and (dk, dv) in TC_PLANS:
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
              window: int, dv: Optional[int] = None) -> tuple:
    """(span_keys, splits) of an FP32-core call of q/k head dim ``hd`` and
    v head dim ``dv`` (``hd`` if None): (0, 1), one block a query tile,
    where the grid fills two waves (2 x :data:`SMS` blocks); else the span
    of whole key tiles whose blocks finish first on :data:`SMS` SMs as
    :func:`_makespan` models them: a block costs its key tiles, plus
    :data:`FP32_SPLIT_COST` x 2 / (hd + dv) of a tile (a tile's operations
    go as hd + dv) when its query tile is split, and no split wins
    ties."""
    walks = fp32_walks(S, T, causal, window)
    longest = max(walks)
    if len(walks) * BH >= 2 * SMS:
        return 0, 1
    # issue order: head by head, each head's query tiles last-first
    order = walks[::-1] * BH
    split_cost = FP32_SPLIT_COST * 2 / (hd + (hd if dv is None else dv))
    best, plan = _makespan(order), (0, 1)
    for span in range(1, longest):
        splits = -(-longest // span)
        sizes = []
        for w in order:
            live = max(1, -(-w // span))
            extra = split_cost if live > 1 else 0.0
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
                   + [ctypes.c_int] * 8 + [ctypes.c_float] * 2
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.flash_attention_tc_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
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
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3 \
            or v.shape[:2] != k.shape[:2]:
        raise ValueError(f"bad shapes: q {tuple(q.shape)} (want BH,S,d), "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} (want "
                         "BH/groups,T,d and BH/groups,T,dv)")
    BH, S, d = q.shape
    dv = v.shape[2]
    if k.shape[2] != d or head_dims(q.dtype, d, dv) != (d, dv):
        raise ValueError(f"head dims q {d}, k {k.shape[2]}, v {dv}: the "
                         f"kernels take one of {HEAD_DIMS} for all three, "
                         f"or (q/k, v) in {TC_PAIRS} in bfloat16 (tensor "
                         f"cores) or {FP32_PAIRS} in float32 (FP32 cores)")
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
    """q: (BH, S, d); k: (BH // groups, T, d); v: (BH // groups, T, dv),
    one CUDA device, one type.  Returns (BH, S, dv) in q's type."""
    _check(q, k, v, groups)
    BH, S, d = q.shape
    T, dv = k.shape[1], v.shape[2]
    out = q.new_empty(BH, S, dv)
    if out.numel() == 0:
        return out
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    kernel = route(q.dtype, d, dv)
    if T == 0 and kernel == TENSOR_CORES:
        # no key at all: every row is fully masked and gives 0 (a tensor
        # map cannot describe an empty K/V)
        return out.zero_()
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if kernel == TENSOR_CORES:
            rows = 64 * tc_plan(BH, S, d, dv).consumers
            err = lib.flash_attention_tc_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH,
                S, T, d, dv, rows, groups, int(bool(causal)), int(window),
                float(cap), float(sc), stream)
        else:
            span, splits = fp32_plan(BH, S, T, d, bool(causal), int(window),
                                     dv)
            ml = acc = tickets = 0
            if splits > 1:
                # the partials: (m, l) pairs, then acc rows of dv (16-byte
                # aligned), per (head, query tile, split, row)
                rows, words, n_tickets = fp32_scratch(BH, S, dv, splits)
                part, tk = split_scratch(_fp32_buffers, q.device, stream,
                                         words, n_tickets)
                ml, acc, tickets = (part.data_ptr(),
                                    part.data_ptr() + 4 * 2 * rows,
                                    tk.data_ptr())
            err = lib.flash_attention_launch(
                _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), ml, acc, tickets, BH, S, T, d, dv, groups,
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
