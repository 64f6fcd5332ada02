"""Paged attention on Hopper: the wrapper around ``csrc/paged_attention.cu``.

One CUDA kernel serves both entry points, as one Pallas kernel does in the
reference (``repro.kernels.paged_attention.kernel``):

``paged_prefill_fwd``
    A chunk of ``C`` query tokens per lane against the fused paged pool.
``paged_decode_fwd``
    One query token per lane: the C=1 case with ``q_start = lengths - 1``.

The pool is fused, ``(P, 2, page, Kv, hd)``, and the block table is
repeat-padded (entries past a lane's last mapped page repeat it; see
``ops.pad_block_table``).  The pool is either in q's type (float32 or
bfloat16) or int8 with ``kv_scales`` ((P, 2, Kv) float32, one scale per
page, K/V and kv head), which the kernel applies as it stages each page
(the ``quant=True`` branch of the reference kernel).  The kernels take
CUDA tensors only: a CPU tensor is the caller's cue to use the plain
version (``ops`` dispatches), never this module's.

The source holds three kernels, and :func:`route` picks one from q's type
and C alone (never on a failure): C = 1 (decode) runs the split-KV kernel
(flash-decoding: a lane's tokens spread over blocks of 128 for bf16 q,
whose products run on the tensor cores, or of 32 for float32 q, combined
by log-sum-exp in the same launch); bf16 q with C > 1 (the chunk and the
speculative verify steps) runs on the tensor cores; float32 q with C > 1
on the FP32 cores.  The library is built with ``nvcc`` at first launch
(``kernels.launch``); every launch adds one to :data:`launches`
(bf16/f32 pool) or :data:`int8_launches` (int8 pool), whichever kernel it
takes, and a tensor-core launch also to :data:`tc_launches`, a split-KV
one to :data:`split_launches`.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.launch import LaunchCounter, load, split_scratch

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
HEAD_DIMS = (16, 32, 64, 128)
#: element-type codes of the C interface (q/out; the pool adds int8)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

#: launches of the paged-attention kernel on a bf16/f32 pool
launches = LaunchCounter()
#: launches of its int8 branch (int8 pool, dequantized in the fetch)
int8_launches = LaunchCounter()
#: launches of the tensor-core kernel (either pool type)
tc_launches = LaunchCounter()
#: launches of the split-KV decode kernel (either pool type)
split_launches = LaunchCounter()

#: the three kernels :func:`route` chooses between
TENSOR_CORES, FP32_CORES, SPLIT_KV = "tensor_cores", "fp32_cores", "split_kv"
#: per (device, stream), the split-KV kernel's float32 partials and its
#: tickets (``launch.split_scratch``; the last block of a lane and kv head
#: resets its own ticket)
_split_buffers: dict = {}


def route(q_dtype: torch.dtype, C: int) -> str:
    """The kernel a call with q of ``q_dtype`` and ``C`` query tokens per
    lane takes: :data:`SPLIT_KV` for C = 1 (decode: bytes-bound, one query
    token per lane, a lane's tokens spread over blocks), whatever q's
    type; :data:`TENSOR_CORES` for bfloat16 q with C > 1 (mma.sync with
    bf16 operands); :data:`FP32_CORES` for float32 q with C > 1 (its 1e-4
    bar is out of the tensor cores' reach); whatever the pool's type."""
    if C == 1:
        return SPLIT_KV
    if q_dtype == torch.bfloat16:
        return TENSOR_CORES
    return FP32_CORES


def split_count(n_pages: int, page: int, span: int) -> int:
    """Splits of the split-KV grid for a block table of ``n_pages``
    columns: enough spans of ``span`` tokens (the kernel's, which the
    library reports) to cover every token the table can map."""
    return -(-n_pages * page // span)


@functools.lru_cache(maxsize=None)
def _split_plan(q_code: int, B: int, H: int, Kv: int, hd: int, page: int,
                n_pages: int) -> tuple:
    """(splits, float32 words of the (m, l) partials rounded up to 16
    bytes, scratch words, tickets) of a split-KV call, with the span and
    the heads per block of q's branch as the library reports them."""
    lib = _library()
    span = lib.paged_decode_split_tokens(q_code)
    heads = lib.paged_decode_split_heads(q_code)
    n_splits = split_count(n_pages, page, span)
    # the acc rows start on a 16-byte boundary: the kernel reads them 16
    # bytes at a time
    n_ml = -(-B * H * n_splits * 2 // 4) * 4
    return (n_splits, n_ml, n_ml + B * H * n_splits * hd,
            B * Kv * -(-(H // Kv) // heads))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load(SOURCE)
    fn = lib.paged_prefill_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.paged_prefill_tc_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    for name in ("paged_decode_split_tokens", "paged_decode_split_heads"):
        getattr(lib, name).argtypes = [ctypes.c_int]
        getattr(lib, name).restype = ctypes.c_int
    fn = lib.paged_decode_split_launch
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 11
                   + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check(q, kv_pages, block_table, page_counts, lengths, q_start,
           kv_scales):
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q dtype {q.dtype} not supported (float32, "
                         "bfloat16)")
    if kv_scales is None and kv_pages.dtype != q.dtype:
        raise ValueError(f"kv_pages dtype {kv_pages.dtype} != q dtype "
                         f"{q.dtype} (an int8 pool needs kv_scales)")
    for name, t in (("block_table", block_table),
                    ("page_counts", page_counts), ("lengths", lengths),
                    ("q_start", q_start)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if q.dim() != 4 or kv_pages.dim() != 5 or kv_pages.shape[1] != 2:
        raise ValueError(f"bad shapes: q {tuple(q.shape)} (want B,C,H,hd), "
                         f"kv_pages {tuple(kv_pages.shape)} "
                         "(want P,2,page,Kv,hd)")
    B, C, H, hd = q.shape
    P, _, page, Kv, hd_kv = kv_pages.shape
    # every head dim here is >= 16, so an int8 K/V row is a whole number
    # of the kernel's 16-byte loads
    if hd_kv != hd or hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} (pool {hd_kv}) not in {HEAD_DIMS}")
    if Kv < 1 or H % Kv:
        raise ValueError(f"H={H} not a multiple of Kv={Kv}")
    if kv_scales is not None:
        if kv_pages.dtype != torch.int8:
            raise ValueError(f"kv_scales given for a {kv_pages.dtype} pool "
                             "(they mark an int8 pool)")
        if kv_scales.dtype != torch.float32 \
                or tuple(kv_scales.shape) != (P, 2, Kv):
            raise ValueError(f"kv_scales {kv_scales.dtype} "
                             f"{tuple(kv_scales.shape)}: want float32 "
                             f"({P}, 2, {Kv})")
    if kv_pages.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("kv_pages and q must be 16-byte aligned (the "
                         "kernels read K/V and q rows 16 bytes at a time)")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or block_table.shape[1] < 1:
        raise ValueError(f"block_table {tuple(block_table.shape)} for B={B}")
    for name, t in (("page_counts", page_counts), ("lengths", lengths),
                    ("q_start", q_start)):
        if tuple(t.shape) != (B,):
            raise ValueError(f"{name} shape {tuple(t.shape)} != ({B},)")
    tensors = [("q", q), ("kv_pages", kv_pages),
               ("block_table", block_table), ("page_counts", page_counts),
               ("lengths", lengths), ("q_start", q_start)]
    if kv_scales is not None:
        tensors.append(("kv_scales", kv_scales))
    for name, t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return B, C, H, hd, P, page, Kv


def paged_prefill_fwd(q: torch.Tensor, kv_pages: torch.Tensor,
                      block_table: torch.Tensor, page_counts: torch.Tensor,
                      lengths: torch.Tensor, q_start: torch.Tensor, *,
                      pages_per_step: int = 2,
                      scale: Optional[float] = None,
                      kv_scales: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """q: (B,C,H,hd) — C query tokens per lane at positions
    ``q_start[b] .. q_start[b]+C-1``, whose K/V are already in the pool
    (``lengths`` counts them); kv_pages: (P, 2, page, Kv, hd) fused pool
    in q's dtype (float32 or bfloat16), or int8 with ``kv_scales``
    ((P, 2, Kv) float32); block_table: (B, n_pages) int32,
    repeat-padded; page_counts / lengths / q_start: (B,) int32.  Rows past
    a lane's real chunk attend to the whole resident sequence (callers
    ignore them).  Returns (B,C,H,hd) in q's dtype.

    ``pages_per_step`` is accepted for parity with the TPU kernel, whose
    grid step it sets; these kernels' tiling does not depend on it (they
    stage 32 to 128 tokens per step whatever the page size)."""
    del pages_per_step
    B, C, H, hd, P, page, Kv = _check(q, kv_pages, block_table, page_counts,
                                      lengths, q_start, kv_scales)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    sc = scale if scale is not None else 1.0 / math.sqrt(hd)
    kernel = route(q.dtype, C)
    lib = _library()
    pointers = (q.data_ptr(), kv_pages.data_ptr(),
                kv_scales.data_ptr() if kv_scales is not None else None,
                block_table.data_ptr(), page_counts.data_ptr(),
                lengths.data_ptr(), q_start.data_ptr(), out.data_ptr())
    sizes = (B, C, H, Kv, hd, page, block_table.shape[1], P, sc)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if kernel == SPLIT_KV:
            n_splits, n_ml, words, n_tickets = _split_plan(
                _DTYPES[q.dtype], B, H, Kv, hd, page, block_table.shape[1])
            # the partials, (m, l) pairs then acc rows, in one buffer
            part, tickets = split_scratch(_split_buffers, q.device,
                                          stream, words, n_tickets)
            err = lib.paged_decode_split_launch(
                _DTYPES[q.dtype], _DTYPES[kv_pages.dtype], *pointers,
                part.data_ptr(), part.data_ptr() + 4 * n_ml,
                tickets.data_ptr(),
                B, H, Kv, hd, page, block_table.shape[1], P, n_splits, sc,
                stream)
        elif kernel == TENSOR_CORES:
            err = lib.paged_prefill_tc_launch(
                _DTYPES[kv_pages.dtype], *pointers, *sizes, stream)
        else:
            err = lib.paged_prefill_launch(
                _DTYPES[kv_pages.dtype], *pointers, *sizes, stream)
    if err:
        raise RuntimeError(f"paged attention kernel ({kernel}) launch "
                           f"failed: CUDA error {err}")
    (int8_launches if kv_scales is not None else launches).n += 1
    if kernel == TENSOR_CORES:
        tc_launches.n += 1
    elif kernel == SPLIT_KV:
        split_launches.n += 1
    return out


def paged_decode_fwd(q: torch.Tensor, kv_pages: torch.Tensor,
                     block_table: torch.Tensor, page_counts: torch.Tensor,
                     lengths: torch.Tensor, *, pages_per_step: int = 2,
                     scale: Optional[float] = None,
                     kv_scales: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """q: (B,H,hd), one query per lane at position ``lengths - 1``: the
    C=1 case of :func:`paged_prefill_fwd` (an empty lane, q_start = -1,
    stays fully masked and outputs 0).  Returns (B,H,hd)."""
    return paged_prefill_fwd(q[:, None], kv_pages, block_table, page_counts,
                             lengths, (lengths - 1).to(torch.int32),
                             pages_per_step=pages_per_step,
                             scale=scale, kv_scales=kv_scales)[:, 0]
