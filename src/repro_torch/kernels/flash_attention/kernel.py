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
reference asserts that its tiles divide S and T).  The library is built
with ``nvcc`` at first launch (``kernels.launch``); every launch adds one
to :data:`launches`.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.launch import LaunchCounter, load

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128, 256)
#: element-type codes of the C interface
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the launch grid's head dimension holds at most 65535 blocks
MAX_HEADS = 65535

#: launches of the flash-attention kernel
launches = LaunchCounter()


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from a flash-attention
    source (this one, or a deliberately broken copy in the tests)."""
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 7 + [ctypes.c_float] * 2
                   + [ctypes.c_void_p])
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
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             "reads rows 16 bytes at a time)")


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
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), BH, S, T, d, groups, int(bool(causal)),
            int(window), float(cap), float(sc), stream)
    if err:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {err}")
    launches.n += 1
    return out
