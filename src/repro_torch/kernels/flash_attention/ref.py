"""Plain-PyTorch flash attention: exact softmax attention, the port of
``repro.kernels.flash_attention.ref.flash_attention_ref``.

Scores in float32 (bf16 products are exact in float32, so upcasting
first is the reference's ``preferred_element_type``), then ``* scale``,
then the tanh softcap ``cap * tanh(s / cap)``, then the mask (positions
are iotas aligned top-left: ``kpos <= qpos`` when causal, ``qpos - kpos <
window`` when a window is set) with ``NEG_INF``; a row with no visible key
gives 0; the probabilities are cast to v's type before P·V, which sums
in float32 and rounds once to v's type.  It is the CUDA kernel's plain
version: the CPU tests hold it against the JAX kernel, ``chip_smoke.py``
holds the kernel against it on the card, and the op's backward
recomputes through it (``ops.py``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def visible_mask(S: int, T: int, causal: bool, window: int,
                 device) -> torch.Tensor:
    """(S, T) bool: which key each query row may see."""
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(T, device=device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= (qpos - kpos) < window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        cap: float = 0.0, scale: Optional[float] = None
                        ) -> torch.Tensor:
    """q: (BH,S,dk); k: (BH,T,dk); v: (BH,T,dv).  Returns (BH,S,dv) in
    v's type; ``scale`` defaults to ``1/sqrt(dk)``."""
    BH, S, d = q.shape
    T = k.shape[1]
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    s = torch.bmm(q.float(), k.float().transpose(1, 2)) * sc
    if cap:
        s = cap * torch.tanh(s / cap)
    mask = visible_mask(S, T, causal, window, q.device)
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # fully-masked rows -> zeros (the kernel's safe divide)
    p = torch.where(mask.any(dim=-1, keepdim=True)[None], p, 0.0)
    return torch.bmm(p.to(v.dtype).float(), v.float()).to(v.dtype)
