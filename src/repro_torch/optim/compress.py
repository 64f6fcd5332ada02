"""int8 quantization primitives (the port of ``repro.optim.compress``).

The quantized KV serving path stores int8 pages with one float32 scale per
(page, K/V, kv-head): the engine's fused scatter quantizes at write
(``headwise_scales`` + ``quantize_int8``) and the attention kernel
dequantizes inside its K/V fetch.  Scales only grow per page (running
absmax), so re-quantizing an untouched page under its unchanged scale is
exactly lossless (``round(q * 1.0) == q``).

These agree bit for bit with the reference as its engine runs them, under
``jax.jit``.  There XLA rewrites a division by the constant 127 into a
multiplication by the float32 reciprocal, so the absmax/127 scale is
computed that way here too; a division by a scale held in a tensor stays a
true division on both sides.  ``torch.round`` and ``jnp.round`` both round
half to even.  ``ef_compress_grads`` comes with the training slice.
"""
from __future__ import annotations

from typing import Tuple

import torch

#: guards divisions by an all-zero slice's scale
SCALE_EPS = 1e-30

#: the constant XLA multiplies by for ``/ 127.0``: a Python float, which a
#: float32 product rounds to float32 (1/127 rounded once, as XLA folds it),
#: so no tensor constant has to reach the device
_INV_127 = 1.0 / 127.0


def compress_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One absmax/127 scale for the whole tensor; returns (int8, scale)."""
    xf = x.float()
    scale = xf.abs().max().clamp(min=1e-12) * _INV_127
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def headwise_scales(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """absmax/127 over ``dim``: ``compress_int8``'s scale, one per
    remaining slice (the per-(page, head) grain the KV pool stores).  Zero
    slices get scale 0 (they quantize to 0)."""
    return x.float().abs().amax(dim=dim) * _INV_127


def quantize_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Quantize under an externally supplied scale (broadcast against
    ``x``): the KV write path computes the page's running-max scale first
    and then quantizes the new tokens under it."""
    q = torch.round(x.float() / scale.clamp(min=SCALE_EPS))
    return torch.clamp(q, -127, 127).to(torch.int8)
