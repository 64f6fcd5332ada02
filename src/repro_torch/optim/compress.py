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
half to even.  ``ef_compress_grads`` is the training step's simulated
int8 wire format (``Trainer(compress=True)``), with an error-feedback
residual kept in the train state; gradients and residuals are dicts keyed
like the parameters.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

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


@torch.no_grad()
def ef_compress_grads(grads: Mapping[str, torch.Tensor],
                      residual: Mapping[str, torch.Tensor],
                      groups: Optional[Sequence[Sequence[str]]] = None
                      ) -> Tuple[Dict[str, torch.Tensor],
                                 Dict[str, torch.Tensor]]:
    """Error-feedback int8 round trip: returns (decompressed grads, new
    residual), what the receiving side of the cross-pod all-reduce would
    reconstruct and what it owes the next step.  One absmax/127 scale per
    group of keys (``groups``; default one per key): the reference keeps
    a layer stack as one ``(L, ...)`` leaf with one scale, so the train
    step passes each stack's per-layer keys as one group."""
    out_g, out_r = {}, {}
    for keys in groups if groups is not None else [[k] for k in grads]:
        # two passes, so one group's float32 copies are never all alive
        amax = torch.stack([(grads[k].float() + residual[k]).abs().max()
                            for k in keys]).max()
        scale = amax.clamp(min=1e-12) * _INV_127
        for k in keys:
            g32 = grads[k].float() + residual[k]
            d = decompress_int8(quantize_int8(g32, scale), scale)
            out_g[k] = d.to(grads[k].dtype)
            out_r[k] = g32 - d
    return out_g, out_r


def init_residual(grads_like: Mapping[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """Zero float32 residuals shaped like ``grads_like``."""
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads_like.items()}
