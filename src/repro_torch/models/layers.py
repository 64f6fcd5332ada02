"""Shared model primitives: norms, RoPE, MLPs, embeddings, logits and the
chunked cross-entropy.

Plain functions on tensors, one per ``repro.models.layers`` function, with
the same parameter layout: ``p`` is any mapping holding the named tensors
(the port's modules are ``nn.ParameterDict``s, so ``p["scale"]`` works).
Dtype flow follows the reference: norms and RoPE compute in float32 and
cast back to the input dtype; logits come out in float32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.parallel.sharding import (
    current_mesh, local_region, placements, pspec_entry, shard, shard_index,
)

# vocab rows upcast per matmul in ``logits_from_hidden`` (bounds the f32
# copy of a bf16 head to a slice instead of the whole V x d matrix)
_LOGIT_ROWS = 8192


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_forward(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if "bias" in p:  # LayerNorm
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        out = out * p["scale"] + p["bias"]
    else:  # RMSNorm
        ms = xf.square().mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(ms + cfg.norm_eps) * p["scale"]
    return out.to(x.dtype)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """Per-head RMSNorm over the trailing head_dim (qwen3 qk-norm)."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale).to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding, rotate-half convention.

    x: (..., S, H, hd) with matching positions (..., S) broadcastable.
    """
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs          # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_forward(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    up = x @ p["w_up"]
    if cfg.mlp_kind in ("swiglu", "geglu"):
        gate = x @ p["w_gate"]
        # jax.nn.gelu defaults to the tanh approximation
        act = F.silu(gate) if cfg.mlp_kind == "swiglu" else \
            F.gelu(gate, approximate="tanh")
        h = act * up
    else:
        h = F.gelu(up, approximate="tanh")
    h = shard(h, "dp", None, "tp")
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# Embedding + logits
# ---------------------------------------------------------------------------

def lookup_rows(table: torch.Tensor, idx: torch.Tensor,
                row_axis: Optional[str]) -> torch.Tensor:
    """``table[idx]``.  Under a mesh each device looks up its own rows of
    ``idx`` (split over ``dp``) in its rows of ``table`` (split over
    ``row_axis``, its columns gathered): a row another device holds is
    zero here, and the result is the sum over the devices that split the
    table (vocab-parallel embedding)."""
    mesh = current_mesh()
    if mesh is None:
        return table[idx.long()]
    from torch.distributed.tensor import Partial, Shard
    t_pl = placements(table.shape, (row_axis, None), mesh)
    i_pl = placements(idx.shape, ("dp",) + (None,) * (idx.dim() - 1), mesh)
    out = tuple(Partial() if isinstance(t, Shard) else i
                for t, i in zip(t_pl, i_pl))
    first, n = shard_index(mesh, pspec_entry(table.shape, (row_axis, None),
                                             mesh, 0))

    def body(table, idx):
        if n == 1:
            return table[idx.long()]
        local = idx.long() - first * table.shape[0]
        inside = (local >= 0) & (local < table.shape[0])
        rows = table[local.clamp(0, table.shape[0] - 1)]
        return torch.where(inside[..., None], rows, rows.new_zeros(()))
    return local_region("lookup", body, (table, idx), (t_pl, i_pl), [out])


def embed_tokens(cfg: ArchConfig, p, tokens: torch.Tensor) -> torch.Tensor:
    x = lookup_rows(p["table"], tokens, "tp")
    if cfg.embedding_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    # the residual stream is sequence-parallel between blocks
    return shard(x, "dp", "sp", None)


def head_matrix(cfg: ArchConfig, p) -> torch.Tensor:
    return p["table"] if cfg.tie_embeddings else p["head"]


def logits_from_hidden(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    """Float32 logits, as the reference asks XLA for
    (``preferred_element_type=float32``).  A bf16 matmul would round its
    output to bf16 and turn near-ties over a large vocabulary into argmax
    ties; here bf16 operands are upcast (products of bf16 values are exact
    in float32) one slice of vocabulary rows at a time."""
    w = head_matrix(cfg, p)
    xf = x.float()
    if w.dtype == torch.float32:
        logits = xf @ w.t()
    else:
        logits = torch.cat([xf @ w[v:v + _LOGIT_ROWS].float().t()
                            for v in range(0, w.shape[0], _LOGIT_ROWS)],
                           dim=-1)
    return softcap(logits, cfg.final_softcap)


def _xent_chunk(cfg: ArchConfig, w: torch.Tensor, h: torch.Tensor,
                lab: torch.Tensor) -> torch.Tensor:
    """Sum over one chunk of ``logsumexp(logits) - logits[label]``, the
    logits in float32 (bf16 operands upcast: their products are exact in
    float32, the reference's ``preferred_element_type``)."""
    logits = softcap(h.float() @ w.float().t(), cfg.final_softcap)
    logits = shard(logits, "dp", None, "tp")
    if current_mesh() is not None:
        return _xent_sharded(logits, lab)
    lse = torch.logsumexp(logits, dim=-1)                      # (B,c)
    correct = logits.gather(-1, lab.long()[..., None])[..., 0]  # (B,c)
    return (lse - correct).sum()


def _xent_sharded(logits: torch.Tensor, lab: torch.Tensor) -> torch.Tensor:
    """:func:`_xent_chunk`'s sum on logits whose vocabulary is split over
    devices, in reductions DTensor splits too (the reference's form): the
    max and the sum of the exponentials over the vocabulary, and the
    label's logit as a masked sum, each a partial result per shard
    reduced once across them."""
    m = shard(logits.detach().amax(dim=-1, keepdim=True), "dp", None, None)
    total = shard(torch.exp(logits - m).sum(dim=-1), "dp", None)
    lse = torch.log(total) + m[..., 0]
    iota = torch.arange(logits.shape[-1], device=logits.device)
    hit = iota == lab.long()[..., None]
    correct = shard(torch.where(hit, logits, torch.zeros(
        (), device=logits.device)).sum(dim=-1), "dp", None)
    return (lse - correct).sum()


def chunked_xent(cfg: ArchConfig, p, hidden: torch.Tensor,
                 labels: torch.Tensor,
                 chunk: Optional[int] = None) -> torch.Tensor:
    """Mean cross-entropy without keeping full (B,S,V) logits.

    The sequence is cut into at most 16 chunks, as the reference cuts it;
    each chunk runs under ``torch.utils.checkpoint``, so its float32
    logits (a 256,000-wide row per token for gemma2) are recomputed in
    the backward instead of kept."""
    B, S, _ = hidden.shape
    c = min(chunk or cfg.loss_chunk, S)
    while S % c:
        c -= 1
    n = S // c
    if n > 16:
        n = max(i for i in range(1, 17) if S % i == 0)
        c = S // n
    w = head_matrix(cfg, p)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n):
        total = total + checkpoint(
            _xent_chunk, cfg, w, hidden[:, i * c:(i + 1) * c],
            labels[:, i * c:(i + 1) * c], use_reentrant=False)
    return total / (B * S)
