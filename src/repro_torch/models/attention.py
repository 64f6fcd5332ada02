"""GQA attention, the port of ``repro.models.attention``: full-sequence
(train / prefill: ``attend_fullseq``, ``gqa_fullseq``) and one-token
decode against a dense cache (``attend_decode``, ``gqa_decode``).

The reference computes full-sequence attention as an exact chunked XLA
scan, which it calls the XLA-level analogue of its flash kernel (both
agree with the same oracle).  Here the flash kernel itself carries it: a
self-attention call whose query and key positions are ``arange(S)`` and
``arange(T)`` (``None``, as ``forward_fullseq`` passes them) goes to
``mha_flash`` (the CUDA kernel on the card, its plain version on the
CPU) with the layer's causal flag, window and logit cap.  That covers every call of the families ported so far; calls with
other positions (encoder offsets), ``kv_override`` (cross-attention) and
MLA raise ``NotImplementedError`` until their families are ported.

Decode attention over the dense (linear or ring) cache of
``models.model.init_cache`` is plain PyTorch, as the reference computes
it in XLA: scores in float32, a mask from the absolute position each
slot holds.  The paged engine's decode attention is the paged kernel's
(``runtime/server.py``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import mha_flash
from repro_torch.models.layers import rms_head_norm, rope, softcap

NEG_INF = -1e30


def _is_iota(t: Optional[torch.Tensor], n: int) -> bool:
    """``None`` stands for ``arange(n)``; a tensor is compared with it (a
    device tensor is read back for that: the forward passes ``None``)."""
    if t is None:
        return True
    return t.dim() == 1 and t.numel() == n and torch.equal(
        t, torch.arange(n, dtype=t.dtype, device=t.device))


def attend_fullseq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   q_positions: Optional[torch.Tensor] = None,
                   k_positions: Optional[torch.Tensor] = None,
                   causal: bool, window: int = 0, cap: float = 0.0,
                   chunk: int = 512,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention.  q: (B,S,H,hd), k/v: (B,T,K,hd), GQA via H = K*G;
    q_positions: (S,), k_positions: (T,), ``None`` meaning ``arange``.
    ``chunk`` (the reference's query-chunk bound on its live score tile)
    has no effect: the kernel never holds more than one tile of scores."""
    del chunk
    S, T = q.shape[1], k.shape[1]
    if not (_is_iota(q_positions, S) and _is_iota(k_positions, T)):
        raise NotImplementedError(
            "attend_fullseq: positions other than arange(S) / arange(T) "
            "(encoder offsets) are not ported yet; the flash kernel takes "
            "top-left-aligned iotas")
    return mha_flash(q, k, v, causal=causal, window=window, cap=cap,
                     scale=scale)


def attend_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  lengths: torch.Tensor, k_positions: torch.Tensor,
                  window: int = 0, cap: float = 0.0) -> torch.Tensor:
    """One-token decode attention against a (ring or linear) cache.

    q: (B,1,H,hd); k/v: (B,T,K,hd); lengths: (B,) the new token's
    position; k_positions: (B,T) absolute position stored per slot (rings
    make slot != position).  Scores are float32 (bf16 operands upcast:
    their products are exact, the reference's
    ``preferred_element_type``); the probabilities are cast to v's type
    for the second product, as the reference casts them."""
    B, _, H, hd = q.shape
    K = k.shape[2]
    qg = q.reshape(B, K, H // K, hd).float()
    s = torch.matmul(qg, k.float().permute(0, 2, 3, 1)) \
        / math.sqrt(hd)                                           # (B,K,G,T)
    s = softcap(s, cap)
    mask = k_positions <= lengths[:, None]                      # (B,T)
    if window:
        mask &= (lengths[:, None] - k_positions) < window
    s = torch.where(mask[:, None, None, :], s, s.new_full((), NEG_INF))
    pr = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.matmul(pr, v.permute(0, 2, 1, 3))               # (B,K,G,hd)
    return out.reshape(B, 1, H, v.shape[-1])


def _project(cfg: ArchConfig, p, x: torch.Tensor):
    B, S, d = x.shape
    q = (x @ p["wq"].reshape(d, -1)).reshape(B, S, cfg.num_heads, -1)
    k = (x @ p["wk"].reshape(d, -1)).reshape(B, S, cfg.num_kv_heads, -1)
    v = (x @ p["wv"].reshape(d, -1)).reshape(B, S, cfg.num_kv_heads, -1)
    if cfg.use_qk_norm:
        q = rms_head_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_head_norm(p["k_norm"], k, cfg.norm_eps)
    return q, k, v


def _out_proj(p, out: torch.Tensor) -> torch.Tensor:
    B, S, H, hd = out.shape
    return out.reshape(B, S, H * hd) @ p["wo"].reshape(H * hd, -1)


def gqa_fullseq(cfg: ArchConfig, p, x: torch.Tensor,
                positions: Optional[torch.Tensor] = None, *,
                window: int = 0,
                causal: bool = True,
                kv_override: Optional[Tuple[torch.Tensor,
                                            torch.Tensor]] = None,
                kv_positions: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Full-sequence GQA self-attention of one layer: (B,S,d) -> (B,S,d);
    ``positions`` ``None`` means ``arange(S)``."""
    if kv_override is not None or kv_positions is not None:
        raise NotImplementedError(
            "gqa_fullseq: kv_override (cross-attention) is not ported yet")
    if cfg.attention_kind != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: {cfg.attention_kind} attention is not ported yet")
    S = x.shape[1]
    q, k, v = _project(cfg, p, x)
    if cfg.use_rope:
        pos = positions if positions is not None else torch.arange(
            S, dtype=torch.int32, device=x.device)
        q = rope(q, pos[None, :], cfg.rope_theta)
        k = rope(k, pos[None, :], cfg.rope_theta)
    out = attend_fullseq(q, k, v, q_positions=positions,
                         k_positions=positions, causal=causal,
                         window=window, cap=cfg.attn_softcap)
    return _out_proj(p, out)


def gqa_decode(cfg: ArchConfig, p, x: torch.Tensor, pos: torch.Tensor,
               k_cache: torch.Tensor, v_cache: torch.Tensor,
               slot: torch.Tensor, k_positions: torch.Tensor, *,
               window: int = 0):
    """One-token GQA decode.

    x: (B,1,d); pos: (B,) absolute positions; slot: (B,) cache slot to
    write (== pos for linear caches, pos % W for ring caches);
    k_positions: (B,T) absolute position per slot, already updated for
    this token by the caller (positions are shared across layers and
    updated once per step).  The token's K/V are written into the caches
    in place.  Returns (out, k_cache, v_cache)."""
    q, k, v = _project(cfg, p, x)
    if cfg.use_rope:
        q = rope(q, pos[:, None], cfg.rope_theta)
        k = rope(k, pos[:, None], cfg.rope_theta)
    rows = torch.arange(x.shape[0], device=x.device)
    k_cache[rows, slot] = k[:, 0]
    v_cache[rows, slot] = v[:, 0]
    out = attend_decode(q, k_cache, v_cache, lengths=pos,
                        k_positions=k_positions, window=window,
                        cap=cfg.attn_softcap)
    return _out_proj(p, out), k_cache, v_cache
