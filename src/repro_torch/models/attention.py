"""Full-sequence GQA attention (train / prefill), the port of
``repro.models.attention``'s ``attend_fullseq`` and ``gqa_fullseq``.

The reference computes full-sequence attention as an exact chunked XLA
scan, which it calls the XLA-level analogue of its flash kernel (both
agree with the same oracle).  Here the flash kernel itself carries it: a
self-attention call whose query and key positions are ``arange(S)`` and
``arange(T)`` (``None``, as ``forward_fullseq`` passes them) goes to
``mha_flash`` (the CUDA kernel on the card, its plain version on the
CPU) with the layer's causal flag, window and logit cap.  That covers every call of the families ported so far; calls with
other positions (encoder offsets), ``kv_override`` (cross-attention) and
MLA raise ``NotImplementedError`` until their families are ported.
Decode attention lives with the paged engine (``runtime/server.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import mha_flash
from repro_torch.models.layers import rms_head_norm, rope


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
    B, S, d = x.shape
    q = (x @ p["wq"].reshape(d, -1)).reshape(B, S, cfg.num_heads, -1)
    k = (x @ p["wk"].reshape(d, -1)).reshape(B, S, cfg.num_kv_heads, -1)
    v = (x @ p["wv"].reshape(d, -1)).reshape(B, S, cfg.num_kv_heads, -1)
    if cfg.use_qk_norm:
        q = rms_head_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_head_norm(p["k_norm"], k, cfg.norm_eps)
    if cfg.use_rope:
        pos = positions if positions is not None else torch.arange(
            S, dtype=torch.int32, device=x.device)
        q = rope(q, pos[None, :], cfg.rope_theta)
        k = rope(k, pos[None, :], cfg.rope_theta)
    out = attend_fullseq(q, k, v, q_positions=positions,
                         k_positions=positions, causal=causal,
                         window=window, cap=cfg.attn_softcap)
    H, hd = cfg.num_heads, out.shape[-1]
    return out.reshape(B, S, H * hd) @ p["wo"].reshape(H * hd, d)
