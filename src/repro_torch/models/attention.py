"""Attention, the port of ``repro.models.attention``: GQA full-sequence
(train / prefill / encoder / cross-attention: ``attend_fullseq``,
``gqa_fullseq``, ``gqa_make_kv``) and one-token decode against a dense
cache (``attend_decode``, ``gqa_decode``); deepseek-v2's MLA
full-sequence (``mla_fullseq``) and absorbed decode against its
compressed cache (``mla_decode``).

The reference computes full-sequence attention as an exact chunked XLA
scan, which it calls the XLA-level analogue of its flash kernel (both
agree with the same oracle).  Here the flash kernel itself carries it:
``mha_flash`` (the CUDA kernel on the card, its plain version on the
CPU) with the layer's causal flag, window and logit cap, on
top-left-aligned iotas.  Positions matter only under a causal mask or a
window, so a call that has neither (whisper's encoder and its
cross-attention) takes any positions; a causal or windowed call takes
``arange(S)`` / ``arange(T)`` (``None``, as ``forward_fullseq`` passes
them) and raises ``NotImplementedError`` for others.  MLA's full-sequence
attention goes through the same op with q/k head dim ``nope + rope``
(192) and v head dim ``v_head`` (128), each of the H heads its own KV
head (G = 1), the roped key shared by the heads broadcast over them.
Its projections are plain matrix products, as the reference's are XLA
einsums.

Decode attention over the dense (linear or ring) cache of
``models.model.init_cache`` is plain PyTorch, as the reference computes
it in XLA: scores in float32, a mask from the absolute position each
slot holds.  So is MLA's absorbed decode over its compressed cache
(scores against ``c`` and the shared roped key, float32).  The paged
engine's decode attention is the paged kernel's (``runtime/server.py``).
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
    Without a causal mask or a window every key is visible whatever the
    positions, so they are not read; with either, positions other than
    the iotas raise.  ``chunk`` (the reference's query-chunk bound on its
    live score tile) has no effect: the kernel never holds more than one
    tile of scores."""
    del chunk
    S, T = q.shape[1], k.shape[1]
    if (causal or window) and not (_is_iota(q_positions, S)
                                   and _is_iota(k_positions, T)):
        raise NotImplementedError(
            "attend_fullseq: a causal or windowed call with positions "
            "other than arange(S) / arange(T) is not ported; the flash "
            "kernel masks on top-left-aligned iotas")
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


def project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B,S,d) @ (d,h,hd) -> (B,S,h,hd)."""
    B, S, d = x.shape
    return (x @ w.reshape(d, -1)).reshape(B, S, w.shape[1], w.shape[2])


def _project(cfg: ArchConfig, p, x: torch.Tensor):
    q, k, v = (project_heads(x, p[w]) for w in ("wq", "wk", "wv"))
    if cfg.use_qk_norm:
        q = rms_head_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_head_norm(p["k_norm"], k, cfg.norm_eps)
    return q, k, v


def out_proj(p, out: torch.Tensor) -> torch.Tensor:
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
    """Full-sequence GQA of one layer: (B,S,d) -> (B,S,d);
    ``positions`` ``None`` means ``arange(S)``.  Self-attention projects
    K/V from ``x``; with ``kv_override`` (cross-attention) K/V are given
    (the encoder's, from :func:`gqa_make_kv`) at ``kv_positions``, and
    as in the reference neither q nor K is then roped and K is not
    qk-normed."""
    if cfg.attention_kind != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: {cfg.attention_kind} attention is not ported yet")
    S = x.shape[1]
    if kv_override is None:
        q, k, v = _project(cfg, p, x)
        kpos = positions
    else:
        q = project_heads(x, p["wq"])
        if cfg.use_qk_norm:
            q = rms_head_norm(p["q_norm"], q, cfg.norm_eps)
        k, v = kv_override
        kpos = kv_positions
    if cfg.use_rope and kv_override is None:
        pos = positions if positions is not None else torch.arange(
            S, dtype=torch.int32, device=x.device)
        q = rope(q, pos[None, :], cfg.rope_theta)
        k = rope(k, pos[None, :], cfg.rope_theta)
    out = attend_fullseq(q, k, v, q_positions=positions,
                         k_positions=kpos, causal=causal,
                         window=window, cap=cfg.attn_softcap)
    return out_proj(p, out)


def gqa_make_kv(cfg: ArchConfig, p, x: torch.Tensor):
    """K/V (B,T,Kv,hd) for cross-attention caches (encoder side), K
    roped at ``arange(T)`` (the encoder's positions) where the arch
    ropes."""
    k, v = project_heads(x, p["wk"]), project_heads(x, p["wv"])
    if cfg.use_rope:
        pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        k = rope(k, pos[None, :], cfg.rope_theta)
    return k, v


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
    return out_proj(p, out), k_cache, v_cache


# ---------------------------------------------------------------------------
# MLA (deepseek-v2)
# ---------------------------------------------------------------------------

def _mla_scale(cfg: ArchConfig) -> float:
    return 1.0 / math.sqrt(cfg.mla_qk_nope_dim + cfg.mla_qk_rope_dim)


def _mla_q(cfg: ArchConfig, p, x: torch.Tensor, positions: torch.Tensor):
    """The low-rank query: (B,S,H,nope) and (B,S,H,rope), the latter roped
    at ``positions`` ((S,) or (B,S))."""
    dn = cfg.mla_qk_nope_dim
    cq = rms_head_norm(p["q_norm"], x @ p["w_dq"], cfg.norm_eps)
    q = project_heads(cq, p["w_uq"])                     # (B,S,H,dn+dr)
    pos = positions if positions.dim() == 2 else positions[None, :]
    return q[..., :dn], rope(q[..., dn:], pos, cfg.rope_theta)


def mla_compress_kv(cfg: ArchConfig, p, x: torch.Tensor,
                    positions: torch.Tensor):
    """(B,S,r_kv) normed compressed KV and the (B,S,rope) roped key the
    heads share."""
    r_kv = cfg.mla_kv_lora_rank
    ckv = x @ p["w_dkv"]                                  # (B,S,r_kv+dr)
    c = rms_head_norm(p["kv_norm"], ckv[..., :r_kv], cfg.norm_eps)
    pos = positions if positions.dim() == 2 else positions[None, :]
    k_rope = rope(ckv[..., None, r_kv:], pos, cfg.rope_theta)[..., 0, :]
    return c, k_rope


def mla_fullseq(cfg: ArchConfig, p, x: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Training / prefill MLA of one layer: (B,S,d) -> (B,S,d), causal;
    ``positions`` ``None`` means ``arange(S)``.  Per-head K and V are
    decompressed from ``c`` and attend through the flash op at q/k head
    dim ``nope + rope`` and v head dim ``v_head``."""
    B, S, _ = x.shape
    H = cfg.num_heads
    pos = positions if positions is not None else torch.arange(
        S, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(cfg, p, x, pos)
    c, k_rope = mla_compress_kv(cfg, p, x, pos)
    k_nope = project_heads(c, p["w_uk"])                  # (B,S,H,dn)
    v = project_heads(c, p["w_uv"])                       # (B,S,H,dv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, k_rope.shape[-1])], dim=-1)
    out = attend_fullseq(q, k, v, q_positions=positions,
                         k_positions=positions, causal=True,
                         scale=_mla_scale(cfg))
    return out_proj(p, out)


def mla_decode(cfg: ArchConfig, p, x: torch.Tensor, pos: torch.Tensor,
               c_cache: torch.Tensor, rope_cache: torch.Tensor,
               slot: torch.Tensor, k_positions: torch.Tensor):
    """Absorbed-matrix MLA decode against the compressed cache.

    x: (B,1,d); c_cache: (B,T,r_kv); rope_cache: (B,T,rope).  The token's
    ``c`` and roped key are written at ``slot`` in place; scores are
    taken in compressed space (``q_c = q_nope @ W_uk``, float32 against
    ``c`` plus the roped part), ``ctx_c = probs @ c`` and ``v = ctx_c @
    W_uv``: the reference's serving formulation, 576 cached values a token
    and layer.  Returns (out, c_cache, rope_cache)."""
    B = x.shape[0]
    q_nope, q_rope = _mla_q(cfg, p, x, pos[:, None])      # (B,1,H,*)
    c_new, kr_new = mla_compress_kv(cfg, p, x, pos[:, None])
    rows = torch.arange(B, device=x.device)
    c_cache[rows, slot] = c_new[:, 0]
    rope_cache[rows, slot] = kr_new[:, 0]
    # absorb W_uk: (B,H,dn) x (r,H,dn) -> (B,H,r)
    q_c = torch.einsum("bhn,rhn->bhr", q_nope[:, 0], p["w_uk"])
    s = (torch.matmul(q_c.float(), c_cache.float().transpose(1, 2))
         + torch.matmul(q_rope[:, 0].float(),
                        rope_cache.float().transpose(1, 2))) \
        * _mla_scale(cfg)                                  # (B,H,T)
    mask = (k_positions <= pos[:, None])[:, None, :]
    s = torch.where(mask, s, s.new_full((), NEG_INF))
    pr = torch.softmax(s, dim=-1).to(c_cache.dtype)
    ctx_c = torch.matmul(pr, c_cache)                      # (B,H,r)
    out = torch.einsum("bhr,rhv->bhv", ctx_c, p["w_uv"])   # (B,H,dv)
    return out_proj(p, out[:, None]), c_cache, rope_cache
