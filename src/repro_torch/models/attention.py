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

Under a mesh (``parallel.sharding``) the reference's ``shard``
constraints lay q / k / v out by heads, and the code DTensor cannot
follow runs per device under ``local_map``: the flash op on each
device's heads, the decode write and attention on each device's heads
or its slots of a cache split over ``sp`` (the softmax combined across
them, :func:`softmax_av`), MLA's absorbed decode over its ``sp``-split
compressed cache.  Without a mesh every call runs as before.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import mha_flash
from repro_torch.models.layers import rms_head_norm, rope, softcap
from repro_torch.parallel.sharding import (
    axis_group, axis_sizes, current_mesh, heads_axis, local_region,
    placements, pspec_entry, shard, shard_index,
)

NEG_INF = -1e30
#: the head-parallel layout of q / k / v / out (B, S, heads, hd)
HEADS = ("dp", None, "tp", None)


def _tp_size() -> int:
    return axis_sizes(current_mesh()).get("model", 1)


def kv_cache_axes(cfg: ArchConfig) -> Tuple[Optional[str], ...]:
    """(B, T, kv, hd) cache sharding: heads over ``tp`` where the mesh's
    ``model`` size divides the kv heads, else the sequence over ``sp``."""
    if cfg.num_kv_heads % _tp_size() == 0:
        return ("dp", None, "tp", None)
    return ("dp", "sp", None, None)


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
    flash = functools.partial(mha_flash, causal=causal, window=window,
                              cap=cap, scale=scale)
    mesh = current_mesh()
    if mesh is None:
        return flash(q, k, v)
    # under a mesh: the kernel on each device's heads (``HEADS``)
    H, K = q.shape[2], k.shape[2]
    body = functools.partial(
        _flash_local, flash=flash, groups=H // K,
        heads=shard_index(mesh, pspec_entry(q.shape, HEADS, mesh, 2)))
    pl = [placements(t.shape, HEADS, mesh) for t in (q, k, v)]
    return local_region("attention", body, (q, k, v), pl, pl[:1])


def _flash_local(q, k, v, *, flash, groups: int, heads: Tuple[int, int]):
    """One device's heads (shard ``heads[0]`` of ``heads[1]``) through the
    flash op.  Where the query heads are split and the kv heads are not
    (their count is not divisible), the device's query heads, kv-major,
    read only the kv heads they belong to."""
    idx, n = heads
    if n > 1 and k.shape[2] * groups != q.shape[2]:
        h0, hl = idx * q.shape[2], q.shape[2]
        lo, hi = h0 // groups, (h0 + hl - 1) // groups + 1
        k, v = k[:, :, lo:hi], v[:, :, lo:hi]
    return flash(q, k, v)


def softmax_av(s: torch.Tensor, v: torch.Tensor, group=None
               ) -> torch.Tensor:
    """``softmax(s) @ v`` over the last axis of ``s`` (the keys), the
    probabilities cast to v's type.  With ``group`` (``axis_group``) the
    keys are split over its devices: the max and the sum are all-reduced
    across them before the product, and the products summed."""
    if group is None:
        return torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v)
    from torch.distributed import _functional_collectives as funcol
    m = funcol.all_reduce(s.amax(dim=-1, keepdim=True), "max", group)
    e = torch.exp(s - m)
    total = funcol.all_reduce(e.sum(dim=-1, keepdim=True), "sum", group)
    return funcol.all_reduce(torch.matmul((e / total).to(v.dtype), v),
                             "sum", group)


def attend_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  lengths: torch.Tensor, k_positions: torch.Tensor,
                  window: int = 0, cap: float = 0.0,
                  group=None) -> torch.Tensor:
    """One-token decode attention against a (ring or linear) cache.

    q: (B,1,H,hd); k/v: (B,T,K,hd); lengths: (B,) the new token's
    position; k_positions: (B,T) absolute position stored per slot (rings
    make slot != position).  Scores are float32 (bf16 operands upcast:
    their products are exact, the reference's
    ``preferred_element_type``); the probabilities are cast to v's type
    for the second product, as the reference casts them.  With ``group``
    the cache's slots are split over its devices (:func:`softmax_av`)."""
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
    out = softmax_av(s, v.permute(0, 2, 1, 3), group)           # (B,K,G,hd)
    return out.reshape(B, 1, H, v.shape[-1])


def attend_by_heads(q, k, v, *, lengths, k_positions) -> torch.Tensor:
    """:func:`attend_decode` against a cache laid out by heads
    (``HEADS``: whisper's cross-attention cache); under a mesh each
    device attends with its own heads."""
    mesh = current_mesh()
    if mesh is None:
        return attend_decode(q, k, v, lengths=lengths,
                             k_positions=k_positions)
    args = (q, k, v, lengths, k_positions)
    pl = [placements(t.shape, a, mesh) for t, a in zip(
        args, (HEADS, HEADS, HEADS, ("dp",), ("dp", None)))]

    def body(q, k, v, lengths, k_positions):
        return attend_decode(q, k, v, lengths=lengths,
                             k_positions=k_positions)
    return local_region("cross_attention", body, args, pl, pl[:1])


def project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B,S,d) @ (d,h,hd) -> (B,S,h,hd)."""
    B, S, d = x.shape
    mesh = current_mesh()
    if mesh is None:
        return (x @ w.reshape(d, -1)).reshape(B, S, w.shape[1], w.shape[2])
    if heads_axis(w.shape[1]) is None:
        # heads ``tp`` does not divide: each device projects all of them
        # for its rows, from the whole weight (DTensor cannot unflatten a
        # product split through a head)
        def body(x, w):
            return (x @ w.reshape(d, -1)).reshape(
                x.shape[0], S, w.shape[1], w.shape[2])
        out = placements((B, S) + tuple(w.shape[1:]),
                         ("dp", None, None, None), mesh)
        return local_region(
            "whole_heads", body, (x, w),
            [placements(x.shape, ("dp", None, None), mesh),
             placements(w.shape, (None, None, None), mesh)], [out])
    w2 = shard(w.reshape(d, -1), "fsdp", "tp")
    return shard(x @ w2, "dp", None, "tp").reshape(
        B, S, w.shape[1], w.shape[2])


def _project(cfg: ArchConfig, p, x: torch.Tensor):
    q, k, v = (project_heads(x, p[w]) for w in ("wq", "wk", "wv"))
    if cfg.use_qk_norm:
        q = rms_head_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_head_norm(p["k_norm"], k, cfg.norm_eps)
    return q, k, v


def out_proj(p, out: torch.Tensor) -> torch.Tensor:
    B, S, H, hd = out.shape
    # flattened (heads, hd) split only where the heads are: the
    # gradients unflatten the same way
    ax = heads_axis(H)
    return shard(out.reshape(B, S, H * hd), "dp", None, ax) @ \
        shard(p["wo"].reshape(H * hd, -1), ax, "fsdp")


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
    q, k, v = (shard(t, "dp", None, "tp", None) for t in (q, k, v))
    out = attend_fullseq(q, k, v, q_positions=positions,
                         k_positions=kpos, causal=causal,
                         window=window, cap=cfg.attn_softcap)
    out = shard(out, "dp", None, "tp", None)
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
    attend = functools.partial(attend_decode, window=window,
                               cap=cfg.attn_softcap)
    args = (q, k, v, k_cache, v_cache, slot, pos, k_positions)
    mesh = current_mesh()
    if mesh is None:
        return out_proj(p, _decode_local(*args, attend=attend)), \
            k_cache, v_cache
    # under a mesh: the write and the attention on each device's shard
    # of the cache, laid out as the cache is (heads over ``tp`` or slots
    # over ``sp``: ``decode_cache_axes``)
    ax = decode_cache_axes(cfg)
    seq = pspec_entry(k_cache.shape, ax, mesh, 1)
    qax = HEADS if ax[2] == "tp" else ("dp", None, None, None)
    pl = [placements(t.shape, a, mesh) for t, a in (
        (q, qax), (k, qax), (v, qax), (k_cache, ax), (v_cache, ax),
        (slot, ("dp",)), (pos, ("dp",)), (k_positions, ax[:2]))]
    body = functools.partial(_decode_local, attend=attend,
                             slots=shard_index(mesh, seq),
                             group=axis_group(mesh, seq))
    out = local_region("decode_attention", body, args, pl, pl[:1])
    return out_proj(p, out), k_cache, v_cache


def decode_cache_axes(cfg: ArchConfig) -> Tuple[Optional[str], ...]:
    """The logical axes of a (B, T, kv, hd) decode K/V cache, as
    ``models.model.cache_axes`` lays it out: hymba's ring unsplit,
    whisper's self-attention cache over heads, every other arch's
    :func:`kv_cache_axes`."""
    if cfg.block_kind == "hymba":
        return ("dp", None, None, None)
    if cfg.block_kind == "encdec":
        return HEADS
    return kv_cache_axes(cfg)


def write_slots(cache: torch.Tensor, new: torch.Tensor, slot: torch.Tensor,
                slots: Tuple[int, int] = (0, 1)):
    """``cache[b, slot[b]] = new[b]`` in place, on a device holding shard
    ``slots[0]`` of ``slots[1]`` equal blocks of the slot dim: a row whose
    slot lies in another block keeps its value."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    idx, n = slots
    if n == 1:
        cache[rows, slot] = new
        return
    local = slot - idx * cache.shape[1]
    inside = (local >= 0) & (local < cache.shape[1])
    local = local.clamp(0, cache.shape[1] - 1)
    keep = inside.reshape((-1,) + (1,) * (new.dim() - 1))
    cache[rows, local] = torch.where(keep, new, cache[rows, local])


def write_positions(kpos: torch.Tensor, slot: torch.Tensor,
                    pos: torch.Tensor):
    """``kpos[b, slot[b]] = pos[b]`` in place (each device its rows of
    the batch under a mesh)."""
    mesh = current_mesh()
    args = (kpos, pos, slot)
    if mesh is None:
        write_slots(*args)
        return
    pl = [placements(t.shape, a, mesh)
          for t, a in zip(args, (("dp", None), ("dp",), ("dp",)))]
    local_region("positions", write_slots, args, pl, [None])


def _decode_local(q, k, v, k_cache, v_cache, slot, pos, k_positions, *,
                  attend, slots=(0, 1), group=None):
    """The token's K/V written at ``slot``, then its attention over the
    cache (one device's shard of it under a mesh)."""
    write_slots(k_cache, k[:, 0], slot, slots)
    write_slots(v_cache, v[:, 0], slot, slots)
    return attend(q, k_cache, v_cache, lengths=pos,
                  k_positions=k_positions, group=group)


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
    q, k, v = (shard(t, "dp", None, "tp", None) for t in (q, k, v))
    out = attend_fullseq(q, k, v, q_positions=positions,
                         k_positions=positions, causal=True,
                         scale=_mla_scale(cfg))
    out = shard(out, "dp", None, "tp", None)
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
    q_nope, q_rope = _mla_q(cfg, p, x, pos[:, None])      # (B,1,H,*)
    c_new, kr_new = mla_compress_kv(cfg, p, x, pos[:, None])
    # absorb W_uk: (B,H,dn) x (r,H,dn) -> (B,H,r)
    q_c = torch.einsum("bhn,rhn->bhr", q_nope[:, 0], p["w_uk"])
    args = (q_c, q_rope[:, 0], c_new[:, 0], kr_new[:, 0], c_cache,
            rope_cache, slot, pos, k_positions)
    body = functools.partial(_mla_decode_local, scale=_mla_scale(cfg))
    mesh = current_mesh()
    if mesh is None:
        ctx_c = body(*args)
    else:
        # the compressed cache's slots over ``sp`` (the reference's
        # ("dp", "sp", None)); every device's query takes all heads
        cax = ("dp", "sp", None)
        seq = pspec_entry(c_cache.shape, cax, mesh, 1)
        pl = [placements(t.shape, a, mesh) for t, a in (
            (q_c, ("dp", None, None)), (args[1], ("dp", None, None)),
            (args[2], ("dp", None)), (args[3], ("dp", None)),
            (c_cache, cax), (rope_cache, cax), (slot, ("dp",)),
            (pos, ("dp",)), (k_positions, ("dp", "sp")))]
        body = functools.partial(body, slots=shard_index(mesh, seq),
                                 group=axis_group(mesh, seq))
        ctx_c = local_region("mla_decode", body, args, pl, pl[:1])
    out = torch.einsum("bhr,rhv->bhv", ctx_c, p["w_uv"])   # (B,H,dv)
    return out_proj(p, out[:, None]), c_cache, rope_cache


def _mla_decode_local(q_c, q_rope, c_new, kr_new, c_cache, rope_cache,
                      slot, pos, k_positions, *, scale: float,
                      slots=(0, 1), group=None):
    """The token's ``c`` and roped key written at ``slot``, then the
    absorbed attention: (B,H,r) context in compressed space."""
    write_slots(c_cache, c_new, slot, slots)
    write_slots(rope_cache, kr_new, slot, slots)
    s = (torch.matmul(q_c.float(), c_cache.float().transpose(1, 2))
         + torch.matmul(q_rope.float(),
                        rope_cache.float().transpose(1, 2))) \
        * scale                                            # (B,H,T)
    mask = (k_positions <= pos[:, None])[:, None, :]
    s = torch.where(mask, s, s.new_full((), NEG_INF))
    return softmax_av(s, c_cache, group)                   # (B,H,r)
