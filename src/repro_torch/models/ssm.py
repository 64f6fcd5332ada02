"""Recurrent blocks: mLSTM / sLSTM (xLSTM) and the Mamba selective SSM
(hymba), the port of ``repro.models.ssm``.

The full-sequence mLSTM is the reference's chunkwise-parallel form: within
a chunk an attention-like product with a decay mask, across chunks a
(B, H, hd, hd) float32 state carried by a loop over the chunks; the
per-token recurrence (:func:`mlstm_reference`) is its oracle.  The
reference's ``lax.scan`` over time becomes a loop over time steps for
sLSTM and Mamba.  The reference computes all of this in XLA, not in
Pallas, so it stays plain PyTorch here: products through ``torch.matmul``
/ ``torch.einsum``, in the reference's order of operations.

All state math runs in float32, as in the reference (exp-gating is
fragile in bf16).  Parameters are the reference's (``build_mlstm``,
``build_slstm``, ``build_mamba``) under the same names; the
``*_state_specs`` functions give each recurrent state's ``(shape,
dtype)`` by name.

Heads (mLSTM, sLSTM) and channels (Mamba) recur independently, so under
a mesh (``parallel.sharding``) each scan runs per device on its own
under ``local_map`` (:func:`_by_heads`); without one it runs as before.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import project_heads
from repro_torch.models.layers import rms_head_norm
from repro_torch.parallel.sharding import (
    current_mesh, heads_axis, local_region, placements, shard,
)

NEG_INF = -1e30
#: Mamba time steps whose decay and input terms are formed at once (bounds
#: the (B, steps, di, N) float32 temporaries of a long prefill)
MAMBA_BLOCK = 128

StateSpecs = Dict[str, Tuple[Tuple[int, ...], torch.dtype]]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` with no linear cut-off."""
    return torch.logaddexp(x, x.new_zeros(()))


def _proj_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)`` in x's type.  Under a mesh an
    sLSTM ``w_in`` (d, 4, H, hd) goes gate by gate: flattening its
    trailing dims with the heads split would give DTensor a strided
    layout."""
    B, S, d = x.shape
    if w.dim() == 4 and current_mesh() is not None:
        return torch.stack([_proj_heads(x, w[:, g])
                            for g in range(w.shape[1])], dim=2)
    if w.dim() == 3:
        return project_heads(x, w)
    return (x @ w.reshape(d, -1)).reshape(B, S, *w.shape[1:])


def zero_state(specs: StateSpecs, device=None) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(s, dtype=dt, device=device)
            for k, (s, dt) in specs.items()}


# ===========================================================================
# mLSTM
# ===========================================================================

def mlstm_state_specs(cfg: ArchConfig, B: int) -> StateSpecs:
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    return {"C": ((B, H, hd, hd), torch.float32),
            "n": ((B, H, hd), torch.float32),
            "m": ((B, H), torch.float32)}


def _mlstm_gates(p, x: torch.Tensor):
    """(B,S,H) log input gate, log forget gate (sigmoid-gated, stable)."""
    raw = x.float() @ p["w_if"] + p["b_if"]
    H = raw.shape[-1] // 2
    log_i = raw[..., :H]                         # exp input gate: log i = raw
    log_f = -_softplus(-raw[..., H:])            # log sigmoid(f_raw)
    return log_i, log_f


def _mlstm_qkv(cfg: ArchConfig, p, x: torch.Tensor):
    hd = cfg.resolved_head_dim
    q = _proj_heads(x, p["wq"]).float()
    k = _proj_heads(x, p["wk"]).float() / math.sqrt(hd)
    v = _proj_heads(x, p["wv"]).float()
    return q, k, v


def _mlstm_out(cfg: ArchConfig, p, x: torch.Tensor,
               h: torch.Tensor) -> torch.Tensor:
    """Head norm, output gate and output projection: h (B,S,H,hd) f32."""
    B, S, d = x.shape
    h = rms_head_norm(p["head_norm"], h, cfg.norm_eps)
    h = shard(h.reshape(B, S, d), "dp", None,
              heads_axis(h.shape[2])).to(x.dtype)
    og = torch.sigmoid(x @ p["w_og"])
    return (h * og) @ p["w_out"]


def mlstm_fullseq(cfg: ArchConfig, p, x: torch.Tensor,
                  chunk: int = 256) -> torch.Tensor:
    """Chunkwise-parallel mLSTM over the full sequence.  x: (B,S,d).  The
    chunk is the largest divisor of S that is at most ``chunk``."""
    q, k, v = _mlstm_qkv(cfg, p, x)
    log_i, log_f = _mlstm_gates(p, x)
    # heads are independent: under a mesh each device scans its own
    heads = ("dp", None, "tp", None)
    h = _by_heads("mlstm", functools.partial(_mlstm_chunks, chunk=chunk),
                  (q, k, v, log_i, log_f),
                  (heads, heads, heads, heads[:3], heads[:3]),
                  [(q.shape, heads)])
    return _mlstm_out(cfg, p, x, h)


def _by_heads(name: str, fn, args, axes, outs):
    """``fn(*args)``, under a mesh on each device's heads
    (``local_region`` with the logical ``axes`` of each arg and the
    ``(shape, axes)`` of each output)."""
    mesh = current_mesh()
    if mesh is None:
        return fn(*args)
    pl = [placements(t.shape, a, mesh) for t, a in zip(args, axes)]
    return local_region(name, fn, args, pl,
                        [placements(s, a, mesh) for s, a in outs])


def _mlstm_chunks(q, k, v, log_i, log_f, *, chunk: int) -> torch.Tensor:
    """The chunkwise-parallel mLSTM recurrence: q, k, v (B,S,H,hd) and
    the log gates (B,S,H) -> h (B,S,H,hd), float32."""
    B, S, H, hd = q.shape
    c = min(chunk, S)
    while S % c:
        c -= 1
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))

    C_prev = q.new_zeros((B, H, hd, hd), dtype=torch.float32)
    n_prev = q.new_zeros((B, H, hd), dtype=torch.float32)
    m_prev = q.new_zeros((B, H), dtype=torch.float32)
    hs = []
    for s0 in range(0, S, c):
        qc, kc, vc = (t[:, s0:s0 + c] for t in (q, k, v))   # (B,c,H,hd)
        li, lf = log_i[:, s0:s0 + c], log_f[:, s0:s0 + c]     # (B,c,H)
        F = torch.cumsum(lf, dim=1)             # inclusive log-decay
        b = F + m_prev[:, None, :]              # inter-chunk decay
        # intra-chunk decay matrix D[t,s] = F_t - F_s + li_s  (s <= t)
        D = F[:, :, None, :] - F[:, None, :, :] + li[:, None, :, :]
        D = torch.where(tri[None, :, :, None], D,
                        D.new_full((), NEG_INF))
        m_t = torch.maximum(D.amax(dim=2), b).detach()       # (B,c,H)
        dec = torch.exp(D - m_t[:, :, None, :])              # (B,c,c,H)
        scores = torch.einsum("bthk,bshk->btsh", qc, kc) * dec
        intra = torch.einsum("btsh,bshk->bthk", scores, vc)
        inter_w = torch.exp(b - m_t)                         # (B,c,H)
        inter = torch.einsum("bthk,bhkj->bthj", qc, C_prev) \
            * inter_w[..., None]
        num = intra + inter
        nvec = torch.einsum("btsh,bshk->bthk", dec, kc)
        nvec = nvec + n_prev[:, None, :, :] * inter_w[..., None]
        denom = torch.maximum(
            torch.einsum("bthk,bthk->bth", qc, nvec).abs(), torch.exp(-m_t))
        hs.append(num / denom[..., None])                    # (B,c,H,hd)

        # chunk-final state
        F_tot = F[:, -1, :]                                  # (B,H)
        m_new = torch.maximum(
            F_tot + m_prev,
            (F_tot[:, None, :] - F + li).amax(dim=1)).detach()
        w_old = torch.exp(F_tot + m_prev - m_new)            # (B,H)
        w_s = torch.exp(F_tot[:, None, :] - F + li - m_new[:, None, :])
        C_prev = C_prev * w_old[..., None, None] + \
            torch.einsum("bsh,bshk,bshj->bhkj", w_s, kc, vc)
        n_prev = n_prev * w_old[..., None] + \
            torch.einsum("bsh,bshk->bhk", w_s, kc)
        m_prev = m_new
    return torch.cat(hs, dim=1) if len(hs) > 1 else hs[0]   # (B,S,H,hd)


def mlstm_decode(cfg: ArchConfig, p, x: torch.Tensor, state: dict
                 ) -> Tuple[torch.Tensor, dict]:
    """Single-token recurrent mLSTM.  x: (B,1,d)."""
    q, k, v = (t[:, 0] for t in _mlstm_qkv(cfg, p, x))      # (B,H,hd)
    log_i, log_f = _mlstm_gates(p, x)
    li, lf = log_i[:, 0], log_f[:, 0]                        # (B,H)
    C, n, m = state["C"], state["n"], state["m"]
    hk, hc = ("dp", "tp", None), ("dp", "tp", None, None)
    h, C, n, m_new = _by_heads(
        "mlstm_decode", _mlstm_cell, (q, k, v, li, lf, C, n, m),
        (hk, hk, hk, hk[:2], hk[:2], hc, hk, hk[:2]),
        [(q.shape, hk), (C.shape, hc), (n.shape, hk), (m.shape, hk[:2])])
    out = _mlstm_out(cfg, p, x, h[:, None])
    return out, {"C": C, "n": n, "m": m_new}


def _mlstm_cell(q, k, v, li, lf, C, n, m):
    """One recurrent mLSTM step: (h, C, n, m) after the token."""
    m_new = torch.maximum(lf + m, li)
    w_old = torch.exp(lf + m - m_new)
    w_in = torch.exp(li - m_new)
    C = C * w_old[..., None, None] + \
        torch.einsum("bhk,bhj->bhkj", k * w_in[..., None], v)
    n = n * w_old[..., None] + k * w_in[..., None]
    num = torch.einsum("bhk,bhkj->bhj", q, C)
    denom = torch.maximum(torch.einsum("bhk,bhk->bh", q, n).abs(),
                          torch.exp(-m_new))
    return num / denom[..., None], C, n, m_new               # (B,H,hd)


def mlstm_reference(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    """Per-token oracle of :func:`mlstm_fullseq` (slow loop over S)."""
    state = zero_state(mlstm_state_specs(cfg, x.shape[0]), x.device)
    ys = []
    for t in range(x.shape[1]):
        out, state = mlstm_decode(cfg, p, x[:, t:t + 1], state)
        ys.append(out)
    return torch.cat(ys, dim=1)


# ===========================================================================
# sLSTM
# ===========================================================================

def slstm_state_specs(cfg: ArchConfig, B: int) -> StateSpecs:
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    return {k: ((B, H, hd), torch.float32) for k in ("c", "n", "m", "h")}


def _slstm_step(cfg: ArchConfig, p, xt_proj: torch.Tensor, state: dict):
    """xt_proj: (B,4,H,hd) pre-computed x W_in.  Recurrent R on h."""
    c, n, m, h = state["c"], state["n"], state["m"], state["h"]
    rec = torch.einsum("bhk,ghkj->bghj", h, p["r"].float())
    g = xt_proj.float() + rec + p["b"]                       # (B,4,H,hd)
    z = torch.tanh(g[:, 0])
    i_raw, f_raw = g[:, 1], g[:, 2]
    o = torch.sigmoid(g[:, 3])
    m_new = torch.maximum(f_raw + m, i_raw)
    i_g = torch.exp(i_raw - m_new)
    f_g = torch.exp(f_raw + m - m_new)
    c_new = f_g * c + i_g * z
    n_new = torch.clamp_min(f_g * n + i_g, 1e-6)
    h_new = o * (c_new / n_new)
    return {"c": c_new, "n": n_new, "m": m_new, "h": h_new}


def _slstm_out(cfg: ArchConfig, p, x: torch.Tensor,
               h: torch.Tensor) -> torch.Tensor:
    B, S, d = x.shape
    h = rms_head_norm(p["head_norm"], h, cfg.norm_eps)
    h = shard(h.reshape(B, S, d), "dp", None, heads_axis(h.shape[2]))
    return h.to(x.dtype) @ p["w_out"]


def slstm_fullseq(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    xp = _proj_heads(x, p["w_in"])                           # (B,S,4,H,hd)
    heads = (None, "tp", None, None)
    h = _by_heads("slstm", functools.partial(_slstm_scan, cfg),
                  (xp, p["r"], p["b"]),
                  (("dp", None, None, "tp", None), heads, heads[:3]),
                  [((xp.shape[0], xp.shape[1]) + xp.shape[3:],
                    ("dp", None, "tp", None))])
    return _slstm_out(cfg, p, x, h)                          # (B,S,H,hd)


def _slstm_scan(cfg: ArchConfig, xp: torch.Tensor, r: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """The sLSTM recurrence over xp (B,S,4,H,hd) from a zero state ->
    h (B,S,H,hd); heads are independent (``r`` is block-diagonal)."""
    B, S, _, H, hd = xp.shape
    state = zero_state({k: ((B, H, hd), torch.float32)
                        for k in ("c", "n", "m", "h")}, xp.device)
    hs = []
    for t in range(S):
        state = _slstm_step(cfg, {"r": r, "b": b}, xp[:, t], state)
        hs.append(state["h"])
    return torch.stack(hs, dim=1)


def slstm_decode(cfg: ArchConfig, p, x: torch.Tensor, state: dict):
    xp = _proj_heads(x, p["w_in"])[:, 0]
    keys = ("c", "n", "m", "h")
    hk = ("dp", "tp", None)

    def step(xp, r, b, *st):
        new = _slstm_step(cfg, {"r": r, "b": b}, xp, dict(zip(keys, st)))
        return tuple(new[k] for k in keys)

    new = _by_heads(
        "slstm_decode", step, (xp, p["r"], p["b"]) + tuple(
            state[k] for k in keys),
        (("dp", None, "tp", None), (None, "tp", None, None),
         (None, "tp", None)) + (hk,) * 4,
        [(state[k].shape, hk) for k in keys])
    state = dict(zip(keys, new))
    return _slstm_out(cfg, p, x, state["h"][:, None]), state


# ===========================================================================
# Mamba selective SSM (hymba branch)
# ===========================================================================

def mamba_dims(cfg: ArchConfig):
    """(d_inner, dt_rank, state size)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    dt_rank = max(1, -(-cfg.d_model // 16))
    return d_inner, dt_rank, cfg.ssm_state


def mamba_state_specs(cfg: ArchConfig, B: int) -> StateSpecs:
    di, _, N = mamba_dims(cfg)
    return {"conv": ((B, cfg.ssm_conv_width - 1, di), torch.float32),
            "ssm": ((B, di, N), torch.float32)}


def _mamba_inner(cfg: ArchConfig, p, xz: torch.Tensor,
                 conv_in: torch.Tensor):
    """Shared projections. xz: (B,S,2*di); conv_in: (B, S+w-1, di) padded."""
    di, _, N = mamba_dims(cfg)
    xpart, z = xz[..., :di], xz[..., di:]
    w = p["conv_w"].float()                                  # (w, di)
    S = xpart.shape[1]
    conv = sum(conv_in[:, j:j + S, :].float() * w[j]
               for j in range(cfg.ssm_conv_width))
    conv = torch.nn.functional.silu(conv + p["conv_b"].float())
    # the low-rank dt projection whole on every device between its halves
    down = shard(conv @ p["w_dt_down"].float(), "dp", None, None)
    dt = _softplus(down @ p["w_dt_up"].float() + p["b_dt"])  # (B,S,di)
    Bp = conv @ p["w_B"].float()
    Cp = conv @ p["w_C"].float()
    return xpart, z, conv, dt, Bp, Cp


def _mamba_out(p, x: torch.Tensor, y: torch.Tensor,
               z: torch.Tensor) -> torch.Tensor:
    y = y * torch.nn.functional.silu(z.float())
    return y.to(x.dtype) @ p["w_out"]


def mamba_fullseq(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    """The selective scan as a loop over time steps.  Per step it is the
    reference's ``h = exp(dt A) h + (dt u) B``, ``y = h . C``; the
    step-independent factors are formed :data:`MAMBA_BLOCK` steps at a
    time, element for element the same arithmetic."""
    B = x.shape[0]
    di = mamba_dims(cfg)[0]
    A = -torch.exp(p["log_A"])                               # (di,N) < 0
    xz = x @ p["w_in"]
    xpart = xz[..., :di]
    pad = xpart.new_zeros((B, cfg.ssm_conv_width - 1, di))
    conv_in = torch.cat([pad, xpart], dim=1)
    xpart, z, conv, dt, Bp, Cp = _mamba_inner(cfg, p, xz, conv_in)

    # channels are independent: under a mesh each device scans its own
    ch = ("dp", None, "tp")
    y = _by_heads("mamba", _mamba_scan, (dt, conv, Bp, Cp, A),
                  (ch, ch, ("dp", None, None), ("dp", None, None),
                   ("tp", None)), [(dt.shape, ch)])
    return _mamba_out(p, x, y + conv * p["D"], z)               # (B,S,di)


def _mamba_scan(dt, conv, Bp, Cp, A) -> torch.Tensor:
    """The selective scan from a zero state: dt, conv (B,S,di), Bp, Cp
    (B,S,N), A (di,N) -> y (B,S,di) without the skip term."""
    B, S, di = dt.shape
    h = dt.new_zeros((B, di, A.shape[1]), dtype=torch.float32)
    ys = []
    for s0 in range(0, S, MAMBA_BLOCK):
        sl = slice(s0, s0 + MAMBA_BLOCK)
        a = torch.exp(dt[:, sl, :, None] * A)                # (B,s,di,N)
        bx = (dt[:, sl] * conv[:, sl])[..., None] * Bp[:, sl, None, :]
        hs = []
        for t in range(a.shape[1]):
            h = a[:, t] * h + bx[:, t]
            hs.append(h)
        ys.append(torch.einsum("bsdn,bsn->bsd", torch.stack(hs, dim=1),
                               Cp[:, sl]))
    return torch.cat(ys, dim=1)


def mamba_decode(cfg: ArchConfig, p, x: torch.Tensor, state: dict):
    """One token.  The float32 conv state is cast to the activations'
    type before it joins the new input, as the reference casts it."""
    di, _, N = mamba_dims(cfg)
    A = -torch.exp(p["log_A"])
    xz = x @ p["w_in"]                                       # (B,1,2di)
    xpart = xz[..., :di]
    conv_in = torch.cat([state["conv"].to(xpart.dtype), xpart], dim=1)
    xpart, z, conv, dt, Bp, Cp = _mamba_inner(cfg, p, xz, conv_in)
    new_conv = conv_in[:, 1:, :].float()

    dt_t, u_t, B_t, C_t = dt[:, 0], conv[:, 0], Bp[:, 0], Cp[:, 0]
    a = torch.exp(dt_t[..., None] * A)
    h = a * state["ssm"] + (dt_t * u_t)[..., None] * B_t[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, C_t) + u_t * p["D"]
    out = _mamba_out(p, x, y[:, None], z)
    return out, {"conv": new_conv, "ssm": h}
