"""The plain reference: the served model's forward pass in float32.

Plain ``torch`` operations on one sequence at a time, no cache, no
batching, no kernel, TF32 off: RMSNorm, rotary embeddings (rotate-half,
theta from the configuration), grouped-query attention (query head
``k * G + g`` reads KV head ``k``) at scale 1 / sqrt(hd), a SwiGLU FFN or
a routed MoE layer (top-k of the float32 router logits, the gates the
softmax over the k chosen), the final norm and the output head.  It
follows the port's equations where they depart from the published model
(the configuration file lists them: OLMoE's per-head qk-norm and gates
normalised over the chosen experts).

The weights are the tensors both sides were given; each layer's are
upcast to float32 as it runs, or, with ``precision="fp8"``, first
rounded to float8 e4m3 under one absmax scale per tensor: the control.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

FP8_MAX = 448.0           # largest float8 e4m3fn value
QUERY_BLOCK = 1024        # query rows of attention computed at once


def _fp8(w: torch.Tensor) -> torch.Tensor:
    w = w.float()
    scale = w.abs().amax().clamp(min=1e-12) / FP8_MAX
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, hd) at positions 0 .. S - 1."""
    S, _, hd = x.shape
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64,
                                    device=x.device) / half)
    ang = (torch.arange(S, dtype=torch.float64, device=x.device)[:, None]
           * freqs).float()
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class Reference:
    def __init__(self, conf: dict, weights: Dict[str, torch.Tensor],
                 precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.conf, self.w = conf, weights
        self.cast = _fp8 if precision == "fp8" else (lambda t: t.float())
        d, H = conf["hidden_size"], conf["num_attention_heads"]
        self.d, self.H, self.Kv = d, H, conf["num_key_value_heads"]
        self.hd = conf.get("head_dim") or d // H
        self.eps = float(conf["rms_norm_eps"])
        self.theta = float(conf["rope_theta"])
        self.experts = conf.get("num_experts", 0)
        self.top_k = conf.get("num_experts_per_tok", 0)
        # (position, layer) pairs where the reference's own top-k set
        # equals the program's it follows
        self.routes_agreed = self.routes_compared = 0

    def _p(self, path: str) -> torch.Tensor:
        t = self.w[path]
        return t.float() if t.dtype == torch.float32 else self.cast(t)

    def _attention(self, i: int, h: torch.Tensor) -> torch.Tensor:
        S, p = h.shape[0], f"layers/{i}/attn"
        q = (h @ self._p(f"{p}/wq").reshape(self.d, -1)).view(S, self.H, -1)
        k = (h @ self._p(f"{p}/wk").reshape(self.d, -1)).view(S, self.Kv, -1)
        v = (h @ self._p(f"{p}/wv").reshape(self.d, -1)).view(S, self.Kv, -1)
        if self.conf.get("qk_norm"):
            q = _rms(q, self._p(f"{p}/q_norm"), self.eps)
            k = _rms(k, self._p(f"{p}/k_norm"), self.eps)
        q, k = _rope(q, self.theta), _rope(k, self.theta)
        G = self.H // self.Kv
        qg = q.view(S, self.Kv, G, self.hd)
        out = torch.empty_like(qg)
        for a in range(0, S, QUERY_BLOCK):
            b = min(S, a + QUERY_BLOCK)
            s = torch.einsum("qkgh,tkh->kgqt", qg[a:b], k[:b])
            s = s / math.sqrt(self.hd)
            mask = torch.arange(b, device=h.device)[None, :] <= \
                torch.arange(a, b, device=h.device)[:, None]
            s = s.masked_fill(~mask, float("-inf"))
            out[a:b] = torch.einsum("kgqt,tkh->qkgh", torch.softmax(s, -1),
                                    v[:b])
        return out.reshape(S, -1) @ self._p(f"{p}/wo").reshape(-1, self.d)

    def _ffn(self, i: int, h: torch.Tensor, follow=None) -> torch.Tensor:
        p = f"layers/{i}"
        if not self.experts:
            g, u = self._p(f"{p}/mlp/w_gate"), self._p(f"{p}/mlp/w_up")
            return (F.silu(h @ g) * (h @ u)) @ self._p(f"{p}/mlp/w_down")
        logits = h @ self._p(f"{p}/moe/router")
        idx = torch.topk(logits, self.top_k, dim=-1).indices
        drop = None
        if follow is not None:
            route, drop = follow                      # (S, k) each
            known = route[:, 0] >= 0
            own = torch.sort(idx[known], -1).values
            self.routes_agreed += int(
                (own == torch.sort(route[known], -1).values).all(-1).sum())
            self.routes_compared += int(known.sum())
            idx = torch.where(known[:, None], route, idx)
        gates = torch.softmax(logits.gather(1, idx), dim=-1)
        if drop is not None:
            gates = gates * ~drop
        wg, wu = self.w[f"{p}/moe/w_gate"], self.w[f"{p}/moe/w_up"]
        wd = self.w[f"{p}/moe/w_down"]
        out = torch.zeros_like(h)
        for e in torch.unique(idx).tolist():
            rows, slot = torch.nonzero(idx == e, as_tuple=True)
            x = h[rows]
            y = (F.silu(x @ self.cast(wg[e])) * (x @ self.cast(wu[e]))) \
                @ self.cast(wd[e])
            out.index_add_(0, rows, y * gates[rows, slot, None])
        return out

    @torch.no_grad()
    def logits(self, tokens: List[int], rows: List[int],
               follow=None) -> torch.Tensor:
        """Float32 logits (len(rows), V) at positions ``rows`` of the
        sequence ``tokens``.  ``follow``, for an MoE model, is the
        program's (expert ids, dropped flags), each (layers, positions, k),
        ids -1 where the program computed no row (``moe_follow``): there
        the reference routes on its own and drops nothing."""
        dev = self.w["embed/table"].device
        ids = torch.tensor(tokens, dtype=torch.long, device=dev)
        x = self._p("embed/table")[ids] if self.cast is _fp8 else \
            self.w["embed/table"][ids].float()
        if follow is not None:
            S, (route, drop) = len(tokens), follow
            n = min(S, route.shape[1])
            r = torch.full((route.shape[0], S, route.shape[2]), -1,
                           dtype=torch.long, device=dev)
            d = torch.zeros(r.shape, dtype=torch.bool, device=dev)
            r[:, :n], d[:, :n] = route[:, :n], drop[:, :n]
            follow = (r, d)
        for i in range(self.conf["num_hidden_layers"]):
            x = x + self._attention(
                i, _rms(x, self._p(f"layers/{i}/ln1/scale"), self.eps))
            x = x + self._ffn(
                i, _rms(x, self._p(f"layers/{i}/ln2/scale"), self.eps),
                None if follow is None else (follow[0][i], follow[1][i]))
        x = _rms(x[rows], self._p("final_norm/scale"), self.eps)
        head = self.w.get("embed/head", self.w["embed/table"])
        return x @ self.cast(head).t()


def set_exact_float32():
    """TF32 off, so float32 products are float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
