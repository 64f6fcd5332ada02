"""Capacity-based routed MoE: the port of ``repro.models.moe``.

The port has no device mesh, so this is the reference's GSPMD path
(``_moe_gspmd``) with one dispatch group: the router product in float32,
the top-k gates softmaxed over the k chosen experts, and a sort-based
dispatch into a ``(E, C, d)`` buffer.  Every row of ``x`` competes for
the C slots of each expert (C from :func:`_capacity`, or the worst case
with ``dropless``); an assignment past its expert's C-th slot is dropped,
in the order a stable sort of the flattened expert ids gives, which is
token order within an expert.  The expert products run in the
parameters' dtype through ``torch.bmm``, as the reference computes them
outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import mlp_forward


def _capacity(cfg: ArchConfig, tokens: int) -> int:
    """Slots per expert for ``tokens`` rows: ``tokens * top_k *
    capacity_factor / E``, at least 8, rounded up to a multiple of 8."""
    c = int(tokens * cfg.moe_top_k * cfg.moe_capacity_factor /
            cfg.moe_num_experts)
    c = max(c, 8)
    return -(-c // 8) * 8


def _route(cfg: ArchConfig, router: torch.Tensor, xf: torch.Tensor):
    """(T, d) rows -> their top-k gate logits and expert ids (T, k), the
    largest first, from the float32 router product."""
    logits = xf.float() @ router
    return torch.topk(logits, cfg.moe_top_k, dim=-1)


def _dispatch(cfg: ArchConfig, xf: torch.Tensor, expert_idx: torch.Tensor,
              C: int):
    """Sort-based dispatch of the (T, k) assignments into an (E, C, d)
    buffer: a stable sort of the flattened expert ids, each assignment's
    position in its expert's run, and a scatter in which an assignment
    past the C-th slot goes to row E*C, which is cut off (only there can
    indices repeat).  Returns (buf, (order, dest, valid))."""
    d = xf.shape[1]
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    N = expert_idx.numel()
    flat_expert = expert_idx.reshape(N)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    starts = torch.searchsorted(
        sorted_expert, torch.arange(E, device=xf.device), side="left")
    pos_in_e = torch.arange(N, device=xf.device) - starts[sorted_expert]
    valid = pos_in_e < C
    dest = torch.where(valid, sorted_expert * C + pos_in_e,
                       torch.full_like(pos_in_e, E * C))
    buf = xf.new_zeros((E * C + 1, d))
    buf[dest] = xf[order // k]
    return buf[:E * C].reshape(E, C, d), (order, dest, valid)


def _experts(p, buf: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU MLPs on their (E, C, d) slots, in the
    parameters' dtype."""
    h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    return torch.bmm(h, p["w_down"])


def _combine(y: torch.Tensor, meta, probs: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_dispatch`: (E, C, d) expert outputs -> (T, d),
    each token's k outputs weighted by its gates (cast to y's dtype); a
    dropped assignment contributes 0."""
    order, dest, valid = meta
    T, k = probs.shape
    d = y.shape[-1]
    y_flat = torch.cat([y.reshape(-1, d), y.new_zeros((1, d))])  # OOB row
    y_slots = y_flat[dest] * valid[:, None].to(y.dtype)
    unsorted = torch.empty_like(y_slots)
    unsorted[order] = y_slots
    return torch.einsum("tkd,tk->td", unsorted.reshape(T, k, d),
                        probs.to(y.dtype))


def moe_forward(cfg: ArchConfig, p, x: torch.Tensor,
                capacity: Optional[int] = None,
                dropless: bool = False) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  ``p`` holds ``router (d, E)`` (float32),
    ``w_gate``/``w_up (E, d, f)``, ``w_down (E, f, d)`` and, with shared
    experts, ``shared`` (a dense MLP added to the routed output).

    ``dropless`` sizes C for the worst case (every assignment on one
    expert); otherwise C is ``capacity`` or :func:`_capacity` of all
    ``B * S`` rows."""
    B, S, d = x.shape
    T = B * S
    if dropless:
        C = -(-T * cfg.moe_top_k // 8) * 8
    else:
        C = capacity or _capacity(cfg, T)
    xf = x.reshape(T, d)
    gate_vals, expert_idx = _route(cfg, p["router"], xf)        # (T, k)
    probs = torch.softmax(gate_vals, dim=-1)
    buf, meta = _dispatch(cfg, xf, expert_idx, C)
    out = _combine(_experts(p, buf), meta, probs).reshape(B, S, d)
    if cfg.moe_shared_experts:
        out = out + mlp_forward(cfg, p["shared"], x)
    return out


def router_load(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    """Expert load histogram (E,) of the top-k assignments of every row
    of x (B, S, d), before any capacity drop."""
    T = x.shape[0] * x.shape[1]
    _, idx = _route(cfg, p["router"], x.reshape(T, -1))
    return torch.bincount(idx.reshape(-1), minlength=cfg.moe_num_experts)
