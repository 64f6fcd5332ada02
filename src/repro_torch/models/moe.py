"""Capacity-based routed MoE: the port of ``repro.models.moe``.

Without a mesh this is the reference's GSPMD path (``_moe_gspmd``) with
one dispatch group: the router product in float32,
the top-k gates softmaxed over the k chosen experts, and a sort-based
dispatch into a ``(E, C, d)`` buffer.  Every row of ``x`` competes for
the C slots of each expert (C from :func:`_capacity`, or the worst case
with ``dropless``); an assignment past its expert's C-th slot is dropped,
in the order a stable sort of the flattened expert ids gives, which is
token order within an expert.  The expert products run in the
parameters' dtype through ``torch.bmm``, as the reference computes them
outside any Pallas kernel.

Under a mesh (``parallel.sharding.mesh_context``) :func:`moe_forward`
chooses as the reference does.  Where the expert-parallel axis divides
E and each data shard holds at least E rows, :func:`_moe_shardmap` runs
routing, sort and scatter shard-locally under ``local_map`` and moves
the tokens with one all-to-all pair across ``ep``.  Otherwise
:func:`_moe_gspmd` routes ``_dp_groups`` dispatch groups (the mesh's
data-parallel degree at 4,096 rows or more, else one), each group
shard-locally, and leaves the experts' products to DTensor with the
buffer split over ``ep``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import mlp_forward
from repro_torch.parallel.sharding import (
    PROFILES, axis_sizes, current_mesh, current_profile, local_region,
    placements, shard,
)


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
    expert); otherwise C is ``capacity`` or :func:`_capacity` of the rows
    of a dispatch group (all ``B * S`` without a mesh)."""
    out = _moe_shardmap(cfg, p, x, capacity, dropless)
    if out is None:
        out = _moe_gspmd(cfg, p, x, capacity, dropless)
    if cfg.moe_shared_experts:
        out = out + mlp_forward(cfg, p["shared"], x)
    return out


def _slots(cfg: ArchConfig, rows: int, capacity: Optional[int],
           dropless: bool) -> int:
    if dropless:
        return -(-rows * cfg.moe_top_k // 8) * 8
    return capacity or _capacity(cfg, rows)


def _moe_local(cfg: ArchConfig, p, xf: torch.Tensor, C: int):
    """One dispatch group's routed output: (T, d) rows -> (T, d)."""
    gate_vals, expert_idx = _route(cfg, p["router"], xf)        # (T, k)
    probs = torch.softmax(gate_vals, dim=-1)
    buf, meta = _dispatch(cfg, xf, expert_idx, C)
    return _combine(_experts(p, buf), meta, probs)


def _dp_groups(T: int) -> int:
    """Dispatch group count: the mesh's data-parallel degree at 4,096
    rows or more (grouping pays off at prefill and train sizes only),
    else 1; always 1 without a mesh."""
    mesh = current_mesh()
    if mesh is None or T < 4096:
        return 1
    sizes = axis_sizes(mesh)
    g = 1
    for a in PROFILES[current_profile()]["dp"]:
        g *= sizes.get(a, 1)
    if g <= 1 or T % g or (T // g) < 8:
        return 1
    return g


def _moe_shardmap(cfg: ArchConfig, p, x: torch.Tensor, capacity,
                  dropless) -> Optional[torch.Tensor]:
    """The expert-parallel path, or None where it does not apply (no
    mesh, no single ``ep`` axis of size > 1, ``ep`` not dividing E or the
    data shards not the batch, fewer rows per data shard than experts).
    Each data shard routes, sorts and scatters its own rows into an
    (E, C, d) buffer; one all-to-all sends each expert's slots to the
    ``ep`` shard holding it, the experts run on (E/ep, ep*C, d), and a
    second all-to-all brings the outputs back."""
    mesh = current_mesh()
    if mesh is None:
        return None
    sizes = axis_sizes(mesh)
    prof = PROFILES[current_profile()]
    ep_axes = tuple(a for a in prof["ep"] if sizes.get(a, 1) > 1)
    if len(ep_axes) != 1:
        return None
    ep = ep_axes[0]
    ntp = sizes[ep]
    E = cfg.moe_num_experts
    B, S, d = x.shape
    if E % ntp:
        return None
    dp_axes = tuple(a for a in prof["dp"] if sizes.get(a, 1) > 1 and a != ep)
    ndp = 1
    for a in dp_axes:
        ndp *= sizes[a]
    if B % ndp:
        return None
    T_loc = (B // ndp) * S
    if T_loc < E:
        # decode-sized row counts: the all-to-all's E*C slots for T_loc*k
        # assignments would outweigh the local path
        return None
    C = _slots(cfg, T_loc, capacity, dropless)
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    rows = tuple(Shard(0) if a in dp_axes else Replicate() for a in names)
    experts = tuple(Shard(0) if a == ep else Replicate() for a in names)
    group = (mesh, names.index(ep))
    repl = (Replicate(),) * len(names)

    def body(xl, router, wg, wu, wd):
        from torch.distributed import _functional_collectives as funcol
        Bl = xl.shape[0]
        xf = xl.reshape(Bl * S, d)
        gate_vals, expert_idx = _route(cfg, router, xf)
        probs = torch.softmax(gate_vals, dim=-1)
        buf, meta = _dispatch(cfg, xf, expert_idx, C)           # (E,C,d)
        # token payload exchange: (E, C, d) -> (E/ep, ep*C, d)
        recv = funcol.all_to_all_single_autograd(buf, None, None, group)
        El = E // ntp
        recv = recv.reshape(ntp, El, C, d).transpose(0, 1).reshape(
            El, ntp * C, d)
        y = _experts({"w_gate": wg, "w_up": wu, "w_down": wd}, recv)
        # reverse exchange back to the rows' owners
        y = y.reshape(El, ntp, C, d).transpose(0, 1).contiguous()
        y = funcol.all_to_all_single_autograd(y.reshape(E, C, d), None,
                                              None, group)
        return _combine(y, meta, probs).reshape(Bl, S, d)

    return local_region(
        "moe_shardmap", body,
        (x, p["router"], p["w_gate"], p["w_up"], p["w_down"]),
        (rows, repl, experts, experts, experts), [rows])


def _moe_gspmd(cfg: ArchConfig, p, x: torch.Tensor,
               capacity: Optional[int] = None,
               dropless: bool = False) -> torch.Tensor:
    """Group-local dispatch: the rows cut into :func:`_dp_groups` groups
    (one without a mesh), each routed, sorted and scattered on its own.
    Under a mesh the groups lie over ``dp``, routing and combining run
    on each device's groups (``local_map``), and the experts' products
    on the (G, E, C, d) buffer split over ``ep`` are DTensor's."""
    B, S, d = x.shape
    T = B * S
    if current_mesh() is None:
        return _moe_local(cfg, p, x.reshape(T, d),
                          _slots(cfg, T, capacity, dropless)
                          ).reshape(B, S, d)
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    G = _dp_groups(T)
    Tg = T // G
    C = _slots(cfg, Tg, capacity, dropless)
    mesh = current_mesh()
    xg = shard(x.reshape(G, Tg, d), "dp", None, None)

    def route(xg, router):
        bufs, metas = [], []
        for xl in xg:
            gate_vals, expert_idx = _route(cfg, router, xl)
            buf, (order, dest, valid) = _dispatch(cfg, xl, expert_idx, C)
            bufs.append(buf)
            metas.append((order, dest, valid,
                          torch.softmax(gate_vals, dim=-1)))
        return (torch.stack(bufs),) + tuple(
            torch.stack(m) for m in zip(*metas))

    def pl(shape, *axes):
        return placements(shape, axes, mesh)

    meta_pl = [pl((G, Tg * k), "dp", None)] * 3 + \
        [pl((G, Tg, k), "dp", None, None)]
    buf, *meta = local_region(
        "moe_route", route, (xg, p["router"]),
        (pl(xg.shape, "dp", None, None), pl(p["router"].shape, None, None)),
        [pl((G, E, C, d), "dp", None, None, None)] + meta_pl)
    buf = shard(buf, "dp", "ep", None, None)                    # the MoE a2a
    h = F.silu(torch.einsum("gecd,edf->gecf", buf, p["w_gate"])) * \
        torch.einsum("gecd,edf->gecf", buf, p["w_up"])
    h = shard(h, "dp", "ep", None, None)
    y = torch.einsum("gecf,efd->gecd", h, p["w_down"])
    y = shard(y, "dp", "ep", None, None)

    def combine(y, order, dest, valid, probs):
        return torch.stack([_combine(y[g], (order[g], dest[g], valid[g]),
                                     probs[g]) for g in range(y.shape[0])])

    out = local_region(
        "moe_combine", combine, (y, *meta),
        [pl(y.shape, "dp", None, None, None)] + meta_pl,
        [pl((G, Tg, d), "dp", None, None)])
    return shard(out, "dp", None, None).reshape(B, S, d)


def router_load(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    """Expert load histogram (E,) of the top-k assignments of every row
    of x (B, S, d), before any capacity drop."""
    T = x.shape[0] * x.shape[1]
    _, idx = _route(cfg, p["router"], x.reshape(T, -1))
    return torch.bincount(idx.reshape(-1), minlength=cfg.moe_num_experts)
