"""What the reference follows of an MoE engine's steps: the experts its
router chose and which of those assignments its capacity dispatch
dropped.

The engine routes every row of a step, pad rows and idle lanes included,
through a dispatch with ``capacity_factor * rows * k / E`` slots per
expert, so whether a token's assignment survives depends on every other
row of its step.  The reference runs one sequence at a time and cannot
know that, so it follows the program: during the run this module keeps,
for each engine iteration, each lane's request and the positions its
rows hold (read where the engine accounts its appends), and for each MoE
layer call the routing and the dispatch's verdict (the tensors
``models/moe.py``'s ``_dispatch`` receives and returns).  Afterwards the reference takes, at each
position and layer, the experts the program chose (a bf16 near-tie of
the router picks another expert on either side, and one expert's share
of a random-weight model's output dwarfs rounding) with its own float32
gates over them, and drops those the program dropped.  The two stages
this skips are checked by themselves: the program's verdict must equal
the capacity rule applied to the program's own routing, exactly, and the
reference reports how often its own top-k agrees with the program's.

A prefill slab's record holds the routing of all of its rows (some 17 MB
on olmoe-1b-7b).  Kept on the device, the records would grow the memory
the run reports and make the allocator reserve fresh segments inside the
window; so each step's record moves to the host when the next step
begins to account its appends.  The engine's step ends in its one
device-to-host pull, so the device is idle then: the move costs three
stacking kernels and three copies a step, and waits on nothing.
"""
from __future__ import annotations

from typing import Dict, List

import torch


class RouteLog:
    def __init__(self, conf: dict):
        self.L = conf["num_hidden_layers"]
        self.E = conf["num_experts"]
        self.k = conf["num_experts_per_tok"]
        self.steps: List[dict] = []
        self.device = None
        self._undo = []

    def _to_host(self) -> None:
        """The newest step's (L, ...) routing, order and verdict, stacked
        over its layers and copied to the host."""
        if not self.steps or not self.steps[-1]["calls"]:
            return
        st = self.steps[-1]
        calls, st["calls"] = st["calls"], []
        st["host"] = [torch.stack([c[j] for c in calls]).cpu()
                      for j in range(3)] + [[c[3] for c in calls]]

    def install(self, engine) -> None:
        from repro_torch.models import moe as MOE
        real_acc = engine._account_appends
        real_disp = MOE._dispatch
        lanes = engine.max_lanes
        self.device = engine.device

        def account(active, n_new):
            self._to_host()
            rows = {r.rid: (r.lane, engine._pool(r).seq_len.get(r.rid, 0),
                            int(n_new[r.lane])) for r in active}
            self.steps.append({"rows": rows, "calls": [], "lanes": lanes})
            return real_acc(active, n_new)

        def dispatch(cfg, xf, expert_idx, C):
            buf, meta = real_disp(cfg, xf, expert_idx, C)
            if self.steps:
                self.steps[-1]["calls"].append(
                    (expert_idx, meta[0], meta[2], C))
            return buf, meta

        engine._account_appends = account
        MOE._dispatch = dispatch
        self._undo = [lambda: delattr(engine, "_account_appends"),
                      lambda: setattr(MOE, "_dispatch", real_disp)]

    def uninstall(self) -> None:
        self._to_host()
        for f in self._undo:
            f()
        self._undo = []

    @staticmethod
    def _kept(order, valid) -> torch.Tensor:
        kept = torch.empty_like(valid)
        kept[order] = valid
        return kept

    def _capacity_rule(self, expert_idx, C) -> torch.Tensor:
        """Kept flags of each (row, slot) under the capacity rule: a
        stable sort of the flattened expert ids; an assignment survives
        if fewer than ``C`` earlier ones went to its expert."""
        flat = expert_idx.reshape(-1)
        order = torch.argsort(flat, stable=True)
        s = flat[order]
        first = torch.searchsorted(s, torch.arange(self.E, device=s.device))
        pos = torch.arange(flat.numel(), device=s.device) - first[s]
        kept = torch.empty_like(pos, dtype=torch.bool)
        kept[order] = pos < C
        return kept

    def follow(self, rids) -> tuple:
        """Per request in ``rids``: its (L, positions, k) expert ids and
        (L, positions, k) dropped flags at each position it computed (-1
        and False elsewhere), and the count of (row, slot) assignments over
        those requests' steps whose verdict differs from the capacity rule
        (0 when the dispatch is sound)."""
        want = set(rids)
        got: Dict[int, Dict[int, list]] = {r: {} for r in want}
        mismatched = 0
        for st in self.steps:
            hit = want & st["rows"].keys()
            if not hit or len(st.get("host", ((),) * 4)[3]) != self.L:
                continue
            idxs, orders, valids = (t.to(self.device)
                                    for t in st["host"][:3])
            for li, C in enumerate(st["host"][3]):
                idx, order, valid = idxs[li], orders[li], valids[li]
                kept = self._kept(order, valid)
                mismatched += int((kept != self._capacity_rule(idx, C)).sum())
                kept = kept.view(-1, self.k)
                width = idx.shape[0] // st["lanes"]
                for rid in hit:
                    lane, start, n = st["rows"][rid]
                    rows = slice(lane * width, lane * width + n)
                    got[rid].setdefault(start, []).append(
                        (li, n, idx[rows], ~kept[rows]))
        out = {}
        for rid, per_start in got.items():
            if not per_start:
                continue
            end = max(s + parts[0][1] for s, parts in per_start.items())
            dev = next(iter(per_start.values()))[0][2].device
            route = torch.full((self.L, end, self.k), -1, dtype=torch.long,
                               device=dev)
            drop = torch.zeros((self.L, end, self.k), dtype=torch.bool,
                               device=dev)
            for s, parts in per_start.items():
                for li, n, ids, dropped in parts:
                    route[li, s:s + n] = ids
                    drop[li, s:s + n] = dropped
            out[rid] = (route, drop)
        return out, mismatched
