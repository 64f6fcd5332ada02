"""AdamW with a cosine schedule and global-norm clipping, the port of
``repro.optim.adamw``.

State is a plain dict keyed like the parameters (``model.param_shapes``
paths): ``m`` and ``v`` in float32, an int32 ``step`` and, unless
``use_master=False``, a float32 ``master`` copy of the parameters.  The
math is the reference's, in float32 from the master copy, the new
parameters cast back to their own type.  The reference's update is pure;
here ``m``, ``v``, the master copy, the parameters and the gradients are
updated in place (each in-place step computes what the reference's
expression computes, in the same order), one parameter at a time, so no
float32 copy of every gradient is ever alive at once: the whole state
sits on one card.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    clip_norm: float = 1.0
    use_master: bool = True


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to 10% of ``lr`` (float32)."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm,
                                0.1 + 0.9 * cos)


@torch.no_grad()
def init_opt_state(params: Mapping[str, torch.Tensor],
                   cfg: AdamWConfig) -> Dict[str, object]:
    """Zero float32 ``m``/``v``, ``step`` 0 (int32, on the parameters'
    device) and, with ``use_master``, a float32 copy of ``params``."""
    dev = next(iter(params.values())).device
    st: Dict[str, object] = {
        "m": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for k, p in params.items()},
        "v": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }
    if cfg.use_master:
        st["master"] = {k: p.detach().to(torch.float32, copy=True)
                        for k, p in params.items()}
    return st


@torch.no_grad()
def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Mapping[str, torch.Tensor], torch.Tensor]:
    """Scale every gradient, in place, by ``min(1, max_norm / (norm +
    1e-9))`` cast to its type; returns (grads, the float32 global norm)."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in grads.values()))
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    for g in grads.values():
        g.mul_(scale.to(g.dtype))
    return grads, gnorm


@torch.no_grad()
def adamw_update(params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], state: Dict[str, object],
                 cfg: AdamWConfig
                 ) -> Tuple[Mapping[str, torch.Tensor], Dict[str, object],
                            Dict[str, torch.Tensor]]:
    """One AdamW step over every parameter, in place.  ``grads`` is
    clipped in place too.  Returns (params, state, {"grad_norm", "lr"})."""
    step = state["step"] + 1
    lr = cosine_lr(cfg, step)
    if cfg.clip_norm:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        gnorm = torch.zeros((), dtype=torch.float32, device=step.device)
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)
    master = state.get("master")
    for k, p in params.items():
        g32 = grads[k].float()
        m, v = state["m"][k], state["v"][k]
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g32))
        del g32
        # p32 - lr * (mh / (sqrt(vh) + eps) + wd * p32)
        upd = (m / b1c).div_(torch.sqrt(v / b2c).add_(cfg.eps))
        p32 = master[k] if master is not None else p.float()
        upd.add_(cfg.weight_decay * p32)
        p32.sub_(upd.mul_(lr))
        del upd
        if p32 is not p:
            p.copy_(p32)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
