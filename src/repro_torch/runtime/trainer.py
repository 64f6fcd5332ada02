"""Trainer: checkpoint/restart fault tolerance and a straggler watchdog,
the port of ``repro.runtime.trainer``.

  * async checkpoint every N steps with atomic commit, in the reference's
    on-disk format and train-state layout (``models.steps.state_tree``);
  * ``run_with_recovery`` restarts from the last commit on (injected or
    real) step failures;
  * a straggler watchdog tracks a step-time EMA; steps slower than
    ``straggler_factor x EMA`` are flagged, counted and traced as a
    ``SYNC`` host event;
  * deterministic data (a pure function of the step) makes recovery
    replayable.

Steps run eagerly on ``device`` (``cuda`` unless the caller passes
``"cpu"``); a step's time ends in ``torch.cuda.synchronize()`` where the
reference blocks on the loss.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.checkpoint.store import (
    AsyncCheckpointer, latest_step, restore_checkpoint,
)
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.tracing import EventType, TraceBuffer
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import steps as ST
from repro_torch.optim.adamw import AdamWConfig


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    log_every: int = 10
    straggler_factor: float = 3.0
    ema_alpha: float = 0.2
    max_restarts: int = 3


class FailureInjector:
    """Deterministic failure schedule: raise at given steps (once each)."""

    def __init__(self, fail_at: List[int]):
        self.fail_at = set(fail_at)
        self.fired: set = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected node failure at step {step}")


class Trainer:
    def __init__(self, cfg: ArchConfig, shape: ShapeSpec, data,
                 tcfg: Optional[TrainerConfig] = None,
                 opt_cfg: Optional[AdamWConfig] = None,
                 tracer: Optional[TraceBuffer] = None,
                 compress: bool = False, device: DeviceLike = None):
        self.cfg, self.shape, self.data = cfg, shape, data
        self.tcfg = tcfg if tcfg is not None else TrainerConfig()
        self.opt_cfg = opt_cfg or ST.default_opt_cfg(cfg)
        self.tracer = tracer
        self.compress = compress
        self.device = resolve_device(device)
        self.step_fn = ST.make_train_step(cfg, self.opt_cfg, compress)
        self.ckpt = AsyncCheckpointer(self.tcfg.ckpt_dir)
        self.metrics_log: List[Dict[str, float]] = []
        self.straggler_steps: List[int] = []
        self.restarts = 0

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0):
        return ST.init_train_state(self.cfg, self.opt_cfg, seed,
                                   self.compress, self.device)

    def _resume_or_init(self, seed: int = 0):
        last = latest_step(self.tcfg.ckpt_dir)
        state = self.init_state(seed)
        if last is None:
            return state, 0
        tree, step = restore_checkpoint(self.tcfg.ckpt_dir, step=last)
        return ST.load_state_tree(self.cfg, state, tree), step

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def run(self, state=None, start_step: int = 0,
            failure: Optional[FailureInjector] = None) -> Dict[str, Any]:
        if state is None:
            state, start_step = self._resume_or_init()
        ema = None
        step = start_step
        while step < self.tcfg.total_steps:
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.data.batch(step).items()}
            t0 = time.perf_counter()
            if failure is not None:
                failure.maybe_fail(step)
            state, metrics = self.step_fn(state, batch)
            self._sync()
            dt = time.perf_counter() - t0

            # straggler watchdog
            if ema is None:
                ema = dt
            if dt > self.tcfg.straggler_factor * ema and \
                    step > start_step + 2:
                self.straggler_steps.append(step)
                if self.tracer:
                    self.tracer.record_host(EventType.SYNC, step, 1)
            ema = self.tcfg.ema_alpha * dt + (1 - self.tcfg.ema_alpha) * ema

            if step % self.tcfg.log_every == 0 or \
                    step == self.tcfg.total_steps - 1:
                self.metrics_log.append({
                    "step": step, "loss": float(metrics["loss"]),
                    "grad_norm": float(metrics["grad_norm"]),
                    "lr": float(metrics["lr"]), "step_s": dt,
                })
            step += 1
            if step % self.tcfg.ckpt_every == 0:
                self.ckpt.save(step, ST.state_tree(self.cfg, state))
        self.ckpt.save(step, ST.state_tree(self.cfg, state))
        self.ckpt.wait()
        return {"state": state, "final_step": step,
                "metrics": self.metrics_log,
                "stragglers": self.straggler_steps,
                "restarts": self.restarts}

    # ------------------------------------------------------------------
    def run_with_recovery(self, failure: Optional[FailureInjector] = None,
                          seed: int = 0) -> Dict[str, Any]:
        """Full fault-tolerant loop: restart from last commit on failure."""
        attempts = 0
        while True:
            try:
                state, start = self._resume_or_init(seed)
                return self.run(state, start, failure)
            except RuntimeError as e:
                attempts += 1
                self.restarts = attempts
                self.ckpt.wait()
                if attempts > self.tcfg.max_restarts:
                    raise RuntimeError(
                        f"exceeded max_restarts={self.tcfg.max_restarts}"
                    ) from e
