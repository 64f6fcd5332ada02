"""Deterministic synthetic LM data pipeline with per-host sharding.

A copy of ``repro.data.pipeline`` (pure numpy): the same seeds give the
reference's batches bit for bit.

Production posture: every host materializes only its slice of the global
batch (``host_id``/``num_hosts``), batches are a pure function of
(seed, step) — so restarts and elastic rescales replay identical data — and
a background prefetcher double-buffers ahead of the step.

Two generators:
  * SyntheticLMData — uniform hash-random tokens (for perf/dry-run work);
  * MarkovChainData — a fixed low-entropy Markov chain, *learnable*, so the
    end-to-end training example shows a real falling loss curve.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeSpec


class SyntheticLMData:
    def __init__(self, cfg: ArchConfig, shape: ShapeSpec, seed: int = 0,
                 num_hosts: int = 1, host_id: int = 0):
        assert shape.global_batch % num_hosts == 0
        self.cfg, self.shape = cfg, shape
        self.seed = seed
        self.num_hosts, self.host_id = num_hosts, host_id
        self.local_batch = shape.global_batch // num_hosts

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = self._rng(step)
        B, S = self.local_batch, self.shape.seq_len
        toks = rng.integers(0, self.cfg.vocab_size, (B, S + 1), dtype=np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.frontend:
            out["frontend"] = rng.standard_normal(
                (B, self.cfg.frontend_seq, self.cfg.d_model),
                dtype=np.float32).astype(np.float32) * 0.02
        return out


class MarkovChainData(SyntheticLMData):
    """Order-1 Markov chain over a small effective vocabulary."""

    def __init__(self, cfg: ArchConfig, shape: ShapeSpec, seed: int = 0,
                 num_hosts: int = 1, host_id: int = 0,
                 effective_vocab: int = 64, temperature: float = 0.3):
        super().__init__(cfg, shape, seed, num_hosts, host_id)
        self.k = min(effective_vocab, cfg.vocab_size)
        chain_rng = np.random.default_rng(seed + 12345)
        logits = chain_rng.standard_normal((self.k, self.k)) / temperature
        self.P = np.exp(logits - logits.max(1, keepdims=True))
        self.P /= self.P.sum(1, keepdims=True)
        self.cum = np.cumsum(self.P, axis=1)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = self._rng(step)
        B, S = self.local_batch, self.shape.seq_len
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.k, B)
        u = rng.random((B, S))
        for t in range(S):
            toks[:, t + 1] = (
                u[:, t, None] < self.cum[toks[:, t]]).argmax(axis=1)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.frontend:
            out["frontend"] = (rng.standard_normal(
                (B, self.cfg.frontend_seq, self.cfg.d_model)) * 0.02
            ).astype(np.float32)
        return out


class Prefetcher:
    """Background-thread double buffering over a data source."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            b = self.source.batch(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
