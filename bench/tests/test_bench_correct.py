"""The comparison that decides ``correct``, on a tiny model on the CPU:
a sound run passes; the float8 control and each fault a serving cell can
have (its state left unchanged, half of the batch left out, a token
altered where it is produced) come out not correct.  A one-chip cell has
no exchange between chips to leave out."""
import json

import pytest
import torch

import tinycell
from repro_torch.runtime import server as S


def limit():
    spec = json.loads((tinycell.BENCH / "workloads" / "yi6b.rag.json")
                      .read_text())
    return spec["limits"]["max_gap"]


@pytest.mark.parametrize("conf", [tinycell.DENSE, tinycell.MOE],
                         ids=["dense", "moe"])
def test_a_sound_run_is_correct(conf):
    out = tinycell.run(tinycell.cell(conf=conf, limit=limit()), seed=11)
    assert out["correct"], out["checks"]
    assert out["checks"]["compared"]["tokens"] > 50
    assert out["attempted"] > 10 and out["failed"] == 0


def test_the_control_is_not_correct():
    for seed in (21, 22, 23):
        out = tinycell.run(tinycell.cell(limit=limit()), seed=seed,
                           control=True)
        assert out["checks"]["max_gap"]["value"] <= limit()
        assert out["control"]["max_gap"] > limit(), out["control"]


def _state_unchanged(monkeypatch):
    real = S.PagedServer._chunk

    def chunk(self, *a, **kw):
        kept = self.kv_pages.clone()
        real(self, *a, **kw)
        self.kv_pages.copy_(kept)
    monkeypatch.setattr(S.PagedServer, "_chunk", chunk)


def _half_batch(monkeypatch):
    real = S._paged_chunk_step

    def step(*a, **kw):
        nxt, lens, logits = real(*a, **kw)
        half = nxt.shape[0] // 2
        nxt = torch.cat([nxt[:half], nxt[:half]])
        return nxt, lens, logits
    monkeypatch.setattr(S, "_paged_chunk_step", step)


def _token_altered(monkeypatch):
    real = S._select

    def select(logits, pos, sampling):
        return (real(logits, pos, sampling) + 1) % logits.shape[-1]
    monkeypatch.setattr(S, "_select", select)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _token_altered],
                         ids=["state_unchanged", "half_batch",
                              "token_altered"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = tinycell.run(tinycell.cell(limit=limit()), seed=13)
    assert not out["correct"], out["checks"]
    assert out["checks"]["max_gap"]["value"] > limit()
