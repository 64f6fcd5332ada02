"""Phase 4's flips weighed on the lockstep's own rows (``chip_smoke.py``).

``_lockstep`` keeps, for each engine, the float32 logits row each lane
drew each output token from on a non-speculative step, and
``excuse_first_flip`` weighs a flip on those rows where both streams have
one at that position (up to it the two contexts are equal), and on a
rerun of the context only where one is missing.  The case that needs it
runs on the CPU engine alone: phase 4's widths (yi-6b x 2 layers, bf16)
with weights from seed 3, an int8 pool and phase 4's sampled requests.
At rid 3's token 3 the rerun, which serves the context alone on a fresh
engine, packs the int8 pages from other chunks and moves the logits by
~0.05: enough to carry a token across the top-p threshold, so the rerun
draws another token than the stream did.
"""
import dataclasses
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as CS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.runtime import CacheConfig, EngineConfig, \
    make_engine  # noqa: E402
from repro_torch.runtime.server import _sample_scores  # noqa: E402


def _draw(row: torch.Tensor, sp, pos: int) -> int:
    """The token the engine's sampler takes from ``row`` at ``pos``."""
    if sp.greedy:
        return int(row.argmax())
    return int(_sample_scores(
        row.float()[None], torch.tensor([sp.seed & 0xFFFFFFFF]),
        torch.tensor([pos]), torch.tensor([sp.temperature]),
        torch.tensor([sp.top_k], dtype=torch.int32),
        torch.tensor([sp.top_p]))[0].argmax())


def test_recorded_rows_weigh_the_int8_top_p_flip_a_rerun_cannot():
    """Every token of the lockstep has its recorded row, and each row
    draws its own token (the row is the lockstep's own).  At rid 3's
    token 3 the rerun's row draws another token z: z sits on the rerun
    row's top-p threshold and just outside the recorded row's, the two
    rows within 0.1 logits of each other.  With ``spec_k=4`` (drafts
    replayed from the first run) a verify step's accepted drafts have no
    row, and the tokens that have one still draw from it."""
    cfg = dataclasses.replace(get_config("yi-6b"), num_layers=2,
                              param_dtype="bfloat16")
    model = init_params(cfg, seed=3, device="cpu")
    ecfg = EngineConfig(cache=CacheConfig(num_pages=64, page_size=16,
                                          max_pages_per_seq=8,
                                          kv_dtype="int8"),
                        max_lanes=2, chunk=16)
    requests = CS.parity_requests(cfg, sampled=True)

    def engine(spec=ecfg):
        return make_engine(cfg, model, spec, device="cpu")

    rows = [{}]
    out = CS._lockstep([engine()], requests, preempt_rid=1,
                       preempt_after=3, rows=rows)[0]
    for r in requests:
        assert sorted(rows[0][r.rid]) == list(range(len(out[r.rid]))) \
            == list(range(8))
        for j, tok in enumerate(out[r.rid]):
            assert _draw(rows[0][r.rid][j], r.sampling,
                         len(r.prompt) + j) == tok, (r.rid, j)
    r = requests[3]
    sp = r.sampling
    ctx = tuple(r.prompt) + tuple(out[3][:3])
    recorded = rows[0][3][3]
    rerun = CS.rerun_rows(lambda: [engine()], 3, sp)(ctx)[0].float()
    z = _draw(rerun, sp, len(ctx))
    assert z != out[3][3]
    assert CS.keep_margin(rerun, sp, z) >= 0 > CS.keep_margin(recorded,
                                                             sp, z)
    assert 0 < (recorded - rerun).abs().max().item() < 0.1

    spec = dataclasses.replace(ecfg, spec_k=4, drafter=CS.ReplayDrafter(
        {tuple(q.prompt): out[q.rid] for q in requests}, cfg.vocab_size))
    rows = [{}]
    eng = engine(spec)
    out = CS._lockstep([eng], requests, preempt_rid=1, preempt_after=3,
                       rows=rows)[0]
    assert eng.spec_accepted > 0
    unrecorded = 0
    for q in requests:
        mine = rows[0].get(q.rid, {})
        unrecorded += len(out[q.rid]) - len(mine)
        for j, row in mine.items():
            assert _draw(row, q.sampling, len(q.prompt) + j) == out[q.rid][j]
    assert unrecorded >= eng.spec_accepted


@pytest.mark.parametrize("have", ["both", "first", "neither"])
def test_a_flip_is_weighed_on_recorded_rows_where_both_streams_have_one(
        have, monkeypatch):
    """``excuse_first_flip`` hands ``flip_margin`` the two recorded rows at
    the first flip when both streams have one there, and the rerun's rows
    (``rows_at`` of the shared context) otherwise; it prints which."""
    a, b = [5, 6, 7, 8], [5, 6, 9, 8]
    mine = [torch.full((10,), 1.0), torch.full((10,), 2.0)]
    theirs = [torch.full((10,), 3.0), torch.full((10,), 4.0)]
    recorded = {"both": [{2: mine[0]}, {2: mine[1]}],
                "first": [{2: mine[0]}, {1: mine[1]}],
                "neither": None}[have]
    asked, weighed = [], []

    def rows_at(ctx):
        asked.append(ctx)
        return theirs

    monkeypatch.setattr(CS, "flip_margin", lambda rows, x, y, *rest: (
        weighed.append((rows, x, y)) or (True, "near-tie")))
    assert CS.excuse_first_flip("case", (1, 2), a, b, rows_at, None,
                                torch.float32, recorded=recorded)
    (rows, x, y), = weighed
    assert (x, y) == (7, 9)
    if have == "both":
        assert asked == [] and all(r is m for r, m in zip(rows, mine))
    else:
        assert asked == [(1, 2, 5, 6)] and rows is theirs
    assert not CS.excuse_first_flip("case", (1, 2), a, a, rows_at, None,
                                    torch.float32, recorded=recorded)
