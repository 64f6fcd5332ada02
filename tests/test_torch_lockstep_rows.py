"""Flips weighed on the rows the tokens were drawn from (``chip_smoke.py``).

``StepRows`` wraps ``PagedServer.step`` and keeps, for every engine that
steps under it, the float32 logits row each emitted token was drawn
from: a chunk or decode step's ``last_logits`` row, a verify step's
``verify_logits`` row (its accepted drafts, then its bonus token).
``_lockstep`` uses it, and ``excuse_first_flip`` weighs a lockstep's
first flip on those rows alone: a flip without a row on both sides fails.
The case that needs it runs on the CPU engine alone: phase 4's widths
(yi-6b x 2 layers, bf16) with weights from seed 3, an int8 pool and phase
4's sampled requests.  At rid 3's token 3 a rerun, which serves the
context alone on a fresh engine, packs the int8 pages from other chunks
and moves the logits by ~0.05: enough to carry a token across the top-p
threshold, so the rerun draws another token than the stream did.  The
other cases run at the smoke config's widths.
"""
import contextlib
import dataclasses
import io
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as CS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.runtime import CacheConfig, EngineConfig, \
    GenerationRequest, make_engine  # noqa: E402
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


def _rerun_row(engine, rid: int, ctx: tuple, sp) -> torch.Tensor:
    """The context ``ctx`` served alone for one token on the fresh
    ``engine`` (a sampled draw keeps its key: it is keyed by position):
    its last logits.  Not the row a stream drew its token from: on an
    int8 pool its pages are packed by other chunks."""
    engine.submit(GenerationRequest(rid, ctx,
                                    dataclasses.replace(sp, max_new=1)))
    engine.run()
    return engine.last_logits[0]


def _every_token_drawn_from_its_row(requests, out, rows):
    """Every emitted token has a recorded row, and the row draws it."""
    for r in requests:
        mine = rows.get(r.rid, {})
        assert sorted(mine) == list(range(len(out[r.rid]))), r.rid
        for j, tok in enumerate(out[r.rid]):
            assert _draw(mine[j], r.sampling, len(r.prompt) + j) == tok, \
                (r.rid, j)


def test_recorded_rows_weigh_the_int8_top_p_flip_a_rerun_cannot():
    """Every token of the lockstep has its recorded row, and each row
    draws its own token (the row is the lockstep's own).  At rid 3's
    token 3 the rerun's row draws another token z: z sits on the rerun
    row's top-p threshold and just outside the recorded row's, the two
    rows within 0.1 logits of each other.  With ``spec_k=4`` (drafts
    replayed from the first run) every token has its row too, a verify
    step's accepted drafts included, and draws from it."""
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
    assert all(len(out[r.rid]) == 8 for r in requests)
    _every_token_drawn_from_its_row(requests, out, rows[0])
    r = requests[3]
    sp = r.sampling
    ctx = tuple(r.prompt) + tuple(out[3][:3])
    recorded = rows[0][3][3]
    rerun = _rerun_row(engine(), 3, ctx, sp).float()
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
    unrecorded = sum(len(out[q.rid]) - len(rows[0].get(q.rid, {}))
                     for q in requests)
    assert unrecorded == 0
    _every_token_drawn_from_its_row(requests, out, rows[0])


@pytest.mark.parametrize("have", ["both", "first", "neither", "path"])
def test_a_flip_is_weighed_on_recorded_rows_where_both_streams_have_one(
        have, monkeypatch):
    """``excuse_first_flip`` hands ``flip_margin`` the two recorded rows at
    the first flip when both streams have one there, and fails the check
    when either lacks one (no rerun stands in).  Given a function of the
    context instead (phases 13 and draft parity: the two sides compute
    the position through different paths), it weighs that function's
    rows.  It prints which."""
    a, b = [5, 6, 7, 8], [5, 6, 9, 8]
    mine = [torch.full((10,), 1.0), torch.full((10,), 2.0)]
    theirs = [torch.full((10,), 3.0), torch.full((10,), 4.0)]
    asked, weighed = [], []

    def rows_at(ctx):
        asked.append(ctx)
        return theirs

    rows = {"both": [{2: mine[0]}, {2: mine[1]}],
            "first": [{2: mine[0]}, {1: mine[1]}],
            "neither": [{}, {}],
            "path": rows_at}[have]
    monkeypatch.setattr(CS, "flip_margin", lambda rows, x, y, *rest: (
        weighed.append((rows, x, y)) or (True, "near-tie")))
    if have in ("first", "neither"):
        with pytest.raises(RuntimeError, match="recorded no row"):
            CS.excuse_first_flip("case", (1, 2), a, b, rows, None,
                                 torch.float32)
        assert weighed == [] and asked == []
    else:
        assert CS.excuse_first_flip("case", (1, 2), a, b, rows, None,
                                    torch.float32)
        (got, x, y), = weighed
        assert (x, y) == (7, 9)
        if have == "both":
            assert asked == [] and all(r is m for r, m in zip(got, mine))
        else:
            assert asked == [(1, 2, 5, 6)] and got is theirs
    assert not CS.excuse_first_flip("case", (1, 2), a, a, rows, None,
                                    torch.float32)


def _smoke(dtype: str = "float32", arch: str = "yi-6b"):
    cfg = dataclasses.replace(get_config(arch).smoke(), param_dtype=dtype)
    return cfg, init_params(cfg, seed=0, device="cpu")


def _parity_spec(cfg, kv_dtype: str = "bf16", spec_k: int = 0,
                 known=None) -> dict:
    """Phase 4's and 18 (a)'s engine settings (64 pages of 16, 2 lanes,
    chunk 16), drafts replayed from ``known`` with ``spec_k``."""
    return dict(cache=CacheConfig(num_pages=64, page_size=16,
                                  max_pages_per_seq=8, kv_dtype=kv_dtype),
                max_lanes=2, chunk=16, spec_k=spec_k,
                drafter=CS.ReplayDrafter(known, cfg.vocab_size)
                if spec_k else None)


def _greedy(cfg, model, requests) -> dict:
    """{prompt: tokens} of a plain greedy run, for a ``ReplayDrafter``."""
    eng = make_engine(cfg, model, EngineConfig(**_parity_spec(cfg)),
                      device="cpu")
    out = CS._lockstep([eng], requests, preempt_rid=0, preempt_after=3)[0]
    return {tuple(r.prompt): out[r.rid] for r in requests}


def test_verify_rows_draw_the_accepted_drafts_and_the_bonus():
    """An int8 + ``spec_k=4`` greedy engine keeps every verify step's
    (B, K+1, V) rows (``verify_logits``): each accepted draft and each
    bonus token is the argmax of its recorded row, the bonus row is
    ``last_logits``, and row j of a lane equals a plain chunk step's row
    over the same context on the same pages within the f32 paged bar
    (the chunk re-feeds the lane's first j + 1 tokens of the step: their
    bytes are written again unchanged, and a rejected draft's growth of
    a page's scale is in the pages both read)."""
    cfg, model = _smoke()
    requests = CS.parity_requests(cfg)
    known = _greedy(cfg, model, requests)
    eng = make_engine(cfg, model, EngineConfig(**_parity_spec(
        cfg, "int8", 4, known)), device="cpu")
    real, checked = eng._spec_step, []

    def spec_step(pages, bt, lens, active, last_tok, drafts, n_spec,
                  kv_scales=None, sampling=None):
        out = real(pages, bt, lens, active, last_tok, drafts, n_spec,
                   kv_scales=kv_scales, sampling=sampling)
        verdict, logits = out[0], out[4]
        K = drafts.shape[1]
        assert torch.equal(out[3], logits[torch.arange(len(verdict)),
                                          verdict[:, K + 1].long()])
        feed = torch.cat([torch.zeros_like(drafts[:, :1]), drafts], 1)
        for b in torch.nonzero(active).flatten().tolist():
            for j in range(int(verdict[b, K + 1]) + 1):
                n_new = torch.zeros_like(n_spec)
                n_new[b] = j + 1
                use = torch.zeros_like(active)
                use[b] = 1
                _, _, row = eng._step(
                    pages.clone(), bt, lens, n_new, feed[:, :j + 1],
                    last_tok, use, kv_scales=kv_scales.clone())
                torch.testing.assert_close(row[b], logits[b, j],
                                           rtol=1e-4, atol=1e-4)
                checked.append((b, j))
        return out
    eng._spec_step = spec_step
    rows = [{}]
    out = CS._lockstep([eng], requests, preempt_rid=0, preempt_after=3,
                       rows=rows)[0]
    assert eng.spec_accepted > 0 and eng.spec_rejected > 0
    assert sum(j > 0 for _, j in checked) == eng.spec_accepted
    _every_token_drawn_from_its_row(requests, out, rows[0])
    assert eng.verify_logits.shape == (2, 5, cfg.vocab_size)


@pytest.mark.parametrize("mesh", [(2, 2, "bf16", 0), (2, 1, "int8", 4)],
                         ids=["2x2-bf16", "2x1-int8-spec4"])
def test_sharded_lockstep_rows_beside_the_unsharded_engine(mesh):
    """Phase 18 (a)'s lockstep at two of its meshes on the CPU: the
    sharded engine beside the unsharded one holding as many lanes and
    pages.  Every token of every lane has a row that draws it (the
    sharded engine's lanes index its clusters' rows concatenated), and
    the two engines' rows agree within ``MODEL_TOL[float32]`` up to the
    first flip of each stream."""
    C, H, kv_dtype, spec_k = mesh
    assert mesh in CS.SHARDED_LOCK
    cfg, model = _smoke()
    requests = CS.parity_requests(cfg)
    known = _greedy(cfg, model, requests) if spec_k else None
    spec = _parity_spec(cfg, kv_dtype, spec_k, known)
    engines = [
        make_engine(cfg, model, EngineConfig(clusters=C, heads=H,
                                             sharded=True, **spec),
                    device="cpu"),
        make_engine(cfg, model, EngineConfig(**dict(
            spec, max_lanes=2 * C, cache=dataclasses.replace(
                spec["cache"], num_pages=64 * C))), device="cpu")]
    rows = [{}, {}]
    outs = CS._lockstep(engines, requests, preempt_rid=0, preempt_after=3,
                        rows=rows)
    assert {r.cluster for r in engines[0].finished} == set(range(C))
    if spec_k:
        assert engines[0].spec_accepted > 0
    for out, mine in zip(outs, rows):
        _every_token_drawn_from_its_row(requests, out, mine)
    for r in requests:
        a, b = outs[0][r.rid], outs[1][r.rid]
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 len(a) - 1)
        for i in range(j + 1):
            CS.logits_agree([rows[0][r.rid][i], rows[1][r.rid][i]],
                            torch.float32, f"rid {r.rid} token {i}")


def test_serve_paged_under_the_recorder_has_a_row_for_every_token():
    """``launch.serve_paged.run`` steps its own engine through
    ``generate()``; ``StepRows`` still records it: all 9 streams (the
    sampling rid 1, the preempted request and the VIP submitted
    mid-stream) have a row for every token, which draws it."""
    from repro_torch.launch import serve_paged as SP
    from repro_torch.runtime import SamplingParams
    cfg, model = _smoke("bfloat16")
    with CS.StepRows() as rec, contextlib.redirect_stdout(io.StringIO()):
        got = SP.run(cfg, model, device="cpu")
    (rows,) = rec.rows.values()
    requests = SP.requests(8) + [GenerationRequest(
        **SP.VIP, sampling=SamplingParams(max_new=6))]
    assert got["preemptions"] >= 1
    assert sorted(rows) == sorted(got["streamed"]) == sorted(
        r.rid for r in requests)
    _every_token_drawn_from_its_row(
        requests, {rid: list(t) for rid, t in got["streamed"].items()},
        rows)


def test_recorded_rows_are_the_vocabulary_heads_own():
    """The rows ``StepRows`` keeps are, bit for bit, what the engine's
    vocabulary head gave for the token (``logits_from_hidden``, a chunk
    step's (B, V) rows, a verify step's (B, K+1, V)), as the MoE
    lockstep captured them before: olmoe's smoke engine, bf16 on an int8
    pool with ``spec_k=4``."""
    cfg, model = _smoke("bfloat16", "olmoe-1b-7b")
    requests = CS.parity_requests(cfg)
    known = _greedy(cfg, model, requests)
    eng = make_engine(cfg, model, EngineConfig(**_parity_spec(
        cfg, "int8", 4, known)), device="cpu")
    real, head, out = L.logits_from_hidden, {}, {r.rid: [] for r in requests}

    def spy(*args, **kw):
        head["last"] = real(*args, **kw)
        return head["last"]
    for r in requests:
        eng.submit(r)
    with CS.StepRows() as rec, pytest.MonkeyPatch.context() as mp:
        mp.setattr(L, "logits_from_hidden", spy)
        busy, preempted = True, False
        while busy:
            lanes = {r.rid: r.lane for r in eng.lanes if r is not None}
            busy = eng.step()
            lanes.update({r.rid: r.lane for r in eng.lanes
                          if r is not None and r.rid not in lanes})
            for d in eng.poll_deltas():
                for m, tok in enumerate(d.tokens):
                    lg = head["last"][lanes[d.rid]]
                    lg = lg if lg.dim() == 1 else lg[m]
                    assert torch.equal(rec.rows[eng][d.rid][
                        len(out[d.rid])], lg)
                    out[d.rid].append(tok)
            if not preempted and len(out[0]) >= 3:
                assert eng.preempt(0)
                preempted = True
    assert eng.spec_accepted > 0
    assert sum(map(len, rec.rows[eng].values())) == sum(map(len,
                                                            out.values()))
