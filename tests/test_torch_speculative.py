"""The port's speculative decoding: the n-gram drafter against the
reference's, and greedy parity of the port's engine with speculation on
and off (bf16 and int8 pools).  Parity with the reference's speculative
engine itself is in ``test_torch_engine.py``."""
import dataclasses

import numpy as np
import pytest

from repro.runtime.speculative import NGramDrafter as JNGramDrafter
from repro_torch.configs import get_config
from repro_torch.models.model import init_params
from repro_torch.runtime import (
    CacheConfig, DraftModelDrafter, EngineConfig, GenerationRequest,
    NGramDrafter, SamplingParams, make_engine,
)


@pytest.mark.parametrize("max_n,min_n", [(3, 1), (2, 2), (4, 1)])
def test_ngram_drafter_matches_reference(max_n, min_n):
    """Random histories over a small vocabulary (so n-grams recur) give
    the same proposals from both drafters, for every k."""
    rng = np.random.default_rng(max_n * 10 + min_n)
    ours, ref = NGramDrafter(max_n, min_n), JNGramDrafter(max_n, min_n)
    for _ in range(300):
        ctx = rng.integers(0, 5, int(rng.integers(0, 24))).tolist()
        for k in range(0, 6):
            assert ours.propose(ctx, k) == ref.propose(ctx, k)


def test_ngram_drafter_cases():
    d = NGramDrafter(max_n=3)
    assert d.propose([1, 7, 8, 9, 7, 8, 9], 2) == [7, 8]
    assert d.propose([3, 5, 5, 5, 5, 5], 3) == [5, 5]
    assert d.propose([1, 2, 3], 2) == []
    with pytest.raises(ValueError):
        NGramDrafter(max_n=1, min_n=2)


def test_draft_model_drafter_not_ported():
    with pytest.raises(NotImplementedError, match="forward_fullseq"):
        DraftModelDrafter(None, None)


@pytest.fixture(scope="module")
def smoke():
    cfg = dataclasses.replace(get_config("yi-6b").smoke(),
                              param_dtype="float32")
    return cfg, init_params(cfg, seed=0, device="cpu")


def _serve(smoke, *, spec_k, kv_dtype, max_new=12, preempt=False):
    cfg, model = smoke
    srv = make_engine(cfg, model, EngineConfig(
        cache=CacheConfig(num_pages=64, page_size=4, max_pages_per_seq=16,
                          kv_dtype=kv_dtype),
        max_lanes=2, chunk=8, spec_k=spec_k), device="cpu")
    rng = np.random.default_rng(0)
    pat = rng.integers(1, cfg.vocab_size, 4).tolist()
    prompts = [pat * 3, rng.integers(1, cfg.vocab_size, 12).tolist(),
               pat * 2 + [5, 6], rng.integers(1, cfg.vocab_size, 9).tolist()]
    for rid, p in enumerate(prompts):
        srv.submit(GenerationRequest(rid, tuple(p),
                                     SamplingParams(max_new=max_new)))
    if preempt:
        for _ in range(6):
            srv.step()
        assert srv.preempt(0)
    done = srv.run()
    srv.pool.check_invariants()
    assert srv.pool.free_pages() == 64
    return {r.rid: r.tokens for r in done}, srv


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("preempt", [False, True])
def test_spec_on_equals_spec_off(smoke, kv_dtype, preempt):
    """The accepted prefix plus the bonus token is the greedy
    continuation, so speculation changes no token; rolled-back pages go
    home and every proposed draft is either accepted or rejected."""
    base, _ = _serve(smoke, spec_k=0, kv_dtype=kv_dtype, preempt=preempt)
    out, srv = _serve(smoke, spec_k=4, kv_dtype=kv_dtype, preempt=preempt)
    assert out == base
    assert srv.spec_proposed > 0
    assert srv.spec_proposed == srv.spec_accepted + srv.spec_rejected
    for r in srv.finished:
        assert 1 <= r.spec_k_final <= 4
        assert r.spec_proposed == r.spec_accepted + r.spec_rejected


@pytest.mark.parametrize("max_new", [1, 2, 5])
def test_spec_respects_max_new(smoke, max_new):
    """At most ``remaining - 1`` drafts per lane: no request overshoots
    its budget."""
    out, srv = _serve(smoke, spec_k=4, kv_dtype="int8", max_new=max_new)
    assert all(len(t) == max_new for t in out.values())
    assert all(r.finish_reason == "length" for r in srv.finished)
