"""The port's speculative decoding: the n-gram and draft-model drafters
against the reference's, and greedy parity of the port's engine with
speculation on and off (bf16 and int8 pools), also with the target model
drafting for itself.  Parity with the reference's speculative engine
itself is in ``test_torch_engine.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import layers as JL
from repro.models import model as JM
from repro.runtime.speculative import (
    DraftModelDrafter as JDraftModelDrafter, NGramDrafter as JNGramDrafter,
)
from repro_torch.configs import get_config
from repro_torch.models.model import init_params, params_from_jax
from repro_torch.runtime import (
    CacheConfig, DraftModelDrafter, EngineConfig, GenerationRequest,
    NGramDrafter, SamplingParams, make_engine,
)
from repro_torch.runtime.speculative import _last_logits


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


@pytest.fixture(scope="module")
def smoke():
    cfg = dataclasses.replace(get_config("yi-6b").smoke(),
                              param_dtype="float32")
    return cfg, init_params(cfg, seed=0, device="cpu")


def _serve(smoke, *, spec_k, kv_dtype, max_new=12, preempt=False,
           drafter=None):
    cfg, model = smoke
    srv = make_engine(cfg, model, EngineConfig(
        cache=CacheConfig(num_pages=64, page_size=4, max_pages_per_seq=16,
                          kv_dtype=kv_dtype),
        max_lanes=2, chunk=8, spec_k=spec_k, drafter=drafter), device="cpu")
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


# ------------------------------------------------------------ draft model --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bucket", [8, 32])
def test_draft_model_drafter_matches_reference(dtype, bucket):
    """The same weights (the reference's, carried over) propose the same
    greedy continuations from contexts of several lengths, across bucket
    boundaries.  In bfloat16 the two forwards round differently, so a
    proposal may differ only at a near-tie: the two forwards' logits at
    that position agree within the bf16 tolerance relative to the
    logits' scale (2e-2 x max |logit|), and the reference's margin
    between its token and ours is under 10x the two forwards'
    disagreement on that pair (counted and printed; in float32 none may
    differ)."""
    jcfg = dataclasses.replace(j_get_config("yi-6b").smoke(),
                               param_dtype=dtype)
    tcfg = dataclasses.replace(get_config("yi-6b").smoke(),
                               param_dtype=dtype)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(tcfg, jax.tree.map(np.asarray, params),
                            device="cpu")
    ref = JDraftModelDrafter(jcfg, params, target_vocab=jcfg.vocab_size,
                             bucket=bucket)
    ours = DraftModelDrafter(tcfg, model, target_vocab=tcfg.vocab_size,
                             bucket=bucket)
    rng = np.random.default_rng(bucket)
    excused = 0
    for n in (1, 5, bucket - 1, bucket, 13):
        ctx = rng.integers(0, tcfg.vocab_size, n).tolist()
        for k in (0, 1, 4):
            a, b = ours.propose(ctx, k), ref.propose(ctx, k)
            assert len(a) == len(b) == k
            j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     None)
            if j is None:
                continue
            assert dtype == "bfloat16", (n, k, a, b)
            toks = ctx + b[:j]
            pad = [0] * (-len(toks) % bucket or bucket)
            row = _last_logits(tcfg, model, torch.tensor([toks + pad]),
                               len(toks)).double().numpy()
            h = JM.forward_fullseq(jcfg, params, jnp.asarray([toks + pad]))
            jrow = np.asarray(JL.logits_from_hidden(
                jcfg, params["embed"], h[:, len(toks) - 1])[0], np.float64)
            diff = np.abs(row - jrow).max()
            assert diff <= 2e-2 * np.abs(jrow).max(), (n, k, j, diff)
            x, y = a[j], b[j]
            margin = jrow[y] - jrow[x]
            bound = 10 * abs((row[y] - row[x]) - margin)
            assert abs(margin) < bound, (n, k, j, margin, bound)
            excused += 1
    print(f"{dtype} bucket {bucket}: {excused} near-tie proposals excused")


def test_draft_model_drafter_vocab_check(smoke):
    cfg, model = smoke
    with pytest.raises(ValueError, match="vocab"):
        DraftModelDrafter(cfg, model, target_vocab=cfg.vocab_size + 1)
    DraftModelDrafter(cfg, model, target_vocab=cfg.vocab_size)


@pytest.mark.parametrize("spec_k", [2, 4])
def test_draft_model_self_draft_fully_accepted(smoke, spec_k):
    """Drafting with the target model itself is accepted wholesale (the
    verify step recomputes the drafter's greedy argmax on a pool of the
    model's own type), so speculation changes no token and rejects
    nothing."""
    cfg, model = smoke
    drafter = DraftModelDrafter(cfg, model, target_vocab=cfg.vocab_size,
                                bucket=8)
    base, _ = _serve(smoke, spec_k=0, kv_dtype="bf16", max_new=8)
    out, srv = _serve(smoke, spec_k=spec_k, kv_dtype="bf16", max_new=8,
                      drafter=drafter)
    assert out == base
    assert srv.spec_accepted > 0 and srv.spec_rejected == 0
