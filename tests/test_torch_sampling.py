"""On-device sampling in the port against the JAX engine.

The sampler alone (``server._sample_tokens``) on the same (B, V) logits,
seeds, positions, temperatures, top-k and top-p as the reference's; then
the port's ``PagedServer`` against the JAX ``PagedServer`` at
``yi-6b.smoke()`` (float32 weights carried over by ``params_from_jax``),
after the unsharded cases of ``tests/test_sampling.py``: the same seed
gives the same stream, another seed another, the stream does not depend
on the chunk size, temperature 0 and top-k 1 are greedy, sampling lanes
ride along under speculation, and a preempted sampling lane resumes its
stream.  Tokens, iterations, transfer counts and speculation counters
must equal the reference's.

Parity rule for sampled tokens: bits, uniforms, greedy tokens and the
top-k mask are exact; a sampled token may differ from the reference's
only where the reference's top two values of ``lg + gumbel`` are under
1e-5 apart (ten times the largest gap measured between the two backends'
Gumbel draws).  Such near-ties are counted and printed, and at these small
sizes the count must be 0.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as JM
from repro.runtime import (
    CacheConfig as JCacheConfig, EngineConfig as JEngineConfig,
    GenerationRequest as JRequest, SamplingParams as JSampling,
    make_engine as j_make_engine,
)
from repro.runtime.server import _sample_tokens as j_sample_tokens
from repro_torch.configs import get_config
from repro_torch.models.model import params_from_jax
from repro_torch.runtime import (
    CacheConfig, EngineConfig, GenerationRequest, SamplingParams,
    make_engine,
)
from repro_torch.runtime import server as S

NEAR_TIE = 1e-5
MAX_NEW = 8


# ---------------------------------------------------------------- sampler --

def _j_scores(logits, seeds, pos, temps, top_ks, top_ps):
    """The reference sampler's ``lg + gumbel`` (its categorical draw is
    their argmax): ``repro.runtime.server._sample_tokens``'s ``one`` step
    for step, stopping before the argmax."""
    def one(lg, seed, p, t, tk, tp):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), p)
        V = lg.shape[-1]
        lg = lg / jnp.maximum(t, 1e-6)
        desc = jnp.sort(lg)[::-1]
        kth = desc[jnp.clip(tk - 1, 0, V - 1)]
        lg = jnp.where((tk > 0) & (lg < kth), -jnp.inf, lg)
        probs = jax.nn.softmax(lg)
        sp = jnp.sort(probs)[::-1]
        keep = (jnp.cumsum(sp) - sp) < tp
        thresh = jnp.min(jnp.where(keep, sp, jnp.inf))
        lg = jnp.where(probs >= thresh, lg, -jnp.inf)
        return jax.random.gumbel(key, (V,), lg.dtype) + lg

    return np.asarray(jax.jit(jax.vmap(one))(logits, seeds, pos, temps,
                                             top_ks, top_ps))


def _lanes(V: int, rng):
    """One lane per (temperature, top-k, top-p) of the grid: temperatures
    0 to 1.5, top-k 0, 1, 3 and V, top-p 0.5, 0.9 and 1."""
    grid = list(itertools.product((0.0, 0.5, 0.8, 1.0, 1.5), (0, 1, 3, V),
                                  (0.5, 0.9, 1.0)))
    B = len(grid)
    temps, tks, tps = (np.array(col, dt) for col, dt in zip(
        zip(*grid), (np.float32, np.int32, np.float32)))
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    seeds = rng.integers(0, 2**32, B).astype(np.uint32)
    pos = rng.integers(0, 4096, B).astype(np.int32)
    return logits, seeds, pos, temps, tks, tps


def _port(fn, logits, seeds, pos, temps, tks, tps):
    return fn(torch.from_numpy(logits),
              torch.from_numpy(seeds.astype(np.int64)),
              torch.from_numpy(pos), torch.from_numpy(temps),
              torch.from_numpy(tks), torch.from_numpy(tps))


@pytest.mark.parametrize("V", [7, 256, 64000])
def test_sample_tokens_match_reference(V):
    args = _lanes(V, np.random.default_rng(V))
    temps = args[3]
    ref = np.asarray(jax.jit(j_sample_tokens)(*args))
    ref_scores = _j_scores(*args)
    # the copy of the reference's steps draws what the reference draws
    np.testing.assert_array_equal(
        np.where(temps > 0, ref_scores.argmax(-1), ref), ref)
    ours = _port(S._sample_tokens, *args).numpy()
    scores = _port(S._sample_scores, *args).numpy()
    greedy = temps == 0
    np.testing.assert_array_equal(ours[greedy], ref[greedy])
    # the truncation (top-k, then top-p) keeps the same tokens, but for a
    # tail where the float32 running sum of probabilities reaches 1 before
    # the last token: at top-p 1 either side may cut tokens whose
    # probability is below the sum's last bit (at most 2.2e-7 here)
    lg = args[0] / np.maximum(temps, np.float32(1e-6))[:, None]
    probs = np.exp(lg - lg.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    differ = np.isinf(scores) != np.isinf(ref_scores)
    differ[greedy] = False
    assert not differ[args[5] < 1].any()
    assert (probs[differ] < 1e-6).all(), probs[differ].max()
    top2 = np.sort(ref_scores, axis=-1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    flips = np.flatnonzero(ours != ref)
    excused = [int(i) for i in flips if margin[i] < NEAR_TIE]
    print(f"V={V}: {len(flips)} differing draws of {len(ref)}, "
          f"{len(excused)} excused near-ties")
    assert list(flips) == excused, [
        (int(i), float(margin[i])) for i in flips]
    assert not excused


def test_top_k_mask_is_exact():
    """The top-k mask alone (a top-p of 2 keeps every probability, so the
    nucleus cut is off on both sides): the kept tokens are exactly those at
    or above the k-th largest scaled logit, ties included, as the
    reference keeps them."""
    rng = np.random.default_rng(3)
    V = 64
    logits = np.round(rng.standard_normal((6, V)) * 2, 1).astype(np.float32)
    tks = np.array([0, 1, 2, 5, V - 1, V], np.int32)
    args = (logits, rng.integers(0, 2**32, 6).astype(np.uint32),
            np.arange(6, dtype=np.int32), np.full(6, 0.7, np.float32), tks,
            np.full(6, 2.0, np.float32))
    ours = np.isfinite(_port(S._sample_scores, *args).numpy())
    np.testing.assert_array_equal(ours, np.isfinite(_j_scores(*args)))
    for b, k in enumerate(tks):
        scaled = logits[b] / np.float32(0.7)
        if k:
            kth = np.sort(scaled)[::-1][k - 1]
            np.testing.assert_array_equal(ours[b], scaled >= kth)
        else:
            assert ours[b].all()


# ----------------------------------------------------------------- engine --

@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(j_get_config("yi-6b").smoke(),
                               param_dtype="float32")
    tcfg = dataclasses.replace(get_config("yi-6b").smoke(),
                               param_dtype="float32")
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(tcfg, jax.tree.map(np.asarray, params),
                            device="cpu")
    return jcfg, params, tcfg, model


def _prompts(vocab, n=3, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=ln).tolist()
            for ln in rng.integers(3, 11, size=n)]


def _sampled(rid, seed_base=40):
    """Even rids sample, odd rids are greedy."""
    if rid % 2:
        return dict(max_new=MAX_NEW)
    return dict(temperature=0.8, top_p=0.9, seed=seed_base + rid,
                max_new=MAX_NEW)


class ReplayDrafter:
    """Proposes each prompt's known continuation (the last draft of a call
    at an odd context length corrupted, so verification both accepts and
    rejects); deterministic in the context, so both engines see the same
    drafts."""

    def __init__(self, known: dict, vocab: int):
        self.known, self.vocab = known, vocab

    def propose(self, ctx, k):
        for prompt, cont in self.known.items():
            n = len(prompt)
            if tuple(ctx[:n]) == prompt and \
                    list(ctx[n:]) == list(cont[:len(ctx) - n]):
                d = list(cont[len(ctx) - n:len(ctx) - n + k])
                if d and len(ctx) % 2:
                    d[-1] = (d[-1] + 1) % self.vocab
                return d
        return []


def _serve(make, cfg, params, EC, CC, R, SP, prompts, sampling_for, *,
           page_size=4, chunk=4, kv_dtype="bf16", preempt=None, **kw):
    """Serve ``prompts`` (rid = index) with ``SP(**sampling_for(rid))``;
    ``preempt`` = (rid, tokens): preempt rid once it has that many
    tokens.  Returns what the two engines must agree on."""
    dev = kw.pop("device", {})
    srv = make(cfg, params, EC(
        cache=CC(num_pages=32, page_size=page_size, max_pages_per_seq=8,
                 kv_dtype=kv_dtype),
        max_lanes=2, chunk=chunk, **kw), **dev)
    reqs = [R(rid, tuple(p), SP(**sampling_for(rid)))
            for rid, p in enumerate(prompts)]
    streamed = {r.rid: [] for r in reqs}
    done_preempt = preempt is None
    for d in srv.generate(reqs):
        streamed[d.rid].extend(d.tokens)
        if not done_preempt and len(streamed[preempt[0]]) >= preempt[1]:
            done_preempt = srv.preempt(preempt[0])
    assert done_preempt
    res = {r.rid: r for r in srv.finished}
    assert {rid: list(r.tokens) for rid, r in res.items()} == streamed
    return dict(
        tokens={rid: r.tokens for rid, r in res.items()},
        reasons={rid: r.finish_reason for rid, r in res.items()},
        spec={rid: (r.spec_proposed, r.spec_accepted, r.spec_rejected,
                    r.spec_k_final) for rid, r in res.items()},
        iterations=srv.iterations, h2d=srv.h2d_events, d2h=srv.d2h_events,
        preemptions=srv.preemptions, spec_iterations=getattr(
            srv, "spec_iterations", 0))


def _both(pair, prompts, sampling_for, **kw):
    jcfg, params, tcfg, model = pair
    ref = _serve(j_make_engine, jcfg, params, JEngineConfig, JCacheConfig,
                 JRequest, JSampling, prompts, sampling_for,
                 use_kernel=False, **kw)
    port = _serve(make_engine, tcfg, model, EngineConfig, CacheConfig,
                  GenerationRequest, SamplingParams, prompts, sampling_for,
                  device=dict(device="cpu"), **kw)
    return ref, port


@pytest.mark.parametrize("page_size", [4, 8])
def test_same_seed_same_stream_as_jax(pair, page_size):
    prompts = _prompts(pair[2].vocab_size)
    ref, port = _both(pair, prompts, _sampled, page_size=page_size)
    assert port == ref
    again = _both(pair, prompts, _sampled, page_size=page_size)[1]
    assert again == port, "sampled decoding not reproducible"
    kernel = _serve(make_engine, pair[2], pair[3], EngineConfig, CacheConfig,
                    GenerationRequest, SamplingParams, prompts, _sampled,
                    page_size=page_size, device=dict(device="cpu"),
                    use_kernel=True)
    assert kernel == port, "the kernel path diverged under sampling"


def test_different_seed_changes_stream(pair):
    prompts = _prompts(pair[2].vocab_size, n=2)
    a = _both(pair, prompts, _sampled)
    b = _both(pair, prompts, lambda rid: _sampled(rid, seed_base=900))
    assert a[1] == a[0] and b[1] == b[0]
    assert a[1]["tokens"][0] != b[1]["tokens"][0]
    assert a[1]["tokens"][1] == b[1]["tokens"][1]     # the greedy lane


@pytest.mark.parametrize("chunk", [1, 3, 16])
def test_stream_independent_of_chunk_size(pair, chunk):
    """Draws are keyed by position, so the chunk size changes iterations
    and transfers but no token; each chunk size matches the reference's
    counts too."""
    prompts = _prompts(pair[2].vocab_size)
    ref, port = _both(pair, prompts, _sampled, chunk=chunk)
    assert port == ref
    base = _both(pair, prompts, _sampled, chunk=4)[1]
    assert port["tokens"] == base["tokens"]


@pytest.mark.parametrize("seed", [0, 7, 123456789])
def test_temperature_zero_is_greedy_regardless_of_seed(pair, seed):
    prompts = _prompts(pair[2].vocab_size)
    base = _both(pair, prompts, lambda rid: dict(max_new=MAX_NEW))
    assert base[1] == base[0]
    calls = S.sampler_calls.n
    out = _both(pair, prompts, lambda rid: dict(
        temperature=0.0, seed=seed, top_p=0.5, top_k=3, max_new=MAX_NEW))
    assert out[1] == out[0] == base[1]
    assert S.sampler_calls.n == calls, "an all-greedy run entered the sampler"


@pytest.mark.parametrize("temperature", [0.7, 2.0])
def test_top_k_one_is_greedy_at_any_temperature(pair, temperature):
    prompts = _prompts(pair[2].vocab_size)
    base = _both(pair, prompts, lambda rid: dict(max_new=MAX_NEW))
    calls = S.sampler_calls.n
    out = _both(pair, prompts, lambda rid: dict(
        temperature=temperature, top_k=1, seed=rid, max_new=MAX_NEW))
    assert out[1] == out[0]
    assert out[1]["tokens"] == base[1]["tokens"]
    assert S.sampler_calls.n > calls


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_sampled_lanes_ride_along_under_spec(pair, kv_dtype):
    """Greedy lanes draft (a replay of their own stream) and sampling lanes
    ride along with zero drafts: every stream equals its plain-decode
    stream, the sampling lanes propose nothing, and the port's spec
    counters equal the reference's."""
    prompts = _prompts(pair[2].vocab_size, n=4, seed=5)
    plain = _both(pair, prompts, _sampled, kv_dtype=kv_dtype)
    assert plain[1] == plain[0]
    known = {tuple(p): plain[1]["tokens"][rid]
             for rid, p in enumerate(prompts) if rid % 2}
    drafter = ReplayDrafter(known, pair[2].vocab_size)
    ref, port = _both(pair, prompts, _sampled, kv_dtype=kv_dtype, spec_k=4,
                      drafter=drafter)
    assert port == ref
    assert port["tokens"] == plain[1]["tokens"]
    assert port["spec_iterations"] > 0
    for rid, (proposed, accepted, rejected, k_final) in port["spec"].items():
        if rid % 2:
            assert proposed == accepted + rejected
        else:
            assert (proposed, k_final) == (0, 0)
    assert sum(s[1] for s in port["spec"].values()) > 0
    assert sum(s[2] for s in port["spec"].values()) > 0


@pytest.mark.parametrize("after", [1, 4])
def test_preemption_mid_sample_resumes_stream(pair, after):
    """A sampling lane preempted mid-decode resumes the stream it would
    have sampled unpreempted, as the reference's does."""
    prompts = _prompts(pair[2].vocab_size)
    base = _both(pair, prompts, _sampled)[1]
    ref, port = _both(pair, prompts, _sampled, preempt=(0, after))
    assert port == ref
    assert port["preemptions"] == 1
    assert port["tokens"] == base["tokens"]
