"""The port's ``PagedServer`` on the CPU against the JAX ``PagedServer``.

Both engines serve the same workload on identical float32 weights (the
reference's ``init_params`` carried over by ``params_from_jax``): a shared
system prompt (prefix-cache hits and copy-on-write), more requests than
lanes, and one forced mid-decode preemption (swap out to the host store,
swap back in).  Tokens, prefix hits, preemptions, iterations and the
host<->device transfer counts must all be equal.  The same holds for the
int8 KV engines (their mapped pages' bytes and scales compared after every
step) and for the speculative engines, whose proposed / accepted /
rejected counts must be equal too.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.models import model as JM
from repro.runtime import (
    CacheConfig as JCacheConfig, EngineConfig as JEngineConfig,
    GenerationRequest as JRequest, SamplingParams as JSampling,
    make_engine as j_make_engine,
)
from repro_torch.configs import get_config
from repro_torch.models.model import params_from_jax
from repro_torch.runtime import (
    CacheConfig, EngineConfig, GenerationRequest, SamplingParams,
    make_engine,
)

SYSTEM = [11, 12, 13, 14, 15, 16, 17, 18]
PROMPTS = [SYSTEM + [21], SYSTEM + [22, 5, 6], SYSTEM + [23],
           [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]]


def _pair(arch):
    """(JAX cfg, JAX params, port cfg, port model) on identical f32
    weights from ``PRNGKey(0)``."""
    jcfg = dataclasses.replace(j_get_config(arch).smoke(),
                               param_dtype="float32")
    tcfg = dataclasses.replace(get_config(arch).smoke(),
                               param_dtype="float32")
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(tcfg, jax.tree.map(np.asarray, params),
                            device="cpu")
    return jcfg, params, tcfg, model


@pytest.fixture(scope="module")
def yi():
    return _pair("yi-6b")


def _serve(make, cfg, params, ecfg, Request, Sampling, **kw):
    """rid 0 runs alone until its prompt pages are published, then three
    more arrive (two share its system prompt); rid 0 is preempted one
    iteration later.  Returns everything the two engines must agree on."""
    srv = make(cfg, params, ecfg, **kw)
    srv.submit(Request(0, tuple(PROMPTS[0]), Sampling(max_new=6)))
    srv.step()
    srv.step()
    for rid in (1, 2, 3):
        srv.submit(Request(rid, tuple(PROMPTS[rid]), Sampling(max_new=6)))
    srv.step()
    assert srv.preempt(0)
    done = srv.run()
    srv.pool.check_invariants()
    return dict(
        results={r.rid: (r.tokens, r.finish_reason, r.prefix_hit_tokens,
                         r.preemptions) for r in done},
        iterations=srv.iterations, h2d=srv.h2d_events, d2h=srv.d2h_events,
        preemptions=srv.preemptions, pool=dict(srv.pool.stats),
        prefill_tokens=srv.prefill_tokens)


def _both(pair, page, chunk, use_kernel):
    jcfg, params, tcfg, model = pair
    kw = dict(max_lanes=2, chunk=chunk, use_kernel=use_kernel)
    ref = _serve(j_make_engine, jcfg, params, JEngineConfig(
        cache=JCacheConfig(num_pages=32, page_size=page,
                           max_pages_per_seq=8), **kw),
        JRequest, JSampling)
    port = _serve(make_engine, tcfg, model, EngineConfig(
        cache=CacheConfig(num_pages=32, page_size=page,
                          max_pages_per_seq=8), **kw),
        GenerationRequest, SamplingParams, device="cpu")
    return ref, port


@pytest.mark.parametrize("page,chunk", [(4, 1), (4, 8), (8, 1), (8, 8)])
def test_engine_matches_jax_ref_path(yi, page, chunk):
    ref, port = _both(yi, page, chunk, use_kernel=False)
    assert port == ref
    assert port["preemptions"] == 1
    assert port["pool"]["prefix_hit_tokens"] > 0
    assert port["pool"]["swapped_in"] > 0


def test_engine_matches_jax_interpret_kernel(yi):
    """The reference with its Pallas kernel (interpret mode) against the
    port with ``use_kernel=True``, which on the CPU reaches the kernel's
    plain version through the repeat-padded table."""
    ref, port = _both(yi, page=4, chunk=8, use_kernel=True)
    assert port == ref


def test_engine_matches_jax_qk_norm_arch():
    """qwen3-32b smoke: the qk-norm branch of the layer."""
    ref, port = _both(_pair("qwen3-32b"), page=8, chunk=8, use_kernel=False)
    assert port == ref


# --------------------------------------------------------------- int8 --
#: an 11-token prompt: a partial tail page at page 4 and 8 that an
#: identical prompt admitted right after its donor's prefill shares (all
#: but its last token are reused), so the first append into it copies it
#: on write
SYS11 = SYSTEM + [19, 20, 21]
#: two K/V values that land near a quantization boundary can round apart
#: by one step, because the two frameworks' float32 matmuls sum in other
#: orders (their K/V agree to a few ulps): mapped int8 bytes may differ by
#: at most 1, in at most this share of the bytes compared
INT8_BYTE_SHARE = 1e-3
#: page scales are absmax/127 of those K/V values: a few ulps apart
SCALE_RTOL = 1e-5
#: the scales of a layer past ``lockstep``'s ``scale_layers``: a byte of
#: an earlier layer that rounds apart moves them by about a quantization
#: step within the same step (~1.6e-4 relative at pixtral's smoke size)
DEEP_SCALE_RTOL = 1e-3


def _lockstep_workload(vocab):
    rng = np.random.default_rng(0)
    pat = rng.integers(1, vocab, 4).tolist()
    return [SYS11, SYS11, pat * 3, rng.integers(1, vocab, 9).tolist()]


def lockstep(pair, *, page, use_kernel, kv_dtype, spec_k=0, max_new=10,
             drafter=None, scale_layers=None):
    """Serve one workload on the JAX engine and the port in lockstep: rid 0
    runs alone through its prefill, rid 1 then shares its partial tail
    page (copy-on-write), rids 2-3 follow, and rid 0 is preempted three
    steps later (swap out, swap back in).  After every step each running
    request maps the same physical pages on both sides, holding the same
    K/V (int8 bytes within ``INT8_BYTE_SHARE``, scales within
    ``SCALE_RTOL``).  ``scale_layers`` holds the scales of only the first
    that many layers to ``SCALE_RTOL`` and those of the later layers to
    ``DEEP_SCALE_RTOL``: a byte of layer l that rounds apart (as
    ``INT8_BYTE_SHARE`` allows) moves the attention output, and so the K/V
    and scales of layer l + 1 on, by about a quantization step within the
    same step.  Returns what the two engines must agree on, and the int8
    byte mismatches."""
    jcfg, params, tcfg, model = pair
    prompts = _lockstep_workload(tcfg.vocab_size)
    kw = dict(max_lanes=2, chunk=8, use_kernel=use_kernel, spec_k=spec_k,
              drafter=drafter)
    j = j_make_engine(jcfg, params, JEngineConfig(cache=JCacheConfig(
        num_pages=48, page_size=page, max_pages_per_seq=16,
        kv_dtype=kv_dtype), **kw))
    t = make_engine(tcfg, model, EngineConfig(cache=CacheConfig(
        num_pages=48, page_size=page, max_pages_per_seq=16,
        kv_dtype=kv_dtype), **kw), device="cpu")
    compared = mismatched = 0
    for step in range(200):
        if step == 2:
            for rid, p in enumerate(prompts[1:], start=1):
                j.submit(JRequest(rid, tuple(p), JSampling(max_new=max_new)))
                t.submit(GenerationRequest(rid, tuple(p),
                                           SamplingParams(max_new=max_new)))
        elif step == 0:
            j.submit(JRequest(0, tuple(prompts[0]),
                              JSampling(max_new=max_new)))
            t.submit(GenerationRequest(0, tuple(prompts[0]),
                                       SamplingParams(max_new=max_new)))
        elif step == 5:
            assert j.preempt(0) and t.preempt(0)
        busy = j.step()
        assert t.step() == busy
        if not busy:
            break
        for r in [r for r in t.lanes if r is not None]:
            mapped = t.pool.seq_pages(r.rid)
            assert mapped == j.pool.seq_pages(r.rid)
            idx = [p for _, p in mapped]
            ours = t.kv_pages[:, idx].numpy()
            ref = np.asarray(j.kv_pages[:, np.asarray(idx)])
            if kv_dtype == "int8":
                d = np.abs(ours.astype(np.int32) - ref.astype(np.int32))
                assert d.max(initial=0) <= 1
                compared += d.size
                mismatched += int((d > 0).sum())
                ts = t.kv_scales[:, idx].numpy()
                js = np.asarray(j.kv_scales[:, np.asarray(idx)])
                n = len(ts) if scale_layers is None else scale_layers
                np.testing.assert_allclose(ts[:n], js[:n], rtol=SCALE_RTOL,
                                           atol=0)
                np.testing.assert_allclose(ts[n:], js[n:],
                                           rtol=DEEP_SCALE_RTOL, atol=0)
            else:
                np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)
    assert mismatched <= INT8_BYTE_SHARE * compared
    t.pool.check_invariants()

    def summary(e):
        return dict(
            results={r.rid: (r.tokens, r.finish_reason, r.prefix_hit_tokens,
                             r.preemptions, r.spec_proposed, r.spec_accepted,
                             r.spec_rejected, r.spec_k_final)
                     for r in e.finished},
            iterations=e.iterations, h2d=e.h2d_events, d2h=e.d2h_events,
            pool=dict(e.pool.stats), degrades=e.degrades,
            spec=(e.spec_iterations, e.spec_proposed, e.spec_accepted,
                  e.spec_rejected),
            bytes_per_token=e.cache_stats().bytes_per_token)

    return summary(j), summary(t), (mismatched, compared)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["ref", "kernel"])
@pytest.mark.parametrize("page", [4, 8])
def test_int8_engine_matches_jax(yi, page, use_kernel):
    """The int8 engine against the reference's int8 engine (its oracle, or
    its Pallas kernel in interpret mode), with a prefix hit, copy-on-write
    and a forced preemption."""
    ref, port, _ = lockstep(yi, page=page, use_kernel=use_kernel,
                            kv_dtype="int8")
    assert port == ref
    assert port["pool"]["prefix_hit_tokens"] > 0
    assert port["pool"]["cow"] > 0
    assert port["pool"]["swapped_in"] > 0


def test_bytes_per_token_closed_form(yi):
    """bytes_per_token = L * 2 * (Kv*hd * itemsize + 4*Kv/page scale bytes
    per token) in int8, L * 2 * Kv*hd * itemsize otherwise."""
    _, _, tcfg, model = yi
    L_, kv, hd = tcfg.num_layers, tcfg.num_kv_heads, tcfg.resolved_head_dim
    for page in (4, 8, 16):
        for kv_dtype, want in (
                ("int8", L_ * 2 * (kv * hd + 4.0 * kv / page)),
                ("bf16", L_ * 2 * kv * hd * 4)):   # a float32 model's pool
            srv = make_engine(tcfg, model, EngineConfig(cache=CacheConfig(
                num_pages=8, page_size=page, kv_dtype=kv_dtype)),
                device="cpu")
            assert srv.cache_stats().bytes_per_token == want


def test_pack_kv_page_matches_reference_bytes():
    """A parked int8 page is the same blob on both sides."""
    from repro.runtime.server import (
        _pack_kv_page as j_pack, _unpack_kv_page as j_unpack,
    )
    from repro_torch.runtime.server import _pack_kv_page, _unpack_kv_page
    rng = np.random.default_rng(3)
    pshape, sshape = (3, 2, 4, 2, 16), (3, 2, 2)
    # a strided view, as the engine packs one page of a gathered batch
    pages = rng.integers(-127, 128, (3, 5) + pshape[1:]).astype(
        np.int8)[:, 1]
    scales = rng.uniform(0, 1, (3, 5, 2, 2)).astype(np.float32)[:, 2]
    blob = _pack_kv_page(pages, scales)
    np.testing.assert_array_equal(blob, j_pack(pages, scales))
    assert blob.dtype == np.uint8
    back = _unpack_kv_page(blob, pshape, sshape)
    ref = j_unpack(blob, pshape, sshape)
    for a, b, want in zip(back, ref, (pages, scales)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, want)


# -------------------------------------------------------- speculation --
@pytest.mark.parametrize("kv_dtype,use_kernel", [
    ("bf16", False), ("int8", False), ("int8", True)],
    ids=["bf16-ref", "int8-ref", "int8-kernel"])
def test_spec_engine_matches_jax(yi, kv_dtype, use_kernel):
    """``spec_k=4`` with the n-gram drafter against the reference's
    speculative engine: the same tokens, verify iterations, proposed /
    accepted / rejected counts, adaptive depths and rolled-back pages (the
    workload's repeated pattern and its greedy tails engage the
    drafter)."""
    ref, port, _ = lockstep(yi, page=4, use_kernel=use_kernel,
                            kv_dtype=kv_dtype, spec_k=4, max_new=16)
    assert port == ref
    spec_iters, proposed, accepted, rejected = port["spec"]
    assert spec_iters > 0 and proposed == accepted + rejected
    assert accepted > 0 and rejected > 0
    assert port["pool"]["spec_trimmed_pages"] > 0


class _BrokenDrafter:
    def propose(self, ctx, k):
        raise RuntimeError("drafter down")


def test_spec_drafter_failure_degrades_like_jax(yi):
    """A drafter that raises disables speculation for its lane (a
    ``DEGRADE(rid, 1)``) and the lane decodes plainly, as in the
    reference."""
    ref, port, _ = lockstep(yi, page=8, use_kernel=False, kv_dtype="bf16",
                            spec_k=4, drafter=_BrokenDrafter())
    assert port == ref
    assert port["degrades"] > 0 and port["spec"] == (0, 0, 0, 0)
