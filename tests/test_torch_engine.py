"""The port's ``PagedServer`` on the CPU against the JAX ``PagedServer``.

Both engines serve the same workload on identical float32 weights (the
reference's ``init_params`` carried over by ``params_from_jax``): a shared
system prompt (prefix-cache hits and copy-on-write), more requests than
lanes, and one forced mid-decode preemption (swap out to the host store,
swap back in).  Tokens, prefix hits, preemptions, iterations and the
host<->device transfer counts must all be equal.
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
