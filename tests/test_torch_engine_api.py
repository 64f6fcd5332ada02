"""The port's engine API: bf16 numerics, streaming, failure semantics,
what is not ported yet (sharding, MoE; the cache tiers and fault
injection since ported), and the device default."""
import dataclasses
import functools

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
from repro.runtime.server import _paged_forward as j_paged_forward
from repro_torch.configs import get_config
from repro_torch.models.model import init_params, params_from_jax
from repro_torch.runtime import (
    CacheConfig, EngineConfig, FaultInjector, GenerationRequest,
    PagedServer, SamplingParams, VirtualClock, make_engine,
)
from repro_torch.runtime.server import _paged_chunk_step


@pytest.fixture(scope="module")
def smoke():
    cfg = dataclasses.replace(get_config("yi-6b").smoke(),
                              param_dtype="float32")
    return cfg, init_params(cfg, seed=0, device="cpu")


def _engine(smoke, **kw):
    cfg, model = smoke
    cache = kw.pop("cache", CacheConfig(num_pages=32, page_size=4,
                                        max_pages_per_seq=8))
    return make_engine(cfg, model, EngineConfig(cache=cache, max_lanes=2,
                                                chunk=4, **kw),
                       device="cpu")


def test_bf16_first_step_logits_match_jax():
    """A bf16 model's first chunk step: the port's float32 logits at each
    lane's last prompt token agree with the reference's within 2e-2."""
    jcfg = j_get_config("yi-6b").smoke()
    tcfg = get_config("yi-6b").smoke()
    assert tcfg.param_dtype == jcfg.param_dtype == "bfloat16"
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(tcfg, jax.tree.map(np.asarray, params),
                            device="cpu")
    B, C, P, page, npg = 2, 8, 16, 4, 4
    feed = np.array([[5, 6, 7, 8, 9, 10, 11, 12], [3, 1, 4, 0, 0, 0, 0, 0]],
                    np.int32)
    n_new = np.array([8, 3], np.int32)
    bt = np.array([[0, 1, 1, 1], [2, 2, 2, 2]], np.int32)
    zeros = np.zeros((B,), np.int32)
    L_, kv, hd = jcfg.num_layers, jcfg.num_kv_heads, jcfg.resolved_head_dim
    forward = jax.jit(functools.partial(j_paged_forward, jcfg, False, 2,
                                        True, P))
    jlogits, _, _ = forward(
        params, jnp.zeros((L_, P + 1, 2, page, kv, hd), jnp.bfloat16),
        jnp.zeros((L_, P + 1, 2, kv), jnp.float32), jnp.asarray(bt),
        jnp.asarray(zeros), jnp.asarray(n_new), jnp.asarray(feed),
        jnp.asarray(zeros), jnp.asarray(zeros))
    jlast = np.asarray(jlogits)[np.arange(B), n_new - 1]
    t = [torch.from_numpy(a) for a in (bt, zeros, n_new, feed, zeros, zeros)]
    pool = torch.zeros((L_, P + 1, 2, page, kv, hd), dtype=torch.bfloat16)
    nxt, new_lens, logits = _paged_chunk_step(
        tcfg, model, False, 2, P, pool, t[0], t[1], t[2], t[3], t[4], t[5])
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), jlast, rtol=2e-2, atol=2e-2)
    np.testing.assert_array_equal(new_lens.numpy(), n_new)


def test_deltas_concatenate_to_results(smoke):
    srv = _engine(smoke)
    reqs = [GenerationRequest(rid, (rid + 1, 2, 3, 4, 5, 6),
                              SamplingParams(max_new=5)) for rid in range(3)]
    streamed = {r.rid: [] for r in reqs}
    events = set()
    for d in srv.generate(reqs):
        streamed[d.rid].extend(d.tokens)
        events.add(d.event)
        if d.tokens and d.rid == 0 and len(streamed[0]) == 2:
            assert srv.preempt(0)
    assert {r.rid: list(r.tokens) for r in srv.finished} == streamed
    assert {"token", "preempt"} <= events
    assert all(r.finish_reason == "length" for r in srv.finished)
    assert srv.pool.free_pages() == 32 and len(srv.backing) == 0


def test_failure_semantics_match_jax():
    """Deadlines, cancellation from the stream and admission-time shedding
    finish the same requests with the same reasons and tokens as the
    reference."""
    jcfg = dataclasses.replace(j_get_config("yi-6b").smoke(),
                               param_dtype="float32")
    tcfg = dataclasses.replace(get_config("yi-6b").smoke(),
                               param_dtype="float32")
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(tcfg, jax.tree.map(np.asarray, params),
                            device="cpu")

    def serve(make, cfg, p, EC, CC, R, S, **kw):
        srv = make(cfg, p, EC(cache=CC(num_pages=32, page_size=4,
                                       max_pages_per_seq=8),
                              max_lanes=2, chunk=4, max_queue_depth=3,
                              clock=None, use_kernel=False), **kw)
        reqs = [R(0, (1, 2, 3, 4, 5), S(max_new=8), deadline_iters=3),
                R(1, (6, 7, 8), S(max_new=8, stop_tokens=())),
                R(2, (9, 10, 11, 12), S(max_new=4)),
                R(3, (13, 14), S(max_new=4)),
                R(4, (15, 16, 17), S(max_new=4), priority=-1)]
        for d in srv.generate(reqs):
            if d.rid == 1 and d.tokens:
                srv.cancel(1)
        return sorted((r.rid, r.tokens, r.finish_reason)
                      for r in srv.finished), \
            (srv.timeouts, srv.cancelled, srv.shed_count, srv.iterations)

    ref = serve(j_make_engine, jcfg, params, JEngineConfig, JCacheConfig,
                JRequest, JSampling)
    port = serve(make_engine, tcfg, model, EngineConfig, CacheConfig,
                 GenerationRequest, SamplingParams, device="cpu")
    assert port == ref
    reasons = {rid: why for rid, _, why in port[0]}
    assert reasons[0] == "timeout" and reasons[1] == "aborted"
    assert "shed" in reasons.values()


def test_virtual_clock_deadline(smoke):
    clock = VirtualClock()
    srv = _engine(smoke, clock=clock)
    srv.submit(GenerationRequest(0, (1, 2, 3), SamplingParams(max_new=8),
                                 deadline_s=1.0))
    srv.step()
    clock.advance(2.0)
    srv.run()
    assert srv.finished[0].finish_reason == "timeout"


@pytest.mark.parametrize("what,make", [
    ("host tier", lambda s: _engine(s, cache=CacheConfig(
        host_tier_pages=8))),
    ("disk tier", lambda s: _engine(s, cache=CacheConfig(
        host_tier_pages=8, disk_tier_pages=8))),
    ("faults", lambda s: _engine(s, fault_injector=FaultInjector())),
    ("sharded", lambda s: _engine(s, clusters=2)),
    ("moe", lambda s: PagedServer(
        dataclasses.replace(s[0], moe_num_experts=4, moe_top_k=2),
        s[1], device="cpu")),
])
def test_features_not_ported_raise(smoke, what, make):
    """Sharding and MoE raise ``NotImplementedError``.  The cache tiers
    and fault injection, ported since, build an engine that carries them
    (their behaviour is held against the reference by
    ``test_torch_hierarchical_cache.py`` and ``test_torch_faults.py``)."""
    if what in ("sharded", "moe"):
        with pytest.raises(NotImplementedError):
            make(smoke)
        return
    srv = make(smoke)
    try:
        tiers = [(t.name, t.capacity_pages) for t in srv.backing.tiers]
        if what == "faults":
            assert tiers == [("host", 0)]
            assert srv.backing.faults is srv.faults
            assert srv.faults.tracer is srv.tracer
        else:
            want = [("host", 8)] + ([("disk", 8)] if what == "disk tier"
                                    else [])
            assert tiers == want and srv.pool.spill_enabled
    finally:
        srv.close()


def test_moe_model_not_ported():
    cfg = dataclasses.replace(get_config("yi-6b").smoke(), moe_num_experts=4)
    with pytest.raises(NotImplementedError):
        init_params(cfg, device="cpu")


def test_default_device_is_cuda(smoke):
    """Entry points default to the card and never fall back to the CPU."""
    cfg, model = smoke
    if torch.cuda.is_available():
        gpu = init_params(cfg)
        assert gpu.device.type == "cuda"
        assert PagedServer(cfg, gpu).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedServer(cfg, model)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_engine(cfg, model)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg)


@pytest.mark.cuda
def test_card_engine_rejects_plain_path_and_cpu_params(smoke):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100: pytest -m cuda)")
    cfg, model = smoke
    with pytest.raises(ValueError, match="CPU only"):
        PagedServer(cfg, init_params(cfg), EngineConfig(use_kernel=False))
    with pytest.raises(ValueError, match="move them"):
        PagedServer(cfg, model, device="cuda")
