"""The port's analytic roofline library (``repro_torch.core.roofline``)
against the reference's (``repro.core.roofline``): for every config in
the port's registry, full size and smoke, every function returns the
reference's value exactly, and ``kv_bytes_per_token`` is the port
engine's own ``cache_stats().bytes_per_token``."""
import dataclasses

import pytest

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.core import roofline as JR
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.core import roofline as R
from repro_torch.models.model import init_params
from repro_torch.runtime import CacheConfig, EngineConfig, make_engine

CONFIGS = [(a, smoke) for a in list_archs() for smoke in (False, True)]


def _cfgs(arch, smoke):
    t, j = get_config(arch), j_get_config(arch)
    return (t.smoke(), j.smoke()) if smoke else (t, j)


@pytest.mark.parametrize("arch,smoke", CONFIGS)
def test_roofline_functions_equal_reference(arch, smoke):
    tcfg, jcfg = _cfgs(arch, smoke)
    assert R.param_counts(tcfg) == JR.param_counts(jcfg)
    for name, shape in SHAPES.items():
        jshape = J_SHAPES[name]
        assert R.model_flops(tcfg, shape) == JR.model_flops(jcfg, jshape)
        for kv in ("bf16", "int8"):
            assert R.cache_bytes(tcfg, shape, kv) == \
                JR.cache_bytes(jcfg, jshape, kv)
            for devices in (1, 8, 256):
                assert R.analytic_bytes(tcfg, shape, devices, kv) == \
                    JR.analytic_bytes(jcfg, jshape, devices, kv)
    hd = tcfg.resolved_head_dim
    for kv in ("bf16", "int8"):
        for page in (4, 8, 16):
            assert R.kv_elt_bytes(kv, hd, page) == \
                JR.kv_elt_bytes(kv, hd, page)
            assert R.kv_bytes_per_token(tcfg, kv, page) == \
                JR.kv_bytes_per_token(jcfg, kv, page)
    f32 = dataclasses.replace(tcfg, param_dtype="float32")
    assert R.kv_bytes_per_token(f32) == JR.kv_bytes_per_token(
        dataclasses.replace(jcfg, param_dtype="float32"))
    assert R.KV_PAGE_SIZE == JR.KV_PAGE_SIZE


def test_param_counts_dense_total_equals_active():
    pc = R.param_counts(get_config("yi-6b"))
    assert pc["active"] == pc["total"] > 5e9


def test_param_counts_and_cache_bytes_moe_equal_reference():
    """olmoe-1b-7b: the routed experts count in full in the total and by
    top_k / E in the active parameters, from the port's own shapes, as
    the reference counts them from its spec tree; the KV cache is a
    dense GQA decoder's."""
    tcfg, jcfg = _cfgs("olmoe-1b-7b", smoke=False)
    pc = R.param_counts(tcfg)
    assert pc == JR.param_counts(jcfg)
    experts = tcfg.num_layers * 3 * tcfg.moe_num_experts * \
        tcfg.d_model * tcfg.moe_d_ff
    assert pc["total"] - pc["active"] == experts * (1 - 8 / 64)
    assert 6.5e9 < pc["total"] < 7.5e9 and pc["active"] < 1.5e9
    for name, shape in SHAPES.items():
        for kv in ("bf16", "int8"):
            assert R.cache_bytes(tcfg, shape, kv) == \
                JR.cache_bytes(jcfg, J_SHAPES[name], kv)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-350m"])
def test_param_counts_and_cache_bytes_recurrent_equal_reference(arch):
    """The recurrent families at the two decode shapes they serve:
    hymba's cache is its 2,048-slot ring of K/V plus each layer's Mamba
    conv and SSM state (float32), xlstm's its mLSTM state; the parameter
    counts come from the port's own shapes."""
    from repro.configs.base import param_count as j_param_count
    from repro_torch.configs import param_count
    from repro_torch.models.ssm import mamba_dims
    tcfg, jcfg = _cfgs(arch, smoke=False)
    assert R.param_counts(tcfg) == JR.param_counts(jcfg)
    assert param_count(tcfg) == j_param_count(jcfg)
    for name in ("decode_32k", "long_500k"):
        got = R.cache_bytes(tcfg, SHAPES[name])
        assert got == JR.cache_bytes(jcfg, J_SHAPES[name])
        if arch == "hymba-1.5b":
            di, _, N = mamba_dims(tcfg)
            B = SHAPES[name].global_batch
            ring = 32 * B * 2048 * 5 * 64 * 2 * 2.0
            state = 32 * B * (di * N + 3 * di) * 4.0
            assert got == ring + state


@pytest.mark.parametrize("kv_dtype,page", [("bf16", 4), ("int8", 4),
                                           ("int8", 8)])
def test_kv_bytes_per_token_matches_engine(kv_dtype, page):
    cfg = get_config("yi-6b").smoke()
    srv = make_engine(cfg, init_params(cfg, seed=0, device="cpu"),
                      EngineConfig(cache=CacheConfig(
                          num_pages=16, page_size=page,
                          max_pages_per_seq=4, kv_dtype=kv_dtype),
                          max_lanes=1, use_kernel=False), device="cpu")
    assert R.kv_bytes_per_token(cfg, kv_dtype, page) == \
        srv.cache_stats().bytes_per_token


def test_cache_bytes_hybrid_not_ported():
    """The hybrid state model, which raised until the port's SSM layers
    came, now gives the reference's value for a hybrid cut from yi-6b."""
    kw = dict(block_kind="hymba", sliding_window=16, ssm_state=8)
    hybrid = dataclasses.replace(get_config("yi-6b").smoke(), **kw)
    j_hybrid = dataclasses.replace(j_get_config("yi-6b").smoke(), **kw)
    for name in ("decode_32k", "long_500k"):
        for kv in ("bf16", "int8"):
            assert R.cache_bytes(hybrid, SHAPES[name], kv) == \
                JR.cache_bytes(j_hybrid, J_SHAPES[name], kv) > 0
