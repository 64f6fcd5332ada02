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
    hybrid = dataclasses.replace(get_config("yi-6b").smoke(),
                                 block_kind="hymba", sliding_window=16)
    with pytest.raises(NotImplementedError):
        R.cache_bytes(hybrid, SHAPES["decode_32k"])
