"""The port's routed MoE (``repro_torch.models.moe``) against the
reference's (``repro.models.moe``) on the CPU.

Both sides get the same numpy inputs from a seed and the reference's
``build_moe`` weights (its ``init_params``, carried over by
``params_from_jax``).  Tolerance: 1e-5 (rtol and atol) in float32; in
bfloat16, where the expert products round to bf16 on both sides, 2e-2
relative plus 2e-2 of the largest |output| (an output of ~10 is a bf16
step of 0.06 from the next).
The routing itself (which assignment lands in which slot, which drops)
must be identical: the load histograms are compared exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as JM
from repro.models import moe as JMOE
from repro_torch.configs import get_config
from repro_torch.models import moe as TMOE
from repro_torch.models.model import _fan_in, init_params, param_shapes, \
    params_from_jax

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = 2e-2
ARCH = "olmoe-1b-7b"


def _layer(dtype="float32", **kw):
    """(JAX cfg, JAX layer-0 moe params, port cfg, port layer-0 moe
    params) on the reference's weights from ``PRNGKey(0)``."""
    jcfg = dataclasses.replace(j_get_config(ARCH).smoke(),
                               param_dtype=dtype, **kw)
    tcfg = dataclasses.replace(get_config(ARCH).smoke(),
                               param_dtype=dtype, **kw)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(tcfg, jax.tree.map(np.asarray, params),
                            device="cpu")
    jp = jax.tree.map(lambda t: t[0], params["layers"]["moe"])
    return jcfg, jp, tcfg, model.layers[0]["moe"]


def _x(shape, dtype="float32", seed=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))


def _dropped(load, C):
    """Assignments past their expert's C slots."""
    return int(np.maximum(np.asarray(load) - C, 0).sum())


CASES = {
    "ample": dict(kw=dict(moe_capacity_factor=8.0), call={}),
    "default": dict(kw={}, call={}),
    "tight": dict(kw=dict(moe_capacity_factor=0.05), call={}),
    "dropless": dict(kw=dict(moe_capacity_factor=0.05),
                     call=dict(dropless=True)),
    "capacity": dict(kw={}, call=dict(capacity=16)),
    "shared": dict(kw=dict(moe_shared_experts=1), call={}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_moe_forward_matches_reference(case):
    kw, call = CASES[case]["kw"], CASES[case]["call"]
    jcfg, jp, tcfg, tp = _layer(**kw)
    jx, tx = _x((3, 40, tcfg.d_model))
    ref = JMOE.moe_forward(jcfg, jp, jx, **call)
    out = TMOE.moe_forward(tcfg, tp, tx, **call)
    assert out.shape == tx.shape and out.dtype == tx.dtype
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_TOL)
    T = 3 * 40
    if call.get("dropless"):
        C = -(-T * tcfg.moe_top_k // 8) * 8
    else:
        C = call.get("capacity") or JMOE._capacity(jcfg, T)
    dropped = _dropped(TMOE.router_load(tcfg, tp, tx), C)
    # the cases cover both sides of the capacity cut
    if case == "tight":
        assert dropped > 0
    if case in ("ample", "dropless"):
        assert dropped == 0


@pytest.mark.parametrize("factor", [0.05, 0.25, 1.25, 8.0])
def test_capacity_matches_reference(factor):
    """C for every row count from 1 to 600: at least 8, a multiple of 8."""
    jcfg = dataclasses.replace(j_get_config(ARCH), moe_capacity_factor=factor)
    tcfg = dataclasses.replace(get_config(ARCH), moe_capacity_factor=factor)
    for T in range(1, 601):
        C = TMOE._capacity(tcfg, T)
        assert C == JMOE._capacity(jcfg, T) and C >= 8 and C % 8 == 0


def test_router_load_matches_reference():
    jcfg, jp, tcfg, tp = _layer()
    jx, tx = _x((2, 33, tcfg.d_model), seed=1)
    load = TMOE.router_load(tcfg, tp, tx)
    np.testing.assert_array_equal(load.numpy(),
                                  np.asarray(JMOE.router_load(jcfg, jp, jx)))
    assert int(load.sum()) == 2 * 33 * tcfg.moe_top_k


@pytest.mark.parametrize("case", ["default", "tight", "shared"])
def test_moe_forward_bf16_matches_reference(case):
    """bf16 weights and activations: the router stays float32 and its
    product runs in float32, the expert products and the combine in
    bf16 (the gates cast to bf16 before the weighted sum)."""
    kw = CASES[case]["kw"]
    jcfg, jp, tcfg, tp = _layer("bfloat16", **kw)
    assert tp["router"].dtype == torch.float32
    assert jp["router"].dtype == jnp.float32
    assert tp["w_gate"].dtype == torch.bfloat16
    jx, tx = _x((2, 24, tcfg.d_model), "bfloat16", seed=2)
    np.testing.assert_array_equal(
        TMOE.router_load(tcfg, tp, tx).numpy(),
        np.asarray(JMOE.router_load(jcfg, jp, jx)))
    ref = JMOE.moe_forward(jcfg, jp, jx)
    out = TMOE.moe_forward(tcfg, tp, tx)
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=BF16_TOL,
                               atol=BF16_TOL * np.abs(ref).max())


def test_tied_pad_rows_drop_in_token_order():
    """Twelve real rows then 36 copies of one pad row, as the engine pads
    a step: the pad rows all pick the same experts, and at a tight
    capacity which of them keep a slot depends on the sort keeping token
    order among equal expert ids (the reference's ``jnp.argsort`` is
    stable).  The port must drop the same ones: the earliest copies
    keep their slots, the latest lose them."""
    jcfg, jp, tcfg, tp = _layer(moe_capacity_factor=0.25)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((48, tcfg.d_model)).astype(np.float32)
    x[12:] = x[12]
    jx, tx = jnp.asarray(x[None]), torch.from_numpy(x[None])
    C = TMOE._capacity(tcfg, 48)
    load = TMOE.router_load(tcfg, tp, tx).numpy()
    assert C == 8 and load.max() > C
    ref = np.asarray(JMOE.moe_forward(jcfg, jp, jx))[0]
    out = TMOE.moe_forward(tcfg, tp, tx)[0].numpy()
    np.testing.assert_allclose(out, ref, **F32_TOL)
    pad = out[12:]
    # identical inputs, different outputs: the order decided the drops
    assert not np.allclose(pad[0], pad[-1])
    np.testing.assert_array_equal(pad[-1], np.zeros_like(pad[-1]))


def test_moe_init_params_fan_in_and_router_dtype():
    """``init_params`` draws the experts with the reference
    ``ParamFactory``'s fan-ins (``w_gate``/``w_up``: their first dim, E;
    ``w_down``: ``moe_d_ff``; the router: d) and keeps the router in
    float32 in a bf16 model."""
    cfg = dataclasses.replace(get_config(ARCH).smoke(), num_layers=1,
                              moe_num_experts=16, moe_d_ff=64)
    jcfg = dataclasses.replace(j_get_config(ARCH).smoke(), num_layers=1,
                               moe_num_experts=16, moe_d_ff=64)
    model = init_params(cfg, seed=0, device="cpu")
    ref = jax.tree.map(lambda t: t[0], JM.init_params(
        jcfg, jax.random.PRNGKey(0))["layers"]["moe"])
    moe = model.layers[0]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["w_down"].dtype == torch.bfloat16
    want = {"router": cfg.d_model, "w_gate": 16, "w_up": 16, "w_down": 64}
    for leaf, fan in want.items():
        shape = param_shapes(cfg)[f"layers/0/moe/{leaf}"]
        assert _fan_in(cfg, f"layers/0/moe/{leaf}", shape) == fan
        for w in (moe[leaf], torch.from_numpy(
                np.array(ref[leaf].astype(jnp.float32)))):
            assert abs(float(w.float().std()) * fan ** 0.5 - 1.0) < 0.05, \
                leaf
