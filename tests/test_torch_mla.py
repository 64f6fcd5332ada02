"""deepseek-v2's pieces in the port against the live JAX package, on the
CPU: the flash op at unequal head dims (MLA's q/k 192 beside v 128,
which both kernels take as it is, and the smoke config's 24 beside 16,
which they take zero-padded), MLA's projections, full-sequence attention and
absorbed decode, the MoE layer at the registered routing (160 experts,
top-6, 2 shared, dropless and with capacity), and the full-sequence
forward's route through the flash op.

Same numpy inputs from ``np.random.default_rng`` and the reference's
weights (``params_from_jax``) on both sides; float32 within 1e-5 of the
largest |value| (``BAR``) unless a test names another bar.  The
``cuda``-marked test holds the kernel's native and padded routes against
the plain version on the card.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as JA
from repro.models import model as JM
from repro.models import moe as JMOE
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention_ref, mha_flash
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ops
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.models import moe as TMOE

ARCH = "deepseek-v2-236b"
BAR = 1e-5
#: (dk, dv): the smoke config's (nope 16 + rope 8, v 16) and the
#: registered one's (128 + 64, 128)
HEAD_DIMS = [(24, 16), (192, 128)]


def _close(got, want, bar=BAR):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=bar * max(np.abs(want).max(), 1e-30))


def _qkv(B, S, H, dk, dv, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, dk), np.float32) * 0.3,
            rng.standard_normal((B, S, H, dk), np.float32) * 0.3,
            rng.standard_normal((B, S, H, dv), np.float32))


@pytest.mark.parametrize("dk,dv,want", [(24, 16, 32), (192, 128, 192),
                                        (16, 16, 16), (128, 128, 128),
                                        (24, 24, 32), (64, 256, 256)])
def test_padded_head_dim(dk, dv, want):
    """``want`` is the q/k hd each type runs at: MLA's (192, 128) as it
    is (the tensor-core kernel's and the FP32-core kernel's own
    instantiations), every other unequal pair padded to one hd."""
    native = (dk, dv) in K.TC_PAIRS
    assert native == ((dk, dv) in K.FP32_PAIRS)
    for dtype in (torch.float32, torch.bfloat16):
        assert ops.padded_head_dim(dk, dv, dtype) == want
        assert K.head_dims(dtype, dk, dv) == (
            (dk, dv) if native else (want, want))


def test_padded_head_dim_refuses_what_no_kernel_covers():
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="at most 256"):
            ops.padded_head_dim(320, 128, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dk,dv", HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
def test_padding_then_plain_equals_unpadded_plain(dk, dv, dtype, causal):
    """What the padded route computes (``pad_head_dims``, the plain
    version at the unpadded scale, the output sliced to dv) is the
    unpadded plain version: zero columns add nothing to q·k and the
    padded P·V columns are dropped.  MLA takes no pad in either type (its
    native route): the operands come back as they are."""
    q, k, v = (torch.from_numpy(a[0].transpose(1, 0, 2).copy()).to(
        getattr(torch, dtype)) for a in _qkv(1, 96, 6, dk, dv, seed=1))
    qp, kp, vp = ops.pad_head_dims(q, k, v)
    D, Dv = K.head_dims(q.dtype, dk, dv)
    assert qp.shape[-1] == kp.shape[-1] == D and vp.shape[-1] == Dv
    assert (D, Dv) != (dk, dv) or all(
        a is b for a, b in zip((qp, kp, vp), (q, k, v)))
    assert torch.equal(qp[..., :dk], q) and not qp[..., dk:].any()
    assert torch.equal(vp[..., :dv], v) and not vp[..., dv:].any()
    scale = 1.0 / math.sqrt(dk)
    got = flash_attention_ref(qp, kp, vp, causal=causal, scale=scale)
    want = flash_attention_ref(q, k, v, causal=causal)
    assert not got[..., dv:].float().any()
    # float32 sums of the same products in another order: a few ulps
    tol = 1e-6 if dtype == "float32" else 2.0 ** -8
    np.testing.assert_allclose(got[..., :dv].float().numpy(),
                               want.float().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dk,dv", HEAD_DIMS)
def test_mha_flash_unequal_head_dims_matches_attend_fullseq(dk, dv):
    """``mha_flash`` (the plain version on the CPU) against the
    reference's ``attend_fullseq`` with MLA's explicit scale, and its
    default scale is 1/sqrt(dk)."""
    arrs = _qkv(2, 80, 4, dk, dv, seed=2)
    scale = 1.0 / math.sqrt(dk)
    q, k, v = map(torch.from_numpy, arrs)
    out = mha_flash(q, k, v, causal=True, scale=scale)
    assert out.shape == (2, 80, 4, dv)
    assert torch.equal(out, mha_flash(q, k, v, causal=True))
    pos = jnp.arange(80, dtype=jnp.int32)
    ref = JA.attend_fullseq(*map(jnp.asarray, arrs), q_positions=pos,
                            k_positions=pos, causal=True, scale=scale)
    _close(out, ref)
    tout = A.attend_fullseq(q, k, v, causal=True, scale=scale)
    assert torch.equal(tout, out)


@pytest.mark.parametrize("dk,dv", HEAD_DIMS)
def test_flash_grads_at_unequal_head_dims_match_jax(dk, dv):
    """The op's recompute backward at dv != dk: dq, dk, dv against
    ``jax.grad`` of the reference's ``attend_fullseq``."""
    arrs = _qkv(2, 64, 4, dk, dv, seed=3)
    scale = 1.0 / math.sqrt(dk)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    ops.backward_recomputes.reset()
    (mha_flash(*ts, causal=True, scale=scale) ** 2).sum().backward()
    assert ops.backward_recomputes.n == 1
    pos = jnp.arange(64, dtype=jnp.int32)

    def loss(q, k, v):
        return (JA.attend_fullseq(q, k, v, q_positions=pos, k_positions=pos,
                                  causal=True, scale=scale) ** 2).sum()

    grads = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, arrs))
    for t, g in zip(ts, grads):
        assert t.grad.shape == t.shape
        _close(t.grad, g)


def test_flash_op_checks_shapes_at_unequal_head_dims():
    q = torch.zeros(4, 8, 24)
    with pytest.raises(ValueError, match="bad shapes"):
        ops.flash_attention(q, torch.zeros(4, 8, 16), torch.zeros(4, 8, 16))
    with pytest.raises(ValueError, match="bad shapes"):
        ops.flash_attention(q, torch.zeros(4, 8, 24), torch.zeros(4, 9, 16))
    assert ops.flash_attention(q, q, torch.zeros(4, 8, 16)).shape == (4, 8,
                                                                      16)


# ------------------------------------------------------------- MLA layer --
def _pair(dtype="float32", **kw):
    jcfg = dataclasses.replace(j_get_config(ARCH).smoke(), param_dtype=dtype,
                               **kw)
    tcfg = dataclasses.replace(get_config(ARCH).smoke(), param_dtype=dtype,
                               **kw)
    params = jax.tree.map(np.asarray, JM.init_params(
        jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, params, M.params_from_jax(tcfg, params, device="cpu")


def _attn(params, model, stack="layers"):
    jp = jax.tree.map(lambda t: jnp.asarray(t[0]), params[stack]["attn"])
    return jp, getattr(model, stack)[0]["attn"]


def _x(cfg, B, S, seed):
    x = np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def test_mla_projections_match_jax():
    jcfg, tcfg, params, model = _pair()
    jp, tp = _attn(params, model)
    jx, tx = _x(tcfg, 2, 12, 4)
    pos = np.arange(12, dtype=np.int32)
    for jpos, tpos in ((jnp.asarray(pos), torch.from_numpy(pos)),
                       (jnp.asarray(pos[None] + np.array([[0], [5]])),
                        torch.from_numpy(pos[None] + np.array([[0], [5]])))):
        for j, t in zip(JA._mla_q(jcfg, jp, jx, jpos),
                        A._mla_q(tcfg, tp, tx, tpos)):
            _close(t, j)
        for j, t in zip(JA.mla_compress_kv(jcfg, jp, jx, jpos),
                        A.mla_compress_kv(tcfg, tp, tx, tpos)):
            _close(t, j)


@pytest.mark.parametrize("stack", ["first_layers", "layers"])
def test_mla_fullseq_matches_jax(stack):
    jcfg, tcfg, params, model = _pair()
    jp, tp = _attn(params, model, stack)
    jx, tx = _x(tcfg, 2, 20, 5)
    ref = JA.mla_fullseq(jcfg, jp, jx, jnp.arange(20, dtype=jnp.int32))
    with torch.no_grad():
        _close(A.mla_fullseq(tcfg, tp, tx), ref)
        _close(A.mla_fullseq(tcfg, tp, tx, torch.arange(20)), ref)


def test_gqa_fullseq_refuses_mla():
    cfg = get_config("yi-6b").smoke()
    with pytest.raises(NotImplementedError, match="mla"):
        A.gqa_fullseq(dataclasses.replace(cfg, attention_kind="mla"), {},
                      torch.zeros(1, 4, cfg.d_model))


def test_mla_decode_matches_jax():
    """One absorbed step at positions 9 and 3 against a seeded cache
    whose slots past each lane's position are empty: the output and both
    caches (the token written at its slot) within the bar."""
    jcfg, tcfg, params, model = _pair()
    jp, tp = _attn(params, model)
    jx, tx = _x(tcfg, 2, 1, 6)
    rng = np.random.default_rng(7)
    T = 16
    c = rng.standard_normal((2, T, tcfg.mla_kv_lora_rank)).astype(np.float32)
    r = rng.standard_normal((2, T, tcfg.mla_qk_rope_dim)).astype(np.float32)
    pos = np.array([9, 3], np.int32)
    kpos = np.where(np.arange(T)[None] <= pos[:, None], np.arange(T)[None],
                    M.EMPTY_POS).astype(np.int32)
    ref = JA.mla_decode(jcfg, jp, jx, jnp.asarray(pos), jnp.asarray(c),
                        jnp.asarray(r), jnp.asarray(pos), jnp.asarray(kpos))
    tc, tr = torch.from_numpy(c.copy()), torch.from_numpy(r.copy())
    with torch.no_grad():
        out = A.mla_decode(tcfg, tp, tx, torch.from_numpy(pos), tc, tr,
                           torch.from_numpy(pos).long(),
                           torch.from_numpy(kpos))
    assert out[1] is tc and out[2] is tr          # written in place
    for got, want in zip(out, ref):
        _close(got, want)


# ------------------------------------------------------------------ MoE --
def _moe_pair(dtype="float32"):
    """deepseek-v2's routing at smoke widths: 160 experts, top-6, 2
    shared (the registered counts)."""
    full = get_config(ARCH)
    kw = dict(moe_num_experts=full.moe_num_experts, moe_top_k=full.moe_top_k,
              moe_shared_experts=full.moe_shared_experts)
    jcfg, tcfg, params, model = _pair(dtype, **kw)
    jp = jax.tree.map(lambda t: jnp.asarray(t[0]), params["layers"]["moe"])
    return jcfg, tcfg, jp, model.layers[0]["moe"]


@pytest.mark.parametrize("call", [{}, {"dropless": True}],
                         ids=["capacity", "dropless"])
def test_moe_forward_at_registered_routing_matches_jax(call):
    jcfg, tcfg, jp, tp = _moe_pair()
    assert tuple(tp["w_gate"].shape) == (160, tcfg.d_model, tcfg.moe_d_ff)
    assert tuple(tp["shared"]["w_up"].shape) == (tcfg.d_model,
                                                 2 * tcfg.moe_d_ff)
    jx, tx = _x(tcfg, 2, 40, 8)
    np.testing.assert_array_equal(
        TMOE.router_load(tcfg, tp, tx).numpy(),
        np.asarray(JMOE.router_load(jcfg, jp, jx)))
    ref = JMOE.moe_forward(jcfg, jp, jx, **call)
    with torch.no_grad():
        _close(TMOE.moe_forward(tcfg, tp, tx, **call), ref)
    load = TMOE.router_load(tcfg, tp, tx)
    C = TMOE._capacity(tcfg, 80)
    if not call:            # 480 assignments over 160 experts: C = 8 drops
        assert C == 8 and int((load - C).clamp(min=0).sum()) > 0


# --------------------------------------------------------------- forward --
def test_forward_routes_every_mla_layer_through_the_flash_op():
    """Each layer's MLA is one flash forward (the dense first layer's
    too), and ``remat_policy="full"`` recomputes it once in the backward
    beside the op's own recompute."""
    _, tcfg, _, model = _pair()
    assert tcfg.remat_policy == "full"
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, tcfg.vocab_size, (2, 17)).astype(np.int32))
    model.requires_grad_(True)
    ops.plain_forwards.reset()
    ops.backward_recomputes.reset()
    M.loss_fn(tcfg, model, {"tokens": toks, "labels": toks}).backward()
    assert ops.plain_forwards.n == 2 * tcfg.num_layers
    assert ops.backward_recomputes.n == tcfg.num_layers
    assert K.launches.n == 0


@pytest.mark.cuda
def test_cuda_padded_route_matches_plain_version():
    """The kernel at MLA's head dims against the unpadded plain version on
    the card, flat and sharp: (192, 128) on the tensor-core kernel's own
    instantiation in bf16 and the FP32-core kernel's in float32 (no pad;
    the kernel itself called on the unpadded operands returns (BH, S,
    128)), and both types at the smoke config's (24, 16) through the
    padded route (hd 32); then the op's gradients against plain
    autograd."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine: "
                    "pytest -m cuda tests/test_torch_mla.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    tol = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
    for (dk, dv), qk in ((d, qk) for d in HEAD_DIMS for qk in (0.3, 4.0)):
        arrs = _qkv(2, 200, 8, dk, dv, seed=10)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.from_numpy(a).cuda().to(dtype) for a in arrs)
            q, k = q * qk, k * qk
            native = K.head_dims(dtype, dk, dv) == (dk, dv)
            assert native == (dk == 192)
            before = (K.launches.n, K.tc_launches.n)
            out = mha_flash(q, k, v, causal=True, scale=1 / math.sqrt(dk))
            torch.cuda.synchronize()
            tc = K.route(dtype, dk, dv) == K.TENSOR_CORES
            assert tc == (dtype == torch.bfloat16 and dk == 192)
            assert (K.launches.n, K.tc_launches.n) == (before[0] + 1,
                                                       before[1] + int(tc))
            flat = [t.transpose(1, 2).reshape(16, 200, -1).contiguous()
                    for t in (q, k, v)]
            ref = flash_attention_ref(*flat, causal=True)
            assert out.shape == (2, 200, 8, dv)
            np.testing.assert_allclose(
                out.transpose(1, 2).reshape(16, 200, dv).float().cpu()
                .numpy(), ref.float().cpu().numpy(), rtol=tol[dtype],
                atol=tol[dtype])
            if native:
                own = K.flash_attention_fwd(*flat, causal=True)
                assert own.shape == (16, 200, dv) and own._base is None
                np.testing.assert_allclose(
                    own.float().cpu().numpy(), ref.float().cpu().numpy(),
                    rtol=tol[dtype], atol=tol[dtype])
    got, want = [], []
    arrs = _qkv(2, 128, 4, 192, 128, seed=11)
    for use_kernel in (True, False):
        ts = [torch.from_numpy(a).cuda().requires_grad_(True) for a in arrs]
        if use_kernel:
            out = mha_flash(*ts, causal=True)
        else:
            flat = [t.transpose(1, 2).reshape(8, 128, -1) for t in ts]
            out = flash_attention_ref(*flat, causal=True)
        (out.float() ** 2).sum().backward()
        (got if use_kernel else want).extend(t.grad for t in ts)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=2e-3, atol=2e-3)
