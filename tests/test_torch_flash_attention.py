"""The port's flash attention against the reference's Pallas kernel.

On the CPU ``repro_torch``'s ``flash_attention`` / ``mha_flash`` run the
plain version (float32 scores, softcap, mask, p cast to v's type); the
reference runs its Pallas kernel in interpret mode, as
``tests/test_kernels.py`` does.  Same inputs from
``np.random.default_rng``, at that file's tolerances: forward 2e-4 in
float32 and 2e-2 in bfloat16 (``TOL``), gradients 2e-3, ``attend_fullseq``
3e-4.  The CUDA kernel itself is held against the plain version by the
``cuda``-marked test (``pytest -m cuda tests/test_torch_flash_attention.py``
on a GPU machine).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.flash_attention import flash_attention_ref as j_ref
from repro.kernels.flash_attention import mha_flash as j_mha
from repro.models.attention import attend_fullseq as j_attend
from repro_torch.kernels.flash_attention import (
    flash_attention, flash_attention_ref, mha_flash,
)
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ops
from repro_torch.models.attention import attend_fullseq

TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
GRAD_TOL = dict(rtol=2e-3, atol=2e-3)
#: (causal, window, cap): tests/test_kernels.py's five masks
MASKS = [(True, 0, 0.0), (False, 0, 0.0), (True, 64, 0.0), (True, 0, 50.0),
         (True, 32, 30.0)]


#: q and k scale of the "sharp" inputs: scores of std SHARP^2 = 16 reach
#: the caps' range (30, 50) and make the softmax peaky; at test_kernels'
#: 0.3 the scores have std 0.09 and a cap moves them by < 5e-5
SHARP = 4.0


def _qkv(BH, S, T, d, seed=0, kv_rows=None, qk=0.3):
    rng = np.random.default_rng(seed)
    kv_rows = kv_rows or BH
    return (rng.standard_normal((BH, S, d), np.float32) * np.float32(qk),
            rng.standard_normal((kv_rows, T, d), np.float32)
            * np.float32(qk),
            rng.standard_normal((kv_rows, T, d), np.float32))


def _port(arrs, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]


def _jax(arrs, dtype):
    return [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]


@pytest.mark.parametrize("bhsd", [(2, 128, 128, 16), (1, 128, 256, 256)])
@pytest.mark.parametrize("causal,window,cap", MASKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference_kernel(bhsd, causal, window, cap, dtype):
    BH, S, T, d = bhsd
    arrs = _qkv(BH, S, T, d)
    out = flash_attention(*_port(arrs, dtype), causal, window, cap)
    ref = j_flash(*_jax(arrs, dtype), causal, window, cap, True)
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **TOL[dtype])


@pytest.mark.parametrize("bhsd", [(2, 128, 128, 16), (1, 128, 256, 256)])
@pytest.mark.parametrize("causal,window,cap", MASKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference_kernel_at_sharp_scores(bhsd, causal,
                                                          window, cap, dtype):
    """Scores in the caps' range and a peaky softmax: the cap and every
    key tile move the outputs by O(|v|) here."""
    BH, S, T, d = bhsd
    arrs = _qkv(BH, S, T, d, seed=5, qk=SHARP)
    out = flash_attention(*_port(arrs, dtype), causal, window, cap)
    ref = j_flash(*_jax(arrs, dtype), causal, window, cap, True)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **TOL[dtype])


@pytest.mark.parametrize("cap", [30.0, 50.0])
def test_sharp_scores_make_the_cap_bite(cap):
    """What the sharp inputs are for: at test_kernels' scale a plain
    version without the cap stays within the float32 tolerance of the one
    with it (such inputs cannot tell them apart); at ``SHARP`` it is off
    by O(1)."""
    def gap(qk):
        q, k, v = _port(_qkv(2, 128, 128, 256, seed=6, qk=qk), "float32")
        return (flash_attention_ref(q, k, v, cap=cap)
                - flash_attention_ref(q, k, v, cap=0.0)).abs().max().item()
    assert gap(0.3) < TOL["float32"]["atol"]
    assert gap(SHARP) > 0.1


@pytest.mark.parametrize("causal,window,cap", MASKS)
def test_gqa_forward_matches_reference_kernel(causal, window, cap):
    """groups=4: query head b reads KV row b // 4, unexpanded."""
    arrs = _qkv(8, 128, 128, 32, seed=1, kv_rows=2)
    out = flash_attention(*_port(arrs, "float32"), causal, window, cap, 4)
    ref = j_flash(*_jax(arrs, "float32"), causal, window, cap, True, 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               **TOL["float32"])


@pytest.mark.parametrize("S,T", [(100, 100), (37, 130), (130, 37)])
def test_partial_tiles_match_the_oracle(S, T):
    """A deliberate difference: the reference asserts that its tiles
    divide S and T; the port takes any S and T (held against the
    reference's pure-jnp oracle), and a causal row with no visible key
    gives 0."""
    for causal, window, cap in MASKS:
        arrs = _qkv(2, S, T, 16, seed=2)
        out = flash_attention(*_port(arrs, "float32"), causal, window, cap)
        ref = j_ref(*_jax(arrs, "float32"), causal=causal, window=window,
                    cap=cap)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   **TOL["float32"])
    with pytest.raises(AssertionError):
        j_flash(*_jax(_qkv(2, 130, 130, 16), "float32"), True, 0, 0.0, True)


def test_window_one_and_fully_masked_rows():
    """A causal window of 1 leaves each row only its own key (out = v);
    rows with no visible key (here: no keys at all) give 0."""
    q, k, v = _port(_qkv(1, 8, 8, 16), "float32")
    own = flash_attention(q, k, v, True, 1, 0.0)
    np.testing.assert_allclose(own.numpy(), v.numpy(), rtol=1e-6, atol=1e-6)
    empty = flash_attention(q, k[:, :0], v[:, :0], False)
    assert empty.shape == q.shape and not empty.any()


def test_grad_matches_reference():
    arrs = _qkv(2, 128, 128, 32)
    q, k, v = _port(arrs, "float32")
    q.requires_grad_(True)
    flash_attention(q, k, v, True, 0, 0.0).sum().backward()
    jq, jk, jv = _jax(arrs, "float32")
    g = jax.grad(lambda q_: j_flash(q_, jk, jv, True, 0, 0.0,
                                    True).sum())(jq)
    np.testing.assert_allclose(q.grad.numpy(), np.asarray(g), **GRAD_TOL)


@pytest.mark.parametrize("causal,window,cap", [(True, 0, 0.0),
                                               (True, 32, 30.0)])
def test_mha_gqa_grads_match_reference(causal, window, cap):
    """The groups > 1 backward sums the per-group K/V grads back onto the
    shared KV heads, as the reference's repeat-based VJP does."""
    B, S, H, Kv, hd = 2, 128, 4, 2, 32
    rng = np.random.default_rng(3)
    arrs = (rng.standard_normal((B, S, H, hd), np.float32) * 0.3,
            rng.standard_normal((B, S, Kv, hd), np.float32) * 0.3,
            rng.standard_normal((B, S, Kv, hd), np.float32))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    (mha_flash(*ts, causal=causal, window=window, cap=cap) ** 2).sum() \
        .backward()

    def loss(q_, k_, v_):
        return (j_mha(q_, k_, v_, causal=causal, window=window, cap=cap,
                      interpret=True) ** 2).sum()

    g = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, arrs))
    for t, gj in zip(ts, g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gj),
                                   **GRAD_TOL)


def test_bf16_grads_keep_their_types():
    q, k, v = (t.requires_grad_(True)
               for t in _port(_qkv(4, 64, 64, 16), "bfloat16"))
    k2 = k.detach()[:2].clone().requires_grad_(True)
    v2 = v.detach()[:2].clone().requires_grad_(True)
    flash_attention(q, k2, v2, True, 0, 50.0, 2).float().sum().backward()
    assert q.grad.dtype == k2.grad.dtype == v2.grad.dtype == torch.bfloat16
    assert k2.grad.shape == (2, 64, 16)


@pytest.mark.parametrize("causal,window,cap", MASKS)
def test_attend_fullseq_matches_reference(causal, window, cap):
    """``None`` positions (as the forward passes them) and an explicit
    ``arange`` both take the flash op."""
    B, S, H, Kv, hd = 2, 128, 8, 2, 32
    rng = np.random.default_rng(4)
    arrs = (rng.standard_normal((B, S, H, hd), np.float32) * 0.3,
            rng.standard_normal((B, S, Kv, hd), np.float32) * 0.3,
            rng.standard_normal((B, S, Kv, hd), np.float32))
    out = attend_fullseq(*map(torch.from_numpy, arrs),
                         q_positions=None,
                         k_positions=torch.arange(S, dtype=torch.int32),
                         causal=causal, window=window, cap=cap)
    pos = jnp.arange(S, dtype=jnp.int32)
    ref = j_attend(*map(jnp.asarray, arrs), q_positions=pos,
                   k_positions=pos, causal=causal, window=window, cap=cap)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=3e-4,
                               atol=3e-4)


def test_attend_fullseq_refuses_offset_positions():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(NotImplementedError, match="positions"):
        attend_fullseq(q, q, q, q_positions=torch.arange(8) + 4,
                       k_positions=torch.arange(8), causal=True)


def test_cpu_tensors_take_the_plain_version_and_never_the_kernel():
    q, k, v = _port(_qkv(2, 32, 32, 16), "float32")
    for c in (K.launches, K.tc_launches, ops.plain_forwards,
              ops.backward_recomputes):
        c.reset()
    q.requires_grad_(True)
    flash_attention(q, k, v).sum().backward()
    assert (K.launches.n, K.tc_launches.n, ops.plain_forwards.n,
            ops.backward_recomputes.n) == (0, 0, 1, 1)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        K.flash_attention_fwd(q.detach(), k, v)
    with pytest.raises(TypeError, match="float32"):
        flash_attention(q.double(), k.double(), v.double())


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 256, "tensor_cores"),   # gemma2-2b
    (torch.bfloat16, 128, "tensor_cores"),   # yi-6b, qwen3-32b
    (torch.bfloat16, 64, "tensor_cores"),
    (torch.bfloat16, 32, "fp32_cores"),      # under one 128-byte TMA box
    (torch.bfloat16, 16, "fp32_cores"),
    (torch.float32, 256, "fp32_cores"),      # the 2e-4 bar
    (torch.float32, 64, "fp32_cores"),
    (torch.float32, 16, "fp32_cores"),
])
def test_route_by_dtype_and_head_dim(dtype, hd, want):
    assert K.route(dtype, hd) == want


@pytest.mark.parametrize("dtype,dk,dv,want,native", [
    (torch.bfloat16, 192, 128, "tensor_cores", True),   # MLA: its own
    (torch.float32, 192, 128, "fp32_cores", True),      # ... in both types
    (torch.bfloat16, 24, 16, "fp32_cores", False),      # the smoke config's
    (torch.float32, 24, 16, "fp32_cores", False),       # ... padded to 32
    (torch.bfloat16, 64, 64, "tensor_cores", True),
    (torch.bfloat16, 64, 256, "tensor_cores", False),   # padded to 256
])
def test_route_and_kernel_operands(dtype, dk, dv, want, native,
                                   monkeypatch):
    """What the op's CUDA route hands the kernel, with the kernel's
    wrapper replaced by a recorder: on a native route q, k and v
    themselves (same storage) and the kernel's own (BH, S, dv) output
    back, no slice; on the padded route q, k and v zero-padded to
    ``kernel.head_dims``' one hd at the unpadded scale, the output sliced
    back to dv."""
    assert K.route(dtype, dk, dv) == want
    q, k, v = (torch.from_numpy(a).to(dtype) for a in (
        _qkv(4, 40, 40, dk, seed=13)[:2]
        + (np.random.default_rng(14).standard_normal((4, 40, dv),
                                                     np.float32),)))
    calls = []

    def recorder(qq, kk, vv, **kw):
        calls.append((qq, kk, vv, kw))
        out = torch.zeros(qq.shape[0], qq.shape[1], vv.shape[2], dtype=dtype)
        calls.append(out)
        return out

    monkeypatch.setattr(K, "flash_attention_fwd", recorder)
    got = ops._kernel_forward(q, k, v, True, 0, 0.0, 1, None)
    (qq, kk, vv, kw), out = calls
    assert kw["scale"] == pytest.approx(1 / np.sqrt(dk))
    assert got.shape == (4, 40, dv)
    if native:
        assert all(a is b for a, b in zip((qq, kk, vv), (q, k, v)))
        assert got is out
        return
    d = K.head_dims(dtype, dk, dv)[0]
    assert qq.shape[-1] == kk.shape[-1] == vv.shape[-1] == d
    assert torch.equal(qq[..., :dk], q) and not qq[..., dk:].any()
    assert torch.equal(vv[..., :dv], v) and not vv[..., dv:].any()
    assert got is out if d == dv else got._base is out


def test_a_refused_native_launch_raises(monkeypatch):
    """An MLA call (bf16 or float32) whose native launch the kernel
    refuses raises: one call, on the unpadded operands, and no retry on
    the padded route."""
    for dtype in (torch.bfloat16, torch.float32):
        q, k = (torch.from_numpy(a).to(dtype)
                for a in _qkv(2, 16, 16, 192, seed=15)[:2])
        v = torch.zeros(2, 16, 128, dtype=dtype)
        calls = []

        def refused(qq, kk, vv, **kw):
            calls.append((qq.shape[-1], vv.shape[-1]))
            raise RuntimeError(f"flash attention kernel "
                               f"({K.route(dtype, 192, 128)}) launch "
                               "failed: CUDA error 1")

        monkeypatch.setattr(K, "flash_attention_fwd", refused)
        with pytest.raises(RuntimeError, match="launch failed"):
            ops._kernel_forward(q, k, v, True, 0, 0.0, 1, None)
        assert calls == [(192, 128)]


@pytest.mark.parametrize("dims,plan", [
    (dims, i) for dims in sorted(K.TC_PLANS)
    for i in range(len(K.TC_PLANS[dims]))])
def test_tensor_core_shared_memory_fits_the_opt_in(dims, plan):
    """Each instantiation's shared memory under each of its plans, as
    ``tc::Smem`` counts it (mirrored by ``kernel.tc_smem_bytes``), under
    the 227 KB a block may opt in to; the hand count of each."""
    dk, dv = dims
    p = K.TC_PLANS[dims][plan]
    want = (1024 + 64 * p.consumers * dk * 2
            + p.stages * (p.keys * dk * 2 + p.keys * dv * 2)
            + (1 + 4 * p.stages) * 8)
    assert K.tc_smem_bytes(dk, dv, p) == want <= K.SMEM_LIMIT == 232448
    assert {(64, 64, 0): 91208, (64, 64, 1): 83016, (128, 128, 0): 99400,
            (256, 256, 0): 197704, (192, 128, 0): 132168}[
        dk, dv, plan] == want


def test_tensor_core_plans_mirror_the_source():
    """``kernel.TC_PLANS`` says what ``csrc/flash_attention.cu``'s plans
    (``using ... = TilePlan<...>``) and its C entry's dispatch say: each
    (hd, dv, query rows a block) launches the plan of those rows."""
    import re
    text = K.SOURCE.read_text()
    plans = {name: K.TcPlan(*map(int, args)) for name, *args in re.findall(
        r"using (\w+) = TilePlan<(\d+), (\d+), (\d+), (\d+), \d+, \d+>;",
        text)}
    launched = {}
    for dk, dv, rows, name in re.findall(
            r"hd == (\d+) && dv == (\d+) && rows == (\d+)\)\s*"
            r"e = FLASH_TC\(\d+, \d+, tc::(\w+)\)", text):
        assert 64 * plans[name].consumers == int(rows)
        launched.setdefault((int(dk), int(dv)), set()).add(plans[name])
    assert launched == {dims: set(p) for dims, p in K.TC_PLANS.items()}


@pytest.mark.parametrize("BH,S,want", [
    (64, 1500, 0),    # whisper's encoder: 512 blocks of 192 rows
    (50, 3072, 0),    # hymba: 800
    (64, 448, 1),     # whisper's cross / causal 448: 192 < 2 waves
    (80, 256, 1),     # train_100m: 160
    (64, 1100, 0),    # 384 blocks: two waves of 132 SMs
    (64, 768, 1),     # 256
])
def test_tc_plan_by_grid(BH, S, want):
    """hd 64 takes its three-consumer plan where 192-row blocks fill two
    waves of the card, else its two-consumer one; every other
    instantiation has one plan."""
    assert K.tc_plan(BH, S, 64, 64) == K.TC_PLANS[64, 64][want]
    assert K.tc_plan(BH, S, 128, 128) == K.TC_PLANS[128, 128][0]
    assert K.tc_plan(BH, S, 192, 128) == K.TC_PLANS[192, 128][0]


def tc_emulation(q, k, v, causal, window, cap, groups=1, plan=None):
    """The tensor-core kernel's arithmetic and tile order, for the tests
    only, under the tile plan the kernel takes for the call
    (``kernel.tc_plan``, unless given): blocks of 64 x consumers
    query rows walk the block's visible keys from k_lo (the window's first
    key, not tile-aligned) to k_hi in tiles of ``plan.keys`` keys; each
    64-row warpgroup skips the tiles none of its rows can see; scores
    float32 from bf16 operands, times scale (1/sqrt of q's head dim), the
    cap in float32, then log2-scaled for exp2; the online softmax's m and
    l in float32; p rounded to bf16 for P.V while l sums it unrounded;
    out = O / l (0 where l is 0), rounded to bf16.  q (BH,S,d), k
    (BH/groups,T,d), v (BH/groups,T,dv) bf16."""
    BH, S, d = q.shape
    T, dv = k.shape[1], v.shape[2]
    plan = plan or K.tc_plan(BH, S, d, dv)
    rows_a_block, bk = 64 * plan.consumers, plan.keys
    scale, log2e = 1.0 / np.sqrt(d), 1.4426950408889634
    qf = q.float()
    kf = torch.cat([k.float(), torch.zeros(k.shape[0], bk, d)], 1)
    vf = torch.cat([v.float(), torch.zeros(v.shape[0], bk, dv)], 1)
    kf = kf.repeat_interleave(groups, 0)
    vf = vf.repeat_interleave(groups, 0)
    out = torch.zeros(BH, S, dv)
    for q0 in range(0, S, rows_a_block):
        last = min(q0 + rows_a_block, S) - 1
        k_hi = min(T, last + 1) if causal else T
        k_lo = max(0, q0 - window + 1) if window else 0
        for r0 in range(q0, q0 + rows_a_block, 64):
            if r0 >= S:
                continue
            rows = torch.arange(r0, min(r0 + 64, S))
            k_first = r0 - window + 1 if window else 0
            k_last = r0 + 63 if causal else T - 1
            m = torch.full((BH, len(rows)), -1e30)
            l_sum = torch.zeros(BH, len(rows))
            o = torch.zeros(BH, len(rows), dv)
            for k0 in range(k_lo, k_hi, bk):
                if not (k0 <= k_last and k0 + bk > k_first):
                    continue
                keys = torch.arange(k0, k0 + bk)
                s = torch.einsum("brd,btd->brt", qf[:, rows],
                                 kf[:, k0:k0 + bk]) * scale
                if cap:
                    s = cap * torch.tanh(s / cap)
                s = s * log2e
                mask = (keys[None, :] < T).expand(len(rows), bk)
                if causal:
                    mask = mask & (keys[None, :] <= rows[:, None])
                if window:
                    mask = mask & (rows[:, None] - keys[None, :] < window)
                s = torch.where(mask[None], s, torch.tensor(-1e30))
                m_new = torch.maximum(m, s.max(-1).values)
                p = torch.where(mask[None], torch.exp2(s - m_new[..., None]),
                                torch.tensor(0.0))
                alpha = torch.exp2(m - m_new)
                l_sum = l_sum * alpha + p.sum(-1)
                o = o * alpha[..., None] + torch.einsum(
                    "brt,btd->brd", p.to(torch.bfloat16).float(),
                    vf[:, k0:k0 + bk])
                m = m_new
            out[:, rows] = o / torch.where(l_sum == 0, torch.ones_like(l_sum),
                                           l_sum)[..., None]
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("qk", [0.3, SHARP])
@pytest.mark.parametrize("causal,window,cap", MASKS)
@pytest.mark.parametrize("d,groups", [(64, 1), (256, 2), (64, 2)])
def test_tensor_core_arithmetic_matches_the_pallas_kernel(d, groups, causal,
                                                          window, cap, qk):
    """The tensor-core kernel's tile order and rounding (``tc_emulation``)
    under every tile plan of the instantiation (at hd 64 128-key tiles
    with blocks of 192 and of 128 query rows) against the reference's
    Pallas kernel in interpret mode at hd 64 (G = 1 and 2) and 256 (GQA),
    the five masks, flat and sharp, within the bf16 bar."""
    BH, S, T = 4, 256, 256
    arrs = _qkv(BH, S, T, d, seed=8, kv_rows=BH // groups, qk=qk)
    ref = j_flash(*_jax(arrs, "bfloat16"), causal, window, cap, True, groups)
    for plan in K.TC_PLANS[d, d]:
        emu = tc_emulation(*_port(arrs, "bfloat16"), causal, window, cap,
                           groups, plan)
        np.testing.assert_allclose(emu.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   **TOL["bfloat16"])


@pytest.mark.parametrize("qk", [0.3, SHARP])
@pytest.mark.parametrize("causal,window,cap", MASKS)
def test_tensor_core_mla_arithmetic_matches_the_pallas_kernel(causal, window,
                                                              cap, qk):
    """MLA's (192, 128) instantiation's arithmetic (``tc_emulation`` at q/k
    192 beside v 128, scale 1/sqrt(192)) against the reference's Pallas
    kernel in interpret mode at d = 192 with v zero-padded to 192 and its
    output sliced to 128, the five masks, flat and sharp, within the bf16
    bar."""
    BH, S, T = 4, 256, 256
    q, k, _ = _qkv(BH, S, T, 192, seed=16, qk=qk)
    v = np.random.default_rng(17).standard_normal((BH, T, 128), np.float32)
    vp = np.concatenate([v, np.zeros((BH, T, 64), np.float32)], -1)
    ref = j_flash(*_jax((q, k, vp), "bfloat16"), causal, window, cap, True)
    emu = tc_emulation(*_port((q, k, v), "bfloat16"), causal, window, cap)
    assert emu.shape == (BH, S, 128)
    np.testing.assert_allclose(emu.float().numpy(),
                               np.asarray(ref, np.float32)[..., :128],
                               **TOL["bfloat16"])


def test_tensor_core_emulation_takes_partial_tiles():
    """S and T that are not multiples of the tiles (of either hd-64
    plan), against the reference's oracle (its kernel asserts that its
    tiles divide them)."""
    for causal, window, cap in MASKS:
        arrs = _qkv(2, 200, 130, 64, seed=9, qk=SHARP)
        ref = j_ref(*_jax(arrs, "bfloat16"), causal=causal, window=window,
                    cap=cap)
        for plan in K.TC_PLANS[64, 64]:
            emu = tc_emulation(*_port(arrs, "bfloat16"), causal, window,
                               cap, plan=plan)
            np.testing.assert_allclose(emu.float().numpy(),
                                       np.asarray(ref, np.float32),
                                       **TOL["bfloat16"])


def fp32_emulation(q, k, v, causal, window, cap, groups=1, span=None):
    """The FP32-core kernel's arithmetic, tile order and splits, for the
    tests only: query tiles of 64 rows walk their visible keys from k_lo
    (the window's first key) to k_hi in 64-key tiles; the walk is cut into
    splits of ``span`` tiles (``kernel.fp32_plan``'s, unless given), each
    with its own online softmax; scores float32 from the inputs widened
    exactly, times scale, the cap as cap - 2 cap / (2^(2 log2e x / cap) +
    1), then log2-scaled for exp2; p rounded to v's type for P.V while l
    sums it unrounded; the splits combined in split order by log-sum-exp
    (a split a row sees nothing of weighs 0); out = O / l (0 where l is 0)
    in q's type.  q (BH,S,d), k (BH/groups,T,d), v (BH/groups,T,dv): the
    partials' acc rows and the output are dv wide."""
    BH, S, d = q.shape
    T, dv = k.shape[1], v.shape[2]
    scale, log2e = 1.0 / np.sqrt(d), 1.4426950408889634
    if span is None:
        span_keys, splits = K.fp32_plan(BH, S, T, d, causal, window, dv)
        span = span_keys // K.FP32_KEYS if splits > 1 else None
    qf = q.float()
    kf = torch.cat([k.float(), torch.zeros(k.shape[0], 64, d)],
                   1).repeat_interleave(groups, 0)
    vf = torch.cat([v.float(), torch.zeros(v.shape[0], 64, dv)],
                   1).repeat_interleave(groups, 0)
    neg = torch.tensor(-1e30)
    out = torch.zeros(BH, S, dv)
    walks = K.fp32_walks(S, T, causal, window)
    for ti, q0 in enumerate(range(0, S, 64)):
        rows = torch.arange(q0, min(q0 + 64, S))
        last = min(q0 + 64, S) - 1
        k_hi = min(T, last + 1) if causal else T
        k_lo = max(0, q0 - window + 1) if window else 0
        n = walks[ti]
        per = span or max(n, 1)
        parts = []
        for t0 in range(0, max(n, 1), per):
            m = torch.full((BH, len(rows)), -1e30)
            l_sum = torch.zeros(BH, len(rows))
            o = torch.zeros(BH, len(rows), dv)
            for it in range(t0, min(n, t0 + per)):
                k0 = k_lo + it * 64
                keys = torch.arange(k0, k0 + 64)
                # keys past k_hi are zero-filled, then masked
                kt = torch.where((keys < k_hi)[None, :, None],
                                 kf[:, k0:k0 + 64], torch.tensor(0.0))
                vt = torch.where((keys < k_hi)[None, :, None],
                                 vf[:, k0:k0 + 64], torch.tensor(0.0))
                s = torch.einsum("brd,btd->brt", qf[:, rows], kt) * scale
                if cap:
                    s = cap - 2 * cap / (torch.exp2(s * (2 * log2e / cap))
                                         + 1)
                s = s * log2e
                mask = (keys[None, :] < T).expand(len(rows), 64)
                if causal:
                    mask = mask & (keys[None, :] <= rows[:, None])
                if window:
                    mask = mask & (rows[:, None] - keys[None, :] < window)
                s = torch.where(mask[None], s, neg)
                m_new = torch.maximum(m, s.max(-1).values)
                p = torch.where(mask[None], torch.exp2(s - m_new[..., None]),
                                torch.tensor(0.0))
                alpha = torch.exp2(m - m_new)
                l_sum = l_sum * alpha + p.sum(-1)
                o = o * alpha[..., None] + torch.einsum(
                    "brt,btd->brd", p.to(v.dtype).float(), vt)
                m = m_new
            parts.append((m, l_sum, o))
        if len(parts) == 1:
            m, l_sum, o = parts[0]
        else:
            mx = torch.stack([pm for pm, _, _ in parts]).max(0).values
            l_sum = torch.zeros_like(mx)
            o = torch.zeros(BH, len(rows), dv)
            for pm, pl, po in parts:
                w = torch.exp2(pm - mx)
                l_sum = l_sum + pl * w
                o = o + po * w[..., None]
        out[:, rows] = o / torch.where(l_sum == 0, torch.ones_like(l_sum),
                                       l_sum)[..., None]
    return out.to(q.dtype)


@pytest.mark.parametrize("qk", [0.3, SHARP])
@pytest.mark.parametrize("causal,window,cap", MASKS + [(True, 1, 0.0)])
@pytest.mark.parametrize("d,dtype,groups,span", [
    (16, "bfloat16", 1, None), (32, "bfloat16", 2, 1),
    (32, "float32", 1, None), (64, "float32", 2, 1), (256, "float32", 2, 2)])
def test_fp32_core_arithmetic_matches_the_pallas_kernel(d, dtype, groups,
                                                        span, causal,
                                                        window, cap, qk):
    """The FP32-core kernel's arithmetic, tile order and split-KV combine
    (``fp32_emulation``; ``span`` forces splits of 1 or 2 key tiles)
    against the reference's Pallas kernel in interpret mode: S=256 over
    T=128 keys, so with a window rows past 128 + window see no key at all
    (fully masked), window 1 leaves each row its own key, and a split a
    row sees nothing of must weigh 0; flat and sharp scores, within the
    type's bar."""
    BH, S, T = 4, 256, 128
    arrs = _qkv(BH, S, T, d, seed=10, kv_rows=BH // groups, qk=qk)
    ref = j_flash(*_jax(arrs, dtype), causal, window, cap, True, groups)
    emu = fp32_emulation(*_port(arrs, dtype), causal, window, cap, groups,
                         span)
    np.testing.assert_allclose(emu.float().numpy(),
                               np.asarray(ref, np.float32), **TOL[dtype])


def test_fp32_core_emulation_splits_and_partial_tiles():
    """Partial tiles (S and T not multiples of 64) and every split size
    against the reference's oracle, float32: the split-KV combine is
    exact up to float32 rounding."""
    for causal, window, cap in MASKS:
        arrs = _qkv(2, 200, 330, 32, seed=11, qk=SHARP)
        ref = np.asarray(j_ref(*_jax(arrs, "float32"), causal=causal,
                               window=window, cap=cap))
        for span in (1, 2, 3, None):
            emu = fp32_emulation(*_port(arrs, "float32"), causal, window,
                                 cap, span=span)
            np.testing.assert_allclose(emu.numpy(), ref, **TOL["float32"])


@pytest.mark.parametrize("qk", [0.3, SHARP])
@pytest.mark.parametrize("causal,window,cap", MASKS + [(True, 1, 0.0)])
@pytest.mark.parametrize("span", [None, 8])
def test_fp32_core_mla_arithmetic_matches_the_pallas_kernel(span, causal,
                                                            window, cap, qk):
    """The FP32-core kernel's (192, 128) instantiation (``fp32_emulation``
    at q/k 192 beside v 128, scale 1/sqrt(192)): its tile walk, the split
    partials' acc rows of 128 and their log-sum-exp combine (``span``
    None: the plan's splits, which cut every walk here; 8: one block a
    query tile) against the reference's Pallas kernel in interpret mode at
    d = 192 with v zero-padded to 192 and its output sliced to 128, S=256
    over T=128 keys (rows past 128 + window see nothing), flat and sharp,
    within the float32 bar."""
    BH, S, T = 4, 256, 128
    q, k, _ = _qkv(BH, S, T, 192, seed=18, qk=qk)
    v = np.random.default_rng(19).standard_normal((BH, T, 128), np.float32)
    vp = np.concatenate([v, np.zeros((BH, T, 64), np.float32)], -1)
    if span is None:
        assert K.fp32_plan(BH, S, T, 192, causal, window, 128)[1] > 1 \
            or window == 1
    ref = j_flash(*_jax((q, k, vp), "float32"), causal, window, cap, True)
    emu = fp32_emulation(*_port((q, k, v), "float32"), causal, window, cap,
                         span=span)
    assert emu.shape == (BH, S, 128)
    np.testing.assert_allclose(emu.numpy(),
                               np.asarray(ref, np.float32)[..., :128],
                               **TOL["float32"])


def test_fp32_core_mla_emulation_takes_partial_tiles():
    """MLA's (192, 128) at S and T that are not multiples of 64, with GQA
    (2 flat heads a KV row), every split size, against the reference's
    oracle at v's own head dim."""
    for causal, window, cap in MASKS:
        q, k, _ = _qkv(4, 200, 330, 192, seed=20, kv_rows=2, qk=SHARP)
        v = np.random.default_rng(21).standard_normal((2, 330, 128),
                                                      np.float32)
        ref = np.asarray(j_ref(*_jax((q, np.repeat(k, 2, 0),
                                     np.repeat(v, 2, 0)), "float32"),
                               causal=causal, window=window, cap=cap))
        for span in (1, 2, 3, None):
            emu = fp32_emulation(*_port((q, k, v), "float32"), causal,
                                 window, cap, groups=2, span=span)
            np.testing.assert_allclose(emu.numpy(), ref, **TOL["float32"])


def test_fp32_core_takes_mla_as_it_is():
    """float32 (192, 128) runs at its own dims on the FP32 cores: its head
    dims, route, split plan (costed by 192 + 128 operations a pair, not
    those of a padded 256), split scratch (acc rows of 128) and shared
    memory (one K slot of 192 beside one V slot of 128) are the pair's
    own."""
    f32 = torch.float32
    assert K.head_dims(f32, 192, 128) == (192, 128)
    assert ops.padded_head_dim(192, 128, f32) == 192
    assert K.route(f32, 192, 128) == K.FP32_CORES
    assert (192, 128) in K.FP32_PAIRS
    # a split costs FP32_SPLIT_COST x 2 / (dk + dv) of a tile: at 16
    # heads of S=T=512 the plan splits as hd 160 does, not as hd 192 does
    assert K.fp32_plan(16, 512, 512, 192, True, 0, 128) \
        == K.fp32_plan(16, 512, 512, 160, True, 0) == (128, 4) \
        != K.fp32_plan(16, 512, 512, 192, True, 0)
    assert K.fp32_plan(8, 512, 512, 192, True, 0, 128) == (192, 3)
    assert K.fp32_plan(256, 512, 512, 192, True, 0, 128) == (0, 1)
    assert K.fp32_plan(8, 512, 512, 192, True, 0) == K.fp32_plan(
        8, 512, 512, 192, True, 0, 192)
    rows, words, tickets = K.fp32_scratch(8, 512, 128, 3)
    assert (rows, words, tickets) == (8 * 8 * 3 * 64, rows * 130, 64)
    assert K.fp32_smem(f32, 192, 128) == (1, 153600)


#: each FP32-core instantiation's (slots of K and of V, bytes), hand
#: counted: q (64 rows of dk + 16 bytes), P (64 x 80 float32), each K slot
#: (64 rows of dk + 16 bytes) and each V slot (64 rows of dv)
FP32_SMEM = {("float32", 16, 16): (2, 44032),
             ("float32", 32, 32): (2, 64512),
             ("float32", 64, 64): (2, 105472),
             ("float32", 128, 128): (2, 187392),
             ("float32", 256, 256): (1, 219136),
             ("float32", 192, 128): (1, 50176 + 20480 + 50176 + 32768),
             ("bfloat16", 16, 16): (2, 33792),
             ("bfloat16", 32, 32): (2, 44032)}


@pytest.mark.parametrize("inst", sorted(FP32_SMEM))
def test_fp32_core_shared_memory_fits_the_opt_in(inst):
    """Each FP32-core instantiation's slots and shared memory, as
    ``fp32::Smem`` derives them from the byte total (mirrored by
    ``kernel.fp32_smem``), under the opt-in less the static flag: two of
    each at every hd but float32 256 and MLA's float32 (192, 128), one
    of each there (at MLA two of each would take 236,544 bytes)."""
    dtype, dk, dv = inst
    got = K.fp32_smem(getattr(torch, dtype), dk, dv)
    assert got == FP32_SMEM[inst] and got[1] <= K.SMEM_LIMIT - 16
    e = 4 if dtype == "float32" else 2
    slot = 64 * e * (dk + 16 // e + dv)     # one K and one V slot
    if got[0] == 1:     # a second of each would pass the opt-in
        assert got[1] + slot > K.SMEM_LIMIT - 16
    if inst == ("float32", 192, 128):
        assert got[1] + slot == 236544


def test_fp32_core_instantiations_mirror_the_source():
    """The FP32-core C entry's dispatch (``FLASH_FP32(type, dk, dv)``)
    instantiates exactly what ``kernel.head_dims`` sends there: float32 at
    every hd of :data:`kernel.HEAD_DIMS` and at :data:`kernel.FP32_PAIRS`,
    bf16 at hd 16 and 32; ``FP32_SMEM`` names the same set."""
    import re
    text = K.SOURCE.read_text()
    names = {"float": "float32", "__nv_bfloat16": "bfloat16"}
    got = {(names[t], int(dk), int(dv)) for t, dk, dv in re.findall(
        r"FLASH_FP32\((float|__nv_bfloat16), (\d+), (\d+)\)", text)}
    want = {("float32", d, d) for d in K.HEAD_DIMS} \
        | {("float32", dk, dv) for dk, dv in K.FP32_PAIRS} \
        | {("bfloat16", 16, 16), ("bfloat16", 32, 32)}
    assert got == want == set(FP32_SMEM)
    for dtype, dk, dv in got:
        assert K.head_dims(getattr(torch, dtype), dk, dv) == (dk, dv)
        assert K.route(getattr(torch, dtype), dk, dv) == K.FP32_CORES


@pytest.mark.parametrize("BH,S,T,d,causal,window,want", [
    (16, 512, 512, 256, True, 0, (128, 4)),   # phase 10's global layer
    (16, 512, 512, 256, True, 128, (0, 1)),   # ... its local layer: 128
                                              # blocks of <= 3 tiles
    (2, 128, 128, 64, True, 0, (0, 1)),       # test_kernels' shapes
    (4, 256, 128, 32, False, 0, (0, 1)),
    (1, 128, 384, 128, False, 0, (64, 6)),    # two blocks of 6 tiles
    (1, 128, 384, 128, True, 0, (64, 2)),
    (4, 200, 330, 32, True, 0, (0, 1)),       # splits cost more at hd 32
    (8, 200, 1000, 128, False, 0, (256, 4)),  # 128 blocks of 4 tiles
    (16, 4096, 4096, 256, True, 0, (0, 1)),   # 1,024 blocks: two waves
    (1, 64, 0, 64, False, 0, (0, 1)),         # no keys
])
def test_fp32_plan_by_shape(BH, S, T, d, causal, window, want):
    assert K.fp32_plan(BH, S, T, d, causal, window) == want


def test_fp32_plan_covers_every_walk():
    """The splits a plan asks for cover the longest walk (the C entry
    refuses fewer), in whole key tiles."""
    for BH in (1, 4, 16):
        for S, T in ((64, 64), (100, 37), (512, 512), (1000, 3000)):
            for causal, window in ((True, 0), (False, 0), (True, 1),
                                   (True, 128), (False, 100)):
                span, splits = K.fp32_plan(BH, S, T, 64, causal, window)
                walks = K.fp32_walks(S, T, causal, window)
                if splits == 1:
                    assert span == 0
                    continue
                assert span % K.FP32_KEYS == 0
                assert splits * span // K.FP32_KEYS >= max(walks)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """The hand-written kernels against their plain version on the card:
    every head dim, both types, the five masks, GQA, partial tiles (at hd
    64 also 96 heads of S=450 over T=700: the three-consumer plan, past a
    192-row block and a 128-key tile; the smaller grids take the other), at
    test_kernels' scale and at ``SHARP``, each call on the kernel its
    route names (bf16 at hd 64-256 on the tensor cores), and the autograd
    gradients against plain autograd."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine: "
                    "pytest -m cuda tests/test_torch_flash_attention.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    for d in K.HEAD_DIMS:
        for (BH, S, T, G), qk in itertools.product(
                ((2, 128, 128, 1), (8, 100, 37, 4), (4, 200, 260, 2))
                + (((96, 450, 700, 2),) if d == 64 else ()), (0.3, SHARP)):
            arrs = _qkv(BH, S, T, d, kv_rows=BH // G, qk=qk)
            for dtype in ("float32", "bfloat16"):
                q, k, v = (t.cuda() for t in _port(arrs, dtype))
                tc = K.route(q.dtype, d) == K.TENSOR_CORES
                for causal, window, cap in MASKS:
                    before = (K.launches.n, K.tc_launches.n)
                    out = flash_attention(q, k, v, causal, window, cap, G)
                    torch.cuda.synchronize()
                    assert (K.launches.n, K.tc_launches.n) == (
                        before[0] + 1, before[1] + int(tc))
                    ref = flash_attention_ref(
                        q, k.repeat_interleave(G, 0),
                        v.repeat_interleave(G, 0), causal=causal,
                        window=window, cap=cap)
                    np.testing.assert_allclose(out.float().cpu().numpy(),
                                               ref.float().cpu().numpy(),
                                               **TOL[dtype])
    arrs = _qkv(4, 128, 128, 64, kv_rows=2)
    got, want = [], []
    for use_kernel in (True, False):
        ts = [t.cuda().requires_grad_(True) for t in _port(arrs, "float32")]
        if use_kernel:
            out = flash_attention(*ts, True, 32, 30.0, 2)
        else:
            out = flash_attention_ref(
                ts[0], ts[1].repeat_interleave(2, 0),
                ts[2].repeat_interleave(2, 0), causal=True, window=32,
                cap=30.0)
        (out ** 2).sum().backward()
        (got if use_kernel else want).extend(t.grad for t in ts)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   **GRAD_TOL)


@pytest.mark.cuda
def test_fp32_core_splits_match_plain_version(monkeypatch):
    """The FP32-core kernel with its key walks split over blocks (the
    plan's splits at phase 10's geometry, and spans of one, two and three
    key tiles forced at smaller ones) against the plain version on the
    card, float32 and bf16 at hd 32, flat and sharp; split launches are
    counted and two calls give equal outputs (the combine's order is
    fixed)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine: "
                    "pytest -m cuda tests/test_torch_flash_attention.py)")
    plan = K.fp32_plan
    cases = [((16, 512, 512, 256, 2), "float32", None)] + [
        (shape, dtype, span)
        for shape in ((4, 200, 330, 32, 2), (2, 256, 128, 64, 1))
        for dtype in ("float32", "bfloat16") for span in (1, 2, 3)
        if dtype == "float32" or shape[3] == 32]
    for (BH, S, T, d, G), dtype, span in cases:
        if span is not None:
            monkeypatch.setattr(K, "fp32_plan",
                                lambda BH, S, T, d, c, w, dv=None: (
                                    64 * span, -(-max(K.fp32_walks(
                                        S, T, c, w)) // span)))
        for qk in (0.3, SHARP):
            q, k, v = (t.cuda() for t in _port(
                _qkv(BH, S, T, d, seed=12, kv_rows=BH // G, qk=qk), dtype))
            for causal, window, cap in MASKS + [(True, 1, 0.0)]:
                splits = K.fp32_plan(BH, S, T, d, causal, window)[1]
                before = K.split_launches.n
                out = flash_attention(q, k, v, causal, window, cap, G)
                again = flash_attention(q, k, v, causal, window, cap, G)
                torch.cuda.synchronize()
                assert K.split_launches.n - before == 2 * int(splits > 1)
                assert torch.equal(out, again)
                ref = flash_attention_ref(
                    q, k.repeat_interleave(G, 0), v.repeat_interleave(G, 0),
                    causal=causal, window=window, cap=cap)
                np.testing.assert_allclose(out.float().cpu().numpy(),
                                           ref.float().cpu().numpy(),
                                           **TOL[dtype])
        monkeypatch.setattr(K, "fp32_plan", plan)


@pytest.mark.cuda
def test_fp32_core_mla_matches_plain_version():
    """The FP32-core kernel's float32 (192, 128) instantiation against the
    plain version on the card, flat and sharp, the five masks and window
    1: at deepseek-v2's 256 flat heads of S=T=512 (one block a query
    tile), at 8 heads (the plan splits the walks) and at 4 heads of S=200
    over T=330 with G=2 (partial tiles).  Each call is one FP32-core
    launch on the operands as they are, its output the kernel's own (BH,
    S, 128), and two calls give equal outputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine: "
                    "pytest -m cuda tests/test_torch_flash_attention.py)")
    seen = set()
    for BH, S, T, G in ((256, 512, 512, 1), (8, 512, 512, 1),
                        (4, 200, 330, 2)):
        for qk in (0.3, SHARP):
            q, k, _ = _qkv(BH, S, T, 192, seed=22, kv_rows=BH // G, qk=qk)
            v = np.random.default_rng(23).standard_normal(
                (BH // G, T, 128), np.float32)
            q, k, v = (torch.from_numpy(a).cuda() for a in (q, k, v))
            for causal, window, cap in MASKS + [(True, 1, 0.0)]:
                splits = K.fp32_plan(BH, S, T, 192, causal, window, 128)[1]
                seen.add(splits > 1)
                before = (K.launches.n, K.tc_launches.n, K.split_launches.n)
                out = K.flash_attention_fwd(q, k, v, causal=causal,
                                            window=window, cap=cap, groups=G)
                again = K.flash_attention_fwd(q, k, v, causal=causal,
                                              window=window, cap=cap,
                                              groups=G)
                torch.cuda.synchronize()
                assert (K.launches.n, K.tc_launches.n, K.split_launches.n) \
                    == (before[0] + 2, before[1], before[2]
                        + 2 * int(splits > 1))
                assert out.shape == (BH, S, 128) and out._base is None
                assert torch.equal(out, again)
                ref = flash_attention_ref(
                    q, k.repeat_interleave(G, 0), v.repeat_interleave(G, 0),
                    causal=causal, window=window, cap=cap)
                np.testing.assert_allclose(out.cpu().numpy(),
                                           ref.cpu().numpy(),
                                           **TOL["float32"])
                del out, again, ref
    assert seen == {True, False}


#: deliberately broken copies of the kernel, made from its source at test
#: time: (text replaced, replacement), each found exactly once.  The first
#: two break the tensor-core kernel, the one gemma2-2b's bf16 hd-256 calls
#: take: its cap line, and its tile walk (both consumer warpgroups skip
#: the second key tile for rows past 2,048; the ring's barriers still
#: turn, so the broken kernel ends).  The "fp32_" ones break the FP32-core
#: kernel, the one phase 10's float32 calls take: its cap line, and its
#: split walk (split 1 skips its last key tile)
MUTANTS = {
    "no_cap": (
        "        if (cap != 0.f) x = cap - __fdividef(two_cap, exp2f(x * k2) "
        "+ 1.f);\n", ""),
    "late_rows_skip_a_key_tile": (
        "    bool live = wg_live && k0 <= k_last_w && k0 + kBK > k_first_w;\n",
        "    bool live = wg_live && k0 <= k_last_w && k0 + kBK > k_first_w;\n"
        "    if (q0 >= 2048 && it == 1) live = false;\n"),
    "fp32_no_cap": (
        "        if (cap != 0.f) x = cap - __fdividef(two_cap, 1.f + "
        "exp2f(k2 * x));\n", ""),
    "fp32_split_skips_a_tile": (
        "  const int n_it = max(0, min(n_tiles, t0 + per) - t0);\n",
        "  const int n_it = max(0, min(n_tiles, t0 + per) - t0) - "
        "(split == 1);\n"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("mutant", sorted(MUTANTS))
def test_sharp_inputs_catch_a_broken_kernel(mutant, tmp_path, monkeypatch):
    """At gemma2-2b's geometry (16 flat heads over 8 KV rows, S=T=4096,
    hd 256, bf16, causal, cap 50) a kernel built without the cap, or one
    that skips a key tile for rows past 2,048, fails the bf16 tolerance
    on the sharp inputs; the kernel as built passes them.  The FP32-core
    mutants are held the same way at phase 10's float32 geometry (S=T=512,
    where the plan splits each walk) against the float32 tolerance.  The
    errors at both scales are printed (``-s``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine: "
                    "pytest -m cuda tests/test_torch_flash_attention.py)")
    from repro_torch.kernels import launch
    old, new = MUTANTS[mutant]
    text = K.SOURCE.read_text()
    assert text.count(old) == 1
    src = tmp_path / "flash_attention.cu"
    src.write_text(text.replace(old, new))
    broken = K.bind(launch.load(src))
    fp32 = mutant.startswith("fp32_")
    dtype = "float32" if fp32 else "bfloat16"
    BH, S, d, G = 16, 512 if fp32 else 4096, 256, 2
    assert K.route(getattr(torch, dtype), d) == (
        K.FP32_CORES if fp32 else K.TENSOR_CORES)
    if fp32:
        assert K.fp32_plan(BH, S, S, d, True, 0)[1] > 1
    errs = {}
    for qk in (0.3, SHARP):
        q, k, v = (t.cuda() for t in _port(
            _qkv(BH, S, S, d, seed=7, kv_rows=BH // G, qk=qk), dtype))
        ref = flash_attention_ref(q, k.repeat_interleave(G, 0),
                                  v.repeat_interleave(G, 0), cap=50.0)
        good = K.flash_attention_fwd(q, k, v, cap=50.0, groups=G)
        with monkeypatch.context() as mp:
            mp.setattr(K, "_library", lambda: broken)
            bad = K.flash_attention_fwd(q, k, v, cap=50.0, groups=G)
        for name, out in (("kernel", good), (mutant, bad)):
            errs[name, qk] = (out.float() - ref.float()).abs().max().item()
            errs[name, qk, "passes"] = torch.allclose(
                out.float(), ref.float(), **TOL[dtype])
        del q, k, v, ref, good, bad
    print(f"\nflash mutant {mutant}: " + " ".join(
        f"{n}@qk={qk}: max_abs_err={errs[n, qk]:.4g} "
        f"passes={errs[n, qk, 'passes']}"
        for n in ("kernel", mutant) for qk in (0.3, SHARP)), flush=True)
    assert errs["kernel", SHARP, "passes"]
    assert not errs[mutant, SHARP, "passes"]
