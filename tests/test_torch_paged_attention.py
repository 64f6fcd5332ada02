"""The port's paged-attention ops against the JAX reference.

On the CPU the port's ops run the plain version (``repro_torch``'s
``ref.py``); it is held against the reference's Pallas kernel in interpret
mode and against its jnp oracle, on the same inputs made with numpy, for
pools in q's type and for int8 pools with their (P, 2, Kv) scales.  The
CUDA kernel itself is held against the plain version by the ``cuda``-marked
test here (it skips without a card) and by ``chip_smoke.py`` phase 3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import (
    paged_attention as j_paged_attention,
    paged_decode_fused as j_paged_decode_fused,
    paged_attention_ref as j_paged_attention_ref,
    paged_prefill as j_paged_prefill,
    paged_prefill_fused as j_paged_prefill_fused,
    paged_prefill_ref as j_paged_prefill_ref,
    pad_block_table as j_pad_block_table,
    page_counts_for as j_page_counts_for,
)
from repro_torch.kernels.paged_attention import (
    mask_block_table, paged_attention, paged_decode_fused, paged_prefill,
    paged_prefill_fused, pad_block_table, page_counts_for, paged_prefill_ref,
    validate_head_sharding,
)
from repro_torch.kernels.paged_attention import kernel as K

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _dense_table(lengths, page, npg, P, rng, shared=()):
    """-1-marked table mapping ceil(len/page) pages per lane; the first
    ``len(shared)`` logical pages of every lane alias ``shared``."""
    bt = np.full((len(lengths), npg), -1, np.int32)
    free = [p for p in rng.permutation(P) if p not in shared]
    for i, ln in enumerate(lengths):
        for j in range(-(-int(ln) // page)):
            bt[i, j] = shared[j] if j < len(shared) else free.pop()
    return bt


def _inputs(seed, B, C, H, Kv, hd, page, P, dtype):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, C, H, hd)).astype(np.float32) * 0.3
    kp = rng.standard_normal((P, page, Kv, hd)).astype(np.float32) * 0.3
    vp = rng.standard_normal((P, page, Kv, hd)).astype(np.float32)
    jx = [jnp.asarray(a).astype(jnp.dtype(dtype)) for a in (q, kp, vp)]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, kp, vp)]
    return rng, jx, tx


def _close(a_jax, b_torch, dtype):
    np.testing.assert_allclose(np.asarray(a_jax, np.float32),
                               b_torch.float().numpy(), **TOL[dtype])


def _i32(*arrays):
    return [torch.from_numpy(np.asarray(a, np.int32)) for a in arrays]


@pytest.mark.parametrize("B,H,Kv,hd,page,npg,P", [
    (3, 8, 4, 32, 8, 6, 16),       # G=2
    (2, 4, 4, 64, 16, 4, 8),       # G=1
    (1, 16, 2, 128, 8, 8, 12),     # G=8
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_jax(B, H, Kv, hd, page, npg, P, dtype):
    rng, (jq, jk, jv), (tq, tk, tv) = _inputs(1, B, 1, H, Kv, hd, page, P,
                                               dtype)
    lengths = rng.integers(1, npg * page + 1, B).astype(np.int32)
    bt = _dense_table(lengths, page, npg, P, rng)
    out = paged_attention(tq[:, 0], tk, tv, *_i32(bt, lengths))
    if dtype == "float32":      # the Pallas kernel, interpreted (slow)
        _close(j_paged_attention(jq[:, 0], jk, jv, jnp.asarray(bt),
                                 jnp.asarray(lengths), interpret=True), out,
               dtype)
    _close(j_paged_attention_ref(jq[:, 0], jk, jv, jnp.asarray(bt),
                                 jnp.asarray(lengths)), out, dtype)


@pytest.mark.parametrize("C,H,Kv,hd,page,npg,P", [
    (8, 8, 4, 32, 4, 10, 24),      # G=2
    (16, 8, 2, 16, 8, 6, 32),      # G=4
    (5, 6, 6, 32, 16, 3, 8),       # G=1, chunk not a divisor of anything
    (4, 8, 1, 16, 4, 6, 16),       # G=8
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_jax(C, H, Kv, hd, page, npg, P, dtype):
    B = 3
    rng, (jq, jk, jv), (tq, tk, tv) = _inputs(2, B, C, H, Kv, hd, page, P,
                                               dtype)
    start = rng.integers(0, max(npg * page - C, 1), B).astype(np.int32)
    lengths = (start + C).astype(np.int32)
    bt = _dense_table(lengths, page, npg, P, rng)
    out = paged_prefill(tq, tk, tv, *_i32(bt, lengths, start))
    args = (jnp.asarray(bt), jnp.asarray(lengths), jnp.asarray(start))
    if dtype == "float32":      # the Pallas kernel, interpreted (slow)
        _close(j_paged_prefill(jq, jk, jv, *args, interpret=True), out,
               dtype)
    _close(j_paged_prefill_ref(jq, jk, jv, *args), out, dtype)


@pytest.mark.parametrize("page", [4, 16])
def test_fused_aliased_prefix_pages_and_empty_lane(page):
    """Lanes alias the same physical prefix pages (prefix-cache hits), one
    lane is empty (len 0) and one is a decode row at q_start = len - 1:
    the fused entry point on the repeat-padded table equals the reference
    kernel and oracle."""
    B, C, H, Kv, hd, npg, P = 4, 4, 8, 2, 16, 5, 24
    rng, (jq, jk, jv), (tq, tk, tv) = _inputs(3, B, C, H, Kv, hd, page, P,
                                               "float32")
    lengths = np.array([2 * page + 3, 2 * page + 1, 0, 3 * page],
                       np.int32)
    start = np.array([2 * page - 1, 2 * page - 3, 0, 3 * page - 1],
                     np.int32)
    bt = _dense_table(lengths, page, npg, P, rng, shared=(7, 3))
    tcounts = page_counts_for(torch.from_numpy(lengths), page)
    jcounts = j_page_counts_for(jnp.asarray(lengths), page)
    tpad = pad_block_table(torch.from_numpy(bt), tcounts)
    jpad = j_pad_block_table(jnp.asarray(bt), jcounts)
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(tpad.numpy(), np.asarray(jpad))
    np.testing.assert_array_equal(mask_block_table(tpad, tcounts).numpy(),
                                  bt)
    out = paged_prefill_fused(tq, torch.stack([tk, tv], dim=1), tpad,
                              tcounts, *_i32(lengths, start))
    _close(j_paged_prefill_fused(jq, jnp.stack([jk, jv], axis=1), jpad,
                                 jcounts, jnp.asarray(lengths),
                                 jnp.asarray(start), interpret=True),
           out, "float32")
    _close(j_paged_prefill_ref(jq, jk, jv, jnp.asarray(bt),
                               jnp.asarray(lengths), jnp.asarray(start)),
           out, "float32")
    assert float(out[2].abs().max()) == 0.0     # empty lane outputs 0


def test_chunked_equals_token_by_token():
    """A chunk through prefill equals feeding its positions one at a time
    through decode (the pre-chunked engine's path)."""
    B, C, H, Kv, hd, page, npg, P = 2, 8, 4, 2, 16, 4, 6, 16
    rng, _, (tq, tk, tv) = _inputs(4, B, C, H, Kv, hd, page, P, "float32")
    start = np.array([0, 5], np.int32)
    lengths = start + C
    bt = _dense_table(lengths, page, npg, P, rng)
    chunked = paged_prefill(tq, tk, tv, *_i32(bt, lengths, start))
    for c in range(C):
        one = paged_attention(tq[:, c], tk, tv,
                              *_i32(bt, start + c + 1))
        np.testing.assert_allclose(chunked[:, c].numpy(), one.numpy(),
                                   rtol=1e-4, atol=1e-4)


def test_page_table_helpers_match_jax():
    rng = np.random.default_rng(5)
    for page in (4, 8, 16):
        lengths = rng.integers(0, 6 * page, 7).astype(np.int32)
        bt = _dense_table(lengths, page, 6, 64, rng)
        tc = page_counts_for(torch.from_numpy(lengths), page)
        jc = j_page_counts_for(jnp.asarray(lengths), page)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(
            pad_block_table(torch.from_numpy(bt), tc).numpy(),
            np.asarray(j_pad_block_table(jnp.asarray(bt), jc)))
        assert page_counts_for(int(lengths[0]), page) == \
            int(np.asarray(j_page_counts_for(lengths[0], page)))
    assert validate_head_sharding(32, 4, 2) == 2
    with pytest.raises(ValueError):
        validate_head_sharding(32, 4, 3)


def _int8_inputs(seed, B, C, H, Kv, hd, page, P, dtype):
    """q in ``dtype``, an int8 fused pool with (P, 2, Kv) float32 scales,
    the same values in both frameworks."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, C, H, hd)).astype(np.float32) * 0.3
    kv = rng.integers(-127, 128, (P, 2, page, Kv, hd)).astype(np.int8)
    sc = rng.uniform(1e-3, 2e-2, (P, 2, Kv)).astype(np.float32)
    jq = jnp.asarray(q).astype(jnp.dtype(dtype))
    tq = torch.from_numpy(np.array(jq.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return rng, (jq, jnp.asarray(kv), jnp.asarray(sc)), \
        (tq, torch.from_numpy(kv), torch.from_numpy(sc))


@pytest.mark.parametrize("C,H,Kv,hd,page,npg,P", [
    (1, 8, 4, 32, 8, 6, 16),       # decode, G=2
    (1, 16, 2, 128, 16, 4, 12),    # decode, G=8, yi-6b head dim
    (8, 8, 2, 16, 4, 10, 24),      # prefill, G=4
    (5, 6, 6, 32, 16, 3, 8),       # prefill, G=1
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_pool_matches_jax(C, H, Kv, hd, page, npg, P, dtype):
    """An int8 pool with scales: the fused op's plain version against the
    reference's oracle with ``k_scales``/``v_scales`` and its Pallas
    kernel (interpret mode) with ``kv_scales``.  Lanes alias one prefix
    page and the last lane is empty."""
    B = 3
    rng, (jq, jkv, jsc), (tq, tkv, tsc) = _int8_inputs(
        7, B, C, H, Kv, hd, page, P, dtype)
    lengths = rng.integers(C, npg * page + 1, B).astype(np.int32)
    lengths[-1] = 0
    start = np.maximum(lengths - C, 0).astype(np.int32)
    bt = _dense_table(lengths, page, npg, P, rng, shared=(2,))
    counts = page_counts_for(torch.from_numpy(lengths), page)
    padded = pad_block_table(torch.from_numpy(bt), counts)
    jpad, jcounts = jnp.asarray(padded.numpy()), jnp.asarray(counts.numpy())
    jref_args = (jkv[:, 0], jkv[:, 1], jnp.asarray(bt), jnp.asarray(lengths))
    jscales = dict(k_scales=jsc[:, 0], v_scales=jsc[:, 1])
    if C == 1:
        out = paged_decode_fused(tq[:, 0], tkv, padded, counts,
                                 torch.from_numpy(lengths), kv_scales=tsc)
        ref = j_paged_attention_ref(jq[:, 0], *jref_args, **jscales)
        ker = j_paged_decode_fused(jq[:, 0], jkv, jpad, jcounts,
                                   jnp.asarray(lengths), interpret=True,
                                   kv_scales=jsc)
    else:
        out = paged_prefill_fused(tq, tkv, padded, counts,
                                  *_i32(lengths, start), kv_scales=tsc)
        ref = j_paged_prefill_ref(jq, *jref_args, jnp.asarray(start),
                                  **jscales)
        ker = j_paged_prefill_fused(jq, jkv, jpad, jcounts,
                                    jnp.asarray(lengths), jnp.asarray(start),
                                    interpret=True, kv_scales=jsc)
    assert out.dtype == tq.dtype
    _close(ref, out, dtype)
    _close(ker, out, dtype)
    assert float(out[-1].abs().max()) == 0.0    # empty lane outputs 0


def test_int8_scales_dequantize_before_the_math():
    """The plain version on an int8 pool equals it on the dequantized
    float32 pool (scales applied per page and kv head)."""
    B, C, H, Kv, hd, page, npg, P = 2, 4, 4, 2, 16, 4, 5, 12
    rng, _, (tq, tkv, tsc) = _int8_inputs(8, B, C, H, Kv, hd, page, P,
                                          "float32")
    lengths = np.array([13, 20], np.int32)
    start = lengths - C
    bt = _dense_table(lengths, page, npg, P, rng)
    deq = tkv.float() * tsc[:, :, None, :, None]
    args = (*_i32(bt, lengths, start),)
    got = paged_prefill_ref(tq, tkv[:, 0], tkv[:, 1], *args,
                            k_scales=tsc[:, 0], v_scales=tsc[:, 1])
    want = paged_prefill_ref(tq, deq[:, 0], deq[:, 1], *args)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_kernel_wrapper_checks_int8_inputs():
    """The wrapper's own checks of an int8 call, before it looks at the
    device: an int8 pool needs float32 (P, 2, Kv) scales, and scales mark
    an int8 pool."""
    B, C, H, Kv, hd, page, P = 1, 1, 4, 2, 16, 4, 6
    q = torch.zeros(B, C, H, hd)
    kv8 = torch.zeros(P, 2, page, Kv, hd, dtype=torch.int8)
    sc = torch.zeros(P, 2, Kv)
    t = torch.zeros(B, 2, dtype=torch.int32)
    one = torch.ones(B, dtype=torch.int32)
    with pytest.raises(ValueError, match="needs kv_scales"):
        K.paged_prefill_fwd(q, kv8, t, one, one, one)
    with pytest.raises(ValueError, match="kv_scales"):
        K.paged_prefill_fwd(q, kv8, t, one, one, one,
                            kv_scales=sc[:, :1])
    with pytest.raises(ValueError, match="kv_scales"):
        K.paged_prefill_fwd(q, kv8, t, one, one, one,
                            kv_scales=sc.double())
    with pytest.raises(ValueError, match="mark an int8 pool"):
        K.paged_prefill_fwd(q, kv8.float(), t, one, one, one, kv_scales=sc)
    with pytest.raises(ValueError, match="CUDA"):
        K.paged_prefill_fwd(q, kv8, t, one, one, one, kv_scales=sc)


def test_kernel_wrapper_rejects_cpu_tensors():
    """The CUDA wrapper never computes on the CPU: a CPU tensor is the
    ops layer's cue to take the plain version, and the wrapper refuses
    it outright."""
    q = torch.zeros(1, 1, 4, 16)
    kv = torch.zeros(4, 2, 4, 2, 16)
    t = torch.zeros(1, 2, dtype=torch.int32)
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        K.paged_prefill_fwd(q, kv, t, one, one, one)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100: "
                    "pytest -m cuda tests/test_torch_paged_attention.py)")
    for C, H, Kv, hd, page, npg, P in [(1, 8, 4, 32, 8, 6, 16),
                                       (8, 8, 4, 32, 4, 10, 24),
                                       (16, 8, 2, 16, 8, 6, 32),
                                       (5, 6, 6, 32, 16, 3, 8),
                                       (3, 16, 2, 128, 8, 8, 12),
                                       (2, 4, 4, 64, 16, 4, 8)]:
        B = 3
        rng, _, (tq, tk, tv) = _inputs(6, B, C, H, Kv, hd, page, P, dtype)
        lengths = rng.integers(C, npg * page + 1, B).astype(np.int32)
        lengths[-1] = 0
        start = np.maximum(lengths - C, 0).astype(np.int32)
        bt = _dense_table(lengths, page, npg, P, rng)
        kv = torch.stack([tk, tv], dim=1)
        ln, st, table = _i32(lengths, start, bt)
        counts = page_counts_for(ln, page)
        padded = pad_block_table(table, counts)
        ref = paged_prefill_ref(tq, tk, tv, table, ln, st)
        dev = [x.cuda() for x in (tq, kv, padded, counts, ln, st)]
        out = K.paged_prefill_fwd(*dev)
        torch.cuda.synchronize()
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   ref.float().numpy(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_kernel_matches_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100: "
                    "pytest -m cuda tests/test_torch_paged_attention.py)")
    before = K.int8_launches.n
    for C, H, Kv, hd, page, npg, P in [(1, 8, 4, 32, 8, 6, 16),
                                       (8, 8, 2, 16, 4, 10, 24),
                                       (5, 6, 6, 64, 16, 3, 8),
                                       (3, 16, 2, 128, 8, 8, 12)]:
        B = 3
        rng, _, (tq, tkv, tsc) = _int8_inputs(9, B, C, H, Kv, hd, page, P,
                                              dtype)
        lengths = rng.integers(C, npg * page + 1, B).astype(np.int32)
        lengths[-1] = 0
        start = np.maximum(lengths - C, 0).astype(np.int32)
        bt = _dense_table(lengths, page, npg, P, rng)
        ln, st, table = _i32(lengths, start, bt)
        counts = page_counts_for(ln, page)
        ref = paged_prefill_ref(tq, tkv[:, 0], tkv[:, 1], table, ln, st,
                                k_scales=tsc[:, 0], v_scales=tsc[:, 1])
        dev = [x.cuda() for x in (tq, tkv, pad_block_table(table, counts),
                                  counts, ln, st)]
        out = K.paged_prefill_fwd(*dev, kv_scales=tsc.cuda())
        torch.cuda.synchronize()
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   ref.float().numpy(), **TOL[dtype])
    assert K.int8_launches.n == before + 4


# --------------------------------------------- the tensor-core kernel --
# q and pool scales of the phase-3-like inputs below: "flat" scores of std
# 0.15 (chip_smoke.py's q*0.3 against K of std 0.5), and "sharp" ones of
# std 4, where a dropped or misplaced K tile moves an output by O(|v|)
SCORE_STD = {"flat": 0.15, "sharp": 4.0}
#: rms of an int8 pool's K after its scales: integers uniform in
#: [-127, 127] (rms 73.6) times scales uniform in [1e-3, 2e-2] (rms 0.0118)
INT8_K_RMS = 0.872


def _tc_inputs(pool, sharpness, seed=11, B=4, C=5, H=8, Kv=2, hd=32,
               page=8, npg=20, P=48):
    """Phase-3-like inputs at a small size: ragged lanes of which the last
    is empty, the others sharing two aliased prefix pages, C query tokens
    at the end of each lane (q_start = len - min(C, len)), more than two
    64-token tiles in the longest lane.  Returns numpy arrays."""
    rng = np.random.default_rng(seed)
    lengths = np.array([150, 67, 3, 0][:B], np.int32)
    q_start = (lengths - np.minimum(C, lengths)).astype(np.int32)
    bt = _dense_table(lengths, page, npg, P, rng, shared=(5, 9))
    k_rms = INT8_K_RMS if pool == "int8" else 0.5
    q = rng.standard_normal((B, C, H, hd)).astype(np.float32) \
        * (SCORE_STD[sharpness] / k_rms)
    if pool == "int8":
        kv = rng.integers(-127, 128, (P, 2, page, Kv, hd)).astype(np.int8)
        sc = rng.uniform(1e-3, 2e-2, (P, 2, Kv)).astype(np.float32)
    else:
        kv = rng.standard_normal((P, 2, page, Kv, hd)).astype(np.float32) \
            * 0.5
        sc = None
    return q, kv, sc, bt, lengths, q_start


def tc_emulation(q, kv, kv_scales, block_table, lengths, q_start,
                 tile=64):
    """The tensor-core kernel's arithmetic, for the tests only: bf16
    operands (int8 values are exact in bf16), float32 sums, 64-token tiles
    under the online softmax, the int8 K scale on each score column, the V
    scale folded into p, p rounded to bf16 for P.V while l sums it
    unrounded.  q: (B,C,H,hd) bf16 tensor; kv (P,2,page,Kv,hd) bf16 or
    int8; kv_scales (P,2,Kv) or None; block_table -1-marked."""
    B, C, H, hd = q.shape
    _, _, page, Kv, _ = kv.shape
    G = H // Kv
    scale = 1.0 / np.sqrt(hd)
    out = torch.zeros(B, C, H, hd)
    for b in range(B):
        n = int(lengths[b])
        if n == 0:
            continue
        t = torch.arange(n)
        phys = torch.as_tensor(block_table[b])[t // page].long()
        k = kv[phys, 0, t % page].float()                   # (n, Kv, hd)
        v = kv[phys, 1, t % page].float()
        ks = kv_scales[phys, 0] if kv_scales is not None \
            else torch.ones(n, Kv)                          # (n, Kv)
        vs = kv_scales[phys, 1] if kv_scales is not None \
            else torch.ones(n, Kv)
        qb = q[b].float().reshape(C, Kv, G, hd).permute(1, 0, 2, 3) \
            .reshape(Kv, C * G, hd)                         # rows (c, g)
        qpos = int(q_start[b]) + torch.arange(C).repeat_interleave(G)
        m = torch.full((Kv, C * G), -1e30)
        l_sum = torch.zeros(Kv, C * G)
        o = torch.zeros(Kv, C * G, hd)
        for t0 in range(0, n, tile):
            sl = slice(t0, min(t0 + tile, n))
            s = torch.einsum("krd,tkd->krt", qb, k[sl]) * scale \
                * ks[sl].T[:, None, :]
            mask = (t[sl][None, :] <= qpos[:, None])[None]    # (1, rows, T)
            s = torch.where(mask, s, torch.tensor(-1e30))
            m_new = torch.maximum(m, s.max(-1).values)
            p = torch.where(mask, torch.exp(s - m_new[..., None]),
                            torch.tensor(0.0))
            alpha = torch.exp(m - m_new)
            l_sum = l_sum * alpha + p.sum(-1)
            pv = (p * vs[sl].T[:, None, :]).to(torch.bfloat16).float()
            o = o * alpha[..., None] + torch.einsum("krt,tkd->krd", pv,
                                                    v[sl])
            m = m_new
        o = o / torch.where(l_sum == 0, torch.ones_like(l_sum),
                            l_sum)[..., None]
        out[b] = o.reshape(Kv, C, G, hd).permute(1, 0, 2, 3).reshape(
            C, H, hd)
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("sharpness", ["flat", "sharp"])
@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_tensor_core_arithmetic_matches_the_pallas_kernel(pool, sharpness):
    """The tensor-core kernel's rounding (bf16 operands, p rounded to bf16
    for P.V, int8 scales folded into the score columns and into p) against
    the reference's Pallas kernel in interpret mode, within the bf16 bar,
    at phase-3-like shapes on both pool types and both score scales."""
    q, kv, sc, bt, lengths, q_start = _tc_inputs(pool, sharpness)
    page = kv.shape[2]
    counts = page_counts_for(torch.from_numpy(lengths), page)
    padded = pad_block_table(torch.from_numpy(bt), counts)
    jq = jnp.asarray(q).astype(jnp.bfloat16)
    tq = torch.from_numpy(np.array(jq.astype(jnp.float32))).to(
        torch.bfloat16)
    if pool == "int8":
        jkv, tkv = jnp.asarray(kv), torch.from_numpy(kv)
    else:
        jkv = jnp.asarray(kv).astype(jnp.bfloat16)
        tkv = torch.from_numpy(np.array(jkv.astype(jnp.float32))).to(
            torch.bfloat16)
    ker = j_paged_prefill_fused(
        jq, jkv, jnp.asarray(padded.numpy()), jnp.asarray(counts.numpy()),
        jnp.asarray(lengths), jnp.asarray(q_start), interpret=True,
        kv_scales=None if sc is None else jnp.asarray(sc))
    emu = tc_emulation(tq, tkv, None if sc is None else torch.from_numpy(sc),
                       bt, lengths, q_start)
    ref = np.asarray(ker, np.float32)
    assert np.abs(ref).max() > (1.0 if sharpness == "sharp" else 0.0)
    _close(ker, emu, "bfloat16")
    assert float(emu[-1].abs().max()) == 0.0     # the empty lane


def test_sharp_inputs_catch_a_dropped_tile():
    """Dropping the first 64-token K/V tile of the longest lane (what a
    kernel with a wrong tile walk would do) moves its outputs by O(1) on
    sharp scores, far past the bf16 bar."""
    q, kv, _, bt, lengths, q_start = _tc_inputs("bf16", "sharp")
    tq = torch.from_numpy(q).to(torch.bfloat16)
    tkv = torch.from_numpy(kv).to(torch.bfloat16)
    full = tc_emulation(tq, tkv, None, bt, lengths, q_start)
    cut = tkv.clone()
    for lp in range(64 // kv.shape[2]):         # lane 0's first tile
        cut[bt[0, lp]] = 0
    dropped = tc_emulation(tq, cut, None, bt, lengths, q_start)
    assert float((full[0].float() - dropped[0].float()).abs().max()) > 0.5


@pytest.mark.parametrize("q_dtype,C,want", [
    (torch.bfloat16, 128, "tensor_cores"),   # the chunk step
    (torch.bfloat16, 5, "tensor_cores"),     # the verify step, spec_k = 4
    (torch.bfloat16, 2, "tensor_cores"),
    (torch.bfloat16, 1, "split_kv"),         # decode
    (torch.float32, 128, "fp32_cores"),      # the 1e-4 bar
    (torch.float32, 1, "split_kv"),
    (torch.float32, 5, "fp32_cores"),
])
def test_route_by_q_dtype_and_chunk(q_dtype, C, want):
    assert K.route(q_dtype, C) == want


def test_cpu_calls_count_no_kernel_launch():
    """On the CPU the ops take the plain version: no kernel counter
    moves, the tensor-core and split-KV ones included."""
    q, kv, _, bt, lengths, q_start = _tc_inputs("bf16", "flat")
    tq = torch.from_numpy(q).to(torch.bfloat16)
    tkv = torch.from_numpy(kv).to(torch.bfloat16)
    counts = page_counts_for(torch.from_numpy(lengths), kv.shape[2])
    for c in (K.launches, K.int8_launches, K.tc_launches, K.split_launches):
        c.reset()
    out = paged_prefill_fused(tq, tkv, pad_block_table(torch.from_numpy(bt),
                                                       counts),
                              counts, *_i32(lengths, q_start))
    assert out.dtype == torch.bfloat16
    out = paged_decode_fused(tq[:, 0], tkv, pad_block_table(
        torch.from_numpy(bt), counts), counts, *_i32(lengths))
    assert out.dtype == torch.bfloat16
    assert (K.launches.n, K.int8_launches.n, K.tc_launches.n,
            K.split_launches.n) == (0, 0, 0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_tensor_core_kernel_matches_plain_on_card(pool):
    """The tensor-core kernel against the plain version on the card, flat
    and sharp, at C in {2, 5, 16, 64}, every head dim, G in {1, 4, 8};
    every call must take the tensor-core kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100: "
                    "pytest -m cuda tests/test_torch_paged_attention.py)")
    from repro_torch.kernels.paged_attention import ref as R
    n = 0
    K.tc_launches.reset()
    for C, H, Kv, hd, sharp in [(5, 8, 2, 32, "flat"), (5, 8, 2, 32, "sharp"),
                                (16, 8, 1, 16, "sharp"),
                                (2, 4, 4, 64, "sharp"),
                                (64, 32, 4, 128, "flat"),
                                (64, 32, 4, 128, "sharp")]:
        q, kv, sc, bt, lengths, q_start = _tc_inputs(pool, sharp, C=C, H=H,
                                                     Kv=Kv, hd=hd)
        tq = torch.from_numpy(q).to(torch.bfloat16)
        tkv = torch.from_numpy(kv) if pool == "int8" else \
            torch.from_numpy(kv).to(torch.bfloat16)
        tsc = None if sc is None else torch.from_numpy(sc)
        ln, st, table = _i32(lengths, q_start, bt)
        counts = page_counts_for(ln, kv.shape[2])
        scales = {} if tsc is None else dict(k_scales=tsc[:, 0],
                                             v_scales=tsc[:, 1])
        ref = R.paged_prefill_ref(tq, tkv[:, 0], tkv[:, 1], table, ln, st,
                                  **scales)
        dev = [x.cuda() for x in (tq, tkv, pad_block_table(table, counts),
                                  counts, ln, st)]
        out = K.paged_prefill_fwd(
            *dev, kv_scales=None if tsc is None else tsc.cuda())
        torch.cuda.synchronize()
        n += 1
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   ref.float().numpy(), **TOL["bfloat16"])
        assert float(out[-1].abs().max()) == 0.0
    assert K.tc_launches.n == n


# ------------------------------------------------ the split-KV kernel --
def split_partials(q, kv, kv_scales, block_table, lengths, span=64,
                   round_p=False):
    """The split-KV decode kernel's arithmetic (C = 1), for the tests
    only: float32 math on the pool's values, each lane's visible tokens
    (t < len, as q_start = len - 1) cut into spans of ``span`` tokens, each
    span's own softmax giving a partial (m, l, acc) per query head: the
    int8 K scale of a token's page on its score, the V scale on its p, l
    summing p unscaled; with ``round_p`` (the kernel's bf16-q branch, on
    the tensor cores) p times the V scale is rounded to bf16 for P.V.
    q (B,H,hd); kv (P,2,page,Kv,hd); block_table -1-marked numpy.
    Returns, per lane, a list of (m, l, acc) of shapes (H,), (H,),
    (H, hd)."""
    B, H, hd = q.shape
    page, Kv = kv.shape[2], kv.shape[3]
    G = H // Kv
    scale = 1.0 / np.sqrt(hd)
    lanes = []
    for b in range(B):
        n = int(lengths[b])
        t = torch.arange(n)
        phys = torch.as_tensor(block_table[b])[t // page].long()
        k = kv[phys, 0, t % page].float()                   # (n, Kv, hd)
        v = kv[phys, 1, t % page].float()
        ones = torch.ones(n, Kv)
        ks = kv_scales[phys, 0] if kv_scales is not None else ones
        vs = kv_scales[phys, 1] if kv_scales is not None else ones
        qb = q[b].float().reshape(Kv, G, hd)
        parts = []
        for t0 in range(0, n, span):
            sl = slice(t0, min(t0 + span, n))
            s = torch.einsum("kgd,tkd->kgt", qb, k[sl]) * scale \
                * ks[sl].T[:, None, :]
            m = s.max(-1).values
            p = torch.exp(s - m[..., None])
            pv = p * vs[sl].T[:, None, :]
            if round_p:
                pv = pv.to(torch.bfloat16).float()
            acc = torch.einsum("kgt,tkd->kgd", pv, v[sl])
            parts.append((m.reshape(H), p.sum(-1).reshape(H),
                          acc.reshape(H, hd)))
        lanes.append(parts)
    return lanes


def split_combine(parts, H, hd):
    """The kernel's log-sum-exp combine of one lane's partials: m = max
    m_i, l = sum l_i e^(m_i - m), acc = sum acc_i e^(m_i - m), out = acc / l
    (0 where l is 0: an empty split has m_i = NEG_INF, l_i = 0, acc_i = 0,
    and a lane with none at all gives 0)."""
    if not parts:
        return torch.zeros(H, hd)
    m = torch.stack([p[0] for p in parts]).max(0).values
    w = [torch.exp(p[0] - m) for p in parts]
    lsum = sum(p[1] * wi for p, wi in zip(parts, w))
    acc = sum(p[2] * wi[:, None] for p, wi in zip(parts, w))
    return acc / torch.where(lsum == 0, torch.ones_like(lsum), lsum)[:, None]


def split_emulation(q, kv, kv_scales, block_table, lengths, span=64,
                    drop=None):
    """Partials per span combined per lane (p rounded to bf16 for P.V
    when q is bf16, as the kernel's tensor-core branch does); ``drop`` =
    (lane, split) leaves one partial out.  Returns (B, H, hd) float32."""
    B, H, hd = q.shape
    lanes = split_partials(q, kv, kv_scales, block_table, lengths, span,
                           round_p=q.dtype == torch.bfloat16)
    return torch.stack([
        split_combine([p for i, p in enumerate(parts) if (b, i) != drop],
                      H, hd)
        for b, parts in enumerate(lanes)])


def _decode_case(pool, q_dtype, sharpness):
    """Phase-3-like decode inputs (``_tc_inputs`` at C = 1: ragged lanes of
    150, 67, 3 and 0 tokens, two aliased prefix pages) in both frameworks,
    with the reference's fused decode kernel (Pallas, interpret mode) on
    them.  The pool is int8 with scales or in q's type."""
    q, kv, sc, bt, lengths, _ = _tc_inputs(
        "int8" if pool == "int8" else "bf16", sharpness, C=1)
    jdt = jnp.dtype(q_dtype)
    jq = jnp.asarray(q[:, 0]).astype(jdt)
    tq = torch.from_numpy(np.array(jq.astype(jnp.float32))).to(
        getattr(torch, q_dtype))
    if pool == "int8":
        jkv, tkv = jnp.asarray(kv), torch.from_numpy(kv)
    else:
        jkv = jnp.asarray(kv).astype(jdt)
        tkv = torch.from_numpy(np.array(jkv.astype(jnp.float32))).to(
            getattr(torch, q_dtype))
    counts = page_counts_for(torch.from_numpy(lengths), kv.shape[2])
    padded = pad_block_table(torch.from_numpy(bt), counts)
    ker = j_paged_decode_fused(
        jq, jkv, jnp.asarray(padded.numpy()), jnp.asarray(counts.numpy()),
        jnp.asarray(lengths), interpret=True,
        kv_scales=None if sc is None else jnp.asarray(sc))
    tsc = None if sc is None else torch.from_numpy(sc)
    return tq, tkv, tsc, bt, lengths, np.asarray(ker, np.float32)


@pytest.mark.parametrize("span", [8, 32, 64, 128, 256])
@pytest.mark.parametrize("sharpness", ["flat", "sharp"])
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pool", ["same", "int8"])
def test_split_kv_arithmetic_matches_the_pallas_decode(pool, q_dtype,
                                                       sharpness, span):
    """Partials per span combined by log-sum-exp (the split-KV kernel's
    arithmetic) against the reference's fused decode kernel in interpret
    mode, on a pool in q's type and on an int8 pool, flat and sharp, with
    spans of one page (8 tokens), of the kernel's 32 (float32 q) and 128
    (bf16 q), 64, and of more tokens than the longest lane holds (256 >
    150),
    an empty lane and aliased prefix pages; bars 1e-4 (float32 q) and 2e-2
    (bf16 q)."""
    tq, tkv, tsc, bt, lengths, ref = _decode_case(pool, q_dtype, sharpness)
    emu = split_emulation(tq, tkv, tsc, bt, lengths, span=span)
    if sharpness == "sharp":
        assert np.abs(ref).max() > 1.0
    _close(ref, emu.to(tq.dtype), q_dtype)
    assert float(emu[-1].abs().max()) == 0.0     # the empty lane


def test_sharp_inputs_catch_a_dropped_split():
    """Leaving out one split's partial of the longest lane (what a wrong
    ticket count or split walk would do) moves its outputs far past the
    bf16 bar on sharp scores."""
    tq, tkv, _, bt, lengths, _ = _decode_case("same", "bfloat16", "sharp")
    full = split_emulation(tq, tkv, None, bt, lengths)
    dropped = split_emulation(tq, tkv, None, bt, lengths, drop=(0, 0))
    assert float((full[0] - dropped[0]).abs().max()) > 0.5
    torch.testing.assert_close(full[1:], dropped[1:], rtol=0, atol=0)


def test_split_combine_of_empty_splits_is_zero_not_nan():
    """Splits that saw nothing carry (NEG_INF, 0, 0): beside a live split
    they weigh 0, and a lane with only such splits gives 0, not NaN."""
    H, hd = 2, 4
    empty = (torch.full((H,), -1e30), torch.zeros(H), torch.zeros(H, hd))
    live = (torch.tensor([0.5, -1.0]), torch.tensor([2.0, 4.0]),
            torch.arange(H * hd, dtype=torch.float32).reshape(H, hd))
    torch.testing.assert_close(split_combine([empty, live, empty], H, hd),
                               live[2] / live[1][:, None])
    out = split_combine([empty, empty], H, hd)
    assert torch.isfinite(out).all() and not out.any()


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pool", ["same", "int8"])
def test_split_kv_kernel_matches_plain_on_card(pool, q_dtype):
    """The split-KV decode kernel against the plain version on the card,
    flat and sharp, every head dim, G in {1, 2, 4, 8, 32} (32: more heads
    than one block takes), on a pool in q's type
    and on an int8 pool; lanes of 150, 67, 3 and 0 tokens (3, 2, 1 and no
    splits) with aliased prefix pages; every call must take the split-KV
    kernel, and twice in a row (its tickets go back to 0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100: "
                    "pytest -m cuda tests/test_torch_paged_attention.py)")
    from repro_torch.kernels.paged_attention import ref as R
    dtype = getattr(torch, q_dtype)
    n = 0
    K.split_launches.reset()
    for H, Kv, hd, sharp in [(4, 4, 16, "flat"), (8, 2, 32, "sharp"),
                             (8, 1, 64, "flat"), (16, 2, 64, "sharp"),
                             (32, 4, 128, "flat"), (32, 4, 128, "sharp"),
                             (8, 8, 128, "sharp"), (16, 4, 16, "sharp"),
                             (32, 1, 64, "sharp")]:
        q, kv, sc, bt, lengths, _ = _tc_inputs(
            "int8" if pool == "int8" else "bf16", sharp, C=1, H=H, Kv=Kv,
            hd=hd)
        tq = torch.from_numpy(q[:, 0]).to(dtype)
        tkv = torch.from_numpy(kv) if pool == "int8" else \
            torch.from_numpy(kv).to(dtype)
        tsc = None if sc is None else torch.from_numpy(sc)
        ln, table = _i32(lengths, bt)
        counts = page_counts_for(ln, kv.shape[2])
        scales = {} if tsc is None else dict(k_scales=tsc[:, 0],
                                             v_scales=tsc[:, 1])
        ref = R.paged_prefill_ref(tq[:, None], tkv[:, 0], tkv[:, 1], table,
                                  ln, ln - 1, **scales)[:, 0]
        dev = [x.cuda() for x in (tq, tkv, pad_block_table(table, counts),
                                  counts, ln)]
        for _ in range(2):
            out = K.paged_decode_fwd(
                *dev, kv_scales=None if tsc is None else tsc.cuda())
            torch.cuda.synchronize()
            n += 1
            np.testing.assert_allclose(out.float().cpu().numpy(),
                                       ref.float().numpy(), **TOL[q_dtype])
            assert float(out[-1].abs().max()) == 0.0
    assert K.split_launches.n == n
