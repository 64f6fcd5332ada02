"""The port's paged-attention ops against the JAX reference.

On the CPU the port's ops run the plain version (``repro_torch``'s
``ref.py``); it is held against the reference's Pallas kernel in interpret
mode and against its jnp oracle, on the same inputs made with numpy.  The
CUDA kernel itself is held against the plain version by the ``cuda``-marked
test here (it skips without a card) and by ``chip_smoke.py`` phase 3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import (
    paged_attention as j_paged_attention,
    paged_attention_ref as j_paged_attention_ref,
    paged_prefill as j_paged_prefill,
    paged_prefill_fused as j_paged_prefill_fused,
    paged_prefill_ref as j_paged_prefill_ref,
    pad_block_table as j_pad_block_table,
    page_counts_for as j_page_counts_for,
)
from repro_torch.kernels.paged_attention import (
    mask_block_table, paged_attention, paged_prefill, paged_prefill_fused,
    pad_block_table, page_counts_for, paged_prefill_ref,
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
