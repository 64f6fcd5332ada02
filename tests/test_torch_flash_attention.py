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
    for c in (K.launches, ops.plain_forwards, ops.backward_recomputes):
        c.reset()
    q.requires_grad_(True)
    flash_attention(q, k, v).sum().backward()
    assert (K.launches.n, ops.plain_forwards.n,
            ops.backward_recomputes.n) == (0, 1, 1)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        K.flash_attention_fwd(q.detach(), k, v)
    with pytest.raises(TypeError, match="float32"):
        flash_attention(q.double(), k.double(), v.double())


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """The hand-written kernel against its plain version on the card:
    every head dim, both types, the five masks, GQA, partial tiles, at
    test_kernels' scale and at ``SHARP``, and the autograd gradients
    against plain autograd."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine: "
                    "pytest -m cuda tests/test_torch_flash_attention.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    for d in K.HEAD_DIMS:
        for (BH, S, T, G), qk in itertools.product(
                ((2, 128, 128, 1), (8, 100, 37, 4), (4, 200, 260, 2)),
                (0.3, SHARP)):
            arrs = _qkv(BH, S, T, d, kv_rows=BH // G, qk=qk)
            for dtype in ("float32", "bfloat16"):
                q, k, v = (t.cuda() for t in _port(arrs, dtype))
                for causal, window, cap in MASKS:
                    before = K.launches.n
                    out = flash_attention(q, k, v, causal, window, cap, G)
                    torch.cuda.synchronize()
                    assert K.launches.n == before + 1
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


#: deliberately broken copies of the kernel, made from its source at test
#: time: (text replaced, replacement), each found exactly once
MUTANTS = {
    "no_cap": ("        if (cap != 0.f) x = cap * tanhf(x / cap);\n", ""),
    "late_rows_skip_a_key_tile": (
        "  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {\n",
        "  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {\n"
        "    if (q0 >= 2048 && k0 == k_lo + kBK) continue;\n"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("mutant", sorted(MUTANTS))
def test_sharp_inputs_catch_a_broken_kernel(mutant, tmp_path, monkeypatch):
    """At gemma2-2b's geometry (16 flat heads over 8 KV rows, S=T=4096,
    hd 256, bf16, causal, cap 50) a kernel built without the cap, or one
    that skips a key tile for rows past 2,048, fails the bf16 tolerance
    on the sharp inputs; the kernel as built passes them.  The errors at
    both scales are printed (``-s``)."""
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
    BH, S, d, G = 16, 4096, 256, 2
    errs = {}
    for qk in (0.3, SHARP):
        q, k, v = (t.cuda() for t in _port(
            _qkv(BH, S, S, d, seed=7, kv_rows=BH // G, qk=qk), "bfloat16"))
        ref = flash_attention_ref(q, k.repeat_interleave(G, 0),
                                  v.repeat_interleave(G, 0), cap=50.0)
        good = K.flash_attention_fwd(q, k, v, cap=50.0, groups=G)
        with monkeypatch.context() as mp:
            mp.setattr(K, "_library", lambda: broken)
            bad = K.flash_attention_fwd(q, k, v, cap=50.0, groups=G)
        for name, out in (("kernel", good), (mutant, bad)):
            errs[name, qk] = (out.float() - ref.float()).abs().max().item()
            errs[name, qk, "passes"] = torch.allclose(
                out.float(), ref.float(), **TOL["bfloat16"])
        del q, k, v, ref, good, bad
    print(f"\nflash mutant {mutant}: " + " ".join(
        f"{n}@qk={qk}: max_abs_err={errs[n, qk]:.4g} "
        f"passes={errs[n, qk, 'passes']}"
        for n in ("kernel", mutant) for qk in (0.3, SHARP)), flush=True)
    assert errs["kernel", SHARP, "passes"]
    assert not errs[mutant, SHARP, "passes"]
