"""The port's recurrent blocks (``repro_torch.models.ssm``) and the two
recurrent families' training path against the live JAX package, on the
CPU.

Same parameters (the reference's ``build_mlstm`` / ``build_slstm`` /
``build_mamba``, or ``init_params`` carried by ``params_from_jax``) and
same numpy-seeded inputs on both sides, at the smoke configs of
xlstm-350m and hymba-1.5b:

* every primitive against its JAX twin: ``mlstm_fullseq`` (one chunk,
  several, and a chunk the largest-divisor rule shrinks), ``mlstm_decode``
  over a sequence, ``slstm_fullseq`` / ``slstm_decode``, ``mamba_fullseq``
  (also over several of its step blocks) / ``mamba_decode``; float32
  within 1e-5 of the largest |value|, bfloat16 within 2e-2;
* the port's chunkwise mLSTM against its own per-token
  ``mlstm_reference`` (the reference's own test: 2e-3);
* the state specs' shapes and types;
* ``loss_fn`` (through ``forward_fullseq``) and every gradient, at the
  bars of ``tests/test_torch_train.py`` on the loss and on bfloat16
  gradients (against the reference's bfloat16 gradient), save where the
  reference's own error sets a bar (:data:`GRAD_BAR_F32`,
  :data:`GRAD_BAR_BF16_ILL`): the recurrent families' gradients are far
  worse conditioned than a transformer's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as JM
from repro.models import ssm as JS
from repro.parallel.sharding import ParamFactory
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models import ssm as S
from repro_torch.models.model import _to_tensor

ARCHS = ["xlstm-350m", "hymba-1.5b"]
DTYPES = ["float32", "bfloat16"]
BAR = {"float32": 1e-5, "bfloat16": 2e-2}
BUILD = {"mlstm": ("xlstm-350m", JS.build_mlstm),
         "slstm": ("xlstm-350m", JS.build_slstm),
         "mamba": ("hymba-1.5b", JS.build_mamba)}


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(j_get_config(arch).smoke(),
                                param_dtype=dtype),
            dataclasses.replace(get_config(arch).smoke(), param_dtype=dtype))


@functools.lru_cache(maxsize=None)
def _cell(kind, dtype):
    """(jax cfg, port cfg, jax params, port params) of one block."""
    arch, build = BUILD[kind]
    jcfg, tcfg = _cfgs(arch, dtype)
    jp = build(ParamFactory("init", jnp.dtype(dtype),
                            jax.random.PRNGKey(7)), jcfg)
    tp = {k: _to_tensor(np.asarray(v)) for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


def _x(cfg, dtype, B=2, S_=24, seed=0):
    x = np.random.default_rng(seed).standard_normal(
        (B, S_, cfg.d_model)).astype(np.float32) * 0.5
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))


def _np(t):
    return (t.detach().float().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t, np.float32))


def _close(got, want, dtype, what=""):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=BAR[dtype] * np.abs(want).max(),
                               err_msg=what)


def _states_close(got, want, dtype):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        _close(got[k], want[k], dtype, k)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seq,chunk", [(24, 256), (32, 8), (30, 8)])
def test_mlstm_fullseq_matches_jax(dtype, seq, chunk):
    """One chunk; four chunks of 8; S=30 with chunk 8, which the
    largest-divisor rule shrinks to 6."""
    jcfg, tcfg, jp, tp = _cell("mlstm", dtype)
    jx, tx = _x(jcfg, dtype, S_=seq)
    want = JS.mlstm_fullseq(jcfg, jp, jx, chunk=chunk)
    got = S.mlstm_fullseq(tcfg, tp, tx, chunk=chunk)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want, dtype)


def _decode_seq(jfn, tfn, jcfg, tcfg, jp, tp, jx, tx, jstate, tstate):
    outs = []
    for t in range(jx.shape[1]):
        jo, jstate = jfn(jcfg, jp, jx[:, t:t + 1], jstate)
        to, tstate = tfn(tcfg, tp, tx[:, t:t + 1], tstate)
        outs.append((jo, to))
    return outs, jstate, tstate


@pytest.mark.parametrize("kind", ["mlstm", "slstm", "mamba"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_over_a_sequence_matches_jax(kind, dtype):
    """Each step's output and the final state; the conv state of Mamba
    passes through the activations' type on both sides."""
    jcfg, tcfg, jp, tp = _cell(kind, dtype)
    jx, tx = _x(jcfg, dtype, S_=12, seed=1)
    specs = getattr(S, f"{kind}_state_specs")(tcfg, 2)
    jstate = {k: jnp.zeros(s, dt) for k, (s, dt, _) in
              getattr(JS, f"{kind}_state_specs")(jcfg, 2).items()}
    outs, jstate, tstate = _decode_seq(
        getattr(JS, f"{kind}_decode"), getattr(S, f"{kind}_decode"),
        jcfg, tcfg, jp, tp, jx, tx, jstate, S.zero_state(specs))
    for jo, to in outs:
        assert to.dtype == tx.dtype and to.shape == (2, 1, tcfg.d_model)
        _close(to, jo, dtype)
    _states_close(tstate, jstate, dtype)


@pytest.mark.parametrize("kind", ["slstm", "mamba"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_fullseq_matches_jax(kind, dtype, monkeypatch):
    """sLSTM's and Mamba's time loops; Mamba at S=40 over blocks of 16
    steps (its step-independent factors are formed a block at a time)."""
    jcfg, tcfg, jp, tp = _cell(kind, dtype)
    jx, tx = _x(jcfg, dtype, S_=40, seed=2)
    if kind == "mamba":
        monkeypatch.setattr(S, "MAMBA_BLOCK", 16)
    want = getattr(JS, f"{kind}_fullseq")(jcfg, jp, jx)
    got = getattr(S, f"{kind}_fullseq")(tcfg, tp, tx)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want, dtype)


def test_mlstm_chunkwise_matches_own_reference():
    _, tcfg, _, tp = _cell("mlstm", "float32")
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 64, tcfg.d_model)).astype(np.float32) * 0.5)
    np.testing.assert_allclose(
        S.mlstm_fullseq(tcfg, tp, x, chunk=16).numpy(),
        S.mlstm_reference(tcfg, tp, x).numpy(), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_state_specs_and_dims_match_jax(arch):
    for j, t in ((j_get_config(arch), get_config(arch)),
                 (j_get_config(arch).smoke(), get_config(arch).smoke())):
        assert S.mamba_dims(t) == JS.mamba_dims(j)
        for kind in ("mlstm", "slstm", "mamba"):
            want = getattr(JS, f"{kind}_state_specs")(j, 3)
            got = getattr(S, f"{kind}_state_specs")(t, 3)
            assert {k: (s, jnp.dtype(dt).name) for k, (s, dt, _)
                    in want.items()} == \
                {k: (s, str(dt).replace("torch.", ""))
                 for k, (s, dt) in got.items()}


# ---------------------------------------------------------------------------
# the families' training path
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _np_params(arch, dtype):
    jcfg, _ = _cfgs(arch, dtype)
    return jax.tree.map(np.asarray, JM.init_params(
        jcfg, jax.random.PRNGKey(0)))


def _batch(vocab, B=2, S_=32, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, vocab, (B, S_ + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


#: float32 gradient bars, of a leaf's largest |g|.  Both packages' float32
#: gradients stand off a float64 evaluation of the same model (the port's
#: code in float64, same weights and batch; ``scripts/float64_check.py
#: --parts grads``): hymba's Mamba leaves by up to 9.3e-6 (the reference)
#: and 9.3e-6 (the port), in opposite directions, so 1.4e-5 apart;
#: xlstm's by up to 2.7e-4 (the reference) and 6.6e-5 (the port), the
#: reference's jitted and eager gradients 9.5e-5 apart.  The bars sit
#: above those spreads; every other family's float32 bar is
#: ``test_torch_train``'s 1e-5.
GRAD_BAR_F32 = {"hymba-1.5b": 2e-5, "xlstm-350m": 4e-4}
#: bfloat16: each gradient against the reference's bfloat16 gradient at
#: the same weights, within ``test_torch_train``'s 6e-2 of the leaf's
#: largest |g|
GRAD_BAR_BF16 = 6e-2
#: ... except xlstm's ill-conditioned leaves: those whose bfloat16
#: gradient in the reference itself stands ``ILL_OWN`` or more (of the
#: largest |g|) off its float32 one (31 of xlstm's 36 leaves, 0.10-1.89;
#: hymba's worst is 0.16 and its leaves all hold 6e-2).  Nudging the
#: embedding table by one bfloat16 ulp moves the reference's own bfloat16
#: gradient of these leaves by 0.31-2.8 (``scripts/float64_check.py
#: --parts bf16``): a change of one rounding's size moves them that far,
#: so two evaluations that round differently need not agree to 6e-2
#: there; the port stands 0.03-0.19 off the reference.
#: :data:`GRAD_BAR_BF16_ILL` still fails a gradient halved (0.5) or of
#: the wrong sign (1 or more)
ILL_OWN, GRAD_BAR_BF16_ILL = 0.1, {"xlstm-350m": 0.25}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_loss_and_grads_match_jax(arch, dtype):
    """Loss and every gradient: the loss at ``test_torch_train``'s bars
    (float32 1e-5 relative, bfloat16 2e-3); a float32 gradient within
    :data:`GRAD_BAR_F32` of its leaf's largest |g|; a bfloat16 gradient
    within :data:`GRAD_BAR_BF16` of the reference's bfloat16 gradient
    (:data:`GRAD_BAR_BF16_ILL` on xlstm's ill-conditioned leaves)."""
    jcfg, tcfg = _cfgs(arch, dtype)
    npp = _np_params(arch, dtype)
    batch = _batch(jcfg.vocab_size)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    f32 = dtype == "float32"

    jloss, jgrads = jax.value_and_grad(lambda p: JM.loss_fn(jcfg, p, jb))(
        jax.tree.map(jnp.asarray, npp))
    model = M.params_from_jax(tcfg, npp, device="cpu").requires_grad_(True)
    loss = M.loss_fn(tcfg, model, tb)
    loss.backward()
    assert loss.dtype == torch.float32
    assert abs(float(loss.detach()) - float(jloss)) / abs(float(jloss)) < \
        (1e-5 if f32 else 2e-3)
    if not f32:
        g32 = jax.grad(lambda p: JM.loss_fn(
            dataclasses.replace(jcfg, param_dtype="float32"), p, jb))(
            jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), npp))
    for path in M.param_shapes(tcfg):
        g = model.param(path).grad
        ref = _np(M.reference_leaf(jgrads, path))
        assert g is not None and g.dtype == model.param(path).dtype, path
        if f32:
            np.testing.assert_allclose(
                _np(g), ref, rtol=0,
                atol=GRAD_BAR_F32[arch] * np.abs(ref).max(), err_msg=path)
            continue
        ref32 = _np(M.reference_leaf(g32, path))
        own = np.abs(ref - ref32).max() / np.abs(ref32).max()
        err = np.abs(_np(g) - ref).max() / np.abs(ref).max()
        bar = GRAD_BAR_BF16_ILL[arch] if own >= ILL_OWN and \
            arch in GRAD_BAR_BF16_ILL else GRAD_BAR_BF16
        assert err <= bar, (path, err, own)
