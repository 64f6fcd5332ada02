"""The port's decode API (``init_cache``, ``decode_forward``,
``prefill_logits``, the prefill/decode steps, ``make_batch``) and the
quickstart launcher against the live JAX package, on the CPU.

Float32 smoke configs of every family the port registers, the same
weights on both sides (``params_from_jax``) and the same numpy-seeded
tokens:

* ``param_shapes`` against the reference's parameter tree for the
  recurrent families and deepseek-v2's MLA and ``first_layers`` (every
  leaf, its shape and type), and the reference's constant inits and
  fan-ins in ``init_params``;
* ``init_cache`` shapes, types and fill against the reference's;
* ``decode_forward`` step by step at T = 24 (hymba's and gemma2's
  16-slot rings wrap; whisper's cross caches filled by each side's
  ``encdec_cross_cache`` from the same frames; pixtral's first
  ``frontend_seq`` positions fed as ``inputs_embeds``): each step's
  logits within 1e-5 of the largest |logit|, every cache leaf within
  1e-5 of its largest |value| (int32 positions equal);
* ``prefill_logits`` within 1e-5 of the largest |logit| (with the same
  frames for an arch with a frontend);
* (``tests/test_torch_decode_bf16.py``) the same step-by-step decode in
  bfloat16;
* ``input_specs`` / ``make_batch`` against the reference's specs;
* ``python -m repro_torch.launch.quickstart --device cpu``.
"""
import contextlib
import dataclasses
import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import smoke_shape as j_smoke_shape
from repro.models import model as JM
from repro.models import steps as JST
from repro_torch.configs import SHAPES, get_config, list_archs, smoke_shape
from repro_torch.launch import quickstart
from repro_torch.models import model as M
from repro_torch.models import steps as ST

ARCHS = ["xlstm-350m", "hymba-1.5b", "gemma2-2b", "yi-6b", "qwen3-32b",
         "minitron-8b", "olmoe-1b-7b", "whisper-medium", "pixtral-12b",
         "deepseek-v2-236b"]
BAR = 1e-5
B, T = 2, 24


def _cfgs(arch):
    return (dataclasses.replace(j_get_config(arch).smoke(),
                                param_dtype="float32"),
            dataclasses.replace(get_config(arch).smoke(),
                                param_dtype="float32"))


@functools.lru_cache(maxsize=None)
def _np_params(arch, dtype="float32"):
    jcfg = dataclasses.replace(_cfgs(arch)[0], param_dtype=dtype)
    return jax.tree.map(np.asarray, JM.init_params(
        jcfg, jax.random.PRNGKey(0)))


def _tokens(vocab, seed=0):
    return np.random.default_rng(seed).integers(
        0, vocab, (B, T)).astype(np.int32)


def _frontend(cfg, seed=2):
    """Stub frontend embeddings (B, frontend_seq, d) at the data
    pipeline's scale, float32 (each side casts them to its weights'
    type), or None for an arch without a frontend."""
    if not cfg.frontend:
        return None
    return (np.random.default_rng(seed).standard_normal(
        (B, cfg.frontend_seq, cfg.d_model)) * 0.02).astype(np.float32)


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _port_leaves(cache):
    return {jax.tree_util.keystr(k): v.detach() for k, v in
            _leaves(M.stack_cache(cache))}


def test_every_family_is_registered():
    assert set(ARCHS) == set(list_archs())


@pytest.mark.parametrize("arch", ["xlstm-350m", "hymba-1.5b",
                                  "deepseek-v2-236b"])
def test_param_shapes_cover_reference_leaves(arch):
    """Every leaf of the reference's tree, full size and smoke, in
    float32 and bfloat16: the port's paths cover it exactly, each with
    its shape (a layer's slice of a stacked leaf) and type."""
    for j, t in ((j_get_config(arch), get_config(arch)),
                 (j_get_config(arch).smoke(), get_config(arch).smoke())):
        for dtype in ("float32", "bfloat16"):
            j = dataclasses.replace(j, param_dtype=dtype)
            t = dataclasses.replace(t, param_dtype=dtype)
            specs = JM.param_specs(j)
            shapes = M.param_shapes(t)
            model = M.DenseDecoder(t, torch.device("meta"))
            groups = M.reference_groups(t)
            assert len(groups) == len(jax.tree.leaves(specs))
            for paths in groups:
                keys, layer = M._reference_path(paths[0])
                leaf = specs
                for k in keys:
                    leaf = leaf[k]
                want = leaf.shape if layer is None else leaf.shape[1:]
                assert len(paths) == (1 if layer is None else leaf.shape[0])
                for path in paths:
                    assert shapes[path] == want, path
                    assert str(model.param(path).dtype).replace(
                        "torch.", "") == jnp.dtype(leaf.dtype).name, path


@pytest.mark.parametrize("arch", ["xlstm-350m", "hymba-1.5b",
                                  "deepseek-v2-236b"])
def test_init_params_constants_and_fan_in(arch):
    cfg = get_config(arch).smoke()
    model = M.init_params(cfg, seed=0, device="cpu")
    for path, shape in M.param_shapes(cfg).items():
        p = model.param(path).float()
        const = M._const_init(path)
        if const is not None:
            assert bool((p == const).all()), path
        elif p.numel() >= 256:
            fan = M._fan_in(cfg, path, shape)
            assert abs(float(p.std()) * fan ** 0.5 - 1.0) < 0.15, path
    assert M._fan_in(cfg, "slstm_layers/0/cell/r", (4, 4, 16, 16)) == 16


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    for dtype in ("float32", "bfloat16"):
        j = dataclasses.replace(jcfg, param_dtype=dtype)
        t = dataclasses.replace(tcfg, param_dtype=dtype)
        want = {jax.tree_util.keystr(k): v for k, v in
                _leaves(JM.init_cache(j, B, T))}
        got = {jax.tree_util.keystr(k): v for k, v in
               _leaves(M.stack_cache(M.init_cache(t, B, T, "cpu")))}
        assert set(got) == set(want)
        for k, v in want.items():
            assert tuple(got[k].shape) == v.shape, k
            assert str(got[k].dtype).replace("torch.", "") == \
                jnp.dtype(v.dtype).name, k
            np.testing.assert_array_equal(got[k].float().numpy(),
                                          np.asarray(v, np.float32))


class _FollowReferenceRouting:
    """While active, each MoE call of the port routes its rows to the
    experts the reference's matching call chose (its ``lax.top_k``,
    recorded as the reference runs op by op; the reference steps first),
    with gates from the port's own router logits at those experts.  A row
    whose own top-k differs must be a near-tie: the port's own k-th
    largest logit at most :data:`ROUTE_TIE` x the row's largest |logit|
    above the forced experts' smallest.  ``flips`` counts those rows."""

    def __enter__(self):
        from repro_torch.models import moe as TMOE
        self._tmoe, self._t_real = TMOE, TMOE._route
        self._j_real = jax.lax.top_k
        self.queue, self.flips, self.rows = [], 0, 0

        def j_spy(x, k):
            vals, idx = self._j_real(x, k)
            self.queue.append(np.asarray(idx).reshape(-1, k))
            return vals, idx

        def t_spy(cfg, router, xf):
            vals, idx = self._t_real(cfg, router, xf)
            forced = torch.from_numpy(np.array(self.queue.pop(0))).long()
            logits = xf.float() @ router
            chosen = logits.gather(1, forced)
            for r in range(idx.shape[0]):
                self.rows += 1
                if set(idx[r].tolist()) == set(forced[r].tolist()):
                    continue
                self.flips += 1
                gap = float(vals[r, -1] - chosen[r].min())
                assert gap <= ROUTE_TIE * float(logits[r].abs().max()), \
                    (r, idx[r].tolist(), forced[r].tolist(), gap)
            return chosen, forced

        jax.lax.top_k, TMOE._route = j_spy, t_spy
        return self

    def __exit__(self, *exc):
        jax.lax.top_k, self._tmoe._route = self._j_real, self._t_real


#: a routing near-tie, of the row's largest |router logit|: bf16 inputs
#: (8 bits of mantissa, ~4e-3 relative) that differ by an ulp move a
#: logit of the router's product by a few 1e-3 of the largest
ROUTE_TIE = 2e-2


def _decode_lockstep(arch, dtype, bar, eager=False, follow=False):
    """The reference's and the port's ``decode_forward`` over the same T
    tokens from empty caches: each step's logits within ``bar`` of the
    largest |logit|, every cache leaf within ``bar`` of its largest
    |value| (int32 positions equal).  ``eager`` runs the reference op by
    op (``jax.disable_jit``), rounding after every operation as the
    port does.  ``follow`` (with ``eager``) routes the port's MoE rows to
    the reference's experts (:class:`_FollowReferenceRouting`).  Returns
    the routing flips so excused (0 without ``follow``)."""
    jcfg, tcfg = (dataclasses.replace(c, param_dtype=dtype)
                  for c in _cfgs(arch))
    npp = _np_params(arch, dtype)
    toks = _tokens(jcfg.vocab_size)
    jparams = jax.tree.map(jnp.asarray, npp)
    model = M.params_from_jax(tcfg, npp, device="cpu")

    def jstep(p, c, t, pos, embeds):
        return JM.decode_forward(jcfg, p, c, t, pos, inputs_embeds=embeds)
    step = jstep if eager else jax.jit(jstep)
    jc = JM.init_cache(jcfg, B, T)
    tc = M.init_cache(tcfg, B, T, "cpu")
    frames = _frontend(jcfg)
    if jcfg.block_kind == "encdec":
        with jax.disable_jit(eager):
            jc["xk"], jc["xv"] = JM.encdec_cross_cache(
                jcfg, jparams, jnp.asarray(frames))
        with torch.no_grad():
            tc["xk"], tc["xv"] = M.encdec_cross_cache(
                tcfg, model, torch.from_numpy(frames))
    assert eager or not follow, "the reference's routing is read op by op"
    routes = _FollowReferenceRouting() if follow else None
    with routes or contextlib.nullcontext():
        for t in range(T):
            pos = np.full((B,), t, np.int32)
            embeds = frames[:, t:t + 1] if jcfg.frontend == "patch" and \
                t < jcfg.frontend_seq else None
            with jax.disable_jit(eager):
                jl, jc = step(jparams, jc, jnp.asarray(toks[:, t:t + 1]),
                              jnp.asarray(pos),
                              None if embeds is None else jnp.asarray(embeds))
            tl, tc = M.decode_forward(
                tcfg, model, tc, torch.from_numpy(toks[:, t:t + 1]),
                torch.from_numpy(pos),
                inputs_embeds=None if embeds is None
                else torch.from_numpy(embeds))
            jl = np.asarray(jl, np.float32)
            assert tl.dtype == torch.float32 and tl.shape == jl.shape
            np.testing.assert_allclose(tl.numpy(), jl, rtol=0,
                                       atol=bar * np.abs(jl).max(),
                                       err_msg=f"step {t}")
            got = _port_leaves(tc)
            for k, v in _leaves(jc):
                k, v = jax.tree_util.keystr(k), np.asarray(v)
                assert str(got[k].dtype).replace("torch.", "") == \
                    jnp.dtype(v.dtype).name, k
                if v.dtype == np.int32:
                    np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
                else:
                    v = v.astype(np.float32)
                    np.testing.assert_allclose(
                        got[k].float().numpy(), v, rtol=0,
                        atol=bar * max(np.abs(v).max(), 1e-30),
                        err_msg=f"step {t} {k}")
    if jcfg.sliding_window:
        W = jcfg.sliding_window
        kpos = tc["kpos_local" if jcfg.local_global_period else "kpos"]
        assert W < T and int(kpos.max()) == T - 1 and \
            int(kpos.min()) == T - W       # the ring wrapped
    if not follow:
        return 0
    assert not routes.queue and routes.rows == T * B * sum(
        "moe" in lp for lp in M._tf_layers(model))
    return routes.flips


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_forward_matches_jax_step_by_step(arch):
    _decode_lockstep(arch, "float32", BAR)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    npp = _np_params(arch)
    toks = _tokens(jcfg.vocab_size, seed=1)
    batch = {"tokens": toks}
    if jcfg.frontend:
        batch["frontend"] = _frontend(jcfg, seed=3)
    want = np.asarray(JM.prefill_logits(
        jcfg, jax.tree.map(jnp.asarray, npp),
        {k: jnp.asarray(v) for k, v in batch.items()}))
    model = M.params_from_jax(tcfg, npp, device="cpu")
    step = ST.make_prefill_step(tcfg)
    got = step(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.dtype == torch.float32 and got.shape == want.shape == \
        (B, 1, tcfg.vocab_size)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=BAR * np.abs(want).max())


def test_decode_step_is_decode_forward():
    _, tcfg = _cfgs("hymba-1.5b")
    model = M.params_from_jax(tcfg, _np_params("hymba-1.5b"), device="cpu")
    batch = ST.make_batch(tcfg, smoke_shape("decode"),
                          torch.Generator().manual_seed(0))
    a, ca = ST.make_decode_step(tcfg)(model, M.init_cache(tcfg, 2, 32,
                                                          "cpu"), batch)
    b, cb = M.decode_forward(tcfg, model, M.init_cache(tcfg, 2, 32, "cpu"),
                             batch["tokens"], batch["pos"])
    assert torch.equal(a, b)
    assert int(ca["kpos"][0, 31 % tcfg.sliding_window]) == 31


@pytest.mark.parametrize("shape", ["smoke_train", "smoke_prefill",
                                   "smoke_decode", "decode_32k"])
def test_make_batch_matches_reference_specs(shape):
    cfg = get_config("hymba-1.5b").smoke()
    jcfg = j_get_config("hymba-1.5b").smoke()
    if shape.startswith("smoke_"):
        tshape = smoke_shape(shape[6:])
        jshape = j_smoke_shape(shape[6:])
    else:
        tshape, jshape = SHAPES[shape], J_SHAPES[shape]
    want = JST.input_specs(jcfg, jshape)
    specs = ST.input_specs(cfg, tshape)
    assert {k: (s, str(dt).replace("torch.", "")) for k, (s, dt)
            in specs.items()} == {k: (v.shape, jnp.dtype(v.dtype).name)
                                  for k, v in want.items()}
    gen = torch.Generator().manual_seed(0)
    batch = ST.make_batch(cfg, tshape, gen)
    ref = JST.make_batch(jcfg, jshape, jax.random.PRNGKey(0))
    assert set(batch) == set(ref)
    for k, v in batch.items():
        assert tuple(v.shape) == ref[k].shape
        assert str(v.dtype).replace("torch.", "") == \
            jnp.dtype(ref[k].dtype).name
    if "pos" in batch:
        assert bool((batch["pos"] == tshape.seq_len - 1).all())
        np.testing.assert_array_equal(batch["pos"].numpy(),
                                      np.asarray(ref["pos"]))
    assert 0 <= int(batch["tokens"].min()) and \
        int(batch["tokens"].max()) < cfg.vocab_size
    again = ST.make_batch(cfg, tshape, torch.Generator().manual_seed(0))
    assert all(torch.equal(batch[k], again[k]) for k in batch)


def test_decode_api_refuses_what_is_not_ported():
    """``inputs_embeds``, the encoder-decoder layout, a patch frontend and
    MLA are ported (their results are held against the reference in
    ``test_decode_forward_matches_jax_step_by_step`` and
    ``tests/test_torch_frontends.py``): the MLA cache holds the
    compressed ``c``, the shared roped key ``rope`` and ``kpos``.  A GQA
    model with dense first layers still raises in ``decode_forward``:
    the reference's step walks ``layers`` alone."""
    cfg = get_config("yi-6b").smoke()
    model = M.init_params(cfg, device="cpu")
    cache = M.init_cache(cfg, 1, 4, "cpu")
    embeds = torch.randn((1, 1, cfg.d_model), generator=torch.Generator(
    ).manual_seed(0))
    zero = torch.zeros((1,), dtype=torch.int32)
    logits, _ = M.decode_forward(cfg, model, cache,
                                 torch.zeros((1, 1), dtype=torch.int32),
                                 zero, inputs_embeds=embeds)
    fresh = M.init_cache(cfg, 1, 4, "cpu")
    other, _ = M.decode_forward(cfg, model, fresh,
                                torch.zeros((1, 1), dtype=torch.int32), zero)
    assert logits.shape == (1, 1, cfg.vocab_size)
    assert not torch.equal(logits, other)       # the embeddings were used
    for kw in (dict(block_kind="encdec", encoder_layers=1, frontend_seq=4,
                    max_positions=8),
               dict(frontend="patch", frontend_seq=4)):
        c = M.init_cache(dataclasses.replace(cfg, **kw), 1, 4, "cpu")
        assert c["kpos"].shape == (1, 4)
        assert ("xk" in c) == (kw.get("block_kind") == "encdec")
    mla = get_config("deepseek-v2-236b").smoke()
    c = M.init_cache(mla, 1, 4, "cpu")
    assert set(c) == {"c", "rope", "kpos"}
    assert [tuple(t.shape) for t in c["c"]] == [
        (1, 4, mla.mla_kv_lora_rank)] * mla.num_layers
    assert [tuple(t.shape) for t in c["rope"]] == [
        (1, 4, mla.mla_qk_rope_dim)] * mla.num_layers
    assert c["kpos"].shape == (1, 4)
    moe = dataclasses.replace(cfg, moe_num_experts=4, moe_top_k=2,
                              moe_d_ff=32, moe_first_dense_layers=1)
    with pytest.raises(NotImplementedError, match="first layers|layers"):
        M.decode_forward(moe, M.init_params(moe, device="cpu"),
                         M.init_cache(moe, 1, 4, "cpu"),
                         torch.zeros((1, 1), dtype=torch.int32), zero)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-350m",
                                  "whisper-medium", "pixtral-12b",
                                  "deepseek-v2-236b"])
def test_quickstart_launcher_on_cpu(arch, monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    out = quickstart.main(["--arch", arch, "--steps", "3", "--device",
                           "cpu"])
    printed = capsys.readouterr().out
    assert len(out) == 8
    assert all(0 <= t < get_config(arch).vocab_size for t in out)
    assert f"greedy continuation: {out}" in printed
    assert "loss" in printed and str(tmp_path) in printed
    assert any(p.name.startswith("quickstart_ckpt_")
               for p in tmp_path.iterdir())
