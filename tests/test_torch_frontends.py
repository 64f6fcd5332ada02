"""The frontend families against the live JAX package, on the CPU:
whisper-medium (an encoder-decoder: LayerNorms with biases, learned
positions, non-causal encoder self-attention, cross-attention) through
the model API, and pixtral-12b (patch embeddings at the head of the
token sequence) through the model API and the paged engine.

Smoke configs, the same weights on both sides (``params_from_jax``) and
numpy-seeded tokens and frames, float32 unless stated:

* the parameter layout: every reference leaf, full size and smoke, in
  float32 and bfloat16, with its shape and type; the constant inits
  (LayerNorm biases zero) and fan-ins (``enc_pos``, ``dec_pos``);
* ``forward_fullseq`` with a frontend within 1e-5 of the largest |h|;
* ``loss_fn`` and every leaf's gradient, at ``test_torch_train.py``'s
  bars (float32: 1e-5; bfloat16: loss 2e-3, gradients 6e-2 of the
  leaf's largest);
* ``encode_frontend`` and ``encdec_cross_cache`` (1e-5);
* the port's ``decode_forward`` step by step, pixtral's patch positions
  fed as ``inputs_embeds``, against the reference's ``prefill_logits``
  (1e-5 of the largest |logit|);
* ``attend_fullseq`` without a causal mask at offset positions and S !=
  T against the reference's; a causal or windowed call at offset
  positions still raises;
* ``input_specs`` / ``make_batch`` with ``frontend``; the data
  pipeline's ``frontend`` batches bit for bit;
* one bf16 train step with compressed gradients on both sides, its
  checkpoint restored by the other package leaf for leaf (the encoder
  and decoder stacks in the reference's layout); ``launch.train``;
* ``roofline.param_counts`` / ``cache_bytes``;
* pixtral's ``PagedServer`` token for token with the JAX engine, with
  counters and pool stats, on the float32 pool (the reference's oracle
  and its interpret-mode kernel) and on int8 pages with a replayed
  drafter at ``spec_k=4``; its sharded engine at (2, 2) gives the
  unsharded engine's tokens; whisper is not served, by either engine.

``tests/test_torch_decode.py`` holds both archs' ``init_cache``,
``decode_forward`` (float32, and bfloat16 op by op in
``test_torch_decode_bf16.py``) and ``prefill_logits`` against the
reference with the other registered archs, and runs the quickstart.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import smoke_shape as j_smoke_shape
from repro.checkpoint import store as JCK
from repro.core import roofline as JR
from repro.data import pipeline as JD
from repro.models import attention as JA
from repro.models import model as JM
from repro.models import steps as JST
from repro.optim import adamw as JAW
from repro.runtime import (
    CacheConfig as JCacheConfig, EngineConfig as JEngineConfig,
    GenerationRequest as JRequest, SamplingParams as JSampling,
    make_engine as j_make_engine,
)
from repro_torch.checkpoint import store as CK
from repro_torch.configs import SHAPES, get_config, smoke_shape
from repro_torch.core import roofline as R
from repro_torch.data import pipeline as D
from repro_torch.launch import train as launch_train
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.models import steps as ST
from repro_torch.optim import adamw as AW
from repro_torch.runtime import (
    CacheConfig, EngineConfig, GenerationRequest, PagedServer,
    SamplingParams, ShardedPagedServer, make_engine,
)
import test_torch_engine as TE
import test_torch_sampling as TS
import test_torch_train as TT

ARCHS = ["whisper-medium", "pixtral-12b"]
BAR = 1e-5
B, S = 2, 24


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(j_get_config(arch).smoke(),
                                param_dtype=dtype),
            dataclasses.replace(get_config(arch).smoke(),
                                param_dtype=dtype))


@functools.lru_cache(maxsize=None)
def _np_params(arch, dtype="float32"):
    return jax.tree.map(np.asarray, JM.init_params(
        _cfgs(arch, dtype)[0], jax.random.PRNGKey(0)))


def _inputs(cfg, seed=0):
    """Tokens (B, S) and frames (B, frontend_seq, d) at the data
    pipeline's scale, float32 (each side casts them to its weights'
    type)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    frames = (rng.standard_normal((B, cfg.frontend_seq, cfg.d_model))
              * 0.02).astype(np.float32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "frontend": frames}


def _close(got, want, bar=BAR, msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, msg
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=bar * max(np.abs(want).max(), 1e-30),
                               err_msg=msg)


# ---------------------------------------------------------------- layout --
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_cover_reference_leaves(arch):
    """Every leaf of the reference's tree, full size and smoke, in float32
    and bfloat16: the port's paths cover it exactly, each with its shape
    (a layer's slice of a stacked leaf) and type; whisper's norms carry
    float32 biases, its position tables ``enc_pos`` (F, d) and
    ``dec_pos`` (max_positions, d)."""
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
            assert sum(len(g) for g in groups) == len(shapes)
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
    if arch == "whisper-medium":
        cfg = get_config(arch)
        shapes = M.param_shapes(cfg)
        assert shapes["enc_pos"] == (1500, 1024)
        assert shapes["dec_pos"] == (32768, 1024)
        assert shapes["dec_layers/23/xattn/wq"] == (1024, 16, 64)
        for norm in ("enc_layers/0/ln1", "dec_layers/0/lnx", "enc_norm",
                     "final_norm"):
            assert shapes[f"{norm}/bias"] == (1024,)
    else:
        assert not any("bias" in p or "pos" in p
                       for p in M.param_shapes(get_config(arch)))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_carries_every_leaf(arch):
    """Smoke weights, float32 and bfloat16: each port parameter holds the
    reference leaf's values bit for bit, in its type; ``stack_layers``
    gives the reference's tree back."""
    for dtype in ("float32", "bfloat16"):
        _, tcfg = _cfgs(arch, dtype)
        npp = _np_params(arch, dtype)
        model = M.params_from_jax(tcfg, npp, device="cpu")
        for path in M.param_shapes(tcfg):
            ref = np.asarray(M.reference_leaf(npp, path))
            got = model.param(path)
            assert str(got.dtype).replace("torch.", "") == ref.dtype.name, \
                path
            np.testing.assert_array_equal(got.float().numpy(),
                                          ref.astype(np.float32),
                                          err_msg=path)
        back = M.stack_layers(tcfg, ST.named_params(model))
        for k, v in jax.tree_util.tree_leaves_with_path(npp):
            node = back
            for key in k:
                node = node[key.key]
            np.testing.assert_array_equal(node.float().numpy(),
                                          np.asarray(v, np.float32))


def test_init_params_constants_and_fan_in():
    """whisper's LayerNorms start at scale 1, bias 0 (the reference's
    ``init="ones"`` / ``"zeros"``); ``enc_pos`` and ``dec_pos`` draw
    with their first dim as fan-in."""
    cfg = get_config("whisper-medium").smoke()
    model = M.init_params(cfg, seed=0, device="cpu")
    biases = 0
    for path, shape in M.param_shapes(cfg).items():
        p = model.param(path).float()
        const = M._const_init(path)
        if path.endswith("/bias"):
            biases += 1
            assert const == 0.0 and p.dtype == torch.float32
        if const is not None:
            assert bool((p == const).all()), path
        elif p.numel() >= 256:
            fan = M._fan_in(cfg, path, shape)
            assert abs(float(p.std()) * fan ** 0.5 - 1.0) < 0.15, path
    # ln1, ln2 per encoder layer; ln1, lnx, ln2 per decoder layer;
    # enc_norm and final_norm
    assert biases == 2 * cfg.encoder_layers + 3 * cfg.num_layers + 2
    assert M._fan_in(cfg, "enc_pos", (8, 64)) == 8
    assert M._fan_in(cfg, "dec_pos", (64, 64)) == 64


# --------------------------------------------------------------- forward --
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_fullseq_with_frontend_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    npp = _np_params(arch)
    batch = _inputs(jcfg)
    want = JM.forward_fullseq(jcfg, jax.tree.map(jnp.asarray, npp),
                              jnp.asarray(batch["tokens"]),
                              frontend=jnp.asarray(batch["frontend"]))
    model = M.params_from_jax(tcfg, npp, device="cpu")
    with torch.no_grad():
        got = M.forward_fullseq(tcfg, model,
                                torch.from_numpy(batch["tokens"]),
                                frontend=torch.from_numpy(batch["frontend"]))
        plain = M.forward_fullseq(tcfg, model,
                                  torch.from_numpy(batch["tokens"]),
                                  frontend=torch.from_numpy(
                                      batch["frontend"] * 2))
    _close(got, want)
    # the frames reach every position (the encoder's through the
    # cross-attention; the patches' through causal attention)
    assert (got - plain).abs().amax(dim=(0, 2)).min() > 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(arch, dtype):
    """Every leaf's gradient, ``enc_*``, ``xattn`` and the LayerNorm biases
    included (each must move)."""
    jcfg, tcfg = _cfgs(arch, dtype)
    f32 = dtype == "float32"
    npp = _np_params(arch, dtype)
    batch = _inputs(jcfg, seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jloss, jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, jb))(jax.tree.map(jnp.asarray, npp))
    model = M.params_from_jax(tcfg, npp, device="cpu").requires_grad_(True)
    loss = M.loss_fn(tcfg, model, tb)
    loss.backward()
    assert loss.dtype == torch.float32
    assert abs(loss.item() - float(jloss)) <= \
        (1e-5 if f32 else 2e-3) * abs(float(jloss))
    moved = set()
    for path in M.param_shapes(tcfg):
        g = model.param(path).grad
        ref = np.asarray(M.reference_leaf(jgrads, path), np.float32)
        assert g is not None and g.dtype == model.param(path).dtype, path
        _close(g, ref, 1e-5 if f32 else 6e-2, path)
        if float(g.float().abs().max()) > 0:
            moved.add(path)
    if arch == "whisper-medium":
        for path in ("enc_pos", "dec_pos", "enc_norm/bias",
                     "enc_layers/0/attn/wq", "enc_layers/1/ln1/bias",
                     "dec_layers/0/xattn/wk", "dec_layers/1/xattn/wq",
                     "dec_layers/0/lnx/bias", "final_norm/bias"):
            assert path in moved, path


def test_encode_frontend_and_cross_cache_match_jax():
    jcfg, tcfg = _cfgs("whisper-medium")
    npp = _np_params("whisper-medium")
    jp = jax.tree.map(jnp.asarray, npp)
    frames = _inputs(jcfg, seed=2)["frontend"]
    model = M.params_from_jax(tcfg, npp, device="cpu")
    with torch.no_grad():
        enc = M.encode_frontend(tcfg, model, torch.from_numpy(frames))
        xk, xv = M.encdec_cross_cache(tcfg, model, torch.from_numpy(frames))
    _close(enc, JM.encode_frontend(jcfg, jp, jnp.asarray(frames)))
    jxk, jxv = JM.encdec_cross_cache(jcfg, jp, jnp.asarray(frames))
    assert len(xk) == len(xv) == tcfg.num_layers
    _close(torch.stack(xk), jxk)
    _close(torch.stack(xv), jxv)
    cache = M.init_cache(tcfg, B, S, "cpu")
    assert [t.shape for t in cache["xk"]] == [t.shape for t in xk]
    with pytest.raises(ValueError):
        M.encode_frontend(_cfgs("pixtral-12b")[1], None, None)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_by_step_matches_jax_prefill(arch):
    """The port's decode over the S tokens (pixtral's first
    ``frontend_seq`` positions fed their patch embeddings as
    ``inputs_embeds``; whisper's cross cache from ``encdec_cross_cache``)
    ends at the reference's ``prefill_logits`` of the same inputs."""
    jcfg, tcfg = _cfgs(arch)
    npp = _np_params(arch)
    batch = _inputs(jcfg, seed=3)
    toks, frames = batch["tokens"], batch["frontend"]
    want = JM.prefill_logits(jcfg, jax.tree.map(jnp.asarray, npp),
                             {"tokens": jnp.asarray(toks),
                              "frontend": jnp.asarray(frames)})
    model = M.params_from_jax(tcfg, npp, device="cpu")
    cache = M.init_cache(tcfg, B, S, "cpu")
    fr = torch.from_numpy(frames)
    if tcfg.block_kind == "encdec":
        cache["xk"], cache["xv"] = M.encdec_cross_cache(tcfg, model, fr)
    for t in range(S):
        embeds = fr[:, t:t + 1] if tcfg.frontend == "patch" and \
            t < tcfg.frontend_seq else None
        got, cache = M.decode_forward(
            tcfg, model, cache, torch.from_numpy(toks[:, t:t + 1]),
            torch.full((B,), t, dtype=torch.int32), inputs_embeds=embeds)
    _close(got, want)


def test_attend_fullseq_positions_rule_matches_jax():
    """Without a causal mask or a window the positions play no part: the
    reference's result at offset positions and S != T (whisper's
    cross-attention); with either, offset positions still raise."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 20, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 20, 2, 16)).astype(np.float32)
    qpos, kpos = np.arange(12, dtype=np.int32) + 7, \
        np.arange(20, dtype=np.int32) * 3 + 100
    want = JA.attend_fullseq(*map(jnp.asarray, (q, k, v)),
                             q_positions=jnp.asarray(qpos),
                             k_positions=jnp.asarray(kpos), causal=False)
    for positions in ((qpos, kpos), (None, None)):
        got = A.attend_fullseq(
            *map(torch.from_numpy, (q, k, v)),
            q_positions=None if positions[0] is None
            else torch.from_numpy(positions[0]),
            k_positions=None if positions[1] is None
            else torch.from_numpy(positions[1]), causal=False)
        _close(got, want)
    for kw in (dict(causal=True), dict(causal=False, window=4)):
        with pytest.raises(NotImplementedError):
            A.attend_fullseq(*map(torch.from_numpy, (q, k, v)),
                             q_positions=torch.from_numpy(qpos),
                             k_positions=torch.from_numpy(kpos), **kw)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", ["smoke_train", "smoke_prefill",
                                   "smoke_decode", "prefill_32k"])
def test_input_specs_and_make_batch_with_frontend(arch, shape):
    for dtype in ("float32", "bfloat16"):
        jcfg, cfg = _cfgs(arch, dtype)
        if shape.startswith("smoke_"):
            tshape, jshape = smoke_shape(shape[6:]), j_smoke_shape(shape[6:])
        else:
            tshape, jshape = SHAPES[shape], J_SHAPES[shape]
            jcfg = dataclasses.replace(j_get_config(arch), param_dtype=dtype)
            cfg = dataclasses.replace(get_config(arch), param_dtype=dtype)
        want = JST.input_specs(jcfg, jshape)
        specs = ST.input_specs(cfg, tshape)
        assert {k: (s, str(dt).replace("torch.", "")) for k, (s, dt)
                in specs.items()} == {k: (v.shape, jnp.dtype(v.dtype).name)
                                      for k, v in want.items()}
        assert ("frontend" in specs) == (tshape.kind != "decode")
        if not shape.startswith("smoke_"):
            continue
        batch = ST.make_batch(cfg, tshape, torch.Generator().manual_seed(0))
        assert {k: (tuple(v.shape), v.dtype) for k, v in batch.items()} == \
            {k: s for k, s in specs.items()}
        if "frontend" in batch:
            std = float(batch["frontend"].float().std())
            assert 0.015 < std < 0.025


@pytest.mark.parametrize("arch", ARCHS)
def test_data_pipeline_frontend_batches_bit_equal(arch):
    """Both sources' batches, ``frontend`` frames included, bit for bit,
    host sharding too."""
    shape = smoke_shape("train")
    tcfg, jcfg = get_config(arch).smoke(), j_get_config(arch).smoke()
    for cls in ("SyntheticLMData", "MarkovChainData"):
        for hosts, host in ((1, 0), (2, 1)):
            t = getattr(D, cls)(tcfg, shape, seed=3, num_hosts=hosts,
                                host_id=host)
            j = getattr(JD, cls)(jcfg, shape, seed=3, num_hosts=hosts,
                                 host_id=host)
            a, b = t.batch(5), j.batch(5)
            assert a.keys() == b.keys() and "frontend" in a
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_cross_packages(arch, tmp_path):
    """One bf16 train step with compressed gradients on both sides from
    the same weights and batch (frames included): the port's checkpoint
    restores in the reference's train state leaf for leaf, and the
    reference's into a fresh port state."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    npp = _np_params(arch, "bfloat16")
    batch = _inputs(jcfg, seed=4)
    ocfg = JAW.AdamWConfig()
    jstate = JST.init_train_state(jcfg, ocfg, jax.random.PRNGKey(0),
                                  compress=True)
    jstate, _ = jax.jit(JST.make_train_step(jcfg, ocfg, compress=True))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state = ST.init_train_state(tcfg, AW.AdamWConfig(), compress=True,
                                params=M.params_from_jax(tcfg, npp,
                                                         device="cpu"))
    state, _ = ST.make_train_step(tcfg, AW.AdamWConfig(), compress=True)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    tree = ST.state_tree(tcfg, state)
    CK.save_checkpoint(str(tmp_path / "port"), 3, tree)
    restored, step = JCK.restore_checkpoint(str(tmp_path / "port"), jstate)
    assert step == 3
    TT._leaves_equal(tree, restored)
    JCK.save_checkpoint(str(tmp_path / "jax"), 5, jstate)
    jtree, step = CK.restore_checkpoint(str(tmp_path / "jax"))
    assert step == 5
    fresh = ST.init_train_state(tcfg, AW.AdamWConfig(), seed=9,
                                compress=True, device="cpu")
    ST.load_state_tree(tcfg, fresh, jtree)
    TT._leaves_equal(ST.state_tree(tcfg, fresh), jstate)


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_smoke_on_cpu(arch, tmp_path, capsys):
    res = launch_train.main(["--arch", arch, "--smoke", "--steps", "3",
                             "--device", "cpu", "--ckpt-dir",
                             str(tmp_path)])
    assert res["final_step"] == 3 and res["restarts"] == 0
    assert all(np.isfinite(m["loss"]) for m in res["metrics"])
    assert "done: 3 steps" in capsys.readouterr().out
    assert CK.latest_step(str(tmp_path)) == 3


@pytest.mark.parametrize("arch", ARCHS)
def test_roofline_counts_and_cache_bytes_equal_reference(arch):
    """The parameter counts come from the port's own shapes (whisper's
    position tables and LayerNorm biases included); the decode cache of
    an encoder-decoder adds its cross K/V over the frames."""
    for smoke in (False, True):
        t, j = get_config(arch), j_get_config(arch)
        if smoke:
            t, j = t.smoke(), j.smoke()
        pc = R.param_counts(t)
        assert pc == JR.param_counts(j)
        for name, shape in SHAPES.items():
            for kv in ("bf16", "int8"):
                assert R.cache_bytes(t, shape, kv) == \
                    JR.cache_bytes(j, J_SHAPES[name], kv)
    pc = R.param_counts(get_config(arch))["total"]
    assert (0.8e9 < pc < 0.9e9) if arch == "whisper-medium" else \
        (12.0e9 < pc < 12.5e9)


# ---------------------------------------------------------------- engine --
@pytest.fixture(scope="module")
def pixtral():
    return TE._pair("pixtral-12b")


@pytest.mark.parametrize("use_kernel", [False, True], ids=["ref", "kernel"])
def test_pixtral_engine_matches_jax(pixtral, use_kernel):
    """``test_torch_engine``'s workload (a shared system prompt, more
    requests than lanes, a forced preemption): tokens, finish reasons,
    prefix hits, counters and pool stats equal.  The engine serves text
    tokens; the frontend is not its input, on either side."""
    ref, port = TE._both(pixtral, page=4, chunk=8, use_kernel=use_kernel)
    assert port == ref
    assert port["preemptions"] == 1
    assert port["pool"]["prefix_hit_tokens"] > 0
    assert port["pool"]["swapped_in"] > 0


def _greedy_continuations(pair, max_new):
    jcfg, params = pair[0], pair[1]
    known = {}
    for p in TE._lockstep_workload(jcfg.vocab_size):
        srv = j_make_engine(jcfg, params, JEngineConfig(
            cache=JCacheConfig(num_pages=48, page_size=4,
                               max_pages_per_seq=16),
            max_lanes=1, chunk=8, use_kernel=False))
        srv.submit(JRequest(0, tuple(p), JSampling(max_new=max_new)))
        known[tuple(p)] = list(srv.run()[0].tokens)
    return known


def test_pixtral_int8_spec_engine_matches_jax(pixtral):
    """int8 pages and ``spec_k=4`` with replayed drafts (corrupted at odd
    context lengths, so verify steps both accept and reject): every
    token, counter, pool stat and speculation count equal, every mapped
    page's bytes within one step (``INT8_BYTE_SHARE``).  Layer 0's page
    scales are held to ``SCALE_RTOL`` and layer 1's to
    ``DEEP_SCALE_RTOL``: at this workload a few layer-0 bytes round apart
    on a verify step, which moves layer 1's K/V, and so its scales, by
    ~1.6e-4 relative in that step (``lockstep``'s ``scale_layers``)."""
    drafter = TS.ReplayDrafter(_greedy_continuations(pixtral, 12),
                               pixtral[2].vocab_size)
    ref, port, (mismatched, compared) = TE.lockstep(
        pixtral, page=4, use_kernel=False, kv_dtype="int8", spec_k=4,
        max_new=12, drafter=drafter, scale_layers=1)
    assert port == ref
    assert mismatched <= TE.INT8_BYTE_SHARE * compared
    spec_iters, proposed, accepted, rejected = port["spec"]
    assert spec_iters > 0 and accepted > 0 and rejected > 0
    assert port["pool"]["cow"] > 0 and port["pool"]["swapped_in"] > 0


def test_pixtral_sharded_engine_gives_unsharded_tokens(pixtral):
    """The sharded engine builds for pixtral (G = 2 at smoke size) and at
    (clusters, heads) = (2, 2) serves the workload to the unsharded
    engine's tokens."""
    _, _, tcfg, model = pixtral
    cache = CacheConfig(num_pages=32, page_size=4, max_pages_per_seq=8)
    one = make_engine(tcfg, model, EngineConfig(cache=cache, max_lanes=2,
                                                chunk=8), device="cpu")
    mesh = make_engine(tcfg, model, EngineConfig(
        cache=cache, max_lanes=2, chunk=8, clusters=2, heads=2),
        device="cpu")
    assert isinstance(mesh, ShardedPagedServer) and not isinstance(
        one, ShardedPagedServer)
    outs = []
    for e in (one, mesh):
        for rid, p in enumerate(TE.PROMPTS):
            e.submit(GenerationRequest(rid, tuple(p),
                                       SamplingParams(max_new=6)))
        outs.append({r.rid: r.tokens for r in e.run()})
    assert outs[0] == outs[1] and len(outs[0]) == len(TE.PROMPTS)
    mesh.cpool.check_invariants()


def test_whisper_is_not_served():
    """Neither engine serves an encoder-decoder (the reference's guard
    admits plain-GQA transformers only)."""
    jcfg, tcfg = _cfgs("whisper-medium")
    model = M.init_params(tcfg, device="cpu")
    with pytest.raises(ValueError):
        PagedServer(tcfg, model, device="cpu")
    with pytest.raises(AssertionError):
        j_make_engine(jcfg, JM.init_params(jcfg, jax.random.PRNGKey(0)),
                      JEngineConfig())
