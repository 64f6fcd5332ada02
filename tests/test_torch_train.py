"""The port's training path against the live JAX package, on the CPU.

Same weights (``params_from_jax``) and same batches (numpy) on both sides:

* ``loss_fn``, every parameter's gradient and one AdamW step for the
  smoke configs of gemma2-2b (local/global layers, softcaps, post-norms,
  tied embeddings) and yi-6b, in float32 and in bfloat16.  Float32:
  loss and grad norm within 1e-5 (relative), each gradient within 1e-5
  of its leaf's largest |g|, each updated parameter within 1e-6 |p| +
  1e-3 lr, except where the reference's |g| < 1e-5: there a gradient is
  within its own summation error of eps-scale, AdamW's sign-like update
  may flip, and the bound is one full update (2.1 lr).  bfloat16
  (loose): loss and grad norm within 2e-3 and 5e-3, gradients within 6%
  of the leaf's largest, parameters within 2.1 lr + 2^-7 |p|; there the
  update lives in the float32 master, m and v, held against the
  reference's as ``_check_bf16_opt_state`` says.
* the data pipeline's batches, bit for bit, host sharding included;
* checkpoints written by either package, restored by the other, bit for
  bit;
* ``Trainer.run_with_recovery`` with an injected failure: the same
  ``final_step`` and ``restarts``, losses within 1e-4;
* ``python -m repro_torch.launch.train --smoke --device cpu``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as JCK
from repro.configs import get_config as j_get_config
from repro.configs import smoke_shape as j_smoke_shape
from repro.data import pipeline as JD
from repro.models import model as JM
from repro.models import steps as JST
from repro.optim import adamw as JA
from repro.optim import compress as JC
from repro.runtime import trainer as JT
from repro_torch.checkpoint import store as CK
from repro_torch.configs import get_config, smoke_shape
from repro_torch.data import pipeline as D
from repro_torch.launch import train as launch_train
from repro_torch.models import model as M
from repro_torch.models import steps as ST
from repro_torch.optim import adamw as A
from repro_torch.optim import compress as C
from repro_torch.runtime import trainer as T

ARCHS = ["gemma2-2b", "yi-6b"]


def _cfgs(arch, dtype, **kw):
    return (dataclasses.replace(j_get_config(arch).smoke(),
                                param_dtype=dtype, **kw),
            dataclasses.replace(get_config(arch).smoke(),
                                param_dtype=dtype, **kw))


def _np_params(jcfg, seed=0):
    return jax.tree.map(np.asarray, JM.init_params(
        jcfg, jax.random.PRNGKey(seed)))


def _batch(vocab, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _f32(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _rel(a, b):
    return abs(float(a.detach() if isinstance(a, torch.Tensor) else a)
               - float(b)) / abs(float(b))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_grads_and_adamw_match_jax(arch, dtype):
    _loss_grads_and_adamw(arch, dtype)


def test_mla_loss_grads_and_adamw_match_jax():
    """deepseek-v2's smoke config (MLA through the flash op at q/k head
    dim 24 and v 16, so its recompute backward at dv != dk; a dense first
    layer; routed top-2 and shared experts with capacity drops;
    ``remat_policy="full"``) at the float32 bars.  bfloat16 is left out,
    as in ``tests/test_torch_engine_moe.py``: one of the 64 rows' top-2
    flips there at a near-tie, which moves the loss by 3.1e-3 (bar
    2e-3); with the reference's routing replayed it is 1.5e-4 off."""
    _loss_grads_and_adamw("deepseek-v2-236b", "float32")


def _loss_grads_and_adamw(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    npp = _np_params(jcfg)
    batch = _batch(jcfg.vocab_size)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    f32 = dtype == "float32"

    jloss, jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, jb))(jax.tree.map(jnp.asarray, npp))
    model = M.params_from_jax(tcfg, npp, device="cpu").requires_grad_(True)
    loss = M.loss_fn(tcfg, model, tb)
    loss.backward()
    assert loss.dtype == torch.float32
    assert _rel(loss, jloss) < (1e-5 if f32 else 2e-3)
    for path in M.param_shapes(tcfg):
        g = model.param(path).grad
        ref = _f32(M.reference_leaf(jgrads, path))
        assert g.dtype == model.param(path).dtype, path
        np.testing.assert_allclose(
            _f32(g), ref, rtol=0,
            atol=(1e-5 if f32 else 6e-2) * np.abs(ref).max(), err_msg=path)

    ocfg = JA.AdamWConfig()
    jstate = JST.init_train_state(jcfg, ocfg, jax.random.PRNGKey(0))
    jstate["params"] = jax.tree.map(jnp.asarray, npp)
    jstate["opt"] = JA.init_opt_state(jstate["params"], ocfg)
    jstate, jm = jax.jit(JST.make_train_step(jcfg, ocfg))(jstate, jb)
    state = ST.init_train_state(
        tcfg, A.AdamWConfig(), params=M.params_from_jax(tcfg, npp,
                                                         device="cpu"))
    state, m = ST.make_train_step(tcfg, A.AdamWConfig())(state, tb)
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) == 1
    assert float(m["lr"]) == float(jm["lr"])
    assert _rel(m["loss"], jm["loss"]) < (1e-5 if f32 else 2e-3)
    assert _rel(m["grad_norm"], jm["grad_norm"]) < (1e-5 if f32 else 5e-3)
    lr = float(m["lr"])
    for path in M.param_shapes(tcfg):
        got = _f32(state["params"].param(path))
        want = _f32(M.reference_leaf(jstate["params"], path))
        p0 = np.abs(_f32(M.reference_leaf(npp, path)))
        if f32:
            g = np.abs(_f32(M.reference_leaf(jgrads, path)))
            tol = 1e-6 * p0 + np.where(g < 1e-5, 2.1 * lr, 1e-3 * lr)
            master = _f32(state["opt"]["master"][path])
            np.testing.assert_array_equal(master, got, err_msg=path)
        else:
            tol = 2.1 * lr + 2.0 ** -7 * p0
            _check_bf16_opt_state(state, jstate["opt"], path, lr, p0)
        assert (np.abs(got - want) <= tol).all(), path
        assert state["params"].param(path).dtype == \
            model.param(path).dtype


def _check_bf16_opt_state(state, jopt, path, lr, p0):
    """A bf16 parameter is too coarse to show a step-1 update (lr 3e-6),
    so the update is held where it lives, in the float32 master, m and v.
    The bf16 gradients agree within 6% of the leaf's largest (above), so
    m (0.1 g) is held at that and v (0.05 g^2) at 13% of its largest.
    The master moves by lr·(g / (|g| + eps) + wd·p): where the two m
    agree in sign and both clipped |g| (= |m| / 0.1) are at least 1e-5,
    or both are 0 (rows of tokens not in the batch), within 1e-6 |p| +
    1e-3 lr of the reference's (so a missing or sign-flipped update
    fails); elsewhere within one full update (2.1 lr).  At least 90% of
    the elements are held to the tight bound.  The parameter is the
    master cast back to bf16, exactly."""
    m_ref = _f32(M.reference_leaf(jopt["m"], path))
    v_ref = _f32(M.reference_leaf(jopt["v"], path))
    master_ref = _f32(M.reference_leaf(jopt["master"], path))
    m = _f32(state["opt"]["m"][path])
    master = state["opt"]["master"][path]
    assert master.dtype == torch.float32, path
    np.testing.assert_allclose(m, m_ref, rtol=0,
                               atol=6e-2 * np.abs(m_ref).max(), err_msg=path)
    np.testing.assert_allclose(_f32(state["opt"]["v"][path]), v_ref, rtol=0,
                               atol=0.13 * v_ref.max(), err_msg=path)
    tight = ((np.sign(m) == np.sign(m_ref))
             & (np.minimum(np.abs(m), np.abs(m_ref)) / 0.1 >= 1e-5)
             | (m == 0) & (m_ref == 0))
    tol = 1e-6 * p0 + np.where(tight, 1e-3 * lr, 2.1 * lr)
    assert (np.abs(_f32(master) - master_ref) <= tol).all(), path
    assert tight.mean() >= 0.9, (path, tight.mean())
    assert torch.equal(state["params"].param(path),
                       master.to(state["params"].param(path).dtype)), path


def test_remat_policies_give_the_same_grads():
    """none / full / dots (selective: 2-D products kept) recompute the
    same arithmetic."""
    _, tcfg = _cfgs("gemma2-2b", "float32")
    model = M.init_params(tcfg, seed=1, device="cpu").requires_grad_(True)
    tb = {k: torch.from_numpy(v)
          for k, v in _batch(tcfg.vocab_size, seed=1).items()}
    out = {}
    for policy in ("none", "full", "dots"):
        cfg = dataclasses.replace(tcfg, remat_policy=policy)
        model.zero_grad(set_to_none=True)
        loss = M.loss_fn(cfg, model, tb)
        loss.backward()
        out[policy] = [loss.detach()] + [p.grad.clone()
                                         for p in model.parameters()]
    for policy in ("full", "dots"):
        for a, b in zip(out[policy], out["none"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-7)


def test_forward_fullseq_routes_attention_through_flash_op():
    from repro_torch.kernels.flash_attention import ops
    _, tcfg = _cfgs("gemma2-2b", "float32")
    model = M.init_params(tcfg, seed=0, device="cpu").requires_grad_(True)
    tb = {k: torch.from_numpy(v)
          for k, v in _batch(tcfg.vocab_size).items()}
    ops.plain_forwards.reset()
    ops.backward_recomputes.reset()
    M.loss_fn(tcfg, model, tb).backward()
    # one forward per layer plus the checkpoint's recompute, one backward
    assert ops.plain_forwards.n == 2 * tcfg.num_layers
    assert ops.backward_recomputes.n == tcfg.num_layers
    assert [M._layer_window(tcfg, i) for i in range(4)] == [16, 0, 16, 0]


def test_ef_compress_grads_matches_jitted_reference():
    rng = np.random.default_rng(5)
    grads = {"a": rng.standard_normal((64, 32)).astype(np.float32),
             "b": rng.standard_normal((128,)).astype(np.float32) * 1e-3}
    resid = {k: rng.standard_normal(v.shape).astype(np.float32) * 1e-2
             for k, v in grads.items()}
    jg, jr = jax.jit(JC.ef_compress_grads)(
        {k: jnp.asarray(v) for k, v in grads.items()},
        {k: jnp.asarray(v) for k, v in resid.items()})
    tg, tr = C.ef_compress_grads(
        {k: torch.from_numpy(v) for k, v in grads.items()},
        {k: torch.from_numpy(v) for k, v in resid.items()})
    for k in grads:
        np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]))
        # the jitted reference fuses g32 - q * s (one rounding less): one
        # float32 step at the largest |g32|
        ulp = np.spacing(np.abs(grads[k] + resid[k]).max())
        np.testing.assert_allclose(tr[k].numpy(), np.asarray(jr[k]),
                                   rtol=0, atol=ulp)
    z = C.init_residual({"a": torch.zeros(3, 2, dtype=torch.bfloat16)})
    assert z["a"].dtype == torch.float32 and not z["a"].any()


def test_compressed_train_step_matches_jax():
    """The residual after one compressed step: within the gradients' own
    float32 error (1e-5 of the leaf's largest |g|), or off by exactly one
    int8 step s = max|g| / 127 where that error moved g / s across a
    rounding boundary (at most 0.1% of a leaf's elements)."""
    jcfg, tcfg = _cfgs("yi-6b", "float32")
    npp = _np_params(jcfg)
    batch = _batch(jcfg.vocab_size, seed=2)
    jgrads = jax.grad(lambda p: JM.loss_fn(
        jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}))(
        jax.tree.map(jnp.asarray, npp))
    ocfg = JA.AdamWConfig()
    jstate = JST.init_train_state(jcfg, ocfg, jax.random.PRNGKey(0),
                                  compress=True)
    jstate, jm = jax.jit(JST.make_train_step(jcfg, ocfg, compress=True))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state = ST.init_train_state(tcfg, A.AdamWConfig(), compress=True,
                                params=M.params_from_jax(tcfg, npp,
                                                         device="cpu"))
    state, m = ST.make_train_step(tcfg, A.AdamWConfig(), compress=True)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert _rel(m["loss"], jm["loss"]) < 1e-5
    assert _rel(m["grad_norm"], jm["grad_norm"]) < 1e-4
    for path in M.param_shapes(tcfg):
        ref = _f32(M.reference_leaf(jstate["resid"], path))
        gmax = np.abs(_f32(M.reference_leaf(jgrads, path))).max()
        diff = np.abs(_f32(state["resid"][path]) - ref)
        near = diff <= 1e-5 * gmax
        flip = np.abs(diff - gmax / 127) <= 1e-5 * gmax
        assert (near | flip).all(), path
        assert flip.sum() <= max(1, 1e-3 * diff.size), path


@pytest.mark.parametrize("cls", ["SyntheticLMData", "MarkovChainData"])
def test_data_pipeline_bit_equal(cls):
    for arch in ARCHS:
        shape = smoke_shape("train")
        tcfg, jcfg = get_config(arch).smoke(), j_get_config(arch).smoke()
        assert dataclasses.asdict(shape) == \
            dataclasses.asdict(j_smoke_shape("train"))
        for hosts, host in ((1, 0), (2, 1)):
            t = getattr(D, cls)(tcfg, shape, seed=3, num_hosts=hosts,
                                host_id=host)
            j = getattr(JD, cls)(jcfg, shape, seed=3, num_hosts=hosts,
                                 host_id=host)
            for step in (0, 7):
                a, b = t.batch(step), j.batch(step)
                assert a.keys() == b.keys()
                for k in a:
                    assert a[k].dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k], b[k])
    pf = D.Prefetcher(D.MarkovChainData(get_config("yi-6b").smoke(),
                                        smoke_shape("train")), start_step=4)
    try:
        step, b = next(pf)
        ref = JD.MarkovChainData(j_get_config("yi-6b").smoke(),
                                 j_smoke_shape("train")).batch(4)
        assert step == 4
        np.testing.assert_array_equal(b["tokens"], ref["tokens"])
    finally:
        pf.close()


def _trained_states(arch):
    """One train step on both sides from the same weights, bf16 params
    with float32 master, m, v and residuals."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    npp = _np_params(jcfg)
    batch = _batch(jcfg.vocab_size, seed=4)
    ocfg = JA.AdamWConfig()
    jstate = JST.init_train_state(jcfg, ocfg, jax.random.PRNGKey(0),
                                  compress=True)
    jstate, _ = jax.jit(JST.make_train_step(jcfg, ocfg, compress=True))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state = ST.init_train_state(tcfg, A.AdamWConfig(), compress=True,
                                params=M.params_from_jax(tcfg, npp,
                                                         device="cpu"))
    state, _ = ST.make_train_step(tcfg, A.AdamWConfig(), compress=True)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    return jcfg, tcfg, jstate, state


def _leaves_equal(torch_tree, jax_tree):
    flat_t = dict(CK._flatten_with_paths(torch_tree))
    flat_j = dict(JCK._flatten_with_paths(jax_tree))
    assert flat_t.keys() == flat_j.keys()
    for path, t in flat_t.items():
        j = np.asarray(flat_j[path])
        assert str(t.dtype).replace("torch.", "") == str(j.dtype), path
        assert tuple(t.shape) == j.shape, path
        np.testing.assert_array_equal(_f32(t), j.astype(np.float32),
                                      err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_restores_in_jax(arch, tmp_path):
    jcfg, tcfg, jstate, state = _trained_states(arch)
    tree = ST.state_tree(tcfg, state)
    CK.save_checkpoint(str(tmp_path), 3, tree)
    assert JCK.latest_step(str(tmp_path)) == 3
    restored, step = JCK.restore_checkpoint(str(tmp_path), jstate)
    assert step == 3
    _leaves_equal(tree, restored)


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_checkpoint_restores_in_port(arch, tmp_path):
    jcfg, tcfg, jstate, _ = _trained_states(arch)
    JCK.save_checkpoint(str(tmp_path), 5, jstate)
    tree, step = CK.restore_checkpoint(str(tmp_path))
    assert step == 5 and CK.latest_step(str(tmp_path)) == 5
    fresh = ST.init_train_state(tcfg, A.AdamWConfig(), seed=9,
                                compress=True, device="cpu")
    ST.load_state_tree(tcfg, fresh, tree)
    _leaves_equal(ST.state_tree(tcfg, fresh), jstate)


def test_async_checkpointer_snapshots_before_in_place_updates(tmp_path):
    state = {"w": torch.ones(4, dtype=torch.bfloat16),
             "step": torch.tensor(1, dtype=torch.int32)}
    ck = CK.AsyncCheckpointer(str(tmp_path))
    ck.save(1, state)
    state["w"].mul_(3)
    ck.close()
    tree, _ = CK.restore_checkpoint(str(tmp_path), like=state)
    assert tree["w"].dtype == torch.bfloat16 and (tree["w"] == 1).all()
    assert tree["step"].shape == () and int(tree["step"]) == 1


class _PortTrainer(T.Trainer):
    """Starts from the reference's weights for ``seed``."""

    def init_state(self, seed=0):
        npp = _np_params(dataclasses.replace(
            j_get_config(self.cfg.name.replace("-smoke", "")).smoke(),
            param_dtype=self.cfg.param_dtype), seed)
        return ST.init_train_state(
            self.cfg, self.opt_cfg, compress=self.compress,
            params=M.params_from_jax(self.cfg, npp, device=self.device))


def test_trainer_recovery_matches_jax(tmp_path):
    jcfg, tcfg = _cfgs("gemma2-2b", "float32")
    shape = smoke_shape("train")
    kw = dict(total_steps=6, ckpt_every=2, log_every=1)
    jt = JT.Trainer(jcfg, j_smoke_shape("train"),
                    JD.MarkovChainData(jcfg, j_smoke_shape("train")),
                    JT.TrainerConfig(ckpt_dir=str(tmp_path / "jax"), **kw))
    jres = jt.run_with_recovery(JT.FailureInjector([3]))
    tt = _PortTrainer(tcfg, shape, D.MarkovChainData(tcfg, shape),
                      T.TrainerConfig(ckpt_dir=str(tmp_path / "port"), **kw),
                      device="cpu")
    tres = tt.run_with_recovery(T.FailureInjector([3]))
    assert (tres["final_step"], tres["restarts"]) == \
        (jres["final_step"], jres["restarts"]) == (6, 1)
    assert [m["step"] for m in tres["metrics"]] == \
        [m["step"] for m in jres["metrics"]]
    for a, b in zip(tres["metrics"], jres["metrics"]):
        assert _rel(a["loss"], b["loss"]) < 1e-4, (a, b)
        assert a["lr"] == pytest.approx(b["lr"], rel=1e-6)
    assert T.latest_step(str(tmp_path / "port")) == 6


def test_trainer_flags_stragglers_in_the_tracer(tmp_path):
    from repro_torch.core.tracing import EventType, TraceBuffer
    _, tcfg = _cfgs("yi-6b", "float32")
    shape = smoke_shape("train")
    tracer = TraceBuffer()
    tr = T.Trainer(tcfg, shape, D.SyntheticLMData(tcfg, shape),
                   T.TrainerConfig(total_steps=6, ckpt_every=100,
                                   ckpt_dir=str(tmp_path),
                                   straggler_factor=0.0),
                   tracer=tracer, device="cpu")
    res = tr.run()
    assert res["stragglers"] == [3, 4, 5]
    rows = tracer.drain()
    assert [int(r[3]) for r in rows if int(r[2]) == EventType.SYNC] == \
        [3, 4, 5]


def test_launch_train_smoke_on_cpu(tmp_path, capsys):
    res = launch_train.main(["--arch", "gemma2-2b", "--smoke", "--steps",
                             "3", "--device", "cpu", "--ckpt-dir",
                             str(tmp_path)])
    assert res["final_step"] == 3 and res["restarts"] == 0
    assert all(np.isfinite(m["loss"]) for m in res["metrics"])
    assert "done: 3 steps" in capsys.readouterr().out
    assert CK.latest_step(str(tmp_path)) == 3


def test_paged_server_still_refuses_local_global_archs():
    from repro_torch.runtime import make_engine
    cfg = get_config("gemma2-2b").smoke()
    model = M.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="plain-GQA"):
        make_engine(cfg, model, device="cpu")
    post = dataclasses.replace(get_config("yi-6b").smoke(),
                               post_block_norm=True)
    with pytest.raises(NotImplementedError, match="paged server"):
        make_engine(post, M.init_params(post, device="cpu"), device="cpu")
