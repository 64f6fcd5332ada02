"""The port's ``PagedServer`` on MoE and on minitron's ungated MLP, against
the JAX ``PagedServer`` on the CPU, plus the MoE training forward.

olmoe-1b-7b at smoke size (4 experts, top-2) serves the workloads of
``test_torch_engine`` and ``test_torch_sampling`` on identical float32
weights (``params_from_jax``), with ``moe_capacity_factor`` lowered on
both sides so that steps drop assignments: every row of a step, pad rows
included, competes for an expert's slots, so the engines agree only if
the port pads, routes and drops as the reference does.  Tokens, finish
reasons, prefix hits, preemptions, iterations, host<->device transfer
counts and pool stats must be equal.  ``forward_fullseq`` / ``loss_fn``
and their gradients are held against ``jax.value_and_grad`` of the
reference's at 1e-5 of the largest value (float32).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.runtime import (
    CacheConfig as JCacheConfig, EngineConfig as JEngineConfig,
    GenerationRequest as JRequest, SamplingParams as JSampling,
    make_engine as j_make_engine,
)
from repro_torch.models import model as M
from repro_torch.models import moe as TMOE
from repro_torch.runtime import (
    CacheConfig, EngineConfig, GenerationRequest, SamplingParams,
    make_engine,
)
import test_torch_engine as TE
import test_torch_sampling as TS

ARCH = "olmoe-1b-7b"
#: low enough that a chunk step of 2 lanes x 8 rows (C = 8 slots for 32
#: assignments over 4 experts) drops assignments
LOW_CF = 0.25


def _pair(arch, **kw):
    jcfg, params, tcfg, model = TE._pair(arch)
    if not kw:
        return jcfg, params, tcfg, model
    return (dataclasses.replace(jcfg, **kw), params,
            dataclasses.replace(tcfg, **kw), model)


@pytest.fixture(scope="module")
def olmoe():
    return _pair(ARCH, moe_capacity_factor=LOW_CF)


@pytest.fixture
def drops(monkeypatch):
    """Records, for every MoE layer call of the port's engine, the rows
    it routed and the assignments past their expert's capacity."""
    seen = []
    real = TMOE.moe_forward

    def spy(cfg, p, x, capacity=None, dropless=False):
        T = x.shape[0] * x.shape[1]
        C = capacity or TMOE._capacity(cfg, T)
        load = TMOE.router_load(cfg, p, x)
        seen.append((T, int((load - C).clamp(min=0).sum())))
        return real(cfg, p, x, capacity, dropless)

    monkeypatch.setattr(TMOE, "moe_forward", spy)
    return seen


@pytest.mark.parametrize("use_kernel", [False, True], ids=["ref", "kernel"])
@pytest.mark.parametrize("page,chunk", [(4, 8), (8, 16)])
def test_moe_engine_matches_jax_with_drops(olmoe, drops, page, chunk,
                                           use_kernel):
    """``test_torch_engine``'s workload (a shared system prompt, more
    requests than lanes, a forced preemption) on 2 lanes; at least one
    step drops assignments."""
    ref, port = TE._both(olmoe, page, chunk, use_kernel)
    assert port == ref
    assert port["preemptions"] == 1
    assert port["pool"]["prefix_hit_tokens"] > 0
    assert {T for T, _ in drops} == {2, 2 * chunk}
    assert sum(d for _, d in drops) > 0


def test_moe_engine_ample_capacity_matches_jax():
    """At the configured capacity factor (1.25) too."""
    ref, port = TE._both(_pair(ARCH), page=4, chunk=8, use_kernel=False)
    assert port == ref


def _greedy_continuations(pair, max_new):
    """Each lockstep prompt's greedy continuation from the reference
    engine, serving it alone."""
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


@pytest.mark.parametrize("use_kernel", [False, True], ids=["ref", "kernel"])
def test_moe_int8_spec_engine_matches_jax(olmoe, drops, use_kernel):
    """An int8 pool and ``spec_k=4`` with replayed drafts (each prompt's
    greedy continuation, corrupted at odd context lengths so that verify
    steps both accept and reject): the verify width changes each step's
    row count and so its capacity, and both engines must still agree on
    every page, token and speculation count."""
    drafter = TS.ReplayDrafter(_greedy_continuations(olmoe, 12),
                               olmoe[2].vocab_size)
    ref, port, _ = TE.lockstep(olmoe, page=4, use_kernel=use_kernel,
                               kv_dtype="int8", spec_k=4, max_new=12,
                               drafter=drafter)
    assert port == ref
    spec_iters, proposed, accepted, rejected = port["spec"]
    assert spec_iters > 0 and accepted > 0 and rejected > 0
    assert port["pool"]["cow"] > 0 and port["pool"]["swapped_in"] > 0
    assert sum(d for _, d in drops) > 0


def test_moe_sampling_matches_jax(olmoe, drops):
    """Odd rids greedy, even rids sampling at temperature 0.8, top-p 0.9,
    with a preemption mid-stream."""
    prompts = TS._prompts(olmoe[2].vocab_size, n=4)
    ref, port = TS._both(olmoe, prompts, TS._sampled, chunk=8,
                         preempt=(0, 3))
    assert port == ref
    assert port["preemptions"] == 1
    assert sum(d for _, d in drops) > 0


# ------------------------------------------------------------- training --
def _fullseq_pair(dtype="float32"):
    jcfg, tcfg = (dataclasses.replace(c, param_dtype=dtype,
                                      moe_capacity_factor=LOW_CF)
                  for c in (TE.j_get_config(ARCH).smoke(),
                            TE.get_config(ARCH).smoke()))
    npp = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                  jax.random.PRNGKey(0)))
    return jcfg, tcfg, npp


def _batch(vocab, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def test_moe_forward_fullseq_and_loss_grads_match_jax():
    """64 rows per layer at capacity factor 0.25: C = 8 slots for 128
    assignments over 4 experts, so most assignments drop and the
    gradients must skip exactly the same ones."""
    jcfg, tcfg, npp = _fullseq_pair()
    batch = _batch(jcfg.vocab_size)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jp = jax.tree.map(jnp.asarray, npp)

    ref_h = np.asarray(JM.forward_fullseq(jcfg, jp, jb["tokens"]))
    model = M.params_from_jax(tcfg, npp, device="cpu")
    with torch.no_grad():
        h = M.forward_fullseq(tcfg, model, tb["tokens"]).numpy()
    np.testing.assert_allclose(h, ref_h, rtol=0,
                               atol=1e-5 * np.abs(ref_h).max())

    jloss, jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, jb))(jp)
    model.requires_grad_(True)
    loss = M.loss_fn(tcfg, model, tb)
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    for path in M.param_shapes(tcfg):
        g = model.param(path).grad
        ref = np.asarray(M.reference_leaf(jgrads, path), np.float32)
        assert g is not None and g.dtype == model.param(path).dtype, path
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=path)
    # the router learns through the gates
    assert float(model.param("layers/0/moe/router").grad.abs().max()) > 0


def test_moe_state_tree_round_trips_reference_layout():
    """``stack_layers`` gives the reference's nested layout for the MoE
    (and shared-expert) leaves, which ``reference_leaf`` reads back."""
    jcfg, tcfg = (dataclasses.replace(c, moe_shared_experts=1)
                  for c in (TE.j_get_config(ARCH).smoke(),
                            TE.get_config(ARCH).smoke()))
    npp = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                  jax.random.PRNGKey(1)))
    model = M.params_from_jax(tcfg, npp, device="cpu")
    tree = M.stack_layers(tcfg, {p: model.param(p)
                                 for p in M.param_shapes(tcfg)})
    assert jax.tree.structure(tree) == jax.tree.structure(npp)
    for path in M.param_shapes(tcfg):
        np.testing.assert_array_equal(
            M.reference_leaf(tree, path).float().numpy(),
            np.asarray(M.reference_leaf(npp, path), np.float32))
    assert len(M.reference_groups(tcfg)) == len(jax.tree.leaves(npp))


# ------------------------------------------------------------ minitron --
def test_minitron_engine_matches_jax():
    """minitron-8b smoke: the ungated (gelu) MLP branch of the layer."""
    ref, port = TE._both(_pair("minitron-8b"), page=8, chunk=8,
                         use_kernel=False)
    assert port == ref
    assert port["preemptions"] == 1


def test_moe_requests_served_by_make_engine_on_cpu():
    """``make_engine`` admits olmoe with the port's own ``init_params``
    (bf16 weights, float32 router) and serves to completion."""
    cfg = TE.get_config(ARCH).smoke()
    model = M.init_params(cfg, seed=0, device="cpu")
    srv = make_engine(cfg, model, EngineConfig(
        cache=CacheConfig(num_pages=16, page_size=4, max_pages_per_seq=8),
        max_lanes=2, chunk=4), device="cpu")
    for rid in range(3):
        srv.submit(GenerationRequest(rid, (1, 2, 3, rid + 4),
                                     SamplingParams(max_new=5)))
    done = srv.run()
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert all(len(r.tokens) == 5 for r in done)
