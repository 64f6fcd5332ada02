"""The sharded step's numbers, on a real ``gloo`` mesh of four CPU
processes, (2, 2) or (1, 4).

``models.steps.lowerable`` lays the train state and the batch over a
("data", "model") mesh as DTensors by their logical axes (megatron
profile: ZeRO over ``data``, heads / ff / vocab / experts over
``model``), and the eager train step runs on them: DTensor's own
sharding, and the regions it cannot propagate under ``local_map``
(``parallel.sharding.local_region``; each run must take the regions
:data:`JOBS` names).  One smoke train step of yi-6b, olmoe-1b-7b,
hymba-1.5b and xlstm-350m must give the loss, the grad norm and the
updated parameters of the reference's *unsharded* ``make_train_step`` on
the same weights and batch, within the float32 bars of
``tests/test_torch_train.py`` (xlstm's ill-conditioned gradients at
their own bar, :data:`ILL_GRAD_BAR`); so must the port's unsharded step.
(The reference's own ``lowerable`` cannot run under jax 0.9: its
sharding constraints name mesh axes ``jax.make_mesh`` now makes
Explicit.)

olmoe runs at ``moe_capacity_factor = E / k``, where no assignment
drops: with drops, each data shard's routing (the reference's
``_moe_shardmap`` routes each shard's rows on their own) rightly differs
from one global route.  One more olmoe step at the registered 1.25 holds
each dispatch group's drops against a plain count over the rows that
group routed.  hymba-1.5b's and xlstm-350m's steps run the Mamba, mLSTM
and sLSTM scans by heads / channels, and the sLSTM's gate-by-gate
projection.

Smoke decode steps, twelve tokens on from an empty cache of 32 slots
(so that a cache split four ways over its slots holds live keys on two
devices), give each step's logits of the reference's unsharded ``decode_forward``: yi-6b at
(2, 2) (the K/V cache split over heads) and at (1, 4) (2 kv heads do not
divide 4: the cache's slots split over ``model``, the softmax combined
across them); deepseek-v2-236b at (1, 4) (MLA's absorbed decode over a
compressed cache split over ``sp``, and ``_moe_gspmd``: two tokens a
step, fewer than the experts); whisper-medium at (2, 2) (the
cross-attention decode over the reference's cross cache, the decoder's
vocab-parallel position lookup).

The four processes are spawned once per arch, each with a timeout.
"""
import dataclasses
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as JM
from repro.models import steps as JST
from repro.optim import adamw as JA
from repro_torch.configs import get_config, smoke_shape
from repro_torch.models import model as M
from repro_torch.models import steps as ST
from repro_torch.optim import adamw as A

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4

WORKER = r"""
import dataclasses, pickle, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor

rank, port, job_path, out_path = (int(sys.argv[1]), sys.argv[2],
                                  sys.argv[3], sys.argv[4])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=4)
from repro_torch.configs import get_config, smoke_shape
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import attention as AT
from repro_torch.models import layers as LY
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SS
from repro_torch.models import steps as ST

job = pickle.load(open(job_path, "rb"))
mesh = make_local_mesh(2, 2)


def fill(dst, full):
    local = distribute_tensor(torch.as_tensor(full).to(dst.dtype),
                              dst.device_mesh, dst.placements).to_local()
    with torch.no_grad():
        dst.to_local().copy_(local)


drops, routers = [], []
route, dispatch = MOE._route, MOE._dispatch


def recording_route(cfg, router, xf):
    routers.append(router.detach().numpy().copy())
    return route(cfg, router, xf)


def recording_dispatch(cfg, xf, expert_idx, C):
    buf, meta = dispatch(cfg, xf, expert_idx, C)
    drops.append({"rank": rank, "rows": xf.detach().numpy().copy(),
                  "router": routers[-1], "C": C,
                  "dropped": int((~meta[2]).sum())})
    return buf, meta


MOE._route, MOE._dispatch = recording_route, recording_dispatch
regions = set()


def recording_regions(mod):
    real = mod.local_region

    def region(name, *args):
        regions.add(name)
        return real(name, *args)
    mod.local_region = region


for mod in (AT, LY, MOE, SS):
    recording_regions(mod)
results = {}
for name, kw in job["runs"]:
    cfg = dataclasses.replace(get_config(job["arch"]).smoke(),
                              param_dtype="float32", **kw)
    fn, (st, batch) = ST.lowerable(cfg, smoke_shape("train"), mesh)
    for path in M.param_shapes(cfg):
        fill(st["params"].param(path), job["params"][path])
        fill(st["opt"]["master"][path], job["params"][path])
    for k in batch:
        fill(batch[k], job["batch"][k])
    drops.clear()
    regions.clear()
    st, metrics = fn(st, batch)
    every = [None] * 4
    dist.all_gather_object(every, list(drops))
    results[name] = {
        "loss": float(metrics["loss"].full_tensor()),
        "grad_norm": float(metrics["grad_norm"].full_tensor()),
        "lr": float(metrics["lr"].full_tensor()),
        "params": {p: st["params"].param(p).full_tensor().detach().numpy()
                   for p in M.param_shapes(cfg)},
        "drops": [c for r in every for c in r],
        "regions": sorted(regions)}
cfg = dataclasses.replace(get_config(job["arch"]).smoke(),
                          param_dtype="float32")
for layout in job.get("decode", ()):
    fn, (params, cache, dbatch) = ST.lowerable(
        cfg, smoke_shape("decode"), make_local_mesh(*layout))
    for path in M.param_shapes(cfg):
        fill(params.param(path), job["params"][path])
    for key, layers in job.get("cross", {}).items():
        for dst, full in zip(cache[key], layers):
            fill(dst, full)
    logits = []
    regions.clear()
    for t, toks in enumerate(job["decode_tokens"]):
        fill(dbatch["tokens"], toks)
        fill(dbatch["pos"], np.full((toks.shape[0],), t, np.int32))
        out, cache = fn(params, cache, dbatch)
        logits.append(out.full_tensor().numpy())
    results[f"decode{layout}"] = {"logits": logits,
                                  "regions": sorted(regions)}
if rank == 0:
    pickle.dump(results, open(out_path, "wb"))
dist.barrier()
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(job, tmp: Path):
    job_path, out_path = tmp / "job.pkl", tmp / "out.pkl"
    job_path.write_bytes(pickle.dumps(job))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), port, str(job_path),
         str(out_path)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return pickle.loads(out_path.read_bytes())


def _cfgs(arch, **kw):
    return (dataclasses.replace(j_get_config(arch).smoke(),
                                param_dtype="float32", **kw),
            dataclasses.replace(get_config(arch).smoke(),
                                param_dtype="float32", **kw))


def _batch(vocab, B=4, S=32, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _no_drops(arch):
    c = get_config(arch).smoke()
    return {"moe_capacity_factor": c.moe_num_experts / c.moe_top_k} \
        if c.moe_num_experts else {}


def _reference(arch, kw):
    """The weights, the batch, the reference's unsharded step (and its
    gradients, for the bars) and the port's unsharded step on them."""
    jcfg, tcfg = _cfgs(arch, **kw)
    npp = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                  jax.random.PRNGKey(0)))
    batch = _batch(jcfg.vocab_size)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    _, jgrads = jax.value_and_grad(lambda p: JM.loss_fn(jcfg, p, jb))(
        jax.tree.map(jnp.asarray, npp))
    ocfg = JA.AdamWConfig()
    jstate = {"params": jax.tree.map(jnp.asarray, npp)}
    jstate["opt"] = JA.init_opt_state(jstate["params"], ocfg)
    jstate, jm = jax.jit(JST.make_train_step(jcfg, ocfg))(jstate, jb)
    state = ST.init_train_state(tcfg, A.AdamWConfig(),
                                params=M.params_from_jax(tcfg, npp, "cpu"))
    state, m = ST.make_train_step(tcfg, A.AdamWConfig())(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    port = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "lr": float(m["lr"]),
            "params": {p: state["params"].param(p).detach().numpy()
                       for p in M.param_shapes(tcfg)}}
    return dict(tcfg=tcfg, npp=npp, batch=batch, jgrads=jgrads,
                jstate=jstate, jm=jm, port=port)


def _decode_tokens(vocab, steps=12, B=2, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (B, 1)).astype(np.int32)
            for _ in range(steps)]


def _reference_decode(jcfg, npp, tokens, T, seed=2):
    """The reference's unsharded ``decode_forward`` over ``tokens`` from
    an empty cache of ``T`` slots: each step's logits, and for an
    encoder-decoder the cross cache it fills from stub frames (the
    decoder layers' ``xk`` / ``xv``, which the sharded side is given)."""
    p = jax.tree.map(jnp.asarray, npp)
    B = tokens[0].shape[0]
    cache = JM.init_cache(jcfg, B, T)
    cross = {}
    if jcfg.block_kind == "encdec":
        frames = (np.random.default_rng(seed).standard_normal(
            (B, jcfg.frontend_seq, jcfg.d_model)) * 0.02).astype(np.float32)
        cache["xk"], cache["xv"] = JM.encdec_cross_cache(
            jcfg, p, jnp.asarray(frames))
        cross = {k: list(np.asarray(cache[k])) for k in ("xk", "xv")}
    step = jax.jit(lambda p, c, t, pos: JM.decode_forward(jcfg, p, c, t, pos))
    out = []
    for t, toks in enumerate(tokens):
        logits, cache = step(p, cache, jnp.asarray(toks),
                             jnp.full((B,), t, jnp.int32))
        out.append(np.asarray(logits, np.float32))
    return out, cross


#: arch -> the ``local_map`` regions (``parallel.sharding.local_region``)
#: its sharded train step runs, None for no train step, and per decode
#: layout the regions its decode steps run
JOBS = {
    "yi-6b": ({"attention", "lookup"},
              {(2, 2): {"decode_attention", "lookup", "positions"},
               (1, 4): {"decode_attention", "lookup", "positions",
                        "whole_heads"}}),
    "olmoe-1b-7b": ({"attention", "lookup", "moe_shardmap"}, {}),
    "hymba-1.5b": ({"attention", "lookup", "mamba"}, {}),
    "xlstm-350m": ({"lookup", "mlstm", "slstm"}, {}),
    "deepseek-v2-236b": (None, {(1, 4): {"lookup", "mla_decode",
                                         "moe_combine", "moe_route",
                                         "positions"}}),
    "whisper-medium": (None, {(2, 2): {"cross_attention", "decode_attention",
                                       "lookup", "positions"}})}
RUNS = {}


def _run(arch, tmp_path_factory):
    """The reference's side of ``arch``'s :data:`JOBS` entry and what the
    four ranks returned (``out``)."""
    if arch in RUNS:
        return RUNS[arch]
    train, layouts = JOBS[arch]
    train, layouts = train is not None, list(layouts)
    kw = _no_drops(arch)
    if train:
        ref = _reference(arch, kw)
    else:
        jcfg, tcfg = _cfgs(arch)
        ref = dict(tcfg=tcfg, npp=jax.tree.map(np.asarray, JM.init_params(
            jcfg, jax.random.PRNGKey(0))))
    tcfg = ref["tcfg"]
    job = {"arch": arch, "runs": [], "decode": layouts,
           "params": {p: np.asarray(M.reference_leaf(ref["npp"], p))
                      for p in M.param_shapes(tcfg)}}
    if train:
        job["batch"] = ref["batch"]
        job["runs"].append(("step", kw))
    if train and tcfg.moe_num_experts:
        job["runs"].append(("registered", {}))
    if layouts:
        job["decode_tokens"] = _decode_tokens(tcfg.vocab_size)
        ref["decode"], job["cross"] = _reference_decode(
            _cfgs(arch)[0], ref["npp"], job["decode_tokens"],
            tcfg.cache_len(smoke_shape("decode")))
    ref["out"] = _spawn(job, tmp_path_factory.mktemp(arch))
    RUNS[arch] = ref
    return ref


#: xlstm-350m's float32 gradients are ill-conditioned: they stand up to
#: 2.7e-4 of a leaf's largest |g| off a float64 evaluation in the
#: reference and 6.6e-5 in the port (``tests/test_torch_ssm.py``'s
#: ``GRAD_BAR_F32``, 4e-4), so any other order of summation, a sharded
#: one too, moves them that far.  There the grad norm is held at that bar
#: (relative), and a gradient within it of zero may flip its update.
ILL_GRAD_BAR = {"xlstm-350m": 4e-4}


def _check_step(arch, ref, got):
    """``tests/test_torch_train.py``'s float32 bars (:data:`ILL_GRAD_BAR`
    for an ill-conditioned family's grad norm and sign-flip threshold)."""
    jm, bar = ref["jm"], ILL_GRAD_BAR.get(arch)
    assert got["lr"] == float(jm["lr"])
    for k, rel in (("loss", 1e-5), ("grad_norm", bar or 1e-5)):
        assert abs(got[k] - float(jm[k])) / abs(float(jm[k])) < rel, k
    lr = got["lr"]
    for path in M.param_shapes(ref["tcfg"]):
        want = np.asarray(M.reference_leaf(ref["jstate"]["params"], path))
        p0 = np.abs(np.asarray(M.reference_leaf(ref["npp"], path)))
        g = np.abs(np.asarray(M.reference_leaf(ref["jgrads"], path)))
        small = max(1e-5, (bar or 0) * g.max())
        tol = 1e-6 * p0 + np.where(g < small, 2.1 * lr, 1e-3 * lr)
        assert (np.abs(got["params"][path] - want) <= tol).all(), path


@pytest.mark.parametrize("arch", [a for a, (train, _) in JOBS.items()
                                  if train is not None])
@pytest.mark.parametrize("side", ["sharded", "unsharded"])
def test_train_step_matches_reference_unsharded(arch, side,
                                                tmp_path_factory):
    ref = _run(arch, tmp_path_factory)
    got = ref["out"]["step"] if side == "sharded" else ref["port"]
    if side == "sharded":
        assert set(got["regions"]) == JOBS[arch][0]
    _check_step(arch, ref, got)


def test_olmoe_no_drops_at_e_over_k(tmp_path_factory):
    """At capacity factor E / k every dispatch group keeps every
    assignment, so one global route and the shard-local ones agree."""
    calls = _run("olmoe-1b-7b", tmp_path_factory)["out"]["step"]["drops"]
    assert calls and all(c["dropped"] == 0 for c in calls)


def test_olmoe_registered_capacity_drops_per_group(tmp_path_factory):
    """At the registered 1.25, each dispatch group (the rows of one data
    shard, routed alike by both ranks of its model pair) drops what a
    plain count over its own rows says: the assignments past each
    expert's C-th slot."""
    ref = _run("olmoe-1b-7b", tmp_path_factory)
    calls = ref["out"]["registered"]["drops"]
    E, k = ref["tcfg"].moe_num_experts, ref["tcfg"].moe_top_k
    B, S = smoke_shape("train").global_batch, smoke_shape("train").seq_len
    assert {c["rank"] for c in calls} == set(range(WORLD))
    total = 0
    for c in calls:
        assert c["rows"].shape[0] == B // 2 * S     # one data shard's rows
        assert c["C"] == 40          # int(64 * 2 * 1.25 / 4), a multiple of 8
        idx = torch.topk(torch.from_numpy(c["rows"]).float()
                         @ torch.from_numpy(c["router"]), k, dim=-1).indices
        load = torch.bincount(idx.reshape(-1), minlength=E)
        assert c["dropped"] == int((load - c["C"]).clamp(min=0).sum())
        total += c["dropped"]
    assert total > 0, "no assignment dropped at 1.25: the check is vacuous"


def _check_decode(arch, layout, tmp_path_factory):
    """The decode ran its :data:`JOBS` regions, and each sharded step's
    logits are within 1e-5 of the reference's largest |logit|
    (``tests/test_torch_decode.py``'s bar)."""
    ref = _run(arch, tmp_path_factory)
    got = ref["out"][f"decode{layout}"]
    assert set(got["regions"]) == JOBS[arch][1][layout]
    got = got["logits"]
    assert len(got) == len(ref["decode"])
    for t, (g, w) in enumerate(zip(got, ref["decode"])):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max(),
                                   err_msg=f"step {t}")


@pytest.mark.parametrize("layout", list(JOBS["yi-6b"][1]))
def test_yi_decode_matches_unsharded(layout, tmp_path_factory):
    _check_decode("yi-6b", layout, tmp_path_factory)


@pytest.mark.parametrize("arch,layout", [
    (a, lay) for a, (_, lays) in JOBS.items() if a != "yi-6b"
    for lay in lays])
def test_decode_matches_reference_unsharded(arch, layout, tmp_path_factory):
    _check_decode(arch, layout, tmp_path_factory)
