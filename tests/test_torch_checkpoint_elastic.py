"""Elastic checkpoint restore onto a ``DeviceMesh``, on a real ``gloo``
mesh of four CPU processes (``tests/test_torch_sharded_step.py``'s
harness), against the reference.

One spawn runs both cases:

* the reference's ``tests/test_system.py::test_elastic_reshard_across_meshes``
  at four ranks: an 8 x 8 float32 leaf sharded on a ``(4,)`` ``("data",)``
  mesh is saved (``save_checkpoint``, then again through
  ``AsyncCheckpointer``) and restored onto ``(2, 2)`` ``("data",
  "model")`` with ``(Shard(0), Shard(1))``: the full tensor, the
  placements and each rank's own 4 x 4 block, which is all its local
  storage holds;
* a yi-6b smoke train state: one sharded step on ``(2, 2)`` under the
  megatron profile, saved, restored onto ``(1, 4)`` under the fsdp
  profile (the placements ``tree_placements`` gives there), a second
  step; loss, grad norm and parameters equal the reference's unsharded
  two steps at ``tests/test_torch_train.py``'s float32 bars, summed over
  the two steps.
"""
import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.models import steps as JST
from repro.optim import adamw as JA
from repro_torch.models import model as M
from test_torch_sharded_step import ROOT, WORLD, _batch, _cfgs, _free_port

WORKER = r"""
import dataclasses, pickle, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Shard, distribute_tensor

rank, port, job_path, out_path = (int(sys.argv[1]), sys.argv[2],
                                  sys.argv[3], sys.argv[4])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=4)
from repro_torch.checkpoint.store import (
    AsyncCheckpointer, latest_step, restore_checkpoint, save_checkpoint)
from repro_torch.configs import get_config, smoke_shape
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import model as M
from repro_torch.models import steps as ST
from repro_torch.parallel.sharding import sharding_profile, tree_placements

job = pickle.load(open(job_path, "rb"))
tmp = job["tmp"]
out = {}

# the reference's case
mesh_a = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
x = distribute_tensor(torch.arange(64, dtype=torch.float32).reshape(8, 8),
                      mesh_a, [Shard(0)])
save_checkpoint(tmp + "/elastic", 1, {"x": x})
ck = AsyncCheckpointer(tmp + "/elastic")
ck.save(2, {"x": x * 2})
ck.close()
mesh_b = make_local_mesh(2, 2)
for step in (1, 2):
    got, s = restore_checkpoint(tmp + "/elastic", {"x": x}, step=step,
                                shardings={"x": (Shard(0), Shard(1))},
                                mesh=mesh_b)
    loc = got["x"].to_local()
    mine = {"rank": rank, "coord": list(mesh_b.get_coordinate()),
            "local": loc.numpy().copy(),
            "storage_bytes": loc.untyped_storage().nbytes()}
    every = [None] * 4
    dist.all_gather_object(every, mine)
    out[f"elastic{step}"] = {
        "step": s, "latest": latest_step(tmp + "/elastic"),
        "full": got["x"].full_tensor().numpy(),
        "placements": [repr(p) for p in got["x"].placements],
        "ranks": every}


def fill(dst, full):
    local = distribute_tensor(torch.as_tensor(full).to(dst.dtype),
                              dst.device_mesh, dst.placements).to_local()
    with torch.no_grad():
        dst.to_local().copy_(local)


def state_tree(st):
    return {"params": ST.named_params(st["params"]), "opt": st["opt"]}


cfg = dataclasses.replace(get_config("yi-6b").smoke(), param_dtype="float32")
shape = smoke_shape("train")
opt_cfg = ST.default_opt_cfg(cfg)
fn, (st, batch) = ST.lowerable(cfg, shape, mesh_b, profile=job["save_profile"])
for path in M.param_shapes(cfg):
    fill(st["params"].param(path), job["params"][path])
    fill(st["opt"]["master"][path], job["params"][path])
for k in batch:
    fill(batch[k], job["batches"][0][k])
st, m1 = fn(st, batch)
ck = AsyncCheckpointer(tmp + "/train")
ck.save(1, state_tree(st))
ck.close()

mesh_c = make_local_mesh(*job["restore_mesh"])
profile = job["restore_profile"]
fn, (st2, batch) = ST.lowerable(cfg, shape, mesh_c, profile=profile)
with sharding_profile(profile):
    pl = tree_placements(ST.train_state_specs(cfg, opt_cfg),
                         ST.train_state_axes(cfg, opt_cfg), mesh_c)
tree, step = restore_checkpoint(tmp + "/train", state_tree(st2),
                                shardings=pl, mesh=mesh_c)
moved = []
for (path, dst), (_, src) in zip(
        sorted(ST.named_params(st2["params"]).items()),
        sorted(tree["params"].items())):
    moved.append(tuple(src.placements) == tuple(dst.placements)
                 and src.device_mesh == mesh_c)
    with torch.no_grad():
        dst.to_local().copy_(src.to_local())
for k in ("m", "v", "master"):
    for path, dst in st2["opt"][k].items():
        src = tree["opt"][k][path]
        moved.append(tuple(src.placements) == tuple(dst.placements))
        dst.to_local().copy_(src.to_local())
st2["opt"]["step"].to_local().copy_(tree["opt"]["step"].to_local())
for k in batch:
    fill(batch[k], job["batches"][1][k])
st2, m2 = fn(st2, batch)
out["train"] = {
    "restored_step": step, "moved": all(moved), "n_moved": len(moved),
    "resharded": any(
        tuple(a.placements) != tuple(b.placements)
        for a, b in zip(ST.named_params(st["params"]).values(),
                        ST.named_params(st2["params"]).values())),
    "step1": {"loss": float(m1["loss"].full_tensor())},
    "loss": float(m2["loss"].full_tensor()),
    "grad_norm": float(m2["grad_norm"].full_tensor()),
    "lr": float(m2["lr"].full_tensor()),
    "params": {p: st2["params"].param(p).full_tensor().detach().numpy()
               for p in M.param_shapes(cfg)}}
if rank == 0:
    pickle.dump(out, open(out_path, "wb"))
dist.barrier()
dist.destroy_process_group()
"""

#: the train case's meshes and profiles: saved from (2, 2) under
#: megatron, restored onto (1, 4) under fsdp
SAVE_PROFILE, RESTORE_MESH, RESTORE_PROFILE = "megatron", (1, 4), "fsdp"


def _spawn(job, tmp):
    import os
    import subprocess
    import sys
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


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's two unsharded steps on yi-6b's smoke weights and
    two batches, and what the four ranks returned."""
    jcfg, tcfg = _cfgs("yi-6b")
    npp = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                  jax.random.PRNGKey(0)))
    batches = [_batch(jcfg.vocab_size, seed=s) for s in (0, 1)]
    ocfg = JA.AdamWConfig()
    step = jax.jit(JST.make_train_step(jcfg, ocfg))
    state = {"params": jax.tree.map(jnp.asarray, npp)}
    state["opt"] = JA.init_opt_state(state["params"], ocfg)
    steps = []
    for b in batches:
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        p0 = jax.tree.map(np.asarray, state["params"])
        _, grads = jax.value_and_grad(lambda p: JM.loss_fn(jcfg, p, jb))(
            state["params"])
        state, metrics = step(state, jb)
        steps.append({"p0": p0, "grads": jax.tree.map(np.asarray, grads),
                      "metrics": {k: float(v) for k, v in metrics.items()},
                      "params": jax.tree.map(np.asarray, state["params"])})
    tmp = tmp_path_factory.mktemp("elastic")
    job = {"tmp": str(tmp), "batches": batches,
           "save_profile": SAVE_PROFILE, "restore_mesh": RESTORE_MESH,
           "restore_profile": RESTORE_PROFILE,
           "params": {p: np.asarray(M.reference_leaf(npp, p))
                      for p in M.param_shapes(tcfg)}}
    return {"tcfg": tcfg, "steps": steps, "out": _spawn(job, tmp)}


@pytest.mark.parametrize("step", [1, 2])
def test_elastic_reshard_across_meshes(run, step):
    """Saved from (4,) ("data",) synchronously (step 1) and through
    ``AsyncCheckpointer`` (step 2, the leaf doubled), restored onto (2, 2)
    ("data", "model")."""
    got = run["out"][f"elastic{step}"]
    want = np.arange(64, dtype=np.float32).reshape(8, 8) * step
    assert got["step"] == step and got["latest"] == 2
    np.testing.assert_array_equal(got["full"], want)
    assert got["placements"] == ["Shard(dim=0)", "Shard(dim=1)"]
    coords = set()
    for r in got["ranks"]:
        i, j = r["coord"]
        coords.add((i, j))
        np.testing.assert_array_equal(
            r["local"], want[4 * i:4 * i + 4, 4 * j:4 * j + 4])
        assert r["storage_bytes"] == 16 * 4, "a rank kept more than its shard"
    assert coords == {(0, 0), (0, 1), (1, 0), (1, 1)}


def test_train_state_restored_onto_another_mesh_steps_like_reference(run):
    """The state saved after a megatron step on (2, 2), restored onto
    (1, 4) under fsdp (every leaf with the placements asked for, some
    laid out otherwise than when saved), takes a second step equal to the
    reference's unsharded second step: loss and grad norm within 1e-5
    (relative), every parameter within ``test_torch_train.py``'s float32
    bar of each step, summed over both."""
    got, steps = run["out"]["train"], run["steps"]
    assert got["restored_step"] == 1
    assert got["moved"] and got["n_moved"] > 0 and got["resharded"]
    first, second = steps
    assert abs(got["step1"]["loss"] - first["metrics"]["loss"]) \
        / abs(first["metrics"]["loss"]) < 1e-5
    assert got["lr"] == second["metrics"]["lr"]
    for k in ("loss", "grad_norm"):
        want = second["metrics"][k]
        assert abs(got[k] - want) / abs(want) < 1e-5, k
    for path in M.param_shapes(run["tcfg"]):
        want = np.asarray(M.reference_leaf(second["params"], path))
        p0 = np.abs(np.asarray(M.reference_leaf(first["p0"], path)))
        tol = 1e-6 * p0
        for s in steps:
            g = np.abs(np.asarray(M.reference_leaf(s["grads"], path)))
            lr = s["metrics"]["lr"]
            tol = tol + np.where(g < 1e-5, 2.1 * lr, 1e-3 * lr)
        assert (np.abs(got["params"][path] - want) <= tol).all(), path
