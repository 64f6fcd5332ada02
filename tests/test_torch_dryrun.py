"""The dry-run (``launch.dryrun.trace_step``) at smoke size on fake meshes.

Each mesh's cells are traced in a subprocess of their own (a fake
process group of the mesh's size lives and dies with it), all started
at once by a module fixture; the assertions are parametrized over the
records, so each cell counts:

* every arch x {train, prefill, decode} x profile at (2, 2) is ``ok``,
  and its argument bytes equal the reference's own count: the local
  shard bytes of its ``param_specs`` / ``train_state_specs`` /
  ``cache_specs`` and inputs under its ``logical_pspec`` on a (2, 2)
  mesh (a JAX subprocess with 4 virtual devices);
* at a one-device mesh, ``cost.flops`` equals ``FlopCounterMode`` over
  the same step run eagerly on real CPU tensors;
* at (2, 2) under ``fsdp`` (batch over all four devices, weights
  gathered) a dense arch's train step costs each device exactly a
  quarter of the global FLOPs; under ``megatron`` at (2, 8), where the
  smoke config's 4 heads do not divide ``model``, more than a
  sixteenth, because the heads' work is repeated on every device;
* a hand-checked two-way tensor-parallel MLP records exactly one
  all-gather and one reduce-scatter of the expected bytes;
* ``total_collective_bytes`` equals the reference's on the same dicts;
* olmoe's and deepseek's prefill record one all-to-all pair per MoE
  layer inside the expert-parallel region.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs import get_config, list_archs
from repro_torch.launch.step_stats import total_collective_bytes

ROOT = Path(__file__).resolve().parents[1]
KINDS = ("train", "prefill", "decode")
PROFILES = ("megatron", "fsdp", "serve")
DENSE = ("yi-6b", "gemma2-2b", "minitron-8b", "qwen3-32b", "pixtral-12b",
         "hymba-1.5b", "xlstm-350m", "whisper-medium")

TRACE = r"""
import json, sys
import torch
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import get_config, smoke_shape
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.dryrun import trace_step
from repro_torch.models import model as M
from repro_torch.models import steps as ST


def eager(cfg, kind):
    # FlopCounterMode over the unsharded step on real CPU tensors
    shape = smoke_shape(kind)
    batch = ST.make_batch(cfg, shape, torch.Generator().manual_seed(0))
    if kind == "train":
        st = ST.init_train_state(cfg, ST.default_opt_cfg(cfg), 0,
                                 device="cpu")
        step, args = ST.make_train_step(cfg), (st, batch)
    elif kind == "prefill":
        step = ST.make_prefill_step(cfg)
        args = (M.init_params(cfg, 0, "cpu"), batch)
    else:
        step = ST.make_decode_step(cfg)
        args = (M.init_params(cfg, 0, "cpu"),
                M.init_cache(cfg, shape.global_batch, cfg.cache_len(shape),
                             "cpu"), batch)
    with FlopCounterMode(display=False) as fc:
        step(*args)
    return fc.get_total_flops()


mesh_shape, cells = json.loads(sys.argv[1]), json.loads(sys.argv[2])
mesh = mesh_lib.make_local_mesh(*mesh_shape)
out = {}
for arch, kind, profile, with_eager in cells:
    key = f"{arch}|{kind}|{profile}"
    cfg = get_config(arch).smoke()
    try:
        rec = trace_step(cfg, smoke_shape(kind), mesh, profile)
        rec["status"] = "ok"
    except Exception as e:  # the test reports the cell
        rec = {"status": "error", "error": f"{type(e).__name__}: {e}"}
    if with_eager:
        rec["eager_flops"] = eager(cfg, kind)
    out[key] = rec
if len(mesh_shape) == 2 and mesh_shape[0] == 1 and mesh_shape[1] == 2:
    # a two-way TP MLP: sequence-parallel input gathered, the row-parallel
    # product reduce-scattered back
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed import tensor as dt
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch.step_stats import StepStats, dtensor_tracing
    from repro_torch.parallel.sharding import mesh_context, shard
    with FakeTensorMode(), dtensor_tracing(), mesh_context(mesh):
        x = dt.zeros((4, 8, 16), dtype=torch.bfloat16, device_mesh=mesh,
                     placements=(Replicate(), Shard(1)))
        w_up = dt.zeros((16, 32), dtype=torch.bfloat16, device_mesh=mesh,
                        placements=(Replicate(), Shard(1)))
        w_down = dt.zeros((32, 16), dtype=torch.bfloat16, device_mesh=mesh,
                          placements=(Replicate(), Shard(0)))
        stats = StepStats()
        with stats:
            h = shard(x, "dp", None, None)
            y = shard(torch.relu(h @ w_up) @ w_down, "dp", "sp", None)
        out["mlp"] = {"collectives": stats.record()["collectives"],
                      "shape": list(y.shape), "local": list(y.to_local().shape)}
mesh_lib.release_fake_world()
print(json.dumps(out))
"""

REFERENCE = r"""
import json, math, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import numpy as np
from repro.configs import get_config, smoke_shape
from repro.models import model as JM
from repro.models import steps as JST
from repro.parallel.sharding import (Axes, logical_pspec, mesh_context,
                                     sharding_profile)

mesh = jax.make_mesh((2, 2), ("data", "model"))
out = {}


def shard_bytes(specs, axes):
    flat_s = jax.tree_util.tree_leaves(specs)
    flat_a = jax.tree_util.tree_leaves(
        axes, is_leaf=lambda x: isinstance(x, Axes))
    total = 0
    for sds, ax in zip(flat_s, flat_a):
        n = math.prod(sds.shape) * np.dtype(sds.dtype).itemsize
        for e in logical_pspec(sds.shape, ax.axes, mesh):
            for a in ((e,) if isinstance(e, str) else e or ()):
                n //= mesh.shape[a]
        total += n
    return total


for arch, kind, profile in json.loads(sys.argv[1]):
    cfg = get_config(arch).smoke()
    shape = smoke_shape(kind)
    with sharding_profile(profile), mesh_context(mesh):
        n = shard_bytes(JST.input_specs(cfg, shape),
                        JST.input_axes(cfg, shape))
        if kind == "train":
            ocfg = JST.default_opt_cfg(cfg)
            n += shard_bytes(JST.train_state_specs(cfg, ocfg),
                             JST.train_state_axes(cfg, ocfg))
        else:
            n += shard_bytes(JM.param_specs(cfg), JM.param_axes(cfg))
        if kind == "decode":
            B, T = shape.global_batch, max(cfg.cache_len(shape), 1)
            n += shard_bytes(JM.cache_specs(cfg, B, T),
                             JM.cache_axes(cfg, B, T))
    out[f"{arch}|{kind}|{profile}"] = n
print(json.dumps(out))
"""

CELLS_2x2 = [(a, k, p) for a in list_archs() for k in KINDS for p in PROFILES]
CELLS_1x1 = [(a, k, "megatron") for a in list_archs() for k in KINDS]


def _env(**extra):
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "OMP_NUM_THREADS": "1", **extra}


@pytest.fixture(scope="module")
def records():
    """Every mesh's traces and the reference's byte counts, the
    subprocesses run side by side."""
    jobs = {
        "2x2/" + p: ([2, 2], [c + ((c[0] in DENSE and c[1] == "train"
                                    and p == "fsdp"),)
                              for c in CELLS_2x2 if c[2] == p])
        for p in PROFILES}
    half = len(CELLS_1x1) // 2
    jobs["1x1/a"] = ([1, 1], [c + (True,) for c in CELLS_1x1[:half]])
    jobs["1x1/b"] = ([1, 1], [c + (True,) for c in CELLS_1x1[half:]])
    jobs["2x8"] = ([2, 8], [("hymba-1.5b", "train", "megatron", True)])
    jobs["1x2"] = ([1, 2], [])
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", TRACE, json.dumps(m), json.dumps(c)],
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name, (m, c) in jobs.items()}
    procs["reference"] = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, json.dumps(CELLS_2x2)],
        env=_env(JAX_PLATFORMS="cpu"), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    out = {}
    try:
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=600)
            assert p.returncode == 0, (name, stderr[-4000:])
            out[name] = json.loads(stdout.strip().splitlines()[-1])
    finally:
        for p in procs.values():
            p.kill()
    two = {}
    for p in PROFILES:
        two.update(out["2x2/" + p])
    return {"2x2": two, "1x1": {**out["1x1/a"], **out["1x1/b"]},
            "2x8": out["2x8"], "1x2": out["1x2"],
            "reference": out["reference"]}


@pytest.mark.parametrize("cell", CELLS_2x2, ids="|".join)
def test_every_cell_traces_and_its_argument_bytes_are_the_references(
        records, cell):
    key = "|".join(cell)
    rec = records["2x2"][key]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["devices"] == 4
    assert rec["memory"]["argument_size_in_bytes"] == \
        records["reference"][key]
    assert rec["memory"]["temp_size_in_bytes"] > 0
    assert rec["cost"]["flops"] >= rec["dot_flops"] > 0
    assert rec["collective_bytes"] == total_collective_bytes(
        rec["collectives"])


@pytest.mark.parametrize("cell", CELLS_1x1, ids="|".join)
def test_one_device_flops_equal_flop_counter_mode(records, cell):
    rec = records["1x1"]["|".join(cell)]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["cost"]["flops"] == rec["eager_flops"]
    if cell[1] == "decode" or cell[0] == "xlstm-350m":
        assert rec["kernel_flops"] == 0          # no flash attention
    else:
        assert 0 < rec["kernel_flops"] < rec["cost"]["flops"]


@pytest.mark.parametrize("arch", DENSE)
def test_fsdp_splits_a_dense_train_step_four_ways(records, arch):
    rec = records["2x2"][f"{arch}|train|fsdp"]
    assert rec["cost"]["flops"] * 4 == rec["eager_flops"]


def test_heads_megatron_cannot_split_are_computed_on_every_device(records):
    """hymba's smoke config has 4 heads; ``model`` is 8 wide."""
    rec = records["2x8"]["hymba-1.5b|train|megatron"]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["cost"]["flops"] * 16 > rec["eager_flops"]
    assert "whole_heads" in rec["local_regions"]


def test_two_way_tp_mlp_collectives(records):
    """x (4, 8, 16) bf16 split over the sequence: the all-gather moves
    its 512-byte half in and 1,024 bytes out; the row-parallel product's
    partial sums (4, 8, 16) bf16 are reduce-scattered back to halves."""
    mlp = records["1x2"]["mlp"]
    assert mlp["collectives"] == {
        "all-gather": {"count": 1, "operand_bytes": 512,
                       "result_bytes": 1024},
        "reduce-scatter": {"count": 1, "operand_bytes": 1024,
                           "result_bytes": 512}}
    assert mlp["local"] == [4, 4, 16]
    assert total_collective_bytes(mlp["collectives"]) == 2048


def test_total_collective_bytes_is_the_references():
    from repro.launch.hlo_stats import total_collective_bytes as ref
    stats = {"all-reduce": {"count": 3, "operand_bytes": 100.0,
                            "result_bytes": 100.0},
             "all-gather": {"count": 2, "operand_bytes": 10.0,
                            "result_bytes": 160.0},
             "reduce-scatter": {"count": 1, "operand_bytes": 64.0,
                                "result_bytes": 4.0},
             "all-to-all": {"count": 4, "operand_bytes": 48.0,
                            "result_bytes": 48.0}}
    assert total_collective_bytes(stats) == ref(stats) == 472.0


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-236b"])
def test_moe_records_one_all_to_all_pair_per_layer(records, arch):
    cfg = get_config(arch).smoke()
    moe_layers = cfg.num_layers - (cfg.moe_first_dense_layers or 0)
    rec = records["2x2"][f"{arch}|prefill|megatron"]
    region = rec["local_regions"]["moe_shardmap"]
    assert region["kinds"].get("all-to-all") == 2 * moe_layers
