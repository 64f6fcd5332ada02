"""Dry-run: trace every (arch x shape x mesh) cell's sharded step on a fake
production mesh, the port of ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \
        --jobs 8

The reference lowers and compiles each cell ahead of time over 512
virtual XLA devices and reads the compiled module's memory analysis,
cost analysis and HLO.  Here the step is the port's eager one
(``models.steps.lowerable``): its arguments are DTensors of fake tensors
over a ``DeviceMesh`` of a fake process group of the mesh's size
(``launch.mesh.make_production_mesh``), and one run of it under
``launch.step_stats.StepStats`` yields the same accounts for one device:

* ``memory.argument_size_in_bytes``: the bytes of the arguments' local
  shards (state and batch, or params, cache and batch);
* ``memory.temp_size_in_bytes``: the most bytes the step's own local
  tensors hold at once (activations, gradients, temporaries);
* ``cost.flops`` / ``dot_flops``: the FLOPs ``FlopCounterMode`` counts,
  and those of its matrix products, on the local shards;
  ``kernel_flops`` the part inside the plain versions that stand in for
  hand-written kernels (the flash forward);
* ``collectives`` / ``collective_bytes``: per kind count, operand and
  result bytes, and their ring-weighted sum; ``local_regions`` the
  collectives that lay out the inputs of each ``local_map`` region.

``trace_s`` (the run's wall time) stands in for the reference's
``lower_s`` and ``compile_s``.  Nothing is compiled, so ``--keep-hlo``
has no counterpart.  ``--jobs N`` traces N cells at once, each worker
process with a fake process group of its own.  Records land in
``artifacts/dryrun_torch/<arch>__<shape>__<mesh>[__<profile>].json``.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from repro_torch.configs import SHAPES, all_cells, get_config, get_shape
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.step_stats import StepStats, dtensor_tracing
from repro_torch.models import steps as ST

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / \
    "dryrun_torch"


def _tensors(tree) -> List[torch.Tensor]:
    """Every tensor of a step's arguments: a model's parameters, the
    leaves of nested dicts, lists and tuples."""
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def trace_step(cfg: ArchConfig, shape: ShapeSpec, mesh,
               profile: str = "megatron", opt_cfg=None,
               compress: bool = False) -> Dict[str, Any]:
    """One run of ``shape``'s sharded step on fake tensors over ``mesh``:
    the record's ``devices``, ``trace_s``, ``memory`` and the
    :meth:`StepStats.record` fields."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.perf_counter()
    with FakeTensorMode(), dtensor_tracing():
        fn, args = ST.lowerable(cfg, shape, mesh, opt_cfg, compress,
                                profile=profile)
        stats = StepStats()
        arg_bytes = stats.track(_tensors(args))
        with stats:
            fn(*args)
    rec = {"devices": mesh.size(),
           "trace_s": round(time.perf_counter() - t0, 2),
           "memory": {"argument_size_in_bytes": arg_bytes,
                      "temp_size_in_bytes": stats.temp_bytes}}
    rec.update(stats.record())
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             profile: str = "megatron") -> dict:
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    ok, why = cfg.shape_applicable(shape)
    mesh_name = "multi" if multi_pod else "single"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "kind": shape.kind, "seq_len": shape.seq_len,
           "global_batch": shape.global_batch, "profile": profile}
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    rec.update(status="ok", **trace_step(cfg, shape, mesh, profile))
    return rec


def _run_or_record(arch: str, shape_name: str, multi_pod: bool,
                   profile: str) -> dict:
    """:func:`run_cell`, a failure recorded as the cell's ``error``."""
    try:
        return run_cell(arch, shape_name, multi_pod, profile)
    except Exception as e:  # noqa: BLE001 - record and go on
        return {"arch": arch, "shape": shape_name,
                "mesh": "multi" if multi_pod else "single",
                "profile": profile, "status": "error",
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-4000:]}


def _worker_run(task) -> dict:
    try:
        return _run_or_record(*task)
    finally:
        mesh_lib.release_fake_world()


def cell_path(arch: str, shape: str, mesh: str,
              profile: str = "megatron") -> Path:
    suffix = "" if profile == "megatron" else f"__{profile}"
    return ARTIFACTS / f"{arch}__{shape}__{mesh}{suffix}.json"


def summary(rec: dict) -> str:
    """The reference's one-line summary of a cell."""
    status = rec["status"]
    extra = ""
    if status == "ok":
        mem = rec["memory"]
        extra = (f"args={mem['argument_size_in_bytes'] / 2**30:.2f}GiB "
                 f"tmp={mem['temp_size_in_bytes'] / 2**30:.2f}GiB "
                 f"flops={rec['cost']['flops']:.3e} "
                 f"coll={rec['collective_bytes'] / 2**30:.3f}GiB "
                 f"trace={rec['trace_s']}s")
    elif status == "error":
        extra = rec["error"][:160]
    elif status == "skipped":
        extra = rec["reason"][:80]
    return (f"[{status:7s}] {rec['arch']:18s} {rec['shape']:12s} "
            f"{rec['mesh']:6s} {extra}")


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--profile", default="megatron",
                    choices=["megatron", "fsdp", "serve"])
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, one process each")
    args = ap.parse_args(argv)

    ARTIFACTS.mkdir(parents=True, exist_ok=True)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.all:
        cells = [(cfg.name, shape.name) for cfg, shape, _, _ in all_cells()]
    elif args.arch:
        shapes = [args.shape] if args.shape else list(SHAPES)
        cells = [(args.arch, s) for s in shapes]
    else:
        ap.error("name --arch (and --shape), or --all")

    tasks = [(arch, shape_name, mp, args.profile)
             for arch, shape_name in cells for mp in meshes]
    n_fail = 0
    t0 = time.perf_counter()

    def done(rec):
        nonlocal n_fail
        n_fail += rec["status"] == "error"
        cell_path(rec["arch"], rec["shape"], rec["mesh"],
                  args.profile).write_text(
            json.dumps(rec, indent=2, default=str))
        print(summary(rec), flush=True)

    if args.jobs > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        with ProcessPoolExecutor(
                args.jobs,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            for rec in pool.map(_worker_run, tasks):
                done(rec)
    else:
        try:
            for task in tasks:
                done(_run_or_record(*task))
        finally:
            mesh_lib.release_fake_world()
    print(f"dry-run wall {time.perf_counter() - t0:.1f} s", flush=True)
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")
    print("DRY-RUN COMPLETE")


if __name__ == "__main__":
    main()
