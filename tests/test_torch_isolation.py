"""The port stands alone: importing every ``repro_torch`` module and
``chip_smoke.py`` pulls in neither JAX, nor ``ml_dtypes``, nor the
reference package."""
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
mods = sorted(m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch."))
for m in mods:
    importlib.import_module(m)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "jaxlib"))
                or m == "repro" or m.startswith("repro.")
                or m == "ml_dtypes" or m.startswith("ml_dtypes."))
print(json.dumps({"modules": mods, "leaked": leaked}))
"""


def test_port_imports_neither_jax_nor_reference():
    """Nor ``ml_dtypes``: the GPU machine has none."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)])}
    r = subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["leaked"] == []
    expected = {f"repro_torch.{m.name}" for m in pkgutil.walk_packages(
        [str(ROOT / "src" / "repro_torch")])}
    assert "repro_torch.runtime.server" in out["modules"]
    assert "repro_torch.kernels.paged_attention.kernel" in out["modules"]
    assert "repro_torch.optim.compress" in out["modules"]
    assert "repro_torch.runtime.speculative" in out["modules"]
    for m in ("core.svm", "core.analysis", "core.cluster", "core.buildflow",
              "configs.hero_pmca", "kernels.cluster_matmul.kernel",
              "kernels.cluster_matmul.ops", "kernels.cluster_matmul.ref",
              "hero.svm_offload_demo", "hero.fig5_svm_offload",
              "hero.fig6_event_tracing", "configs.gemma2_2b",
              "kernels.flash_attention.kernel", "kernels.flash_attention.ops",
              "kernels.flash_attention.ref", "models.attention",
              "models.steps", "optim.adamw", "data.pipeline",
              "checkpoint.store", "runtime.trainer", "launch.train",
              "runtime.faults", "core.roofline", "launch.mesh",
              "launch.load_gen", "planner.workload", "planner.simulator",
              "planner.costs", "planner.capacity", "models.moe",
              "configs.olmoe_1b_7b", "configs.minitron_8b", "models.ssm",
              "configs.xlstm_350m", "configs.hymba_1p5b",
              "launch.quickstart", "parallel", "parallel.sharding",
              "runtime.sharded_server", "launch.serve", "launch.dryrun",
              "launch.step_stats", "hero.roofline_table",
              "hero.tab2_resources", "hero.fig4_cluster_speedup",
              "hero.run", "launch.train_100m", "launch.serve_paged"):
        assert f"repro_torch.{m}" in out["modules"], m
    assert expected <= set(out["modules"]) | {"repro_torch.runtime",
                                              "repro_torch.kernels"}


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without a CUDA device the script exits non-zero and prints no
    result line; alone in a directory it cannot import the port."""
    import torch
    if torch.cuda.is_available():
        return
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       capture_output=True, text=True, cwd=tmp_path,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
