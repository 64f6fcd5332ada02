"""Nothing ``bench/run.py`` loads is JAX, jaxlib, flax or the JAX package
``repro``, compared by whole top-level names (``repro_torch`` begins
with ``repro``), and the reference imports nothing of the program."""
import ast
import subprocess
import sys

import tinycell

PROBE = r"""
import runpy, sys
sys.argv = ["bench/run.py"]
mod = runpy.run_path(sys.argv[0], run_name="not_main")
from harness import cell, correct, driver, reference, trace, traffic
import repro_torch.runtime, repro_torch.runtime.server
banned = {"jax", "jaxlib", "flax", "repro"}
print(sorted({m.split(".")[0] for m in sys.modules} & banned))
print("repro_torch" in {m.split(".")[0] for m in sys.modules})
"""


def test_run_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=tinycell.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-2] == "[]"
    assert lines[-1] == "True"


def test_loaded_jax_modules_compares_whole_names():
    from harness import cell
    names = ["torch", "repro_torch", "repro_torch.runtime", "reprox"]
    assert cell.loaded_jax_modules(names) == []
    assert cell.loaded_jax_modules(names + ["repro.core"]) == ["repro"]
    assert cell.loaded_jax_modules(["jaxlib.xla", "flax"]) == ["flax",
                                                               "jaxlib"]


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "correct.py", "counts.py", "traffic.py",
                 "weights.py", "stats.py"):
        tree = ast.parse((tinycell.BENCH / "harness" / name).read_text())
        mods = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods.add(node.module.split(".")[0])
        assert not mods & {"repro_torch", "repro", "jax", "jaxlib"}, name
