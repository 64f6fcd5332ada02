"""Fig.4 and the benchmark driver, against the reference's
``benchmarks/fig4_cluster_speedup.py`` and ``benchmarks/run.py`` (loaded
by path; the reference's measured subprocess is not run), and the
general kernel's plan under an SM budget.

The analytic and GIPS rows must print exactly the reference's; the
measured half runs on the CPU at 64^3 and each product must equal the
reference's ``cluster_parallel_matmul`` on a mesh of as many virtual
devices (a JAX subprocess with 8 host devices), within 1e-5 of the
largest |C| (two float32 summation orders).
"""
import ast
import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import cluster as TC
from repro_torch.hero import fig4_cluster_speedup as T4
from repro_torch.hero import run as TRUN
from repro_torch.kernels.cluster_matmul import kernel as K
from test_torch_hero import ROOT, _reference


@pytest.fixture(scope="module")
def J4():
    mod = _reference("benchmarks/fig4_cluster_speedup.py")
    mod.measured_speedups = dict    # its subprocess is not run here
    return mod


def _printed(fn, *args, **kw) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kw)
    return buf.getvalue().splitlines()


def _sections(lines) -> tuple:
    """(the analytic rows with their headers, the GIPS rows with theirs)."""
    measured = next(i for i, x in enumerate(lines)
                    if x.startswith("## measured")) \
        if any(x.startswith("## measured") for x in lines) else None
    gips = next(i for i, x in enumerate(lines)
                if x.startswith("## nominal GIPS"))
    return lines[:measured if measured is not None else gips], lines[gips:]


def test_analytic_and_gips_rows_match_reference(J4):
    assert T4.modeled_speedups() == J4.modeled_speedups()
    ours = _sections(_printed(T4.main, throughput=True, sizes=()))
    theirs = _sections(_printed(J4.main, throughput=True))
    assert ours == theirs
    assert len(ours[0]) == 13 and len(ours[1]) == 5


REF_PRODUCTS = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax.numpy as jnp
from repro.core.cluster import cluster_parallel_matmul, make_cluster_mesh
d = np.load(sys.argv[1])
a, b = jnp.asarray(d["a"]), jnp.asarray(d["b"])
out = {}
for n in (1, 2, 4, 8):
    mesh = make_cluster_mesh(n)
    assert mesh.shape["cluster"] == n
    out[str(n)] = np.asarray(cluster_parallel_matmul(mesh, a, b))
np.savez(sys.argv[2], **out)
print("REF_OK")
"""


def test_measured_half_on_cpu_matches_reference_products(tmp_path):
    """``measure(64, "cpu")``: one row per cluster count, host-clock
    times, and each count's product equal to the reference's over a
    ``shard_map`` mesh of that many devices."""
    size = 64
    a, b = T4.operands(size, "cpu")
    np.savez(tmp_path / "ab.npz", a=a.numpy(), b=b.numpy())
    r = subprocess.run(
        [sys.executable, "-c", REF_PRODUCTS, str(tmp_path / "ab.npz"),
         str(tmp_path / "ref.npz")], capture_output=True, text=True,
        timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert "REF_OK" in r.stdout, r.stdout + r.stderr
    ref = np.load(tmp_path / "ref.npz")
    rows = T4.measure(size, "cpu", reps=2)
    assert [row["n_clusters"] for row in rows] == list(T4.COUNTS)
    for row in rows:
        n = row["n_clusters"]
        want = ref[str(n)]
        got = row["out"].numpy()
        assert got.shape == want.shape == (size, size)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
        assert row["clock"] == "host" and len(row["cluster_ms"]) == n
        assert row["wall_ms"] > 0 and row["speedup"] > 0
    lines = _printed(T4.print_measured, rows, T4.card_label("cpu"))
    assert lines[1] == "# cpu (host clock)"
    assert [x.split(",")[2] for x in lines[3:]] == ["1", "2", "4", "8"]


def test_cluster_parallel_matmul_rejects_uneven_rows():
    a, b = torch.ones(6, 4), torch.ones(4, 3)
    with pytest.raises(ValueError):
        TC.cluster_parallel_matmul([torch.device("cpu")] * 4, a, b)
    with pytest.raises(ValueError):
        TC.make_card_clusters(2, "cpu")


def test_driver_sections_match_reference():
    """``hero/run.py``'s section names are ``benchmarks/run.py``'s, in its
    order."""
    tree = ast.parse((ROOT / "benchmarks" / "run.py").read_text())
    names = [node.args[0].value for node in ast.walk(tree)
             if isinstance(node, ast.Call)
             and getattr(node.func, "id", None) == "_run"
             and isinstance(node.args[0], ast.Constant)]
    assert names == [name for name, _ in TRUN.SECTIONS]
    assert len(names) == 5


def _plan_before(m, k, n, dtype=torch.float32):
    """``general_plan`` as it was before the SM budget, for a card of
    ``K.SMS`` SMs."""
    sms = 132
    if -(-m // 128) * -(-n // 128) >= sms:
        return 128, 1
    bf16 = dtype == torch.bfloat16
    tiles = -(-m // 64) * -(-n // 64)
    k_tiles = -(-k // (32 if bf16 else 16))
    splits = min(k_tiles // (8 if bf16 else 4), (1 if bf16 else 4) * sms
                 // tiles)
    if splits <= 1:
        return 64, 1
    per = -(-k_tiles // splits)
    return 64, -(-k_tiles // per)


SHAPES = [(m, k, n) for m in (1, 64, 127, 128, 256, 1000, 1024, 2048, 4096)
          for k in (1, 16, 127, 768, 4096, 8192) for n in (20, 128, 776,
                                                           2048, 11008)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unbudgeted_plan_is_unchanged(dtype):
    assert K.SMS == 132
    for m, k, n in SHAPES:
        assert K.general_plan(m, k, n, dtype) == _plan_before(m, k, n, dtype)
        assert K.general_plan(m, k, n, dtype, sms=None) \
            == K.general_plan(m, k, n, dtype, sms=K.SMS)


@pytest.mark.parametrize("sms", [1, 2, 8, 16, 33, 66, 132])
def test_budgeted_plan_is_the_plan_of_a_card_of_that_many_sms(
        sms, monkeypatch):
    budgeted = {(m, k, n, dt): K.general_plan(m, k, n, dt, sms=sms)
                for m, k, n in SHAPES
                for dt in (torch.float32, torch.bfloat16)}
    monkeypatch.setattr(K, "SMS", sms)
    for (m, k, n, dt), plan in budgeted.items():
        assert plan == K.general_plan(m, k, n, dt)
        assert K.fills_a_wave(m, n) == K.fills_a_wave(m, n, sms)


def test_fig4_cluster_plans():
    """The plans Fig.4's clusters take within 16 SMs (the H100's 132 // 8):
    128 x 128 tiles while an (m / n) x size block fills 16 of them, else
    64 x 64 tiles with K split."""
    got = {(size, n): K.general_plan(size // n, size, size, sms=16)
           for size in T4.SIZES for n in T4.COUNTS}
    assert got == {(1024, 1): (128, 1), (1024, 2): (128, 1),
                   (1024, 4): (128, 1), (1024, 8): (64, 2),
                   (2048, 1): (128, 1), (2048, 2): (128, 1),
                   (2048, 4): (128, 1), (2048, 8): (128, 1)}
