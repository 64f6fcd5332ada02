"""The port's HERO layer against the reference's, on the CPU: the
cluster model and mesh, the config-graph build flow and PMCA space, and
the Fig.5 / Fig.6 benchmarks' kernels and outputs.  Same inputs from
``np.random.default_rng`` (or the benchmarks' own seeded inputs) on both
sides; tolerances are stated per test."""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import hero_pmca as JP
from repro.core import buildflow as JB
from repro.core import cluster as JC
from repro_torch.configs import hero_pmca as TP
from repro_torch.configs import list_archs
from repro_torch.core import buildflow as TB
from repro_torch.core import cluster as TC
from repro_torch.hero import fig5_svm_offload as T5
from repro_torch.hero import fig6_event_tracing as T6
from repro_torch.kernels.cluster_matmul import cluster_matmul

ROOT = Path(__file__).resolve().parents[1]


def _reference(rel: str):
    """Load one of the reference's scripts (``benchmarks/...``) by path."""
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(
        "reference_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def J5():
    return _reference("benchmarks/fig5_svm_offload.py")


def test_cluster_config_and_interconnect_model_match_reference():
    for n in (1, 2, 4, 8):
        for ic in ("bus", "noc"):
            kw = dict(n_clusters=n, pes_per_cluster=4, interconnect=ic)
            jc, tc = JC.ClusterConfig(**kw), TC.ClusterConfig(**kw)
            assert tc.total_pes == jc.total_pes
            assert tc.nominal_gips() == jc.nominal_gips()
            for total_bytes, compute_s in ((1 << 20, 0.5), (0, 2.0)):
                assert TC.interconnect_model(tc, total_bytes, compute_s) \
                    == JC.interconnect_model(jc, total_bytes, compute_s)
    assert TC.ClusterConfig().nominal_gips() \
        == JC.ClusterConfig().nominal_gips()


def test_pmca_config_space_matches_reference():
    tg, jg = TP.pmca_config_space(), JP.pmca_config_space()
    assert len(tg) == len(jg) > 0
    assert tg.cells() == jg.cells()
    assert (TP.JUNO_ADP, TP.ZC706) == (JP.JUNO_ADP, JP.ZC706)


def test_config_graph_constraints_and_annotations_match_reference():
    def build(G):
        return (G().axis("x", [1, 2, 3]).axis("y", ["a", "b"])
                .constraint(lambda c: c["x"] != 2)
                .annotate(lambda c: {"tag": f"{c['x']}{c['y']}"})
                .annotate(lambda c: None))
    assert build(TB.ConfigGraph).cells() == build(JB.ConfigGraph).cells()
    assert len(build(TB.ConfigGraph)) == 4


def test_hero_test_matrix_matches_reference_on_ported_archs():
    ported = set(list_archs())
    ref = [c for c in JB.hero_test_matrix().cells() if c["arch"] in ported]
    ours = TB.hero_test_matrix().cells()
    assert ours == ref and len(ours) > 0
    assert {c["arch"] for c in ours} == ported


@pytest.mark.parametrize("kernel", ["default", "cluster_matmul"])
def test_cluster_parallel_matmul_matches_reference_on_one_device(kernel):
    """One CPU device on both sides (rtol = atol = 2e-4, the float32
    kernel tolerance); then the port's row split over four clusters (the
    same CPU four times) gives the one-cluster result exactly.  The
    reference runs its default body (``at @ bt``) for both cases: its
    Pallas kernel inside ``shard_map`` is refused by this JAX (the
    ``pallas_call`` output carries no ``vma``)."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((256, 128)).astype(np.float32)
    b = rng.standard_normal((128, 64)).astype(np.float32)
    mesh = TC.make_cluster_mesh(4, device="cpu")
    assert mesh == [torch.device("cpu")]
    fn = cluster_matmul if kernel == "cluster_matmul" else None
    out = TC.cluster_parallel_matmul(mesh, torch.from_numpy(a),
                                     torch.from_numpy(b), fn)
    ref = JC.cluster_parallel_matmul(JC.make_cluster_mesh(4), jnp.asarray(a),
                                     jnp.asarray(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)
    four = TC.cluster_parallel_matmul([torch.device("cpu")] * 4,
                                      torch.from_numpy(a),
                                      torch.from_numpy(b), fn)
    np.testing.assert_array_equal(four.numpy(), out.numpy())
    with pytest.raises(ValueError, match="do not split"):
        TC.cluster_parallel_matmul([torch.device("cpu")] * 3,
                                   torch.from_numpy(a), torch.from_numpy(b))


def test_fig5_inputs_match_reference(J5):
    g = T5._graph()
    assert g == J5._graph()
    for t, j in zip(T5._graph_to_csr(g), J5._graph_to_csr(g)):
        np.testing.assert_array_equal(t, j)


def test_fig5_pagerank_matches_reference(J5):
    """On the benchmark's own graph; rtol 1e-5 (the scatter-add order
    differs between the two)."""
    indptr, indices = T5._graph_to_csr(T5._graph())
    n = indptr.shape[0] - 1
    rank = np.full(n, 1.0 / n, np.float32)
    ours = T5.pagerank_kernel(torch.from_numpy(indptr),
                              torch.from_numpy(indices),
                              torch.from_numpy(rank))
    ref = J5.pagerank_kernel(jnp.asarray(indptr), jnp.asarray(indices),
                             jnp.asarray(rank))
    assert ours.dtype == torch.float32 and ours.shape == (n,)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5)


def test_fig5_forest_matches_reference_exactly(J5):
    """On the benchmark's own forest (the same draws from seed 1); node
    sums compared as int64 after the explicit cast."""
    rng = np.random.default_rng(1)
    n_trees, n_nodes = 64, 2048
    feat = rng.integers(0, 16, (n_trees, n_nodes)).astype(np.int32)
    thr = rng.standard_normal((n_trees, n_nodes)).astype(np.float32)
    child = rng.integers(0, n_nodes, (n_trees, n_nodes, 2)).astype(np.int32)
    xq = rng.standard_normal((256, 16)).astype(np.float32)
    ours = T5.forest_kernel(*(torch.from_numpy(x)
                              for x in (feat, thr, child, xq)))
    ref = J5.forest_kernel(*(jnp.asarray(x) for x in (feat, thr, child, xq)))
    assert ours.dtype == torch.int32 and ours.shape == (256,)
    np.testing.assert_array_equal(ours.numpy().astype(np.int64),
                                  np.asarray(ref).astype(np.int64))


def test_fig5_runs_on_the_cpu():
    rows = T5.run_benchmarks(repeats=1, device="cpu")
    assert [r["bench"] for r in rows] == list(T5.CLAIMS)
    for r in rows:
        assert r["copy_total_s"] > 0 and r["svm_total_s"] > 0
        assert np.isfinite(r["reduction_pct"])


def test_fig6_output_and_assertions_match_reference(capsys):
    """The timeline text, TLB transactions, assertion verdicts and RAB
    stats print identically."""
    J6 = _reference("benchmarks/fig6_event_tracing.py")
    J6.main()
    ref = capsys.readouterr().out
    results = T6.main()
    ours = capsys.readouterr().out
    assert ours == ref
    assert results == {"hit_under_miss": True, "wake_follows_handle": True}
    assert "hit_under_miss: PASS" in ours
