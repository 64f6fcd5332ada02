"""Fig.5 reproduction: offload + kernel time, copy-based SM vs zero-copy SVM.

Ported from ``benchmarks/fig5_svm_offload.py``, at its sizes.  Four
benchmarks with the paper's cost structure:
  (a) PageRank        — pointer-rich linked graph; copy mode pays pointer
                        flattening (adjacency dict -> CSR) on every offload;
  (b) Random Hough Forests — large tree ensemble, only a fraction touched;
                        copy mode ships the entire forest;
  (c) MemCopy         — streaming; copy mode's staging dominates;
  (d) MatMul          — compute amortizes the copy cost partially.

Paper's reductions: (a) ~60%, (b) >60%, (c) >95%, (d) ~80%.

    PYTHONPATH=src python -m repro_torch.hero.fig5_svm_offload [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Dict, List

import numpy as np
import torch

from repro_torch.core.offload import OffloadTarget
from repro_torch.core.tracing import TraceBuffer
from repro_torch.device import DeviceLike


def _graph(n=4096, deg=8, seed=0):
    """Adjacency dict: the pointer-rich host structure."""
    rng = np.random.default_rng(seed)
    return {v: rng.integers(0, n, deg).tolist() for v in range(n)}


def _graph_to_csr(g: Dict[int, List[int]]):
    """The pointer-flattening step copy-based offload must do every time."""
    indptr = np.zeros(len(g) + 1, np.int32)
    flat = []
    for v in range(len(g)):
        flat.extend(g[v])
        indptr[v + 1] = len(flat)
    return indptr, np.asarray(flat, np.int32)


def pagerank_kernel(indptr, indices, rank):
    """Ten scatter-add sweeps, as the reference's ``lax.scan``.  Like the
    reference's scan body, each sweep ignores its carry: every sweep
    spreads the *initial* rank's contributions, so all ten give the same
    result.  ``output_size`` keeps ``repeat_interleave`` from syncing
    with the host to size its output; ``index_add_`` on CUDA adds in no
    fixed order."""
    n = rank.shape[0]
    deg = (indptr[1:] - indptr[:-1]).to(torch.float32)
    contrib = rank / torch.clamp(deg, min=1.0)
    repeats = deg.to(torch.int64)
    targets = indices.to(torch.int64)
    out = rank
    for _ in range(10):
        inc = torch.zeros(n, dtype=torch.float32, device=rank.device)
        inc.index_add_(0, targets, torch.repeat_interleave(
            contrib, repeats, output_size=indices.shape[0]))
        out = 0.85 * inc + 0.15 / n
    return out


def forest_kernel(feat_idx, thresh, children, x):
    """Classify batch x through depth-8 trees via gathers (partial
    access).  The reference also gathers each node's feature index and
    never uses it, so XLA drops that gather; the port does not run it."""
    trees = torch.arange(feat_idx.shape[0], device=x.device)[None, :]
    node = torch.zeros((x.shape[0], feat_idx.shape[0]), dtype=torch.int32,
                       device=x.device)
    for _ in range(8):
        t = thresh[trees, node]
        go_right = x[:, 0][:, None] > t
        node = children[trees, node, go_right.to(torch.int32)]
    return node.sum(dim=1, dtype=torch.int32)


def run_benchmarks(repeats: int = 3, device: DeviceLike = None):
    tgt = OffloadTarget(tracer=TraceBuffer(), device=device)
    rows = []

    def put(x):
        return tgt.svm.share(torch.from_numpy(x).to(tgt.device))

    def bench(name, copy_fn, zero_setup, zero_fn):
        copy_total, zc_total, copy_off, zc_kern = [], [], [], []
        handles = zero_setup()
        for _ in range(repeats):
            out_c, rep_c = copy_fn()
            out_h, rep_z = zero_fn(handles)
            copy_total.append(rep_c.total_s)
            zc_total.append(rep_z.total_s)
            copy_off.append(rep_c.offload_s + rep_c.writeback_s)
            zc_kern.append(rep_z.kernel_s)
        c, z = float(np.median(copy_total)), float(np.median(zc_total))
        rows.append({
            "bench": name, "copy_total_s": c, "svm_total_s": z,
            "copy_offload_s": float(np.median(copy_off)),
            "svm_kernel_s": float(np.median(zc_kern)),
            "reduction_pct": 100.0 * (1 - z / c),
        })

    # (a) PageRank — linked data structure
    g = _graph()
    n = len(g)

    def pr_copy():
        indptr, indices = _graph_to_csr(g)            # pointer fixing
        rank = np.full(n, 1.0 / n, np.float32)
        return tgt.run_copy_based(pagerank_kernel, indptr, indices, rank)

    def pr_setup():
        indptr, indices = _graph_to_csr(g)
        return [put(indptr), put(indices),
                put(np.full(n, 1.0 / n, np.float32))]

    bench("pagerank", pr_copy, pr_setup,
          lambda hs: tgt.run_zero_copy(pagerank_kernel, *hs))

    # (b) Random Hough Forests — big, partially-accessed
    rng = np.random.default_rng(1)
    n_trees, n_nodes = 64, 2048
    feat = rng.integers(0, 16, (n_trees, n_nodes)).astype(np.int32)
    thr = rng.standard_normal((n_trees, n_nodes)).astype(np.float32)
    child = rng.integers(0, n_nodes, (n_trees, n_nodes, 2)).astype(np.int32)
    xq = rng.standard_normal((256, 16)).astype(np.float32)

    bench("hough_forest",
          lambda: tgt.run_copy_based(forest_kernel, feat, thr, child, xq),
          lambda: [put(a) for a in (feat, thr, child, xq)],
          lambda hs: tgt.run_zero_copy(forest_kernel, *hs))

    # (c) MemCopy — streaming
    big = rng.standard_normal((1 << 22,)).astype(np.float32)  # 16 MiB

    def ident(x):
        return x + 0.0
    bench("memcopy",
          lambda: tgt.run_copy_based(ident, big),
          lambda: [put(big)],
          lambda hs: tgt.run_zero_copy(ident, *hs))

    # (d) MatMul: a plain product outside any kernel, as in the reference
    A = rng.standard_normal((768, 768)).astype(np.float32)
    B = rng.standard_normal((768, 768)).astype(np.float32)

    def mm(a, b):
        return a @ b
    bench("matmul",
          lambda: tgt.run_copy_based(mm, A, B),
          lambda: [put(A), put(B)],
          lambda hs: tgt.run_zero_copy(mm, *hs))
    return rows


CLAIMS = {"pagerank": "~60", "hough_forest": ">60", "memcopy": ">95",
          "matmul": "~80"}


def main(device: DeviceLike = None):
    print("# Fig.5: copy-based SM vs zero-copy SVM offload")
    print("bench,copy_total_s,svm_total_s,copy_offload_s,svm_kernel_s,"
          "reduction_pct,paper_claim_pct")
    rows = run_benchmarks(device=device)
    for r in rows:
        print(f"{r['bench']},{r['copy_total_s']:.5f},{r['svm_total_s']:.5f},"
              f"{r['copy_offload_s']:.5f},{r['svm_kernel_s']:.5f},"
              f"{r['reduction_pct']:.1f},{CLAIMS[r['bench']]}")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    main(ap.parse_args().device)
