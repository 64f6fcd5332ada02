from repro_torch.kernels.cluster_matmul.ops import cluster_matmul
from repro_torch.kernels.cluster_matmul.ref import cluster_matmul_ref

__all__ = ["cluster_matmul", "cluster_matmul_ref"]
