// The grid-stride instantiations of cluster_matmul.cu's general kernels,
// which a launch within an SM budget takes (kernel.py: matmul(..., sms=)).
// Built as a library of its own so that its nvcc run goes beside the main
// file's instead of after it; the kernels are the main file's, compiled
// with CLUSTER_MATMUL_BUDGETED (no wgmma branch here).
#define CLUSTER_MATMUL_BUDGETED
#include "cluster_matmul.cu"
