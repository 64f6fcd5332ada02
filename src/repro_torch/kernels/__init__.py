"""Hand-written Hopper kernels, each beside its plain-PyTorch version
(the kernel/ref/ops split of ``repro.kernels``)."""
