"""The port's HERO entry points: the SVM offload demo and the Fig.5 /
Fig.6 paper-figure benchmarks (``python -m repro_torch.hero.<name>``)."""
