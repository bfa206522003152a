"""Hand-written GPU kernels for the compute hot-spots the paper itself
optimizes, each beside its plain PyTorch version."""
