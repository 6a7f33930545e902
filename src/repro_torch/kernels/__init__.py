"""Hand-written Hopper kernels of the GP hot path, each beside its plain
PyTorch version (the CPU path and the on-card oracle)."""
