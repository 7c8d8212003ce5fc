"""Hand-written CUDA kernels with their plain versions and dispatchers."""
