"""Hand-written CUDA kernels of the sweep, their wrappers and plain versions."""
