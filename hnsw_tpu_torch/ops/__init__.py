"""Distance, top-k, and the wrappers of the hand-written CUDA kernels."""
