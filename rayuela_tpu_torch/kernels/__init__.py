"""Build and launch of the hand-written CUDA kernels (see `build`)."""
