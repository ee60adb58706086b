"""Generator ops and their CUDA kernels."""
