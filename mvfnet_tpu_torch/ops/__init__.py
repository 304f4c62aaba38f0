"""Tensor ops of the port; CUDA kernels build on first use."""
