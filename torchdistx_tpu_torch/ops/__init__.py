"""Ops of the port: attention and its hand-written CUDA kernels."""
