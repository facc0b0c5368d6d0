"""Ops of the port: attention (``ops.attention``: plain, cached and
dispatched, with the flash kernel on each rank's block of a mesh and ring
attention over a sequence axis) and its hand-written CUDA kernels
(``ops.cuda``)."""
