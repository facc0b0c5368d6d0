"""Kernels written by hand for Hopper (sm_90a), built from ``csrc/`` at
first use by :mod:`._build`."""
