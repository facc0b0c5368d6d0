"""torchdistx_tpu_torch — the PyTorch/CUDA port of :mod:`torchdistx_tpu`.

Fake tensors and deferred module init (record construction with zero
allocation, then materialize on the device), the Llama, GPT-2 and MoE
decoders with their forward, training step and greedy ``generate``, and the
attention kernels written by hand for Hopper (``ops/cuda``).  Module names mirror the JAX package so that each
counterpart is easy to find.

Entry points run on CUDA unless the caller passes ``device="cpu"``; on a
host without CUDA, ``device=None`` raises instead of falling back to the
CPU (see :func:`torchdistx_tpu_torch._device.resolve_device`).
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
