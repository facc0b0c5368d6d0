"""Training (counterpart of ``torchdistx_tpu.parallel``): the single-device
train step, the ``fit`` loop and cross-process flag agreement."""
