"""Training steps (counterpart of ``torchdistx_tpu.parallel``); one device
for now."""
