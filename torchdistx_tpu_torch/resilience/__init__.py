"""Resilience: the non-finite step guard (counterpart of
``torchdistx_tpu.resilience``)."""
