"""Utilities (counterpart of ``torchdistx_tpu.utils``): checkpointing."""
