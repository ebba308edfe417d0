"""Optimizers of the port (``repro.optim``): AdamW and the int8
error-feedback gradient compression of the cross-pod all-reduce."""
from repro_torch.optim import adamw, compression
from repro_torch.optim.adamw import AdamWConfig

__all__ = ["adamw", "compression", "AdamWConfig"]
