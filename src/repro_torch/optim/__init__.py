"""Optimizers of the port (``repro.optim``): AdamW.  The int8
error-feedback gradient compression (``repro.optim.compression``) comes
with multi-card work (ROADMAP Queue 1, item 5)."""
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig

__all__ = ["adamw", "AdamWConfig"]
