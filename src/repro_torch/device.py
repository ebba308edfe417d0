"""Device selection for the port.

Every entry point (``HistoricalGraphStore.build``, ``TGI``,
``TemporalQuery.over``, ``PlanExecutor``) takes ``device=``.  ``None``
means the CUDA card; without one that raises rather than running the
plain versions on the CPU behind the caller's back.  Tests and CPU
rehearsals pass ``device="cpu"`` explicitly.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def default_device() -> torch.device:
    """The CUDA card; raises when none is visible."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions instead")
    return torch.device("cuda")


def resolve(device: DeviceLike) -> torch.device:
    """``None`` -> ``default_device()``; anything else -> ``torch.device``."""
    if device is None:
        return default_device()
    return torch.device(device)
