"""The roofline of one step on H100s (port of ``repro.roofline``): the
analytic FLOP and byte model (``analytic``, a copy of the reference's),
the three-term roofline at the card's data-sheet peaks, and the
collectives a sharded step issues (``collectives``, the counterpart of
``repro.roofline.hlo_analysis``)."""
from repro_torch.roofline.collectives import (
    CollectiveRecorder,
    summarize_collectives,
)
from repro_torch.roofline.roofline import (
    FP32_FLOPS,
    HBM_BW,
    INT32_OPS,
    NVLINK_BW,
    PEAK_FLOPS,
    TF32_FLOPS,
    Roofline,
    compute_roofline,
    model_flops,
)

__all__ = [
    "CollectiveRecorder",
    "summarize_collectives",
    "Roofline",
    "compute_roofline",
    "model_flops",
    "PEAK_FLOPS",
    "TF32_FLOPS",
    "FP32_FLOPS",
    "INT32_OPS",
    "HBM_BW",
    "NVLINK_BW",
]
