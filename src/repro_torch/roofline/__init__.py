"""The roofline of one step on one H100 (port of ``repro.roofline``): the
analytic FLOP and byte model (``analytic``, a copy of the reference's)
and the three-term roofline at the card's data-sheet peaks.  The
collective parse of ``repro.roofline.hlo_analysis`` waits for the
multi-card slice, where a sharded step has collectives to count."""
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
