"""Three-term roofline of one step on one NVIDIA H100 SXM5 (port of
``repro.roofline.roofline``).

Convention, as the reference's: ``cost`` holds the PER-DEVICE program's
counts, so each term is per-device time; MODEL_FLOPS is the textbook
useful work (6·N·D train, 2·N·D forward) divided by the chip count.

The peaks are NVIDIA's data-sheet figures for the H100 SXM5 (dense, no
sparsity), not measurements; a card under a lower power limit runs
below them.  ``PEAK_FLOPS`` is the bf16 tensor-core rate every step's
products are held to; the TF32, FP32 and INT32 peaks are the rates the
kernels' bounds use for their own types (``chip_smoke.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

PEAK_FLOPS = 989e12  # bf16 dense tensor-core FLOP/s (H100 SXM5 data sheet)
TF32_FLOPS = 495e12  # TF32 dense tensor-core FLOP/s (data sheet)
FP32_FLOPS = 67e12  # FP32 CUDA-core FLOP/s, no tensor cores (data sheet)
INT32_OPS = 33.5e12  # INT32 op/s (Hopper architecture white paper)
HBM_BW = 3.35e12  # HBM3 bytes/s (data sheet)
NVLINK_BW = 450e9  # NVLink 4 bytes/s one direction a GPU (data sheet: 900 GB/s both ways)


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_per_dev: float
    hlo_flops_per_dev: float  # the counted FLOPs a device (the reference's name)
    useful_ratio: float
    step_time_s: float  # max of the three (no-overlap bound)
    mfu: float  # model_flops / (step_time * PEAK)

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def compute_roofline(
    cost: Dict,
    collective_wire_bytes: float,
    model_flops_total: float,
    n_chips: int,
) -> Roofline:
    flops_dev = float(cost.get("flops", 0.0))
    bytes_dev = float(cost.get("bytes accessed", 0.0))
    compute_s = flops_dev / PEAK_FLOPS
    memory_s = bytes_dev / HBM_BW
    collective_s = collective_wire_bytes / NVLINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    model_dev = model_flops_total / max(n_chips, 1)
    step = max(compute_s, memory_s, collective_s)
    return Roofline(
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        model_flops_per_dev=model_dev,
        hlo_flops_per_dev=flops_dev,
        useful_ratio=(model_dev / flops_dev) if flops_dev else 0.0,
        step_time_s=step,
        mfu=(model_dev / (step * PEAK_FLOPS)) if step else 0.0,
    )


def model_flops(kind: str, n_active_params: int, tokens: int) -> float:
    """6ND for train (fwd+bwd), 2ND for forward-only (prefill/decode)."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active_params * tokens
