"""Wrapper of the RG-LRU scan kernel.

Dispatch is on the tensor's device: on a CUDA device the hand-written
kernel (``rglru_scan.cu``) runs and any build or launch error raises; on
the CPU the plain version (``ref.py``) runs.  ``LAUNCHES`` counts the
kernel launches, one per wrapper call that reaches the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru_scan import ref

LAUNCHES = {"rglru": 0}
CHUNK = 64  # steps a block of the kernel scans (rglru_scan.cu's CHUNK)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"rglru_launch": [_P, _P, _P, _P, _I, _I, _I, _P]}


def rglru(log_a, b):
    """``h_t = exp(log_a_t) * h_{t-1} + b_t`` over axis 1 with ``h_0 = 0``;
    log_a, b: (B, S, W) float32 -> h (B, S, W) float32."""
    log_a, b = torch.as_tensor(log_a), torch.as_tensor(b)
    if log_a.device.type == "cpu":
        return ref.rglru_ref(log_a, b)
    if log_a.device.type != "cuda" or b.device != log_a.device:
        raise ValueError(f"rglru runs on cuda or cpu, got {log_a.device} and {b.device}")
    if log_a.dim() != 3 or tuple(b.shape) != tuple(log_a.shape) or log_a.numel() == 0:
        raise ValueError(f"rglru wants two equal non-empty (B, S, W) tensors, got "
                         f"{tuple(log_a.shape)} and {tuple(b.shape)}")
    if log_a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"rglru wants float32, got {log_a.dtype} and {b.dtype}")
    log_a, b = log_a.contiguous(), b.contiguous()
    B, S, W = log_a.shape
    h = torch.empty_like(log_a)
    # the chunks' carries (one word per lane) and the block ticket
    scratch = torch.empty(B * W + 1, dtype=torch.int64, device=log_a.device)
    lib = _build.load("rglru_scan", _SIGNATURES)
    with torch.cuda.device(log_a.device):
        err = lib.rglru_launch(log_a.data_ptr(), b.data_ptr(), h.data_ptr(),
                               scratch.data_ptr(), B, S, W, _build.stream_of(log_a))
    _build.check(lib, err, "rglru_scan.rglru")
    LAUNCHES["rglru"] += 1
    return h
