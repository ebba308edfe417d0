"""Wrapper of the temporal connected-components kernel.

Dispatch is on the tensor's device: on a CUDA device the hand-written
kernel (``temporal_cc.cu``) runs and any build or launch error raises; on
the CPU the plain version (``ref.py``) runs.  ``LAUNCHES`` counts the
kernel launches, one per wrapper call that reaches the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.temporal_cc import ref
from repro_torch.kernels.temporal_pagerank.ops import dense_inputs

LAUNCHES = {"cc": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"cc_launch": [_P] * 6 + [_I, _I, _I, _P]}


def temporal_cc(adj, active, iters: int = 32):
    """Component labels (T, N) int32 at every timepoint from a dense
    (T, N, N) float32 adjacency and a (T, N) activity mask: the least row
    index that reached each node within ``iters`` rounds, -1 on inactive
    nodes."""
    adj, active = torch.as_tensor(adj), torch.as_tensor(active)
    if adj.device.type == "cpu":
        return ref.cc_ref(adj, active, iters=iters)
    adj, active = dense_inputs(adj, active, "temporal_cc")
    T, N, _ = adj.shape
    iters = int(iters)
    lab_a = torch.empty((T, N), dtype=torch.int32, device=adj.device)
    lab_b = torch.empty_like(lab_a)
    out = torch.empty_like(lab_a)
    changed = torch.zeros((max(iters, 1), T), dtype=torch.int32,
                          device=adj.device)
    lib = _build.load("temporal_cc", _SIGNATURES)
    with torch.cuda.device(adj.device):
        err = lib.cc_launch(adj.data_ptr(), active.data_ptr(), lab_a.data_ptr(),
                            lab_b.data_ptr(), changed.data_ptr(),
                            out.data_ptr(), T, N, iters, _build.stream_of(adj))
    _build.check(lib, err, "temporal_cc.cc")
    LAUNCHES["cc"] += 1
    return out
