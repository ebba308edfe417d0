"""Wrapper of the temporal connected-components kernel.

Dispatch is on the tensor's device: on a CUDA device the hand-written
kernel (``temporal_cc.cu``) runs and any build or launch error raises; on
the CPU the plain version (``ref.py``) runs.  ``LAUNCHES`` counts the
kernel launches, one per wrapper call that reaches the card.  The kernel
packs the stack's edges (entries > 0) into column bits once and runs the
rounds over the bits, in the regime ``temporal_pagerank.ops.regime``
picks from N.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.temporal_cc import ref
from repro_torch.kernels.temporal_pagerank.ops import dense_inputs, regime

LAUNCHES = {"cc": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"cc_launch": [_P] * 7 + [_I, _I, _I, _I, _P]}


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
    stream = regime(N) == "stream"
    i32 = dict(dtype=torch.int32, device=adj.device)
    out = torch.empty((T, N), **i32)
    words = torch.empty((T, (N + 31) // 32, N), **i32)
    # the stream regime's two label buffers (rows padded to a multiple of 4)
    # and per-(round, t) change flags
    NP = -(-N // 4) * 4
    lab_a, lab_b, changed = ((torch.empty(shape, **i32) for shape in (
        (T, NP), (T, NP), (max(iters, 1), T))) if stream else (None,) * 3)
    lib = _build.load("temporal_cc", _SIGNATURES)

    def ptr(x):
        return None if x is None else x.data_ptr()

    with torch.cuda.device(adj.device):
        err = lib.cc_launch(adj.data_ptr(), active.data_ptr(), out.data_ptr(),
                            words.data_ptr(), ptr(lab_a), ptr(lab_b), ptr(changed),
                            T, N, iters, int(stream), _build.stream_of(adj))
    _build.check(lib, err, "temporal_cc.cc")
    LAUNCHES["cc"] += 1
    return out
