"""Wrapper of the temporal motif kernel.

Dispatch is on the tensor's device: on a CUDA device the hand-written
kernel (``temporal_motif.cu``) runs and any build or launch error raises;
on the CPU the plain version (``ref.py``) runs.  ``LAUNCHES`` counts the
kernel launches, one per wrapper call that reaches the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.temporal_motif import ref

LAUNCHES = {"motif": 0}
MAX_N = 32 * 32 * 32  # the count pass holds a column's N / 32 words in registers

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"motif_launch": [_P, _P, _P, _I, _I, _P]}


def temporal_motif(adj):
    """Per-node triangle counts (T, N) int32 at every timepoint from a
    dense (T, N, N) float32 adjacency: ``out[t, j] = (sum over i with
    A[i, j] != 0 of (A.A)[i, j]) / 2`` on A's 0/1 pattern, exact for any
    pattern (diag(A^3) / 2 for a symmetric A with a zero diagonal)."""
    adj = torch.as_tensor(adj)
    if adj.device.type == "cpu":
        return ref.motif_ref(adj)
    if adj.device.type != "cuda":
        raise ValueError(f"temporal_motif runs on cuda or cpu, not {adj.device}")
    if adj.dim() != 3 or adj.shape[1] != adj.shape[2] or adj.numel() == 0:
        raise ValueError(f"temporal_motif wants a non-empty (T, N, N) stack, "
                         f"got {tuple(adj.shape)}")
    if adj.dtype != torch.float32:
        raise TypeError(f"temporal_motif wants float32, got {adj.dtype}")
    T, N, _ = adj.shape
    if N > MAX_N:
        raise ValueError(f"temporal_motif takes N up to {MAX_N}, got {N}")
    adj = adj.contiguous()
    if adj.data_ptr() % 16:  # the pack pass reads aligned 16-byte words
        adj = adj.clone()
    words = torch.empty((2, T, N, (N + 31) // 32), dtype=torch.int32, device=adj.device)
    out = torch.empty((T, N), dtype=torch.int32, device=adj.device)
    lib = _build.load("temporal_motif", _SIGNATURES)
    with torch.cuda.device(adj.device):
        err = lib.motif_launch(adj.data_ptr(), words.data_ptr(), out.data_ptr(),
                               T, N, _build.stream_of(adj))
    _build.check(lib, err, "temporal_motif.motif")
    LAUNCHES["motif"] += 1
    return out
