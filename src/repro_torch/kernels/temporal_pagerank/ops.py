"""Wrapper of the temporal PageRank kernel.

Dispatch is on the tensor's device: on a CUDA device the hand-written
kernel (``temporal_pagerank.cu``) runs and any build or launch error
raises; on the CPU the plain version (``ref.py``) runs.  ``LAUNCHES``
counts the kernel launches, one per wrapper call that reaches the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.temporal_pagerank import ref

LAUNCHES = {"pagerank": 0}

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SIGNATURES = {"pagerank_launch": [_P] * 6 + [_I, _I, _I, _D, _P]}


def dense_inputs(adj, active, what: str):
    """Check a dense (T, N, N) adjacency and its (T, N) activity mask for
    a CUDA kernel; returns both as contiguous float32 on the card."""
    if adj.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {adj.device}")
    if adj.dim() != 3 or adj.shape[1] != adj.shape[2] or adj.numel() == 0:
        raise ValueError(f"{what} wants a non-empty (T, N, N) stack, "
                         f"got {tuple(adj.shape)}")
    if tuple(active.shape) != tuple(adj.shape[:2]):
        raise ValueError(f"{what} wants a (T, N) active mask, got "
                         f"{tuple(active.shape)} for {tuple(adj.shape)}")
    if adj.dtype != torch.float32:
        raise TypeError(f"{what} wants float32 adjacency, got {adj.dtype}")
    if active.device != adj.device:
        raise ValueError(f"{what} inputs lie on different devices")
    return adj.contiguous(), active.to(torch.float32).contiguous()


def temporal_pagerank(adj, active, damping: float = 0.85, iters: int = 20):
    """Ranks (T, N) float32 at every timepoint from a dense (T, N, N)
    float32 adjacency and a (T, N) activity mask (0 on inactive nodes)."""
    adj, active = torch.as_tensor(adj), torch.as_tensor(active)
    if adj.device.type == "cpu":
        return ref.pagerank_ref(adj, active, damping=damping, iters=iters)
    adj, active = dense_inputs(adj, active, "temporal_pagerank")
    T, N, _ = adj.shape
    deg = torch.empty((T, N), dtype=torch.float32, device=adj.device)
    buf = torch.empty_like(deg)
    out = torch.empty_like(deg)
    nvec = torch.empty(T, dtype=torch.float32, device=adj.device)
    lib = _build.load("temporal_pagerank", _SIGNATURES)
    with torch.cuda.device(adj.device):
        err = lib.pagerank_launch(adj.data_ptr(), active.data_ptr(),
                                  deg.data_ptr(), nvec.data_ptr(),
                                  buf.data_ptr(), out.data_ptr(), T, N,
                                  int(iters), float(damping),
                                  _build.stream_of(adj))
    _build.check(lib, err, "temporal_pagerank.pagerank")
    LAUNCHES["pagerank"] += 1
    return out
