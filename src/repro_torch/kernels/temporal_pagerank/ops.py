"""Wrapper of the temporal PageRank kernel.

Dispatch is on the tensor's device: on a CUDA device the hand-written
kernel (``temporal_pagerank.cu``) runs and any build or launch error
raises; on the CPU the plain version (``ref.py``) runs.  ``LAUNCHES``
counts the kernel launches, one per wrapper call that reaches the card.

The kernel packs the stack into column bits once, then iterates over the
bits in one of two regimes, chosen from N alone by ``regime``: "cluster"
(one launch for all iterations, a timepoint's words in the shared memory
of a cluster of 8 blocks) while N <= CLUSTER_MAX_N, so that a block's
share of a timepoint's words, ceil(N / 32) * ceil(N / 8) * 4 bytes, stays
within 144 KB and its whole working set within the 227 KB a block may
hold; else "stream" (one launch per iteration over the words in L2 or
HBM).  ``temporal_cc`` follows the same rule.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.temporal_pagerank import ref

LAUNCHES = {"pagerank": 0}

CLUSTER_MAX_N = 3072

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SIGNATURES = {"pagerank_launch": [_P] * 10 + [_I, _I, _I, _D, _I, _P]}


def regime(N: int) -> str:
    """The dense kernels' iteration regime for N nodes: "cluster" (words
    in shared memory, one launch) or "stream" (a launch per iteration)."""
    return "cluster" if N <= CLUSTER_MAX_N else "stream"


def dense_inputs(adj, active, what: str):
    """Check a dense (T, N, N) adjacency and its (T, N) activity mask for
    a CUDA kernel; returns both as contiguous float32 on the card, the
    adjacency 16-byte aligned."""
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
    adj = adj.contiguous()
    if adj.data_ptr() % 16:  # the pack pass reads aligned 16-byte words
        adj = adj.clone()
    return adj, active.to(torch.float32).contiguous()


def temporal_pagerank(adj, active, damping: float = 0.85, iters: int = 20):
    """Ranks (T, N) float32 at every timepoint from a dense (T, N, N)
    float32 adjacency and a (T, N) activity mask (0 on inactive nodes)."""
    adj, active = torch.as_tensor(adj), torch.as_tensor(active)
    if adj.device.type == "cpu":
        return ref.pagerank_ref(adj, active, damping=damping, iters=iters)
    adj, active = dense_inputs(adj, active, "temporal_pagerank")
    T, N, _ = adj.shape
    W = (N + 31) // 32
    stream = regime(N) == "stream"
    f32 = dict(dtype=torch.float32, device=adj.device)
    out = torch.empty((T, N), **f32)
    words = torch.empty((T, W, N), dtype=torch.int32, device=adj.device)
    part = torch.empty((T, W, N), **f32)
    # the pack's per-block "not all ones" flags, then one flag per timepoint
    flags = torch.empty(T * W * -(-N // 256) + T, dtype=torch.int32, device=adj.device)
    # the stream regime's deg, n, two contrib and two dangling-partial buffers
    # (contrib rows padded to a multiple of 4 floats)
    deg, nvec, contrib, dpart = ((torch.empty(shape, **f32) for shape in (
        (T, N), (T,), (2, T, -(-N // 4) * 4), (2, T, W))) if stream else (None,) * 4)
    lib = _build.load("temporal_pagerank", _SIGNATURES)

    def ptr(x):
        return None if x is None else x.data_ptr()

    with torch.cuda.device(adj.device):
        err = lib.pagerank_launch(adj.data_ptr(), active.data_ptr(), out.data_ptr(),
                                  words.data_ptr(), part.data_ptr(), flags.data_ptr(),
                                  ptr(deg), ptr(nvec), ptr(contrib), ptr(dpart),
                                  T, N, int(iters), float(damping), int(stream),
                                  _build.stream_of(adj))
    _build.check(lib, err, "temporal_pagerank.pagerank")
    LAUNCHES["pagerank"] += 1
    return out
