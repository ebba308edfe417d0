"""Wrapper of the RG-LRU scan kernels.

Dispatch is on the tensor's device: on a CUDA device the hand-written
kernels (``rglru_scan.cu``) run and any build or launch error raises; on
the CPU the plain versions (``ref.py``) run, and autograd differentiates
the plain scan; on ``meta`` tensors (the dry run) they run too, computing
nothing.  ``LAUNCHES`` counts the kernel launches, one per
wrapper call that reaches the card: ``rglru`` the forward scan, ``bwd``
the backward scan.

On the card a call that needs a gradient goes through ``RGLRUScan``, an
``autograd.Function`` whose forward is the scan kernel (it saves
``log_a`` and ``h``) and whose backward is the reverse scan kernel
(``rglru_bwd``): the gradient never leaves the kernels.  The backward
stages its inputs in shared memory by one of two load paths, which the
launcher picks from W and the pointers (``bwd_load_path``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru_scan import ref

LAUNCHES = {"rglru": 0, "bwd": 0}
PLAIN_DEVICES = ("cpu", "meta")  # devices the plain versions serve
CHUNK = 64  # steps a block of either kernel scans (rglru_scan.cu's CHUNK and BWD_CHUNK)

BWD_PATHS = ("lane", "bulk")  # the backward's load paths, by rglru_bwd_path's answer

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"rglru_launch": [_P, _P, _P, _P, _I, _I, _I, _P],
               "rglru_bwd_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
               "rglru_bwd_path": [_P, _P, _P, _I],
               "rglru_bwd_resources": [_I, ctypes.POINTER(ctypes.c_int)]}


def rglru(log_a, b):
    """``h_t = exp(log_a_t) * h_{t-1} + b_t`` over axis 1 with ``h_0 = 0``;
    log_a, b: (B, S, W) float32 -> h (B, S, W) float32."""
    log_a, b = torch.as_tensor(log_a), torch.as_tensor(b)
    if log_a.device.type in PLAIN_DEVICES:
        return ref.rglru_ref(log_a, b)
    if torch.is_grad_enabled() and (log_a.requires_grad or b.requires_grad):
        return RGLRUScan.apply(log_a, b)
    return _scan(log_a, b)


def _check(what, *ts):
    dev = ts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"{what} runs on cuda or cpu, got {[str(t.device) for t in ts]}")
    shape = tuple(ts[0].shape)
    if len(shape) != 3 or any(tuple(t.shape) != shape for t in ts) or ts[0].numel() == 0:
        raise ValueError(f"{what} wants equal non-empty (B, S, W) tensors, got "
                         f"{[tuple(t.shape) for t in ts]}")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"{what} wants float32, got {[t.dtype for t in ts]}")
    return [t.contiguous() for t in ts]


def _scratch(t):
    """The chunks' carries (one word per lane) and the block ticket.  The
    caller holds it until the launch is queued: a temporary's block would
    return to the allocator before the launch, safe only while every
    later user of the block is on the same stream."""
    B, _, W = t.shape
    return torch.empty(B * W + 1, dtype=torch.int64, device=t.device)


# (device, stream) -> the backward's scratch, which every launch leaves zero
_BWD_SCRATCH = {}


def _bwd_scratch(t):
    """The backward's carries and ticket for ``t``'s shape on the current
    stream: zeroed once, when allocated, and kept, since the kernel leaves
    them zero.  One a stream, so no two launches share one at once; two
    threads on one stream may race to replace it, which only changes
    which zeroed scratch is kept, as their launches run in stream order."""
    B, _, W = t.shape
    key = (t.device, torch.cuda.current_stream(t.device).cuda_stream)
    scratch = _BWD_SCRATCH.get(key)
    if scratch is None or scratch.numel() < B * W + 1:
        scratch = _BWD_SCRATCH[key] = torch.zeros(B * W + 1, dtype=torch.int64, device=t.device)
    return scratch


def _scan(log_a, b):
    log_a, b = _check("rglru", log_a, b)
    B, S, W = log_a.shape
    h = torch.empty_like(log_a)
    scratch = _scratch(log_a)
    lib = _build.load("rglru_scan", _SIGNATURES)
    with torch.cuda.device(log_a.device):
        err = lib.rglru_launch(log_a.data_ptr(), b.data_ptr(), h.data_ptr(),
                               scratch.data_ptr(), B, S, W, _build.stream_of(log_a))
    _build.check(lib, err, "rglru_scan.rglru")
    LAUNCHES["rglru"] += 1
    return h


def rglru_bwd(log_a, h, dh):
    """The scan's backward: with ``g_t = dh_t + exp(log_a_{t+1}) g_{t+1}``,
    returns ``(dlog_a, db)`` = ``(g_t exp(log_a_t) h_{t-1}, g_t)``; all
    (B, S, W) float32."""
    log_a, h, dh = (torch.as_tensor(t) for t in (log_a, h, dh))
    if log_a.device.type in PLAIN_DEVICES:
        return ref.rglru_bwd_ref(log_a, h, dh)
    log_a, h, dh = _check("rglru_bwd", log_a, h, dh)
    B, S, W = log_a.shape
    dlog_a, db = torch.empty_like(log_a), torch.empty_like(log_a)
    lib = _build.load("rglru_scan", _SIGNATURES)
    with torch.cuda.device(log_a.device):
        scratch = _bwd_scratch(log_a)
        err = lib.rglru_bwd_launch(log_a.data_ptr(), h.data_ptr(), dh.data_ptr(),
                                   dlog_a.data_ptr(), db.data_ptr(), scratch.data_ptr(),
                                   B, S, W, _build.stream_of(log_a))
    _build.check(lib, err, "rglru_scan.rglru_bwd")
    LAUNCHES["bwd"] += 1
    return dlog_a, db


def bwd_load_path(log_a, h, dh):
    """How ``rglru_bwd`` stages these CUDA tensors in shared memory:
    ``"bulk"`` (a ``cp.async.bulk`` copy a row of a tile: W % 4 == 0 and
    16-byte aligned data) or ``"lane"`` (a 4-byte ``cp.async`` a lane)."""
    log_a, h, dh = _check("rglru_bwd", log_a, h, dh)
    lib = _build.load("rglru_scan", _SIGNATURES)
    return BWD_PATHS[lib.rglru_bwd_path(log_a.data_ptr(), h.data_ptr(), dh.data_ptr(),
                                        log_a.shape[2])]


def bwd_resources():
    """The backward kernel's resources on the current CUDA device, for
    each load path: registers a thread, static and dynamic shared memory
    a block, resident blocks an SM and local (spilled) bytes a thread."""
    lib = _build.load("rglru_scan", _SIGNATURES)
    out = {}
    for bulk, path in enumerate(BWD_PATHS):
        got = (ctypes.c_int * 5)()
        _build.check(lib, lib.rglru_bwd_resources(bulk, got), "rglru_scan.rglru_bwd_resources")
        out[path] = dict(zip(("registers", "static_smem_bytes", "dynamic_smem_bytes",
                              "blocks_per_sm", "local_bytes"), got))
    return out


class RGLRUScan(torch.autograd.Function):
    """The scan with its backward kernel; the wrapper applies it on the
    card when a gradient is needed."""

    @staticmethod
    def forward(ctx, log_a, b):
        log_a = log_a.contiguous()
        h = rglru(log_a, b)  # grad mode is off here: the kernel (or, on the CPU, ref.py)
        ctx.save_for_backward(log_a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        log_a, h = ctx.saved_tensors
        return rglru_bwd(log_a, h, dh)
