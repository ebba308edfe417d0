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
(``rglru_bwd``): the gradient never leaves the kernels.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru_scan import ref

LAUNCHES = {"rglru": 0, "bwd": 0}
PLAIN_DEVICES = ("cpu", "meta")  # devices the plain versions serve
CHUNK = 64  # steps a block of the kernel scans (rglru_scan.cu's CHUNK)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"rglru_launch": [_P, _P, _P, _P, _I, _I, _I, _P],
               "rglru_bwd_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P]}


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
    scratch = _scratch(log_a)
    lib = _build.load("rglru_scan", _SIGNATURES)
    with torch.cuda.device(log_a.device):
        err = lib.rglru_bwd_launch(log_a.data_ptr(), h.data_ptr(), dh.data_ptr(),
                                   dlog_a.data_ptr(), db.data_ptr(), scratch.data_ptr(),
                                   B, S, W, _build.stream_of(log_a))
    _build.check(lib, err, "rglru_scan.rglru_bwd")
    LAUNCHES["bwd"] += 1
    return dlog_a, db


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
