"""Wrappers of the delta_overlay kernels.

Dispatch is on the tensors' device: on a CUDA device the hand-written
kernel (``delta_overlay.cu``) runs and any build or launch error raises;
on the CPU the plain version (``ref.py``) runs.  ``LAUNCHES`` counts the
kernel launches, one per wrapper call that reaches the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.delta_overlay import ref

LAUNCHES = {"overlay": 0, "overlay_batch": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "overlay_launch": [_P] * 6 + [_I, _L, _I, _P],
    "overlay_batch_launch": [_P] * 9 + [_I, _L, _I, _I, _P],
    "layer_lists_launch": [_P] * 3 + [_I, _I, _P],
}


def _on_cpu(x) -> bool:
    dev = x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"delta_overlay runs on cuda or cpu, not {dev}")
    return dev.type == "cpu"


def _stacks(valid, present, attrs):
    """Check the stacked layers for the kernel: (h, P, S) one-byte valid
    and int8 present, (h, P, S, K) int32 attrs, all on one device."""
    if valid.dim() != 3 or present.shape != valid.shape or attrs.dim() != 4 \
            or attrs.shape[:3] != valid.shape:
        raise ValueError(f"overlay wants (h,P,S) valid/present and (h,P,S,K) "
                         f"attrs, got {tuple(valid.shape)}, "
                         f"{tuple(present.shape)}, {tuple(attrs.shape)}")
    if valid.dtype not in (torch.bool, torch.int8, torch.uint8) \
            or present.dtype != torch.int8 or attrs.dtype != torch.int32:
        raise TypeError(f"overlay wants bool/int8 valid, int8 present, int32 "
                        f"attrs, got {valid.dtype}, {present.dtype}, "
                        f"{attrs.dtype}")
    if not valid.device == present.device == attrs.device:
        raise ValueError("overlay inputs lie on different devices")
    if valid.numel() == 0:
        raise ValueError(f"overlay kernel needs h, P, S >= 1, got "
                         f"{tuple(attrs.shape)}")
    return valid.contiguous(), present.contiguous(), attrs.contiguous()


def overlay(valid, present, attrs):
    """Fold stacked deltas (h, P, S[, K]) -> (P, S[, K]): returns
    (valid bool, present int8, attrs int32)."""
    valid, present, attrs = (torch.as_tensor(x) for x in (valid, present, attrs))
    if _on_cpu(valid):
        return ref.overlay_ref(valid, present, attrs)
    valid, present, attrs = _stacks(valid, present, attrs)
    h, P, S = valid.shape
    K = attrs.shape[-1]
    o_v = torch.empty((P, S), dtype=torch.bool, device=valid.device)
    o_p = torch.empty((P, S), dtype=torch.int8, device=valid.device)
    o_a = torch.empty((P, S, K), dtype=torch.int32, device=valid.device)
    lib = _build.load("delta_overlay", _SIGNATURES)
    with torch.cuda.device(valid.device):
        err = lib.overlay_launch(
            valid.data_ptr(), present.data_ptr(), attrs.data_ptr(),
            o_v.data_ptr(), o_p.data_ptr(), o_a.data_ptr(),
            h, P * S, K, _build.stream_of(valid))
    _build.check(lib, err, "delta_overlay.overlay")
    LAUNCHES["overlay"] += 1
    return o_v, o_p, o_a


def _tmask(tmask, device, h=None):
    """An (h, T) layer->timepoint mask as contiguous int32 on ``device``."""
    if tmask.dim() != 2 or 0 in tmask.shape or h not in (None, tmask.shape[0]):
        raise ValueError(f"tmask must be (h={h or 'h>0'}, T>0), got "
                         f"{tuple(tmask.shape)}")
    return tmask.to(device, torch.int32).contiguous()


def layer_lists(tmask):
    """The batch kernel's pre-pass alone: for each timepoint t of an
    (h, T) mask, the layers i with ``tmask[i, t]`` set, in index order.
    Returns lists (T, h) int32, -1 past each count, and counts (T,)
    int32.  The main path runs it inside ``overlay_batch``."""
    tmask = torch.as_tensor(tmask)
    if _on_cpu(tmask):
        return ref.layer_lists_ref(tmask)
    tmask = _tmask(tmask, tmask.device)
    h, T = tmask.shape
    lists = torch.empty((T, h), dtype=torch.int32, device=tmask.device)
    counts = torch.empty(T, dtype=torch.int32, device=tmask.device)
    lib = _build.load("delta_overlay", _SIGNATURES)
    with torch.cuda.device(tmask.device):
        err = lib.layer_lists_launch(tmask.data_ptr(), lists.data_ptr(),
                                     counts.data_ptr(), h, T,
                                     _build.stream_of(tmask))
    _build.check(lib, err, "delta_overlay.layer_lists")
    return lists, counts


def overlay_batch(valid, present, attrs, tmask):
    """Time-batched fold: stacked deltas (h, P, S[, K]) + layer->timepoint
    mask (h, T) -> per-timepoint outputs (P, S, T[, K]).

    Timepoint t folds exactly the layers with ``tmask[i, t]`` set
    (typically: every shared hierarchy-path layer + that timepoint's own
    eventlist layer), starting from the neutral accumulator."""
    valid, present, attrs, tmask = (
        torch.as_tensor(x) for x in (valid, present, attrs, tmask))
    if _on_cpu(valid):
        return ref.overlay_batch_ref(valid, present, attrs, tmask)
    valid, present, attrs = _stacks(valid, present, attrs)
    h, P, S = valid.shape
    K = attrs.shape[-1]
    tmask = _tmask(tmask, valid.device, h)
    T = tmask.shape[1]
    # the pre-pass's per-timepoint layer lists (T, h), then their counts (T,)
    lists = torch.empty(T * (h + 1), dtype=torch.int32, device=valid.device)
    o_v = torch.empty((P, S, T), dtype=torch.bool, device=valid.device)
    o_p = torch.empty((P, S, T), dtype=torch.int8, device=valid.device)
    o_a = torch.empty((P, S, T, K), dtype=torch.int32, device=valid.device)
    lib = _build.load("delta_overlay", _SIGNATURES)
    with torch.cuda.device(valid.device):
        err = lib.overlay_batch_launch(
            valid.data_ptr(), present.data_ptr(), attrs.data_ptr(),
            tmask.data_ptr(), lists.data_ptr(), lists[T * h:].data_ptr(),
            o_v.data_ptr(), o_p.data_ptr(), o_a.data_ptr(),
            h, P * S, K, T, _build.stream_of(valid))
    _build.check(lib, err, "delta_overlay.overlay_batch")
    LAUNCHES["overlay_batch"] += 1
    return o_v, o_p, o_a
