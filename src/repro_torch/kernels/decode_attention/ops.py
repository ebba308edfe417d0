"""Wrapper of the decode-attention kernel.

Dispatch is on the tensor's device: on a CUDA device the hand-written
kernel (``decode_attention.cu``) runs and any build or launch error
raises; on the CPU the plain version (``ref.decode_attention_ref``) runs,
and on ``meta`` tensors (the dry run) it runs too, computing nothing.
``LAUNCHES["decode_attention"]`` counts the kernel launches, one per
wrapper call that reaches the card.

The kernel reads the cache as it is stored, (B, Sc, KVv, hd) in its type
(float32 or bfloat16, the type of q too), with any strides on B, Sc and
KVv and unit stride on hd; its 16-byte ``cp.async`` copies want 16-byte
aligned bases and strides, and a tensor without them is copied first.
Head dims 16, 64, 96, 128 and 256 are compiled.  The type picks the
kernel, a fixed choice: bfloat16 (serving) runs its products on the tensor
cores, float32 (the reduced configurations) on the CUDA cores, in float32.
How the work is cut depends only on the shapes: a block holds
``group_plan``'s query heads of one KV head, and ``split_plan`` cuts the
slots into ranges so the blocks fill the card once, at the blocks an SM
holds of the launched variant (``decode_attention_blocks_per_sm``, the
occupancy of its shared memory, registers and threads).  ``with_lse``
also returns each row's log-sum-exp, read from the ranges' maxima and
sums the kernel leaves in its scratch: what merges the outputs of ranges
of slots attended apart (``ref.merge_ranges``, a cache sharded on its
slots).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import ref

LAUNCHES = {"decode_attention": 0}
PLAIN_DEVICES = ("cpu", "meta")  # devices the plain version serves
HEAD_DIMS = (16, 64, 96, 128, 256)  # the kernel's compiled head dims
MIN_SPLIT = 128  # fewest slots a range
MAX_SPLIT = 128  # most ranges a column (decode_attention.cu's MAX_SPLIT)
SPLIT_STEP = 16  # ranges are whole multiples of this many slots (a bf16 warp's chunk)

_P, _I, _L, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
_SIGNATURES = {
    "decode_attention_launch": [_P] * 8 + [_I] * 10 + [_L] * 11 + [_D, _P],
    "decode_attention_max_group": [_I, _I],
    "decode_attention_blocks_per_sm": [_I, _I, _I, _P],
}


def decode_attention(k, v, q, k_pos, pos, window: int = 0, logit_cap: float = 0.0,
                     with_lse: bool = False):
    """k, v: (B, Sc, KVv, hd), the cache; q: (B, 1, H, hd), H a multiple of
    KVv (head h reads KV head h // (H // KVv)); k_pos: (B, Sc) int
    positions of the slots, -1 empty; pos: (B,) the new tokens' positions.
    Slot j is attended iff 0 <= k_pos[b, j] <= pos[b] and, with window > 0,
    k_pos[b, j] > pos[b] - window.  Returns (B, 1, H, hd) in q's type and,
    ``with_lse``, each row's float32 log-sum-exp of its scaled scores
    (B, H).  ``logit_cap > 0`` runs only on the CPU."""
    if logit_cap > 0 and q.device.type != "cpu":
        raise NotImplementedError("the decode_attention kernel has no logit soft cap; "
                                  "no configuration of the port's path uses one")
    if q.device.type in PLAIN_DEVICES:
        return ref.decode_attention_ref(k, v, q, k_pos, pos, window, logit_cap, with_lse)
    k_pos, pos = _check(k, v, q, k_pos, pos)
    B, Sc, KVv, hd = k.shape
    H = q.shape[2]
    bf16 = q.dtype == torch.bfloat16
    lib = _build.load("decode_attention", _SIGNATURES)
    gb, n_split, split_len = plan(q, k)
    chunks = -(-(H // KVv) // gb)
    q, k, v = (_aligned(t) for t in (q, k, v))
    part = torch.empty((B, H, n_split, hd + 4), dtype=torch.float32, device=q.device)
    counters = _counters(q.device, B * KVv * chunks)
    out = torch.empty((B, 1, H, hd), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_pos.data_ptr(), pos.data_ptr(),
            part.data_ptr(), counters.data_ptr(), out.data_ptr(), int(bf16), B, H, KVv, Sc, hd,
            gb, n_split,
            split_len, int(window), *_strides(q, 0, 2), *_strides(k, 0, 1, 2),
            *_strides(v, 0, 1, 2), *_strides(k_pos, 0), *_strides(out, 0, 2),
            float(hd) ** -0.5, _build.stream_of(q))
    _build.check(lib, err, "decode_attention")
    LAUNCHES["decode_attention"] += 1
    if not with_lse:
        return out
    m, l = part[..., hd], part[..., hd + 1]  # each range's max (log2 units) and sum
    top = m.amax(dim=-1, keepdim=True)
    lse = top[..., 0] + torch.log2((torch.exp2(m - top) * l).sum(dim=-1))
    return out, lse * math.log(2.0)


def plan(q, k) -> tuple:
    """``(gb, n_split, split_len)``: how the kernel cuts decode attention
    of q over the cache k on q's card (``group_plan``, ``split_plan`` at
    the blocks an SM holds of the variant launched)."""
    B, Sc, KVv, hd = k.shape
    bf16 = q.dtype == torch.bfloat16
    gb, chunks = group_plan(q.shape[2] // KVv, _max_group(bf16, hd))
    n_split, split_len = split_plan(B * KVv * chunks, Sc, _sms(q.device),
                                    _blocks_per_sm(q.device, bf16, hd, gb))
    return gb, n_split, split_len


def group_plan(group: int, max_group: int) -> tuple:
    """``(gb, chunks)``: the query heads a block holds, a power of two at
    least ``group`` (the query heads a KV head serves) up to ``max_group``,
    and the blocks a KV head's group is cut into."""
    gb = 1
    while gb < group and gb < max_group:
        gb *= 2
    return gb, -(-group // gb)


def split_plan(columns: int, sc: int, sms: int, blocks_per_sm: int) -> tuple:
    """``(n_split, split_len)``: the ``sc`` slots cut into ranges of
    ``split_len`` (a multiple of SPLIT_STEP, at least MIN_SPLIT; the last
    range may be shorter, none is empty; at most MAX_SPLIT ranges) so that
    ``columns`` x n_split blocks fill the ``blocks_per_sm`` x ``sms`` the
    card holds at once without passing it (a partial wave more would be a
    tail)."""
    fit = blocks_per_sm * sms // columns  # ranges a column while every block fits
    want = max(1, min(-(-sc // MIN_SPLIT), fit, MAX_SPLIT))
    split_len = max(MIN_SPLIT, -(-sc // (want * SPLIT_STEP)) * SPLIT_STEP)
    return -(-sc // split_len), split_len


# (device, stream) -> the columns' counters, which every launch leaves zero
_COUNTERS = {}


def _counters(device, n: int):
    """The last-block counters of ``n`` columns (sequence, KV head, group
    chunk) on the current stream: zeroed once, when allocated, and kept,
    since the kernel leaves them zero.  One a stream, so no two launches
    share them at once."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    counters = _COUNTERS.get(key)
    if counters is None or counters.numel() < n:
        counters = _COUNTERS[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return counters


@functools.lru_cache(maxsize=None)
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _max_group(bf16: bool, hd: int) -> int:
    return _build.load("decode_attention", _SIGNATURES).decode_attention_max_group(int(bf16), hd)


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(device, bf16: bool, hd: int, gb: int) -> int:
    lib = _build.load("decode_attention", _SIGNATURES)
    resident = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.decode_attention_blocks_per_sm(int(bf16), hd, gb, ctypes.byref(resident))
    _build.check(lib, err, "decode_attention_blocks_per_sm")
    if resident.value < 1:
        raise RuntimeError(f"decode_attention: no block of the bf16={bf16} hd={hd} gb={gb} "
                           f"kernel fits an SM of {device}")
    return resident.value


def _check(k, v, q, k_pos, pos):
    if any(isinstance(t, DTensor) for t in (k, v, q, k_pos, pos)):
        raise NotImplementedError("decode_attention takes each rank's block as a plain "
                                  "tensor (models.attention._decode_attend gives it so)")
    if q.device.type != "cuda" or any(t.device != q.device for t in (k, v, k_pos, pos)):
        raise ValueError("decode_attention runs on cuda or cpu, with every input on one "
                         f"device; q is on {q.device}")
    if k.dim() != 4 or k.shape != v.shape or q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"decode_attention wants k, v (B, Sc, KVv, hd) and q (B, 1, H, hd), "
                         f"got {tuple(k.shape)}, {tuple(v.shape)}, {tuple(q.shape)}")
    B, Sc, KVv, hd = k.shape
    H = q.shape[2]
    if q.shape[0] != B or q.shape[3] != hd or H % KVv or Sc == 0:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not match the cache "
                         f"{tuple(k.shape)} (H a multiple of KVv, a non-empty cache)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention is compiled for head dims {HEAD_DIMS}, not {hd}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"decode_attention wants float32 or bfloat16 q, k, v of one type, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if tuple(k_pos.shape) != (B, Sc) or tuple(pos.shape) != (B,):
        raise ValueError(f"decode_attention wants k_pos ({B}, {Sc}) and pos ({B},), got "
                         f"{tuple(k_pos.shape)}, {tuple(pos.shape)}")
    k_pos = k_pos.to(torch.int32)
    if k_pos.stride(1) != 1:
        k_pos = k_pos.contiguous()
    return k_pos, pos.to(torch.int32).contiguous()


def _strides(t, *dims) -> list:
    """``t``'s strides on ``dims``, 0 on an axis of length 1 (never stepped)."""
    return [t.stride(d) if t.shape[d] > 1 else 0 for d in dims]


def _aligned(t):
    """``t`` as the kernel's 16-byte copies read it: itself when its base is
    16-byte aligned, its last stride 1 and its other strides (of axes
    longer than 1) multiples of 16 bytes, else a contiguous copy."""
    vec = 16 // t.element_size()
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
            s % vec == 0 for n, s in zip(t.shape[:-1], t.stride()[:-1]) if n > 1):
        return t
    return t.contiguous()
