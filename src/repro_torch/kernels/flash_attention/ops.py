"""Wrapper of the flash-attention kernels.

Dispatch is on the tensor's device: on a CUDA device a hand-written
kernel (``flash_attention.cu``) runs and any build or launch error
raises; on the CPU the plain version (``ref.py``) runs, and on ``meta``
tensors (the dry run, ``repro_torch.launch.dryrun``) it runs too, which
there computes nothing and only gives shapes and a FLOP count.
``LAUNCHES`` counts the kernel launches, one per wrapper call that
reaches the card.

On the card the input type picks the kernel, a fixed choice: bfloat16
goes to the tensor-core kernel (``wgmma`` fed by TMA; P is rounded to
bfloat16 before P·V, as the reference's model path does), float32 to the
3xTF32 kernel: every product on the tensor cores as lo·hi + hi·lo + hi·hi
of TF32 halves (``ref.split_tf32``), float32 accuracy at a third of the
TF32 rate; ``ref.attention_3xtf32_ref`` mirrors it.

Both take q, k and v as they are: any strides on the batch, head and
sequence axes (so a (B, S, H, D) projection viewed as (B, H, S, D), and
one KV head expanded to H heads with stride 0, need no copy), unit
stride on D.  The bfloat16 kernels read through TMA and the float32
kernels with 16-byte ``cp.async`` copies; both want 16-byte aligned bases
and strides, and a tensor without them is copied first
(``tma_view``, ``f32_view``).  The output has q's type and q's layout.

On the card a call that needs a gradient goes through ``FlashAttention``,
an ``autograd.Function``: its forward also writes each row's
log-sum-exp (``flash_attention_lse``), and its backward is more kernels
(``flash_attention_bwd``: the rows' ``rowsum(dO * O)``, dK and dV over
key tiles, dQ over query tiles), deterministic, chosen by type as the
forward is: bfloat16 in three launches on ``wgmma`` fed by TMA (P^T,
dS^T and dS rounded to bfloat16 only as the products' A operands, every
sum in float32; ``ref.attention_bwd_bf16_ref`` mirrors it), float32 in
two 3xTF32 launches (dQ, which also writes ``rowsum(dO * O)``, then dK
and dV; ``ref.attention_bwd_3xtf32_ref`` mirrors them).  K and V come in
expanded to H heads (a stride-0 head axis for one KV head): the backward
writes every head's dK and dV, and autograd's ``expand`` backward sums
them.
``LAUNCHES["bwd"]`` counts backward calls that reach the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

LAUNCHES = {"flash_attention": 0, "bwd": 0}
PLAIN_DEVICES = ("cpu", "meta")  # devices the plain version serves

_P, _I, _L, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
_SIGNATURES = {
    "flash_attention_f32_launch": [_P] * 7 + [_I] * 5 + [_L] * 12 + [_I, _I, _D, _P],
    "flash_attention_bf16_launch": [_P] * 7 + [_I] * 7 + [_L] * 12 + [_I, _I, _D, _P],
    "flash_attention_bwd_f32_launch": [_P] * 12 + [_I] * 5 + [_L] * 15 + [_I, _I, _D, _P],
    "flash_attention_bwd_bf16_launch": [_P] * 13 + [_I] * 7 + [_L] * 15 + [_I, _I, _D, _P],
}


def flash_attention(q, k, v, q_pos, k_pos, *, causal: bool = True, window: int = 0):
    """q: (B, H, Sq, D); k, v: (B, H, Sk, D) (KV already expanded to H
    heads); q_pos (Sq,), k_pos (Sk,) int positions, ``k_pos = -1`` a hole.
    float32 or bfloat16 in, float32 accumulation, out (B, H, Sq, D) in
    q's type; a query with no key to attend gives 0."""
    if q.device.type in PLAIN_DEVICES:
        return ref.attention_ref(q, k, v, q_pos, k_pos, causal=causal,
                                 window=window).to(q.dtype)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, q_pos, k_pos, causal, window)
    return _forward(q, k, v, q_pos, k_pos, causal, window, with_lse=False)[0]


def flash_attention_lse(q, k, v, q_pos, k_pos, *, causal: bool = True, window: int = 0):
    """``flash_attention`` and each row's log-sum-exp of its scaled scores
    ((B, H, Sq) float32, ``-inf`` for a row with no key): the forward the
    backward needs."""
    if q.device.type in PLAIN_DEVICES:
        return (ref.attention_ref(q, k, v, q_pos, k_pos, causal=causal, window=window)
                .to(q.dtype), ref.lse_ref(q, k, q_pos, k_pos, causal=causal, window=window))
    return _forward(q, k, v, q_pos, k_pos, causal, window, with_lse=True)


def _check(q, k, v, q_pos, k_pos):
    if q.device.type != "cuda" or any(t.device != q.device for t in (k, v, q_pos, k_pos)):
        raise ValueError("flash_attention runs on cuda or cpu, with every input "
                         f"on one device; q is on {q.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention wants q (B, H, Sq, D) and k, v (B, H, Sk, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    if k.shape[0] != B or k.shape[1] != H or k.shape[3] != D:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if D % 16 or not 16 <= D <= 256 or Sq == 0 or Sk == 0:
        raise ValueError(f"flash_attention wants D a multiple of 16 up to 256 and "
                         f"non-empty sequences, got D={D} Sq={Sq} Sk={Sk}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention wants float32 or bfloat16 q, k, v of one type, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if tuple(q_pos.shape) != (Sq,) or tuple(k_pos.shape) != (Sk,):
        raise ValueError(f"flash_attention wants q_pos ({Sq},) and k_pos ({Sk},), got "
                         f"{tuple(q_pos.shape)}, {tuple(k_pos.shape)}")
    return q_pos.to(torch.int32).contiguous(), k_pos.to(torch.int32).contiguous()


def _forward(q, k, v, q_pos, k_pos, causal, window, with_lse):
    q_pos, k_pos = _check(q, k, v, q_pos, k_pos)
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if with_lse else None
    lse_ptr = lse.data_ptr() if with_lse else None
    lib = _build.load("flash_attention", _SIGNATURES)
    if q.dtype == torch.bfloat16:
        q, _, _, *q_str = tma_view(q, shared=False)
        k, v, Bk, Hk, k_str, v_str = _tma_kv(k, v)
        out = torch.empty_like(q)  # q's layout when q is dense, else contiguous
        with torch.cuda.device(q.device):
            err = lib.flash_attention_bf16_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse_ptr,
                q_pos.data_ptr(), k_pos.data_ptr(), B, H, Bk, Hk, Sq, Sk, D,
                *q_str, *k_str, *v_str, *out.stride()[:3],
                int(causal), int(window), float(D) ** -0.5, _build.stream_of(q))
    else:
        q, k, v = (f32_view(t) for t in (q, k, v))
        out = torch.empty_like(q)
        strides = _f32_strides(q, k, v, out)
        with torch.cuda.device(q.device):
            err = lib.flash_attention_f32_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse_ptr,
                q_pos.data_ptr(), k_pos.data_ptr(), B, H, Sq, Sk, D, *strides,
                int(causal), int(window), float(D) ** -0.5, _build.stream_of(q))
    _build.check(lib, err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out, lse


def flash_attention_bwd(q, k, v, q_pos, k_pos, o, lse, do, *, causal: bool = True,
                        window: int = 0):
    """The gradients ``(dq, dk, dv)`` of ``flash_attention`` at output ``o``
    with row log-sum-exp ``lse`` (from ``flash_attention_lse``) and output
    gradient ``do``; each in its input's shape and type, dk and dv per head
    of the (expanded) k and v."""
    if q.device.type in PLAIN_DEVICES:
        return tuple(g.to(q.dtype) for g in ref.attention_bwd_ref(
            q, k, v, q_pos, k_pos, o, lse, do, causal=causal, window=window))
    q_pos, k_pos = _check(q, k, v, q_pos, k_pos)
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    if tuple(o.shape) != tuple(q.shape) or tuple(do.shape) != tuple(q.shape) \
            or o.dtype != q.dtype or tuple(lse.shape) != (B, H, Sq) \
            or lse.dtype != torch.float32 or any(t.device != q.device for t in (o, lse, do)):
        raise ValueError("flash_attention_bwd wants o and do like q and lse (B, H, Sq) "
                         "float32 on q's device")
    do = do.to(q.dtype)
    lse = lse.contiguous()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    dq = torch.empty((B, H, Sq, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, H, Sk, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    lib = _build.load("flash_attention", _SIGNATURES)
    if q.dtype == torch.bfloat16:
        (q, _, _, *q_str), (o, _, _, *o_str), (do, _, _, *g_str) = (
            tma_view(t, shared=False) for t in (q, o, do))
        k, v, Bk, Hk, k_str, v_str = _tma_kv(k, v)
        # each 64-row tile's position range, written by the first kernel
        ranges = torch.empty((-(-Sq // ref.TILE) - (-Sk // ref.TILE), 4), dtype=torch.int32,
                             device=q.device)
        with torch.cuda.device(q.device):
            err = lib.flash_attention_bwd_bf16_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                lse.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(), delta.data_ptr(),
                ranges.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, Bk, Hk,
                Sq, Sk, D, *q_str, *k_str, *v_str, *o_str, *g_str, int(causal), int(window),
                float(D) ** -0.5, _build.stream_of(q))
    else:
        q, k, v, o, do = (f32_view(t) for t in (q, k, v, o, do))
        strides = _f32_strides(q, k, v, o, do)
        with torch.cuda.device(q.device):
            err = lib.flash_attention_bwd_f32_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                lse.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, Sq, Sk, D, *strides,
                int(causal), int(window), float(D) ** -0.5, _build.stream_of(q))
    _build.check(lib, err, "flash_attention_bwd")
    LAUNCHES["bwd"] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its backward kernels; the wrapper applies
    it on the card when a gradient is needed."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, causal, window):
        out, lse = flash_attention_lse(q, k, v, q_pos, k_pos, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, q_pos, k_pos, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_pos, k_pos, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, q_pos, k_pos, out, lse, do,
                                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None, None, None


def _tma_kv(k, v):
    """k and v as their TMA maps read them, ``(k, v, Bk, Hk, k_strides,
    v_strides)``: a stride-0 batch or head axis shared when both allow
    it, as one map shape serves both."""
    (k, Bk, Hk, *k_str), (v, Bv, Hv, *v_str) = tma_view(k), tma_view(v)
    if (Bv, Hv) != (Bk, Hk):
        (k, Bk, Hk, *k_str), (v, _, _, *v_str) = (tma_view(t, shared=False) for t in (k, v))
    return k, v, Bk, Hk, k_str, v_str


def tma_view(t, shared: bool = True):
    """``(t, B, H, sb, sh, ss)``: a bfloat16 (B, H, S, D) tensor as its TMA
    map reads it.  With ``shared``, a stride-0 batch or head axis (an
    expanded KV head) becomes length 1, shared by every b or h; a
    length-1 axis takes the packed stride of the axes inside it.  TMA
    wants a 16-byte aligned base, unit stride on D and the other strides
    in multiples of 16 bytes: a tensor without them is made contiguous."""
    for _ in range(2):
        B, H, S, D = t.shape
        sb, sh, ss, sd = t.stride()
        if shared:
            B, H = (1 if sb == 0 else B), (1 if sh == 0 else H)
        ss = D if S == 1 else ss
        sh = ss * S if H == 1 else sh
        sb = sh * H if B == 1 else sb
        if sd == 1 and t.data_ptr() % 16 == 0 and all(s > 0 and s % 8 == 0
                                                      for s in (sb, sh, ss)):
            return t, B, H, sb, sh, ss
        t = t.clone(memory_format=torch.contiguous_format)
    raise AssertionError(f"no TMA layout for a fresh {tuple(t.shape)} copy")


def f32_view(t):
    """A float32 (B, H, S, D) tensor as the float32 kernels' 16-byte
    ``cp.async`` copies read it: ``t`` itself when its base is 16-byte
    aligned, its D stride 1 and its other strides (of axes longer than 1;
    0 for an expanded KV head) multiples of 4 elements, else a contiguous
    copy."""
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
            s % 4 == 0 for n, s in zip(t.shape[:3], t.stride()[:3]) if n > 1):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _f32_strides(*ts):
    """Each tensor's (B, H, S) element strides for the float32 launchers,
    0 on a length-1 axis (never stepped over, so any stride ``f32_view``
    let through there passes the launchers' alignment check)."""
    return [s if n > 1 else 0 for t in ts for n, s in zip(t.shape[:3], t.stride()[:3])]
