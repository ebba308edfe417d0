"""Plain PyTorch versions of the decode-attention kernel: the port's
decode attention as it ran before the kernel (the reference's
``_decode_mha`` in float32 over KV heads expanded to the query heads),
and ``decode_attention_splits_ref``, the kernel's decomposition: the
cache's slots cut into ranges, each range's softmax kept unnormalised
with its max, P in the cache's type, the ranges merged; and
``merge_ranges``, which merges the outputs of ranges of slots attended
apart by their log-sum-exps."""
from __future__ import annotations

import torch

NEG = -0.7 * torch.finfo(torch.float32).max
LOG2E = 1.4426950408889634


def expand_kv(k, v, n_heads: int):
    """Repeat KV heads (axis 2) to n_heads, consecutive grouping (q head h
    reads kv head h // (H // KV), ``jnp.repeat``, i.e.
    ``repeat_interleave``).  One KV head is expanded as a stride-0 view,
    without a copy."""
    kvh = k.shape[2]
    if kvh == 1 and n_heads > 1:
        shape = (k.shape[0], k.shape[1], n_heads, k.shape[3])
        return k.expand(shape), v.expand(shape)
    if kvh != n_heads:
        rep = n_heads // kvh
        return k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
    return k, v


def slot_mask(k_pos, pos, window: int = 0):
    """(B, Sc) bool: the slots sequence b's new token at ``pos[b]`` may
    attend: filled (``k_pos >= 0``), not after it, and inside the window."""
    ok = (k_pos >= 0) & (k_pos <= pos[:, None])
    if window > 0:
        ok = ok & (k_pos > pos[:, None] - window)
    return ok


def decode_attention_ref(k, v, q, k_pos, pos, window: int = 0, logit_cap: float = 0.0,
                         with_lse: bool = False):
    """k, v: (B, Sc, KVv, hd); q: (B, 1, H, hd); k_pos: (B, Sc); pos: (B,)
    -> (B, 1, H, hd) in q's type.  Scores in float32, masked slots NEG, the
    softmax's P rounded to v's type before P V.  ``with_lse``: also each
    row's log-sum-exp of its scores, (B, H) float32."""
    H, hd = q.shape[2], q.shape[3]
    k, v = expand_kv(k, v, H)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (hd ** -0.5)
    if logit_cap > 0:
        s = torch.tanh(s / logit_cap) * logit_cap
    s = torch.where(slot_mask(k_pos, pos, window)[:, None, None, :], s, NEG)
    pr = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", pr.to(v.dtype).float(), v.float()).to(q.dtype)
    return (out, torch.logsumexp(s, dim=-1)[..., 0]) if with_lse else out


def merge_ranges(o, lse, dim: int = 1):
    """The attention output over every slot from the outputs ``o`` (..., hd)
    over disjoint ranges of them, stacked on ``dim``, each normalised over
    its own range, and their log-sum-exps ``lse`` (``o``'s shape without
    hd): the ranges weighed by softmax(lse) over ``dim``, in float32, the
    merged axis kept with length 1."""
    w = torch.softmax(lse.float(), dim=dim)
    return (w[..., None] * o.float()).sum(dim=dim, keepdim=True)


def decode_attention_splits_ref(k, v, q, k_pos, pos, window: int, split_len: int,
                                p_dtype=None):
    """The kernel's arithmetic, a range of ``split_len`` slots at a time:
    scores scaled by scale * log2 e, NEG where masked; each range's max m,
    p = exp2(s - m), its sum l and o = P V with P rounded to v's type
    (or ``p_dtype``) first (the kernel keeps one max a chunk of a range, so its P rounds
    against another max: within a rounding of this); then the ranges
    merged by weights exp2(m - max m), in order, and o / l in q's type."""
    H, hd = q.shape[2], q.shape[3]
    k, v = expand_kv(k, v, H)
    ok = slot_mask(k_pos, pos, window)[:, None, :]
    qs = q[:, 0].float() * (hd ** -0.5 * LOG2E)
    parts = []
    for s0 in range(0, k.shape[1], split_len):
        kr, vr = k[:, s0:s0 + split_len].float(), v[:, s0:s0 + split_len]
        s = torch.where(ok[..., s0:s0 + split_len], torch.einsum("bhd,bkhd->bhk", qs, kr), NEG)
        m = s.amax(dim=-1)
        p = torch.exp2(s - m[..., None])
        o = torch.einsum("bhk,bkhd->bhd", p.to(p_dtype or vr.dtype).float(), vr.float())
        parts.append((m, p.sum(dim=-1), o))
    top = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    o = sum(torch.exp2(m - top)[..., None] * o for m, _, o in parts)
    l = sum(torch.exp2(m - top) * l for m, l, _ in parts)
    return (o / l[..., None])[:, None].to(q.dtype)
